"""Differentiable risk (counterpart of ``mfm_tpu/grad``).

Only the admissibility box of the shock space, :class:`ShockBall`, is
ported so far: the streaming sweep (``scenario/sweep.py``) and its
``sweep`` requests build one.  Reverse stress testing, gradient-based
portfolio construction, the exact sensitivities and the rest of
``grad/engine.py`` wait for ROADMAP.md §A 12.
"""

from mfm_tpu_torch.grad.engine import ShockBall

__all__ = ["ShockBall"]
