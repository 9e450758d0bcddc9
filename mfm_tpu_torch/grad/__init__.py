"""Differentiable risk: the grad subsystem (counterpart of
``mfm_tpu/grad``).

Three consumer surfaces, all ``torch.autograd`` through the SAME
composition the rest of the port serves — ``scenario/kernel.py``'s
stressed covariance, the grad-safe PSD gate (its eighs the full Jacobi
kernel on the card, differentiated by the rule of ``jnp.linalg.eigh``),
and ``models/risk_model.py``'s portfolio vol:

- :mod:`mfm_tpu_torch.grad.reverse` — reverse stress testing: per-
  portfolio projected gradient ascent over the ScenarioSpec shock space,
  "which admissible shock hurts THIS book most".
- :mod:`mfm_tpu_torch.grad.construct` — gradient-based portfolio
  construction: min-vol / risk-parity / hedge-overlay solvers, surfaced
  as ``construct`` request lines of ``serve/server.py``.
- :mod:`mfm_tpu_torch.grad.sensitivity` — exact d vol/d shock and
  d vol/d exposure Jacobian rows (one backward, not finite differences),
  stamped into scenario manifests.

Host orchestration and the atomic report writer live in
:mod:`mfm_tpu_torch.grad.engine` and :mod:`mfm_tpu_torch.grad.report`.
"""

from mfm_tpu_torch.grad.construct import (
    hedge_batch,
    minvol_batch,
    riskparity_batch,
)
from mfm_tpu_torch.grad.engine import GradEngine, ShockBall
from mfm_tpu_torch.grad.report import (
    GRAD_REPORT_NAME,
    read_grad_report,
    write_grad_report,
)
from mfm_tpu_torch.grad.reverse import reverse_stress_batch
from mfm_tpu_torch.grad.sensitivity import sensitivity_batch

__all__ = [
    "GradEngine",
    "ShockBall",
    "GRAD_REPORT_NAME",
    "read_grad_report",
    "write_grad_report",
    "reverse_stress_batch",
    "minvol_batch",
    "riskparity_batch",
    "hedge_batch",
    "sensitivity_batch",
]
