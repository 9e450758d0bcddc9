"""Reverse stress testing: the worst admissible shock per portfolio
(counterpart of ``mfm_tpu/grad/reverse.py``).

Forward stress testing asks "what does scenario s do to my book"; reverse
stress testing asks the adjoint question — "which admissible scenario
hurts my book MOST".  The scenario space is the dense part of
:class:`~mfm_tpu_torch.scenario.spec.ScenarioSpec` flattened into one
shock vector

    theta = [shift (K,) | scale (K,) | vol_mult | corr_beta]   # (2K + 2,)

and the search is projected gradient ASCENT of the predicted portfolio
vol through the real serving composition — ``stress_cov`` -> the
grad-safe PSD gate ``psd_project`` -> ``portfolio_vol`` — inside the
admissibility box :class:`~mfm_tpu_torch.grad.engine.ShockBall`.

The reference vmaps one lane's ``jax.grad`` over the portfolios; here
every lane's vol depends only on its own theta, so ONE
``torch.autograd.grad`` of the summed vols with respect to theta (B,
2K+2) gives every lane's gradient at once.  theta is detached after each
step, so no graph lives across steps.  Each step runs two eighs (the
gate's and the projection's): the full Jacobi kernel on the card.  Every
product on the path, forward and backward, is an elementwise product and
an innermost sum within the lane, so a batch of B equals B singles
bitwise.

Per-coordinate scaling: the ascent direction is the L2-normalized
gradient scaled by each coordinate's box width — a diagonal
preconditioner that moves every coordinate a comparable fraction of its
admissible range.
"""

from __future__ import annotations

import torch

from mfm_tpu_torch.models.risk_model import portfolio_vol
from mfm_tpu_torch.scenario.kernel import psd_project, stress_cov

#: guard against 0/0 in the gradient normalization; bitwise-neutral next
#: to any real gradient norm at float32 and keeps all-zero (pad) lanes at 0
_TINY = 1e-30


def stressed_vol(theta, cov, x):
    """Predicted vols (B,) of exposure rows ``x`` (B, K) under shocks
    ``theta`` (B, 2K+2) of the constant base ``cov`` ((K, K) shared, or
    (B, K, K)) — the scalar per lane the ascent differentiates.  The PSD
    gate is the grad-safe form, so the value agrees with the serving
    kernel's projection and the gradient stays finite."""
    K = x.shape[-1]
    cov_s = stress_cov(cov, theta[..., :K], theta[..., K:2 * K],
                       theta[..., 2 * K], theta[..., 2 * K + 1])
    cov_p, _, _ = psd_project(cov_s)
    return portfolio_vol(cov_p, x)


def reverse_stress_batch(cov, xs, theta0, lo, hi, step, steps: int):
    """Worst-case shock search for B portfolios.

    Args:
      cov: (K, K) base covariance (shared across lanes).
      xs: (B, K) factor-exposure vectors (pad lanes all-zero).
      theta0: (B, 2K+2) start shocks (the identity point, normally).
      lo, hi: (2K+2,) admissibility box (``ShockBall.bounds``).
      step: ascent rate (fraction of box width per iteration), a 0-d
        tensor or a float.
      steps: iteration count.

    Pad lanes (all-zero portfolios) hit the sqrt(0) gradient corner; the
    isfinite guard zeroes their gradient and they stay at their start.
    Returns ``(theta_star (B, 2K+2), vol_star (B,), vol0 (B,))``.
    """
    width = hi - lo
    theta = theta0
    for _ in range(int(steps)):
        th = theta.detach().requires_grad_(True)
        with torch.enable_grad():
            vol = stressed_vol(th, cov, xs)
            g, = torch.autograd.grad(vol.sum(), th)
        # the eigh gradient is genuinely non-differentiable at repeated
        # eigenvalues (heavily clipped correlations can reach them along
        # the ascent path); a non-finite component would poison theta
        # forever, so zero it — the projection keeps the lane admissible
        # and the next iterate re-evaluates a clean gradient
        g = torch.where(torch.isfinite(g), g, torch.zeros((), dtype=g.dtype,
                                                          device=g.device))
        # |g|^2 as two innermost sums of K + 1 terms: on the card a sum of
        # more than 64 terms takes another order at another row count
        sq = (g * g).reshape(g.shape[:-1] + (2, -1)).sum(-1).sum(
            -1, keepdim=True)
        dirn = g / (torch.sqrt(sq) + _TINY)
        theta = torch.minimum(torch.maximum(theta + step * width * dirn, lo),
                              hi)
    with torch.no_grad():
        vol0 = portfolio_vol(cov, xs)
        vol_star = stressed_vol(theta, cov, xs)
    return theta, vol_star, vol0
