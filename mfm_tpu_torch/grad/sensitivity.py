"""Exact sensitivity reports: one backward, every Jacobian row at once
(counterpart of ``mfm_tpu/grad/sensitivity.py``).

For each scenario lane the report wants the gradient of the predicted
portfolio vol with respect to EVERY shock coordinate and every exposure —
d vol/d shift (K,), d scale (K,), d vol_mult, d corr_beta, and d vol/d x
(K,).  vol is a scalar per lane and the lanes are independent, so ONE
backward of the summed vols through the serving composition
(``stress_cov`` -> grad-safe ``psd_project`` -> ``portfolio_vol``) yields
all 3K + 2 numbers of every lane exactly — no finite differences.  The
shared exposure vector is expanded to one leaf row per lane, so d vol/d x
comes out per lane as the reference's vmapped vjp gives it.

The derivative is evaluated AT the spec's shock point: an identity lane
reports the local gradient at the unshocked world.  Non-finiteness: the
eigh gradient divides by eigenvalue gaps, so a lane whose stressed matrix
is exactly degenerate can report inf/NaN rows — a true statement (the vol
is not differentiable there), which the host layer records as ``null``
with a ``nondifferentiable`` flag (grad/engine.py).
"""

from __future__ import annotations

import torch

from mfm_tpu_torch.grad.reverse import stressed_vol


def sensitivity_batch(base_cov, shift, scale, vol_mult, corr_beta, x):
    """All sensitivity rows for S scenario lanes.

    Args:
      base_cov: (S, K, K) resolved base covariances per lane.
      shift, scale: (S, K) densified shock vectors.
      vol_mult, corr_beta: (S,) scalar shocks per lane.
      x: (K,) the portfolio's factor exposures (shared across lanes).

    Returns ``(vol (S,), d_shift (S, K), d_scale (S, K), d_vol_mult (S,),
    d_corr_beta (S,), d_x (S, K))``.
    """
    S, K = shift.shape
    theta = torch.cat([shift, scale, vol_mult[:, None], corr_beta[:, None]],
                      dim=1).detach().requires_grad_(True)
    xs = x.expand(S, K).clone().requires_grad_(True)
    with torch.enable_grad():
        vol = stressed_vol(theta, base_cov, xs)
        d_theta, d_x = torch.autograd.grad(vol.sum(), (theta, xs))
    return (vol.detach(), d_theta[:, :K], d_theta[:, K:2 * K],
            d_theta[:, 2 * K], d_theta[:, 2 * K + 1], d_x)
