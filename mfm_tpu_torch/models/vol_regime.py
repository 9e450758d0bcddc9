"""Volatility regime adjustment (USE4) as one masked recursion
(counterpart of ``mfm_tpu/models/vol_regime.py``).

Contract (``Barra-master/mfm/MFM.py:130-167``):
- per-date cross-sectional bias statistic
  ``B_t = sqrt(mean_k(f_{t,k}^2 / sigma^2_{t,k}))`` with sigma^2 the
  diagonal of the (eigen-adjusted) covariance at the same date;
- exp-decay weights with half-life tau over dates, restricted to dates
  whose variance row has no NaN, renormalized;
- factor-volatility multiplier ``lambda_t = sqrt(sum_i w_i B_i^2)`` over
  i <= t, and the adjusted covariance is ``cov_t * lambda_t^2``.

The restricted renormalized EWMA is two scalar recursions, run as a serial
loop over the dates on the device.
"""

from __future__ import annotations

import torch

from mfm_tpu_torch._device import host_flags
from mfm_tpu_torch.parallel.mesh import replicate_under_mesh

def vr_init_carry(dtype, device=None) -> tuple:
    """The ``(num, den)`` EWMA state before any date — the resumable
    checkpoint of this stage."""
    return (torch.zeros((), dtype=dtype, device=device),
            torch.zeros((), dtype=dtype, device=device))


def vol_regime_adjust_by_time(factor_ret, covs, valid, half_life: float = 42.0):
    """Args:
      factor_ret: (T, K) raw factor returns from the cross-sectional stage.
      covs: (T, K, K) eigen-adjusted covariances (NaN at invalid dates).
      valid: (T,) validity of each covariance.

    Returns (adjusted_covs (T, K, K), lamb (T,)).
    """
    adj, lamb, _ = vol_regime_adjust_resume(factor_ret, covs, valid, half_life)
    return adj, lamb


def vol_regime_adjust_resume(factor_ret, covs, valid, half_life: float = 42.0,
                             carry: tuple | None = None, skip_mask=None):
    """:func:`vol_regime_adjust_by_time`, checkpointable.

    Returns ``(adjusted_covs, lamb, carry_out)``; ``carry`` resumes the
    ``(num, den)`` recursion from a previous call's ``carry_out``, so dates
    ``[0:T0]`` then ``[T0:T]`` match one uninterrupted pass bitwise.

    ``skip_mask`` ((T,) bool, the quarantine verdicts) excises dates: at a
    masked date ``(num, den)`` pass through unchanged.  That is stronger
    than an invalid date, which still decays both sums; a quarantined date
    leaves the time axis, so (good, BAD, good) matches (good, good)
    bitwise.  The masked date's stored multiplier is the frozen carry's
    ratio, the value a degraded-mode reader would see.  Under a mesh the
    (T,) series run replicated: date-sharded inputs are gathered first.
    """
    factor_ret, covs, valid = replicate_under_mesh((factor_ret, covs, valid))
    dtype, dev = factor_ret.dtype, factor_ret.device
    lam = torch.tensor(0.5, dtype=dtype, device=dev) ** (1.0 / half_life)
    var = covs.diagonal(dim1=-2, dim2=-1)  # (T, K)
    ok = valid & torch.isfinite(var).all(dim=-1)
    B2 = (factor_ret ** 2 / var).mean(dim=-1)  # (T,) B_t^2
    zero = torch.zeros((), dtype=dtype, device=dev)
    B2z = torch.where(ok, B2, zero)
    okf = ok.to(dtype)
    T = B2z.shape[0]

    num, den = vr_init_carry(dtype, dev) if carry is None else carry
    skip = host_flags(skip_mask, T)
    fvm2 = []
    for i in range(T):
        if not skip[i]:
            num = lam * num + okf[i] * B2z[i]
            den = lam * den + okf[i]
        # before any valid date numpy sums over empty arrays yield 0.0, not NaN
        fvm2.append(torch.where(den > 0, num / den, zero))
    fvm2 = torch.stack(fvm2) if T else torch.zeros((0,), dtype=dtype, device=dev)
    lamb = torch.sqrt(fvm2)
    return covs * fvm2[:, None, None], lamb, (num, den)
