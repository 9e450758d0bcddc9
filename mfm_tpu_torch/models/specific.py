"""Specific-risk model: EWMA specific volatility + Bayesian shrinkage
(counterpart of ``mfm_tpu/models/specific.py``).

1. :func:`ewma_specific_vol` — per-stock EWMA volatility of specific
   returns, the vol-regime stage's restricted renormalized half-life
   weights (``MFM.py:158-159``) applied per stock over its valid dates.
2. :func:`specific_risk_by_time` — that vol panel shrunk per date toward
   cap-group means (``utils.py:133-168``) over the date's universe, all
   dates in one batched :func:`~mfm_tpu_torch.models.bias.bayes_shrink`.

The portfolio-level combination sigma_p^2 = x'Fx + sum w_i^2 sigma_i^2
lives on :meth:`mfm_tpu_torch.pipeline.RiskPipelineResult.portfolio_risk`.
"""

from __future__ import annotations

import torch

from mfm_tpu_torch.models.bias import bayes_shrink


def ewma_specific_vol(specific_ret: torch.Tensor, half_life: float = 42.0,
                      min_periods: int = 10) -> torch.Tensor:
    """Per-stock EWMA volatility of specific returns.

    specific_ret: (T, N), NaN outside each date's universe.  For each
    (t, n), ``vol = sqrt(sum_i w_i u_i^2 / sum_i w_i)`` over stock n's
    valid dates i <= t with exp-decay weights of the given half-life; NaN
    while fewer than ``min_periods`` valid observations have been seen.

    The three sums (numerator, weight, count) run as one (3, N) recursion
    over the dates, a multiply and an add per date; the count's decay is
    1, an exact no-op, so each sum rounds as the reference's scan does.
    """
    dtype, dev = specific_ret.dtype, specific_ret.device
    lam = torch.tensor(0.5, dtype=dtype, device=dev) ** (1.0 / half_life)
    m = torch.isfinite(specific_ret)
    zero = torch.zeros((), dtype=dtype, device=dev)
    mf = m.to(dtype)
    u2 = torch.where(m, specific_ret, zero) ** 2
    inputs = torch.stack([mf * u2, mf, mf], dim=1)       # (T, 3, N)
    decay = torch.stack([lam, lam, torch.ones_like(lam)])[:, None]
    state = torch.zeros(inputs.shape[1:], dtype=dtype, device=dev)
    sums = []
    for x in inputs:
        state = decay * state + x
        sums.append(state)
    T, N = specific_ret.shape
    num, den, cnt = (torch.stack(sums) if T else inputs).unbind(dim=1)
    var = torch.where((cnt >= min_periods) & (den > 0),
                      num / torch.clamp_min(den, 1e-30),
                      torch.full_like(num, float("nan")))
    return torch.sqrt(var)


def specific_risk_by_time(specific_ret: torch.Tensor, cap: torch.Tensor,
                          half_life: float = 42.0, ngroup: int = 10,
                          q: float = 1.0, min_periods: int = 10):
    """(T, N) specific-risk panel: EWMA vol, then per-date Bayesian
    shrinkage toward cap-group means over that date's valid universe.

    Returns (raw_vol (T, N), shrunk_vol (T, N)); cells with no vol estimate
    yet (or no cap) are NaN in both.
    """
    vol = ewma_specific_vol(specific_ret, half_life, min_periods)
    cap = cap.to(vol.dtype)
    mask = torch.isfinite(vol) & torch.isfinite(cap) & (cap > 0)
    shrunk = bayes_shrink(vol, cap, ngroup=ngroup, q=q, mask=mask)
    nan = torch.full_like(vol, float("nan"))
    return torch.where(mask, vol, nan), torch.where(mask, shrunk, nan)
