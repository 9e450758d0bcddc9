"""Alpha scoring: per-date information coefficients and summaries
(counterpart of ``mfm_tpu/alpha/metrics.py``)."""

from __future__ import annotations

import torch

from mfm_tpu_torch.alpha.dsl import _nan_like, _sqrt, cs_rank


def _rowsum(x: torch.Tensor) -> torch.Tensor:
    """``x.sum(-1)`` with the same bits for every row of a batch.  CUDA's
    vectorized reduction aligns each row's loads to its start address, so
    a row whose length is not a multiple of 4 is summed in an order set by
    its position in the batch (two copies of one expression would score
    apart); zero-padding the rows to a multiple of 4 gives every row the
    same alignment."""
    pad = -x.shape[-1] % 4
    if pad and x.is_cuda:
        x = torch.nn.functional.pad(x, (0, pad))
    return x.sum(dim=-1)


def information_coefficient(alpha: torch.Tensor,
                            fwd_ret: torch.Tensor) -> torch.Tensor:
    """Per-date Pearson correlation of alpha vs forward returns.

    alpha: (..., T, N); fwd_ret: (T, N).  Returns (..., T).
    """
    m = torch.isfinite(alpha) & torch.isfinite(fwd_ret)
    n = m.sum(dim=-1)
    az = torch.where(m, alpha, 0.0)
    rz = torch.where(m, fwd_ret, 0.0)
    ma = _rowsum(az) / n
    mr = _rowsum(rz) / n
    da = torch.where(m, alpha - ma[..., None], 0.0)
    dr = torch.where(m, fwd_ret - mr[..., None], 0.0)
    cov = _rowsum(da * dr)
    ic = cov / _sqrt(_rowsum(da * da) * _rowsum(dr * dr))
    return torch.where(n >= 3, ic, _nan_like(ic))


def rank_ic(alpha: torch.Tensor, fwd_ret: torch.Tensor) -> torch.Tensor:
    """Spearman: Pearson IC of the cross-sectional ranks."""
    ra = cs_rank(alpha)
    rr = cs_rank(fwd_ret.expand(alpha.shape))
    return information_coefficient(ra, rr)


def _turnover_from_ranks(r: torch.Tensor) -> torch.Tensor:
    prev = torch.cat([torch.full_like(r[..., :1, :], float("nan")),
                      r[..., :-1, :]], dim=-2)
    m = torch.isfinite(r) & torch.isfinite(prev)
    n = m.sum(dim=-1)
    d = _rowsum(torch.where(m, torch.abs(r - prev), 0.0))
    return torch.where(n >= 1, d / n, _nan_like(r))


def rank_turnover(alpha: torch.Tensor) -> torch.Tensor:
    """Per-date mean |Δ cross-sectional rank| between consecutive dates.

    alpha: (..., T, N).  Returns (..., T); date 0 and dates where a stock is
    valid on only one of the two days contribute through the stocks valid on
    BOTH.  0 = identical ordering day-over-day, →0.5 = full reshuffle (the
    expectation for independent uniform ranks is 1/3).
    """
    return _turnover_from_ranks(cs_rank(alpha))


def _spread_from_ranks(r: torch.Tensor, fwd_ret: torch.Tensor,
                       q: float) -> torch.Tensor:
    f = fwd_ret.expand(r.shape)
    m = torch.isfinite(r) & torch.isfinite(f)
    top = m & (r > 1.0 - q)
    bot = m & (r <= q)
    n_top = top.sum(dim=-1)
    n_bot = bot.sum(dim=-1)
    mu_top = _rowsum(torch.where(top, f, 0.0)) / n_top
    mu_bot = _rowsum(torch.where(bot, f, 0.0)) / n_bot
    return torch.where((n_top >= 1) & (n_bot >= 1), mu_top - mu_bot,
                       _nan_like(mu_top))


def quantile_spread(alpha: torch.Tensor, fwd_ret: torch.Tensor,
                    q: float = 0.2) -> torch.Tensor:
    """Per-date top-minus-bottom quantile forward return.

    Mean forward return of the top-``q`` fraction of stocks by alpha minus
    the bottom-``q`` fraction (by fractional cross-sectional rank).
    alpha: (..., T, N); fwd_ret: (T, N).  Returns (..., T).
    """
    return _spread_from_ranks(cs_rank(alpha), fwd_ret, q)


def _nanmean_last(x):
    m = torch.isfinite(x)
    return _rowsum(torch.where(m, x, 0.0)) / m.sum(dim=-1)


def alpha_summary(alphas: torch.Tensor, fwd_ret: torch.Tensor,
                  spread_q: float = 0.2) -> dict:
    """Batch scorecard for (E, T, N) alpha values.

    Returns per-expression tensors: mean IC, IC information ratio
    (mean/std over dates), mean rank-IC, coverage (mean valid fraction),
    mean day-over-day rank turnover, and the mean top-minus-bottom
    ``spread_q``-quantile forward return.
    """
    ic = information_coefficient(alphas, fwd_ret)  # (E, T)
    # one cs_rank over (E, T, N) shared by rank-IC, turnover and spread
    r = cs_rank(alphas)
    ric = information_coefficient(r, cs_rank(fwd_ret))
    m = torch.isfinite(ic)
    n = m.sum(dim=-1)
    mean_ic = _rowsum(torch.where(m, ic, 0.0)) / n
    var_ic = _rowsum(torch.where(m, (ic - mean_ic[:, None]) ** 2, 0.0)) / n
    # jnp.mean of a bool mask: float32 whatever the alphas' dtype, the
    # count times the float32 reciprocal of the cell count
    cells = alphas.shape[-2] * alphas.shape[-1]
    coverage = torch.isfinite(alphas).sum(dim=(-2, -1)).to(torch.float32) \
        * torch.tensor(1.0 / cells, dtype=torch.float32, device=alphas.device)
    return {
        "mean_ic": mean_ic,
        "ic_ir": mean_ic / _sqrt(var_ic),
        "mean_rank_ic": _nanmean_last(ric),
        "coverage": coverage,
        "mean_turnover": _nanmean_last(_turnover_from_ranks(r)),
        "mean_spread": _nanmean_last(_spread_from_ranks(r, fwd_ret,
                                                        spread_q)),
    }
