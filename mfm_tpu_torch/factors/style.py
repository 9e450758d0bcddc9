"""The 16 Barra sub-factor kernels (counterpart of
``mfm_tpu/factors/style.py``).

Each function is a tensor op over dense (T, N) panels.  The rolling ones
run in *row space* (each stock's observed days packed to the front, see
:mod:`mfm_tpu_torch.factors.engine`); NLSIZE and the rest run in calendar
space.  Contracts per sub-factor: ``Barra_factor_cal/factor_calculator.py``
as cited below.
"""

from __future__ import annotations

import torch

from mfm_tpu_torch.config import FactorConfig
from mfm_tpu_torch.ops.masked import masked_ols_residuals
from mfm_tpu_torch.ops.rolling import (
    rolling_beta_hsigma,
    rolling_cmra,
    rolling_decay_weighted_mean,
    rolling_sum,
    rolling_weighted_std,
)

_NAN = float("nan")


def compute_size(total_mv: torch.Tensor) -> torch.Tensor:
    """SIZE = ln(total market value) (``factor_calculator.py:68-77``)."""
    return torch.log(total_mv)


def compute_beta_hsigma(ret, market_ret, cfg: FactorConfig = FactorConfig(),
                        *, block=64, impl="scan"):
    """BETA/HSIGMA: rolling WLS slope and residual std
    (``factor_calculator.py:79-125``)."""
    s = cfg.beta
    return rolling_beta_hsigma(
        ret, market_ret, window=s.window, half_life=s.half_life,
        min_periods=s.min_periods, block=block, impl=impl)


def compute_rstr(log_ret, cfg: FactorConfig = FactorConfig(), *, block=64,
                 impl="scan"):
    """RSTR momentum: the lagged, head-aligned decay-weighted mean of log
    returns (``factor_calculator.py:127-153``); the L-date skip is a shift
    along the stock's own rows."""
    L = cfg.rstr_lag
    shifted = torch.cat([log_ret.new_full((L,) + tuple(log_ret.shape[1:]),
                                          _NAN), log_ret[:-L]])
    return rolling_decay_weighted_mean(
        shifted, window=cfg.rstr_total - L, half_life=cfg.rstr_half_life,
        min_periods=cfg.rstr_min_periods, block=block, impl=impl)


def compute_dastd(ret, market_ret, cfg: FactorConfig = FactorConfig(), *,
                  block=64, impl="scan"):
    """DASTD: exp-weighted std of excess returns
    (``factor_calculator.py:155-196``)."""
    if market_ret.dim() == 1:
        market_ret = market_ret[:, None]
    s = cfg.dastd
    return rolling_weighted_std(
        ret - market_ret, window=s.window, half_life=s.half_life,
        min_periods=s.min_periods, block=block, impl=impl)


def compute_cmra(log_ret, cfg: FactorConfig = FactorConfig(), *, block=64,
                 impl="scan"):
    """CMRA: cumulative-return range over a fully observed window
    (``factor_calculator.py:199-234``)."""
    return rolling_cmra(log_ret, window=cfg.cmra_window, block=block,
                        impl=impl)


def compute_nlsize(size: torch.Tensor, valid=None) -> torch.Tensor:
    """NLSIZE: minus the residual of the per-date cross-sectional OLS of
    SIZE^3 on SIZE (``factor_calculator.py:237-293``), all dates in one
    batched regression; a date needs >= 2 valid stocks.

    Computed in the centered basis: with m the date's mean and z = SIZE -
    m, ``resid(SIZE^3) = resid(z^3 + 3 m z^2)`` (the rest lies in span{1,
    SIZE}), which keeps float32 clear of the O(m^3) cancellation of the
    raw form.
    """
    valid = (torch.isfinite(size) if valid is None
             else valid & torch.isfinite(size))
    n = valid.sum(-1, keepdim=True)
    m = torch.where(valid, size, 0.0).sum(-1, keepdim=True) \
        / torch.clamp_min(n, 1)
    z = torch.where(valid, size - m, 0.0)
    y = z ** 3 + 3.0 * m * z ** 2
    return -masked_ols_residuals(y, z, valid, min_valid=2)


def compute_bp(pb: torch.Tensor) -> torch.Tensor:
    """BP = 1/pb where pb > 0 (``factor_calculator.py:295-321``)."""
    return torch.where(pb > 0, 1.0 / pb, _NAN)


def compute_liquidity(turnover_rate, cfg: FactorConfig = FactorConfig(), *,
                      block=64, impl="scan"):
    """STOM/STOQ/STOA: log rolling sums of daily turnover (percent / 100),
    a zero sum -> NaN before the log (``factor_calculator.py:324-367``)."""
    dtv = turnover_rate / 100.0
    out = {}
    for name, spec in (("STOM", cfg.stom), ("STOQ", cfg.stoq),
                       ("STOA", cfg.stoa)):
        base = rolling_sum(dtv, window=spec.window,
                           min_periods=spec.min_periods, block=block,
                           impl=impl)
        out[name] = torch.log(torch.where(base == 0.0, _NAN, base))
    return out


def ttm_rolling4(values: torch.Tensor, report_id: torch.Tensor):
    """Trailing-twelve-month values: the rolling sum of the last 4
    *distinct* reports of each stock, mapped back to its days.

    Contract (``factor_calculator.py:392-412``): unique (stock, report)
    rows in report order, ``rolling(4, min_periods=4).sum()`` (all 4 of
    the last 4 reports present and finite), joined back to the days by
    report id.  ``report_id`` is an int that changes when the report
    changes, < 0 for no report that day.

    The reference scans the dates with a 4-slot ring; here every date is
    computed at once.  A report is pushed on a day whose id is >= 0 and
    differs from the last id >= 0 before it (a day without a report does
    not reset that id); the pushes are counted, packed per stock in push
    order, and each day sums the last four pushed values.
    """
    T, N = values.shape
    t = torch.arange(T, device=values.device)[:, None].expand(T, N)
    has = report_id >= 0
    last = torch.cummax(torch.where(has, t, -1), 0).values
    before = torch.cat([last.new_full((1, N), -1), last[:-1]])
    prev_id = torch.where(before >= 0,
                          report_id.gather(0, before.clamp_min(0)), -2)
    push = has & (report_id != prev_id)
    count = torch.cumsum(push.to(torch.int64), 0)
    # the k-th push of a stock lands on row k; the other days on row T,
    # which nothing reads
    packed = values.new_full((T + 1, N), _NAN)
    packed.scatter_(0, torch.where(push, count - 1, T), values)
    ring = torch.stack([packed.gather(0, (count - 4 + j).clamp_min(0))
                        for j in range(4)])
    ok = has & (count >= 4) & torch.isfinite(ring).all(0)
    return torch.where(ok, ring.sum(0), _NAN)


def compute_earnings_yield(cashflow_ttm, total_mv, pe_ttm):
    """CETOP = TTM operating cashflow / total_mv (both > 0); ETOP =
    1/pe_ttm where pe_ttm > 0 (``factor_calculator.py:371-434``)."""
    cetop = torch.where((total_mv > 0) & (cashflow_ttm > 0),
                        cashflow_ttm / total_mv, _NAN)
    etop = torch.where(pe_ttm > 0, 1.0 / pe_ttm, _NAN)
    return cetop, etop


def compute_growth(q_profit_yoy, q_sales_yoy):
    """YOYProfit/YOYSales: percent -> ratio
    (``factor_calculator.py:436-462``)."""
    return q_profit_yoy / 100.0, q_sales_yoy / 100.0


def compute_leverage(total_mv, total_ncl, book_value, debt_to_assets):
    """MLEV/DTOA/BLEV (``factor_calculator.py:464-509``): MLEV maps +-inf
    (zero market cap) to NaN; BLEV needs a positive book value."""
    mlev = (total_mv + total_ncl) / total_mv
    mlev = torch.where(torch.isinf(mlev), _NAN, mlev)
    blev = torch.where(book_value > 0, (book_value + total_ncl) / book_value,
                       _NAN)
    return mlev, debt_to_assets, blev
