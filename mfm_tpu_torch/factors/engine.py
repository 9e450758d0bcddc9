"""FactorEngine, the batched form of the reference's
``FactorCalculator.run`` (counterpart of ``mfm_tpu/factors/engine.py``).

Row-space semantics
-------------------
The reference's master frame has one row per (stock, traded day), so a
stock's rolling windows span its own trading days and skip its
suspensions (``groupby('ts_code').rolling(...)``).  With dense (T, N)
tensors the engine packs each stock's observed days to the front of the
date axis ("row space"), runs every rolling kernel there, and scatters the
results back to their calendar positions.  Returns are computed in row
space (close over the previous traded close, like ``pct_change`` within
the group); NLSIZE and the post-processing run in calendar space.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from mfm_tpu_torch._device import on_device, resolve_device
from mfm_tpu_torch.config import FactorConfig
from mfm_tpu_torch.factors import style
from mfm_tpu_torch.factors.post import apply_post_processing
from mfm_tpu_torch.ops.rolling import auto_block

_NAN = float("nan")


# -- row-space packing ---------------------------------------------------------

def rowspace_index(observed: torch.Tensor) -> torch.Tensor:
    """(T, N) bool -> (T, N) int64: row r of stock n holds the calendar
    index of its r-th observed day, or -1 past its last one."""
    T = observed.shape[0]
    t = torch.arange(T, device=observed.device)[:, None]
    key = torch.where(observed, t, T + t)  # observed days sort first, in order
    order = torch.argsort(key, dim=0)      # keys are unique in each column
    nobs = observed.sum(0)
    return torch.where(t < nobs[None, :], order, -1)


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Pack calendar-space (T, ...) data into row space through ``idx``;
    (T,) per-date data (the market return) is broadcast per stock."""
    safe = torch.clamp_min(idx, 0)
    g = x[safe] if x.dim() == 1 else torch.gather(x, 0, safe)
    return torch.where(idx >= 0, g, _NAN)


def scatter_rows(f: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Unpack row-space results to their calendar positions (the inverse of
    :func:`gather_rows`).  Rows past a stock's last observed day write to
    a sacrificial row T, which is dropped."""
    T, N = f.shape
    out = f.new_full((T + 1, N), _NAN)
    out.scatter_(0, torch.where(idx >= 0, idx, T),
                 torch.where(idx >= 0, f, _NAN))
    return out[:T]


@dataclasses.dataclass
class FactorEngine:
    """The 16 sub-factors and the composites over a dense panel.

    ``fields``: (T, N) float tensors or numpy arrays, NaN = missing, under
    the tushare names the reference joins: close, total_mv, circ_mv,
    turnover_rate, pb, pe_ttm, n_cashflow_act, end_date_code (int report
    id, -1 = none), q_profit_yoy, q_sales_yoy, total_ncl,
    total_hldr_eqy_inc_min_int, debt_to_assets.  ``index_close``: (T,)
    market index closes.  Both keep their dtypes and move to ``device``:
    None for the CUDA card, or e.g. "cpu".
    """

    fields: Dict[str, torch.Tensor]
    index_close: torch.Tensor
    config: FactorConfig = dataclasses.field(default_factory=FactorConfig)
    #: date-block size of the "block" impl; None derives it from the panel
    #: width (ops/rolling.py::auto_block)
    block: int | None = None
    #: "scan" (O(T*N) two-level chunked scans, the default) or "block"
    #: (windowed gathers, the reference formulation)
    rolling_impl: str = "scan"
    device: str | torch.device | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.fields = {k: on_device(v, self.device)
                       for k, v in self.fields.items()}
        self.index_close = on_device(self.index_close, self.device)
        if self.block is None:
            close = self.fields["close"]
            cfg = self.config
            # the budget of this config's widest rolling kernel
            widest = max(cfg.beta.window, cfg.rstr_total, cfg.dastd.window,
                         cfg.cmra_window, cfg.stoa.window)
            self.block = auto_block(close.shape[1], window=widest,
                                    itemsize=close.element_size())

    def run(self, factors=None, post_process: bool = True
            ) -> Dict[str, torch.Tensor]:
        """``{name: (T, N) tensor}``: ``ret``, ``log_ret``, the sub-factors
        of ``factors`` (default ``config.factors_to_run``) and, with
        ``post_process``, the winsorized sub-factors and the
        orthogonalized composites."""
        factors = tuple(factors or self.config.factors_to_run)
        f, cfg, idx_close = self.fields, self.config, self.index_close
        kw = dict(block=self.block, impl=self.rolling_impl)
        close = f["close"]
        idx = rowspace_index(torch.isfinite(close))

        # returns in row space: over the previous traded day, like
        # groupby pct_change
        rs_close = gather_rows(close, idx)
        rs_ret = rs_close / torch.cat([rs_close.new_full((1, close.shape[1]),
                                                         _NAN),
                                       rs_close[:-1]]) - 1.0
        rs_logret = torch.log1p(rs_ret)
        market_ret = idx_close / torch.cat([idx_close.new_full((1,), _NAN),
                                            idx_close[:-1]]) - 1.0
        rs_market = gather_rows(market_ret, idx)

        out = {"ret": scatter_rows(rs_ret, idx),
               "log_ret": scatter_rows(rs_logret, idx)}
        for name in factors:
            name = name.upper()
            if name == "SIZE":
                out["SIZE"] = style.compute_size(f["total_mv"])
            elif name == "BETA":
                beta, hsigma = style.compute_beta_hsigma(rs_ret, rs_market,
                                                         cfg, **kw)
                out["BETA"] = scatter_rows(beta, idx)
                out["HSIGMA"] = scatter_rows(hsigma, idx)
            elif name == "RSTR":
                out["RSTR"] = scatter_rows(
                    style.compute_rstr(rs_logret, cfg, **kw), idx)
            elif name == "DASTD":
                out["DASTD"] = scatter_rows(
                    style.compute_dastd(rs_ret, rs_market, cfg, **kw), idx)
            elif name == "CMRA":
                out["CMRA"] = scatter_rows(
                    style.compute_cmra(rs_logret, cfg, **kw), idx)
            elif name == "NLSIZE":
                out["NLSIZE"] = style.compute_nlsize(torch.log(f["total_mv"]))
            elif name == "BP":
                out["BP"] = style.compute_bp(f["pb"])
            elif name == "LIQUIDITY":
                rs_turn = gather_rows(f["turnover_rate"], idx)
                for k, v in style.compute_liquidity(rs_turn, cfg,
                                                    **kw).items():
                    out[k] = scatter_rows(v, idx)
            elif name == "EARNINGS":
                rs_cash = gather_rows(f["n_cashflow_act"], idx)
                code = f["end_date_code"]
                rs_rid = torch.where(
                    idx >= 0, torch.gather(code, 0, torch.clamp_min(idx, 0)),
                    -1)
                ttm = style.ttm_rolling4(rs_cash, rs_rid)
                out["CETOP"], out["ETOP"] = style.compute_earnings_yield(
                    scatter_rows(ttm, idx), f["total_mv"], f["pe_ttm"])
            elif name == "GROWTH":
                out["YOYProfit"], out["YOYSales"] = style.compute_growth(
                    f["q_profit_yoy"], f["q_sales_yoy"])
            elif name == "LEVERAGE":
                out["MLEV"], out["DTOA"], out["BLEV"] = style.compute_leverage(
                    f["total_mv"], f["total_ncl"],
                    f["total_hldr_eqy_inc_min_int"], f["debt_to_assets"])
            else:
                raise ValueError(f"unknown factor {name!r}")

        if post_process:
            sub = {k: v for k, v in out.items() if k not in ("ret", "log_ret")}
            out.update(apply_post_processing(
                sub, cfg.composite, cfg.ortho_rules,
                n_std=cfg.winsorize_n_std))
        return out
