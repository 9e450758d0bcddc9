"""End-to-end pipelines (counterpart of ``mfm_tpu/pipeline.py``): raw
panel -> factor table -> barra table -> risk model -> results.

- :func:`run_factor_pipeline` ≈ ``Barra_factor_cal/main.py``: the raw
  dense panel through :class:`~mfm_tpu_torch.factors.engine.FactorEngine`
  (the 16 sub-factors, winsorized, composed and orthogonalized), the
  returns shifted to the next traded day (:func:`shift_ret_next_period`)
  and the barra table assembled (:func:`assemble_barra_table`) as a dict
  of numpy columns in the reference's column order;
- :func:`run_risk_pipeline` ≈ ``Barra-master/demo.py``: a barra-format
  long table (a pandas DataFrame or a dict of numpy columns) densified and
  run through :class:`~mfm_tpu_torch.models.risk_model.RiskModel`;
- :class:`RiskPipelineResult`: the ``demo.py`` result tables, the
  specific-risk panel, portfolio risk and the random-portfolio bias test;
- :func:`save_pipeline_state` / :func:`append_risk_pipeline`: the daily
  append from a fenced checkpoint, bitwise the suffix of a full run.

Everything runs on the CUDA card unless ``device="cpu"`` is given.  Only
the five table methods, :meth:`RiskPipelineResult.specific_risk`'s
DataFrames and :meth:`RiskPipelineResult.portfolio_risk`'s ``pd.Series``
import pandas, when called; ``_specific_panels`` and ``_portfolio_risk``
are their numpy cores.

Not ported here, each raising ``NotImplementedError`` with its ROADMAP.md
item: the query engine (§A 10) and the sharded ``mesh=`` ingest (§A 16).
The reference's telemetry around the append (update latency, guard
tallies) waits for the observability slice (§A 15).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import re
from typing import Dict, Mapping

import numpy as np
import torch

from mfm_tpu_torch._device import resolve_device
from mfm_tpu_torch.config import PipelineConfig
from mfm_tpu_torch.data.artifacts import _numpy
from mfm_tpu_torch.data.barra import BarraArrays, barra_frame_to_arrays
from mfm_tpu_torch.factors.engine import (
    FactorEngine,
    gather_rows,
    rowspace_index,
    scatter_rows,
)
from mfm_tpu_torch.models.risk_model import (
    RiskModel,
    RiskModelOutputs,
    RiskModelState,
)


def _not_ported(what: str, item: int):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md §A {item})")


#: composite -> barra output name (``Barra_factor_cal/config.py:53-72``)
BARRA_OUTPUT_STYLES = (
    ("SIZE", "size"),
    ("BETA", "beta"),
    ("RSTR", "momentum"),
    ("volatility", "residual_volatility"),
    ("NLSIZE", "non_linear_size"),
    ("BP", "book_to_price_ratio"),
    ("liquidity", "liquidity"),
    ("earnings", "earnings_yield"),
    ("growth", "growth"),
    ("leverage", "leverage"),
)


def shift_ret_next_period(ret, observed) -> np.ndarray:
    """The t+1 return label: each (stock, day) gets the stock's return on
    its *next traded day* (``main.py:99``: groupby shift(-1) on the long
    frame).  Numpy in, numpy out: the host-side table assembly runs it on
    the CPU."""
    ret = torch.tensor(np.asarray(ret))
    idx = rowspace_index(torch.tensor(np.asarray(observed, bool)))
    rs = gather_rows(ret, idx)
    shifted = torch.cat([rs[1:], rs.new_full((1, rs.shape[1]), np.nan)])
    return scatter_rows(shifted, idx).numpy()


def assemble_barra_table(factors: Mapping[str, np.ndarray], dates, stocks,
                         industry_l1, circ_mv, observed) -> Dict[str, np.ndarray]:
    """The long barra table in the reference's output schema, as a dict of
    1-D numpy columns (``pd.DataFrame`` of it is the reference's frame).

    ``factors``: (T, N) arrays holding at least ``ret`` and the composite
    names of :data:`BARRA_OUTPUT_STYLES`; ``industry_l1``: (N,) per-stock
    industry codes.  One row per observed (stock, day) cell, in date-major
    order; ``ret`` is shifted to the next traded day.  Columns: date,
    stocknames, capital, ret, industry, then the ten styles.
    """
    observed = np.asarray(observed, bool)
    ti, si = np.nonzero(observed)
    next_ret = shift_ret_next_period(np.asarray(factors["ret"]), observed)
    data = {
        "date": np.asarray(dates)[ti],
        "stocknames": np.asarray(stocks)[si],
        "capital": np.asarray(circ_mv)[ti, si],
        "ret": next_ret[ti, si],
        "industry": np.asarray(industry_l1)[si],
    }
    for src, dst in BARRA_OUTPUT_STYLES:
        data[dst] = np.asarray(factors[src])[ti, si]
    return data


def run_factor_pipeline(fields: Dict, index_close, industry_l1, dates,
                        stocks, config: PipelineConfig | None = None,
                        device=None):
    """Raw dense panel -> (barra table, factor dict): the whole
    ``Barra_factor_cal/main.py`` path.

    ``fields``: numpy (T, N) arrays of everything
    :class:`~mfm_tpu_torch.factors.engine.FactorEngine` takes, plus
    ``circ_mv``.  The factors run on ``device`` (None: the CUDA card) in
    ``config.dtype``, with ``config.factors``, ``config.block`` and
    ``config.rolling_impl``; they come back as numpy arrays, and the
    table (:func:`assemble_barra_table`) is assembled on the host.
    """
    config = config or PipelineConfig()
    dev = resolve_device(device)
    dtype = _dtype(config)
    tensors = {k: (torch.as_tensor(v, device=dev) if k == "end_date_code"
                   else torch.as_tensor(v, dtype=dtype, device=dev))
               for k, v in fields.items()}
    eng = FactorEngine(tensors, torch.as_tensor(index_close, dtype=dtype,
                                                device=dev),
                       config=config.factors, block=config.block,
                       rolling_impl=config.rolling_impl, device=dev)
    factors = {k: _numpy(v) for k, v in eng.run().items()}
    observed = np.isfinite(np.asarray(fields["close"], np.float64))
    barra = assemble_barra_table(factors, dates, stocks, industry_l1,
                                 fields["circ_mv"], observed)
    return barra, factors


def _dtype(config: PipelineConfig) -> torch.dtype:
    return torch.float64 if config.dtype == "float64" else torch.float32


def _panels(a: BarraArrays, dtype: torch.dtype, device) -> tuple:
    """The five model panels of ``a`` as tensors on ``device``: floats in
    ``dtype``, industry codes int32, the universe mask bool."""
    def t(x, dt):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device, dt)

    return (t(a.ret, dtype), t(a.cap, dtype), t(a.styles, dtype),
            t(a.industry, torch.int32), t(a.valid, torch.bool))


@dataclasses.dataclass
class RiskPipelineResult:
    outputs: RiskModelOutputs
    arrays: BarraArrays
    #: the fitted model of a live run; None when rehydrated from artifacts
    #: (:func:`load_risk_pipeline_result`) — every method works off
    #: outputs and arrays alone
    model: RiskModel | None = None
    #: the resumable state after the last date, when asked for
    #: (``with_state=True`` or :func:`append_risk_pipeline`)
    state: RiskModelState | None = None
    #: per-date guard verdicts of a guarded append (``GuardReport``);
    #: ``report.served_cov`` is the degraded-mode covariance series
    report: object | None = None
    #: (half_life, ngroup, q, min_periods) -> (T, N) (raw, shrunk) numpy
    _spec_cache: dict = dataclasses.field(default_factory=dict, repr=False)

    # -- demo.py:60-94 result tables (pandas) ------------------------------
    def factor_returns(self):
        import pandas as pd

        return pd.DataFrame(_numpy(self.outputs.factor_ret),
                            index=self.arrays.dates,
                            columns=self.arrays.factor_names())

    def r_squared(self):
        import pandas as pd

        return pd.DataFrame(_numpy(self.outputs.r2), index=self.arrays.dates,
                            columns=["R2"])

    def specific_returns(self):
        import pandas as pd

        return pd.DataFrame(_numpy(self.outputs.specific_ret),
                            index=self.arrays.dates,
                            columns=self.arrays.stocks)

    def final_covariance(self):
        """Last date's fully adjusted covariance, like ``demo.py:84-88``."""
        import pandas as pd

        names = self.arrays.factor_names()
        return pd.DataFrame(_numpy(self.outputs.vr_cov[-1]), index=names,
                            columns=names)

    def lambda_series(self):
        import pandas as pd

        return pd.DataFrame(_numpy(self.outputs.lamb), index=self.arrays.dates,
                            columns=["lambda"])

    # -- specific and portfolio risk ----------------------------------------
    def specific_risk(self, half_life: float = 42.0, ngroup: int = 10,
                      q: float = 1.0, min_periods: int = 10):
        """(raw, shrunk) per-stock specific-vol DataFrames (T x N): EWMA
        specific volatility Bayes-shrunk toward cap-group means."""
        import pandas as pd

        raw, shrunk = self._specific_panels(half_life, ngroup, q, min_periods)
        return tuple(pd.DataFrame(x, index=self.arrays.dates,
                                  columns=self.arrays.stocks)
                     for x in (raw, shrunk))

    def _specific_panels(self, half_life, ngroup, q, min_periods):
        """Cached (raw, shrunk) (T, N) numpy specific-vol panels per
        parameter set, computed on the outputs' device."""
        from mfm_tpu_torch.models.specific import specific_risk_by_time

        key = (half_life, ngroup, q, min_periods)
        if key not in self._spec_cache:
            sr = self.outputs.specific_ret
            raw, shrunk = specific_risk_by_time(
                sr, torch.from_numpy(self.arrays.cap).to(sr.device, sr.dtype),
                half_life=half_life, ngroup=ngroup, q=q,
                min_periods=min_periods)
            self._spec_cache[key] = (_numpy(raw), _numpy(shrunk))
        return self._spec_cache[key]

    def _design(self, rows):
        """The regression design of the dates ``rows`` (a slice), in the
        outputs' dtype on their device."""
        from mfm_tpu_torch.ops.xreg import regression_design

        a = self.arrays
        ref = self.outputs.factor_ret
        sub = dataclasses.replace(a, ret=a.ret[rows], cap=a.cap[rows],
                                  styles=a.styles[rows],
                                  industry=a.industry[rows],
                                  valid=a.valid[rows])
        return regression_design(*_panels(sub, ref.dtype, ref.device),
                                 n_industries=a.n_industries)

    def portfolio_bias(self, n_portfolios: int = 100, seed: int = 0,
                       burn_in: int = 252, half_life: float = 42.0,
                       ngroup: int = 10, q: float = 1.0,
                       min_periods: int = 10) -> dict:
        """Random-portfolio bias statistics, the USE4 acceptance test:
        ``n_portfolios`` long-only base portfolios (|N(0,1)| weights over
        all stocks, restricted per date to the regression universe with a
        specific-vol estimate and renormalized); predicted vol from the
        adjusted factor covariance and the shrunk specific risk, realized
        from the t+1-labelled returns.  Returns a JSON-ready dict with the
        per-portfolio bias list and aggregates, over all valid dates and
        excluding the burn-in (:func:`mfm_tpu_torch.models.bias.
        portfolio_bias_stat`)."""
        from mfm_tpu_torch.models.bias import bias_std, portfolio_bias_stat

        out = self.outputs
        dtype, dev = out.factor_ret.dtype, out.factor_ret.device
        T = self.arrays.ret.shape[0]
        X, dval, _ = self._design(slice(None))
        spec = torch.from_numpy(
            self._specific_panels(half_life, ngroup, q, min_periods)[1]
        ).to(dev, dtype)
        rng = np.random.default_rng(seed)
        weights = torch.from_numpy(np.abs(rng.standard_normal(
            (n_portfolios, self.arrays.ret.shape[1])))).to(dev, dtype)
        ret = torch.from_numpy(self.arrays.ret).to(dev, dtype)
        # vr_cov's validity is the eigen stage's (the vol-regime stage only
        # scales it by lambda^2)
        z, ok = portfolio_bias_stat(X, dval, out.vr_cov, out.eigen_valid,
                                    spec, ret, weights)

        def agg(mask):
            b = _numpy(bias_std(z, mask))
            fin = b[np.isfinite(b)]
            dev1 = np.abs(fin - 1.0)
            r = lambda x: round(float(x), 4)
            return {
                "bias": [r(v) if np.isfinite(v) else None for v in b],
                "mean": r(fin.mean()) if fin.size else None,
                "median": r(np.median(fin)) if fin.size else None,
                "mean_abs_dev_from_1": r(dev1.mean()) if fin.size else None,
                "max_abs_dev_from_1": r(dev1.max()) if fin.size else None,
            }

        res = {"n_portfolios": int(n_portfolios), "seed": int(seed),
               "all_valid_dates": agg(ok)}
        after = ok & (torch.arange(T - 1, device=dev) >= burn_in)[None, :]
        if bool(after.any()):
            res[f"after_burn_in_{burn_in}"] = agg(after)
        return res

    def portfolio_risk(self, weights, t: int = -1, specific_vol=None,
                       half_life: float = 42.0, ngroup: int = 10,
                       q: float = 1.0, min_periods: int = 10) -> dict:
        """Predicted portfolio risk at date ``t``:
        ``sigma_p^2 = x'Fx + sum_i w_i^2 sigma_i^2`` with x = X_t' w.

        ``weights``: (N,) finite, aligned to ``arrays.stocks``; weight on
        stocks outside date t's regression universe must be 0 (raises).
        X_t is the regression's own design, so F (the adjusted covariance)
        applies to x in the basis it was estimated in.  ``specific_vol``:
        (N,) per-stock vol at date t, by default the shrunk EWMA specific
        risk of :meth:`specific_risk` with the given parameters.  Held
        stocks with no vol estimate raise.  The exposures and the Euler
        risk contributions come as ``pd.Series`` over the factor names.
        """
        import pandas as pd

        res = self._portfolio_risk(weights, t, specific_vol, half_life,
                                   ngroup, q, min_periods)
        names = self.arrays.factor_names()
        for k in ("factor_exposures", "factor_risk_contribution"):
            res[k] = pd.Series(res[k], index=names)
        return res

    def _portfolio_risk(self, weights, t, specific_vol, half_life, ngroup, q,
                        min_periods) -> dict:
        """:meth:`portfolio_risk` in numpy (float64): the exposures and
        contributions as (K,) arrays."""
        a = self.arrays
        T = a.ret.shape[0]
        t = int(t)
        if not -T <= t < T:
            # no silent modulo wrap: t = T must not report date-0 risk
            raise IndexError(f"date index {t} out of range for T={T}")
        t %= T
        w = np.asarray(weights, np.float64)
        if not np.isfinite(w).all():
            raise ValueError("weights must be finite (reindex fills of NaN "
                             "on out-of-universe stocks must be 0)")
        X, valid, _ = self._design(slice(t, t + 1))
        X, valid = _numpy(X[0]).astype(np.float64), _numpy(valid[0])
        if np.abs(w[~valid]).sum() > 0:
            raise ValueError("nonzero weight on stocks outside the date-t "
                             "regression universe")
        F = _numpy(self.outputs.vr_cov[t]).astype(np.float64)
        if not np.isfinite(F).all():
            raise ValueError(f"no valid adjusted covariance at date index {t}")
        x = X.T @ w
        Fx = F @ x
        factor_var = float(x @ Fx)
        if specific_vol is None:
            specific_vol = self._specific_panels(
                half_life, ngroup, q, min_periods)[1][t]
        sv = np.asarray(specific_vol, np.float64)
        held = np.abs(w) > 0
        if np.isnan(sv[held]).any():
            n_bad = int(np.isnan(sv[held]).sum())
            raise ValueError(
                f"{n_bad} held stock(s) have no specific-vol estimate at "
                f"date index {t} (fewer than min_periods={min_periods} "
                "observations); pass specific_vol= explicitly or zero their "
                "weight")
        spec_var = float(np.sum((w[held] ** 2) * (sv[held] ** 2)))
        return {
            "date": a.dates[t],
            "factor_var": factor_var,
            "specific_var": spec_var,
            "total_vol": float(np.sqrt(factor_var + spec_var)),
            "factor_exposures": x,
            # Euler decomposition: x_i (F x)_i sums exactly to x'Fx
            "factor_risk_contribution": x * Fx,
        }

    def query_engine(self, t: int = -1, benchmarks=None, **kw):
        """The batched portfolio query engine; not ported (§A 10)."""
        _not_ported("RiskPipelineResult.query_engine", 10)


def run_risk_pipeline(
    barra_df=None,
    arrays: BarraArrays | None = None,
    config: PipelineConfig | None = None,
    industry_codes=None,
    sim_covs=None,
    sim_length: int | None = None,
    fused: bool = True,
    with_state: bool = False,
    mesh=None,
    device=None,
) -> RiskPipelineResult:
    """Barra table -> full risk model (the ``demo.py`` path).

    ``barra_df`` is a DataFrame or a dict of numpy columns, densified by
    :func:`~mfm_tpu_torch.data.barra.barra_frame_to_arrays` (or pass the
    densified ``arrays``).  ``sim_covs`` / ``sim_length`` inject the
    Monte-Carlo sample covariances and their draw count (see
    :meth:`RiskModel.run`).  ``fused`` is kept for the reference's
    signature: eager PyTorch runs the same stages either way.
    ``with_state`` runs :meth:`RiskModel.init_state` and sets
    ``result.state``, the checkpoint :func:`append_risk_pipeline` serves
    new dates from.  ``device``: None for the CUDA card, or e.g. "cpu".
    """
    config = config or PipelineConfig()
    if mesh is not None:
        _not_ported("run_risk_pipeline(mesh=...)", 16)
    dev = resolve_device(device)
    if arrays is None:
        arrays = barra_frame_to_arrays(barra_df, industry_codes=industry_codes)
    rm = RiskModel(*_panels(arrays, _dtype(config), dev),
                   n_industries=arrays.n_industries, config=config.risk,
                   device=dev)
    if with_state:
        out, state = rm.init_state(
            sim_covs=sim_covs, sim_length=sim_length,
            last_date=date_stamp(arrays.dates[-1]))
        return RiskPipelineResult(outputs=out, arrays=arrays, model=rm,
                                  state=state)
    run = rm.run_fused if fused else rm.run
    out = run(sim_covs=sim_covs, sim_length=sim_length)
    return RiskPipelineResult(outputs=out, arrays=arrays, model=rm)


def save_pipeline_state(path: str, result: RiskPipelineResult):
    """Persist ``result.state`` with the alignment metadata an append in a
    later process needs: the stock axis, style order, industry code list
    and dtype the state was built against (the reference's meta keys)."""
    from mfm_tpu_torch.data.artifacts import save_risk_state

    if result.state is None:
        raise ValueError("result has no state — run the pipeline with "
                         "with_state=True (or append_risk_pipeline)")
    a = result.arrays
    save_risk_state(path, result.state, meta={
        "stocks": np.asarray(a.stocks).astype(str).tolist(),
        "style_names": list(map(str, a.style_names)),
        "industry_codes": np.asarray(a.industry_codes).tolist(),
        "dtype": str(result.outputs.factor_ret.dtype).removeprefix("torch."),
        "n_dates": int(len(a.dates)),
        "first_date": date_stamp(a.dates[0]),
    })


def append_risk_pipeline(
    state_path: str,
    barra_df,
    config: PipelineConfig | None = None,
    force: bool = False,
    mesh=None,
    device=None,
) -> RiskPipelineResult:
    """Serve the new date(s) of a barra table from a saved checkpoint.

    Loads the :func:`save_pipeline_state` artifact (written by either
    package), takes the table's rows strictly after the checkpoint's last
    date, densifies them on the checkpoint's stock/style/industry axes and
    runs one :meth:`RiskModel.update` over them — bitwise what a full run
    gives for those dates.  Returns a result over the appended dates with
    ``result.state`` advanced past them.  Raises when the table holds no
    new date.  With ``config.risk.quarantine.enabled`` the update runs
    guarded (:meth:`RiskModel.update_guarded`) and ``result.report``
    carries the verdicts.  ``force`` overrides the checkpoint's generation
    fencing.
    """
    from mfm_tpu_torch.data.artifacts import load_risk_state

    config = config or PipelineConfig()
    if mesh is not None:
        _not_ported("append_risk_pipeline(mesh=...)", 16)
    dev = resolve_device(device)
    state, meta = load_risk_state(state_path, dev, force=force)
    arrays = barra_frame_to_arrays(
        barra_df,
        industry_codes=np.asarray(meta["industry_codes"]),
        style_names=list(meta["style_names"]),
        stocks=np.asarray(meta["stocks"]),
    )
    last = state.last_date
    keep = np.array([last is None or date_stamp(d) > last
                     for d in arrays.dates], bool)
    if not keep.any():
        raise ValueError(
            f"{state_path}: checkpoint already covers every date in the "
            f"table (last_date={last!r})")
    slab = dataclasses.replace(
        arrays, dates=arrays.dates[keep], ret=arrays.ret[keep],
        cap=arrays.cap[keep], styles=arrays.styles[keep],
        industry=arrays.industry[keep], valid=arrays.valid[keep])
    return _append_update_step(slab, state, config, last, dev)


def _append_update_step(slab, state, config, last, device):
    from mfm_tpu_torch.serve.guard import host_date_reasons

    rm = RiskModel(*_panels(slab, _dtype(config), device),
                   n_industries=slab.n_industries, config=config.risk,
                   device=device)
    last_date = date_stamp(slab.dates[-1])
    if config.risk.quarantine.enabled:
        # the host-side date-order pre-check feeds the guards: a
        # disordered date is quarantined, not folded into the carries
        pre = host_date_reasons([date_stamp(d) for d in slab.dates],
                                last_date=last)
        outputs, report, new_state = rm.update_guarded(
            state, last_date=last_date, pre_reasons=pre)
        return RiskPipelineResult(outputs=outputs, arrays=slab, model=rm,
                                  state=new_state, report=report)
    outputs, new_state = rm.update(state, last_date=last_date)
    return RiskPipelineResult(outputs=outputs, arrays=slab, model=rm,
                              state=new_state)


_MONTHS = {name: i + 1 for i, names in enumerate((
    ("jan", "january"), ("feb", "february"), ("mar", "march"),
    ("apr", "april"), ("may",), ("jun", "june"), ("jul", "july"),
    ("aug", "august"), ("sep", "sept", "september"), ("oct", "october"),
    ("nov", "november"), ("dec", "december"))) for name in names}
_WEEKDAYS = {"mon", "monday", "tue", "tuesday", "wed", "wednesday", "thu",
             "thursday", "fri", "friday", "sat", "saturday", "sun", "sunday"}
_NUMERIC_DATE = re.compile(r"(\d{1,4})([-/.])(\d{1,4})(?:\2(\d{1,4}))?")
_CLOCK = re.compile(r"(.*?)[ T]([01]?\d|2[0-3]):[0-5]\d(?::[0-5]\d(?:\.\d+)?)?")


def _calendar_day(s: str):
    """``(year, month, day)`` of a date string in one of the forms
    ``pd.Timestamp`` reads beyond ISO, or None.  Numbers separated by one
    of ``-/.``: a four-digit year first (``2023/11/30``, ``2023-1-5``), or
    last after month and day (``11/30/2023``; day first where the first
    number cannot be a month: ``30/11/2023``); a month name, a day and a
    four-digit year in any order (``Nov 30 2023``, ``30-Nov-2023``,
    ``Thursday, November 30, 2023``).  Without a day (``2023/11``,
    ``Nov 2023``) it is the month's first.  A trailing clock time is
    dropped."""
    clock = _CLOCK.fullmatch(s)
    if clock:
        s = clock.group(1)
    m = _NUMERIC_DATE.fullmatch(s)
    if m:
        a, _, b, c = m.groups()
        if c is None:  # month and year: the month's first day
            if len(a) == 4 or len(b) == 4:
                return (int(a), int(b), 1) if len(a) == 4 \
                    else (int(b), int(a), 1)
            return None
        if len(a) == 4:
            return int(a), int(b), int(c)
        if len(c) == 4:
            first, second = int(a), int(b)
            return (int(c), second, first) if first > 12 \
                else (int(c), first, second)
        return None
    tokens = [t for t in re.split(r"[\s,/.-]+", s.lower()) if t]
    if tokens and tokens[0] in _WEEKDAYS:
        tokens = tokens[1:]
    months = [_MONTHS[t] for t in tokens if t in _MONTHS]
    years = [int(t) for t in tokens if t.isdigit() and len(t) == 4]
    days = [int(t) for t in tokens if t.isdigit() and len(t) <= 2]
    if len(months) == len(years) == 1 and len(tokens) == 2 + len(days) \
            and len(days) <= 1:
        return years[0], months[0], days[0] if days else 1
    return None


def date_stamp(d) -> str:
    """Calendar-day form of a date value, for the checkpoints' identity
    stamps: the reference's ``str(pd.Timestamp(d).date())``, without
    pandas, for ``datetime64``, ``datetime``, ``pd.Timestamp`` and the
    date strings ``pd.Timestamp`` reads: ISO (with or without a time),
    ``YYYYMMDD`` (tushare's form, which ``np.datetime64`` would read as a
    year), and the forms of :func:`_calendar_day`.  An 8-digit integer is
    read as ``YYYYMMDD`` too: ``pd.read_csv`` gives a tushare date column
    as integers, which ``pd.Timestamp`` counts as nanoseconds since 1970
    (the reference stamps every such date ``"1970-01-01"``).  Anything
    else, or what does not parse, is ``str(d)``.  Appends compare these
    strings, so a different stamp forks the history.
    """
    try:
        if isinstance(d, datetime.datetime):  # pd.Timestamp included
            return str(d.date())
        if isinstance(d, datetime.date):
            return str(d)
        if isinstance(d, np.datetime64):
            return str(d.astype("datetime64[D]"))
        if isinstance(d, (int, np.integer)) and not isinstance(d, bool) \
                and 10_000_000 <= d <= 99_999_999:
            d = str(int(d))
        if isinstance(d, (str, np.str_)):
            s = str(d).strip()
            if len(s) == 8 and s.isdigit():
                s = f"{s[:4]}-{s[4:6]}-{s[6:]}"
            ymd = _calendar_day(s)
            if ymd is not None:
                return str(datetime.date(*ymd))
            return str(np.datetime64(s).astype("datetime64[D]"))
    except (ValueError, TypeError):
        pass
    return str(d)


def load_risk_pipeline_result(out_dir: str,
                              barra_csv: str = "barra_data.csv",
                              npz: str = "risk_outputs.npz",
                              industry_info: str = "industry_info.csv",
                              device=None) -> RiskPipelineResult:
    """Rehydrate a finished ``pipeline`` output directory (the barra table,
    the industry code list and ``risk_outputs.npz``) into a
    :class:`RiskPipelineResult`, outputs on ``device``, so the analytics
    run without recomputing the model.  Reading the CSV needs pandas.
    ``model`` is None on a rehydrated result.
    """
    from mfm_tpu_torch.data.artifacts import load_risk_outputs
    from mfm_tpu_torch.data.barra import load_barra_csv

    outputs, meta = load_risk_outputs(os.path.join(out_dir, npz), device)
    info_path = os.path.join(out_dir, industry_info)
    arrays = load_barra_csv(
        os.path.join(out_dir, barra_csv),
        info_path if os.path.exists(info_path) else None)
    shape = tuple(outputs.specific_ret.shape)
    if arrays.ret.shape != shape:
        raise ValueError(
            f"{out_dir}: barra table shape {arrays.ret.shape} does not match "
            f"the artifact's {shape} — mixed outputs from different runs?")
    if outputs.factor_ret.shape[1] != len(arrays.factor_names()):
        raise ValueError(
            f"{out_dir}: the barra table implies "
            f"{len(arrays.factor_names())} factors but the artifact holds "
            f"{outputs.factor_ret.shape[1]} — industry_info.csv missing or "
            "from a different run?")
    # exact-identity stamp when the artifact carries first/last dates
    stamp = meta.get("dates")
    if stamp is not None:
        have = [date_stamp(arrays.dates[0]), date_stamp(arrays.dates[-1])]
        if have != [date_stamp(s) for s in stamp]:
            raise ValueError(f"{out_dir}: barra table covers {have} but the "
                             f"artifact was saved for {stamp}")
    return RiskPipelineResult(outputs=outputs, arrays=arrays)
