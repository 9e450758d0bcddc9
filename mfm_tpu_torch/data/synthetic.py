"""Seeded synthetic panels and tables (numpy only).

:func:`synthetic_risk_inputs` is a copy of the JAX package's
``__graft_entry__._synthetic_risk_inputs``, and
:func:`synthetic_market_panel` and :func:`synthetic_barra_table` of those
in ``mfm_tpu/data/synthetic.py`` (the modules import JAX, so the port
cannot use them): the same numpy draws in the same order, so a seed gives
both packages the same data; :class:`Universe`, :data:`UNIVERSES` and
:func:`resolve_universe` are copies of the workload shapes there.
:func:`panel_to_engine_fields` turns a
market panel into the tensors :class:`~mfm_tpu_torch.factors.engine.
FactorEngine` takes.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

#: the CSI300 universe of the reference's config-1 workload (T, N, P, Q)
CSI300 = (1390, 300, 31, 10)


class Universe:
    """A named (T, N, P, Q) workload shape — the ``--universe`` knob.

    ``csi300`` is the CSI300-shaped panel of the reference's config 1;
    ``alla`` is the full A-share universe (~5,000 names, bench config 4).
    An integer spec gives an N-stock universe with the CSI300 history
    length and the same factor structure (P=31 industries + Q=10 styles),
    so walls stay comparable along the N axis alone.
    """

    __slots__ = ("name", "T", "N", "P", "Q")

    def __init__(self, name, T, N, P, Q):
        self.name, self.T, self.N, self.P, self.Q = name, T, N, P, Q

    def __repr__(self):
        return (f"Universe({self.name!r}, T={self.T}, N={self.N}, "
                f"P={self.P}, Q={self.Q})")


#: the named universes (T, N, P, Q): csi300 is config 1's shape, alla
#: config 4's
UNIVERSES = {
    "csi300": CSI300,
    "alla": (2500, 5000, 31, 10),
}


def resolve_universe(spec, T: int | None = None) -> Universe:
    """``'csi300' | 'alla' | N`` (int-like) -> :class:`Universe`.

    ``T`` overrides the history length (e.g. a bounded run at N=5000); the
    override is recorded in the universe's name (``_t{T}``), so a record
    produced from it can never pass for the full-length workload.
    """
    if isinstance(spec, str) and spec in UNIVERSES:
        t0, n, p, q = UNIVERSES[spec]
        name = spec
    else:
        try:
            n = int(spec)
        except (TypeError, ValueError):
            raise ValueError(
                f"unknown universe {spec!r}: expected "
                f"{sorted(UNIVERSES)} or an integer stock count") from None
        if n <= 0:
            raise ValueError(f"universe N must be positive, got {n}")
        t0, (_, p, q) = UNIVERSES["csi300"][0], UNIVERSES["csi300"][1:]
        name = f"n{n}"
    t = t0 if T is None else int(T)
    if t != t0:
        name = f"{name}_t{t}"
    return Universe(name, t, n, p, q)


def synthetic_risk_inputs(T: int, N: int, P: int, Q: int, seed: int = 0):
    """(ret, cap, styles, industry, valid) numpy arrays: float32 (T, N),
    (T, N), (T, N, Q), int32 industry codes (T, N) and a bool (T, N)
    universe in which every industry keeps one stock on every date."""
    rng = np.random.default_rng(seed)
    industry = rng.integers(0, P, size=N)
    styles = rng.standard_normal((T, N, Q)).astype(np.float32)
    ret = (0.01 * rng.standard_normal((T, N))).astype(np.float32)
    cap = np.exp(rng.normal(11.0, 1.0, size=(1, N))).astype(np.float32)
    cap = np.broadcast_to(cap, (T, N)).copy()
    valid = rng.random((T, N)) > 0.03
    # keep every industry populated each date (the constraint matrix needs
    # the last industry's cap)
    first = np.array([np.argmax(industry == p) for p in range(P)])
    valid[:, first] = True
    return (ret, cap, styles,
            np.broadcast_to(industry, (T, N)).astype(np.int32), valid)


def _dates(T: int, start: str = "2020-01-02") -> np.ndarray:
    """T business days (Monday to Friday) from ``start``, datetime64[D]."""
    out, d = [], np.datetime64(start, "D")
    while len(out) < T:
        if np.is_busday(d):
            out.append(d)
        d += 1
    return np.array(out, dtype="datetime64[D]")


def synthetic_market_panel(T: int = 300, N: int = 50, n_industries: int = 8,
                           seed: int = 0, missing: float = 0.02,
                           listing_gap: float = 0.3) -> Dict[str, np.ndarray]:
    """Dense (T, N) market and financial arrays plus metadata, in the shape
    the factor engine takes.

    Fields under the tushare names the reference joins into its master
    panel (close, turnover_rate, total_mv, circ_mv, pb, pe_ttm,
    n_cashflow_act, q_profit_yoy, q_sales_yoy, total_ncl,
    total_hldr_eqy_inc_min_int, debt_to_assets) as float64 with NaN where
    unobserved, the int report id ``end_date_code`` (-1 where unobserved)
    and the metadata ``dates`` (datetime64[D]), ``stocks``, ``industry``
    (an int code per stock), ``index_close`` and ``observed``.  A
    ``listing_gap`` fraction of the stocks list mid-sample (leading NaNs);
    ``missing`` is the rate of sparse holes.
    """
    rng = np.random.default_rng(seed)
    dates = _dates(T)
    stocks = np.array([f"{600000 + i}.SH" for i in range(N)])
    industry = rng.integers(0, n_industries, size=N)

    # market factor and idiosyncratic returns
    mkt = 0.0003 + 0.01 * rng.standard_normal(T)
    beta = 0.5 + rng.random(N)
    idio = 0.015 * rng.standard_normal((T, N)) * (0.5 + rng.random(N))
    ret = beta[None, :] * mkt[:, None] + idio
    close0 = np.exp(2.0 + rng.standard_normal(N))
    close = close0[None, :] * np.cumprod(1.0 + ret, axis=0)
    index_close = 3000.0 * np.cumprod(1.0 + mkt)

    total_mv = np.exp(rng.normal(11.0, 1.2, size=N))[None, :] * np.cumprod(
        1.0 + ret, axis=0)
    circ_mv = total_mv * (0.4 + 0.5 * rng.random(N))[None, :]
    turnover = np.exp(rng.normal(0.0, 0.8, size=(T, N)))  # percent units
    pb = np.exp(rng.normal(0.8, 0.5, size=(T, N)))
    pb[rng.random((T, N)) < 0.01] *= -1  # a few nonpositive pb -> NaN BP
    pe = np.exp(rng.normal(3.0, 0.7, size=(T, N)))
    pe[rng.random((T, N)) < 0.02] *= -1

    # quarterly report fields, forward-filled daily like the PIT join output
    n_q = T // 63 + 2
    q_cash = rng.normal(1e5, 5e4, size=(n_q, N))
    q_profit = rng.normal(10.0, 20.0, size=(n_q, N))
    q_sales = rng.normal(8.0, 15.0, size=(n_q, N))
    q_idx = np.minimum(np.arange(T) // 63, n_q - 1)
    end_date_code = q_idx[:, None] * np.ones((1, N), dtype=int)

    total_ncl = np.exp(rng.normal(10.0, 1.0, size=(T, N)))
    book = np.exp(rng.normal(10.5, 1.0, size=(T, N)))
    book[rng.random((T, N)) < 0.01] *= -1
    dtoa = 100.0 * rng.random((T, N)) * 0.8

    fields = {
        "close": close,
        "total_mv": total_mv,
        "circ_mv": circ_mv,
        "turnover_rate": turnover,
        "pb": pb,
        "pe_ttm": pe,
        "n_cashflow_act": q_cash[q_idx],
        "q_profit_yoy": q_profit[q_idx],
        "q_sales_yoy": q_sales[q_idx],
        "total_ncl": total_ncl,
        "total_hldr_eqy_inc_min_int": book,
        "debt_to_assets": dtoa,
    }

    # listing gaps (leading NaNs per stock) and sparse random holes
    start_idx = np.zeros(N, dtype=int)
    late = rng.random(N) < listing_gap
    start_idx[late] = rng.integers(1, max(2, T // 2), size=late.sum())
    obs = (np.arange(T)[:, None] >= start_idx[None, :]) \
        & (rng.random((T, N)) >= missing)
    for k, v in fields.items():
        v = v.astype(np.float64)
        v[~obs] = np.nan
        fields[k] = v
    fields["end_date_code"] = np.where(obs, end_date_code, -1)

    return {"dates": dates, "stocks": stocks, "industry": industry,
            "index_close": index_close, "observed": obs, **fields}


#: non-field keys of a :func:`synthetic_market_panel` result
PANEL_META_KEYS = ("dates", "stocks", "industry", "index_close", "observed",
                   "end_date_code")


def panel_to_engine_fields(data: Dict, dtype, device=None) -> Dict:
    """The :class:`~mfm_tpu_torch.factors.engine.FactorEngine` field dict
    of a :func:`synthetic_market_panel` result: the float fields as
    ``dtype`` tensors, the report id ``end_date_code`` as an integer
    tensor, all on ``device`` (None: the CUDA card)."""
    import torch

    from mfm_tpu_torch._device import resolve_device

    dev = resolve_device(device)
    fields = {k: torch.as_tensor(v, dtype=dtype, device=dev)
              for k, v in data.items() if k not in PANEL_META_KEYS}
    fields["end_date_code"] = torch.as_tensor(data["end_date_code"],
                                              device=dev)
    return fields


def synthetic_barra_table(T: int = 120, N: int = 60, P: int = 6, Q: int = 4,
                          seed: int = 0, missing: float = 0.05):
    """A long barra-format table like ``result/barra_data_csi.csv``.

    Returns ``(table, style_names)``: ``table`` a dict of 1-D numpy arrays
    with the reference DataFrame's columns (date as ISO strings,
    stocknames, capital, ret, industry as SW-like code strings, then the Q
    styles), in its row order.  Returns follow a true factor structure so
    the regression has signal to find; ``missing`` drops whole stock-date
    rows, but the first member of each industry is always kept, so every
    industry is present on every date.
    """
    rng = np.random.default_rng(seed)
    dates = _dates(T)
    stocks = np.array([f"{600000 + i}.SH" for i in range(N)])
    industry = np.arange(N) % P
    rng.shuffle(industry)
    styles = rng.standard_normal((T, N, Q))
    f_style = 0.002 * rng.standard_normal((T, Q))
    f_ind = 0.003 * rng.standard_normal((T, P))
    f_cty = 0.0005 * rng.standard_normal(T)
    ind_oh = np.eye(P)[industry]  # (N, P)
    ret = (
        f_cty[:, None]
        + (ind_oh @ f_ind.T).T
        + np.einsum("tnq,tq->tn", styles, f_style)
        + 0.01 * rng.standard_normal((T, N))
    )
    cap = np.exp(rng.normal(11.0, 1.0, size=N))[None, :] * np.ones((T, 1))

    keep = rng.random((T, N)) >= missing
    first_member = np.array([np.argmax(industry == p) for p in range(P)])
    keep[:, first_member] = True

    ti, si = np.nonzero(keep)
    style_names = [f"style_{q}" for q in range(Q)]
    table = {
        "date": dates[ti].astype(str),
        "stocknames": stocks[si],
        "capital": cap[ti, si],
        "ret": ret[ti, si],
        "industry": np.array([f"sw{p:02d}" for p in industry])[si],
    }
    for q, name in enumerate(style_names):
        table[name] = styles[ti, si, q]
    return table, style_names


def _quarter_ends(start: np.datetime64, last: np.datetime64) -> np.ndarray:
    """``pd.date_range(start - QuarterEnd() * 6, last, freq="QE")``: the
    quarter ends from the sixth before ``start`` (strictly before, counted
    back one quarter at a time) to ``last``, datetime64[D]."""
    month = start.astype("datetime64[M]")
    m = int(month.astype(np.int64))          # months since 1970-01
    prev_qe_month = m - (m % 3) - 1          # the quarter end before start
    months = np.arange(prev_qe_month - 15, int(last.astype("datetime64[M]")
                                                .astype(np.int64)) + 1, 3)
    ends = (months + 1).astype("datetime64[M]").astype("datetime64[D]") - 1
    return ends[ends <= last]


def synthetic_collections(
    store,
    T: int = 120,
    N: int = 20,
    n_industries: int = 5,
    index_code: str = "000300.SH",
    seed: int = 0,
    start: str = "2020-01-02",
    missing: float = 0.02,
    listing_gap: float = 0.2,
    revision_rate: float = 0.3,
):
    """Fill a :class:`mfm_tpu_torch.data.etl.PanelStore` with raw
    tushare-shaped collections (yyyymmdd string dates, the storage format
    of the reference's Mongo collections): a copy of the reference's
    generator, the same ``default_rng(seed)`` draws in the same order, so a
    seed gives both packages the same store.

    Produces the six collections ``load_and_prepare_data`` consumes plus
    ``stock_info``: daily_prices, balancesheet, cashflow,
    financial_indicators, index_daily_prices, index_components,
    sw_industries.  ``revision_rate`` of statements get a second announcement
    (same end_date, later f_ann_date, revised values) to exercise the
    two-pass dedup; one extra stock exists outside the index to exercise
    universe selection.
    """
    from mfm_tpu_torch.data.columns import day_strings

    rng = np.random.default_rng(seed)
    first = np.busday_offset(np.datetime64(start, "D"), 0, roll="forward")
    dates = np.busday_offset(first, np.arange(T))
    date_strs = day_strings(dates)
    # N constituents + 1 non-member (must be excluded by universe selection)
    all_stocks = [f"{600000 + i}.SH" for i in range(N + 1)]
    members, outsider = all_stocks[:N], all_stocks[N]
    l1_codes = [f"801{(i % n_industries):02d}0.SI" for i in range(N + 1)]

    store.insert("stock_info", {
        "ts_code": all_stocks,
        "name": [f"stk{i}" for i in range(N + 1)],
        "list_date": ["20100101"] * (N + 1),
    }, unique=("ts_code",))

    # --- daily prices (with listing gaps + random holes) -------------------
    mkt = 0.0003 + 0.01 * rng.standard_normal(T)
    cols = {k: [] for k in ("ts_code", "t", "close", "mv", "circ", "pb",
                            "turnover_rate", "pe_ttm")}
    for code in all_stocks:
        beta = 0.5 + rng.random()
        ret = beta * mkt + 0.015 * rng.standard_normal(T)
        close = np.exp(2.0 + rng.standard_normal()) * np.cumprod(1 + ret)
        mv0 = np.exp(rng.normal(11.0, 1.0))
        start_i = (rng.integers(1, max(2, T // 3))
                   if rng.random() < listing_gap else 0)
        ts = []
        for t in range(start_i, T):
            if rng.random() < missing:
                continue
            ts.append(t)
            cols["pb"].append(np.exp(rng.normal(0.8, 0.3)))
            cols["turnover_rate"].append(np.exp(rng.normal(0.0, 0.6)))
            cols["pe_ttm"].append(np.exp(rng.normal(3.0, 0.5)))
        ts = np.asarray(ts, np.int64)
        cols["ts_code"] += [code] * len(ts)
        cols["t"].append(ts)
        cols["close"].append(close[ts])
        cols["mv"].append(mv0 * close[ts] / close[0])
        cols["circ"].append(0.7 * mv0 * close[ts] / close[0])
    t = np.concatenate(cols["t"])
    close = np.concatenate(cols["close"])
    mv = np.concatenate(cols["mv"])
    store.insert("daily_prices", {
        "ts_code": np.array(cols["ts_code"], str),
        "trade_date": date_strs[t],
        "close": close, "total_mv": mv,
        "circ_mv": np.concatenate(cols["circ"]),
        "pb": np.array(cols["pb"]),
        "turnover_rate": np.array(cols["turnover_rate"]),
        "pe_ttm": np.array(cols["pe_ttm"]),
    }, unique=("ts_code", "trade_date"))

    # --- quarterly statements (with revisions) -----------------------------
    q_ends = _quarter_ends(np.datetime64(start, "D"), dates[-1])
    q_strs = day_strings(q_ends)
    bal, cf, fi = ([] for _ in range(3))
    for code in all_stocks:
        for qe, qs in zip(q_ends, q_strs):
            ann = qe + np.timedelta64(int(rng.integers(20, 80)), "D")
            a_s = day_strings([ann])[0]
            bal.append((code, qs, a_s, np.exp(rng.normal(10.0, 0.5)),
                        np.exp(rng.normal(10.5, 0.5))))
            cf.append((code, qs, a_s, rng.normal(1e5, 5e4)))
            fi.append((code, qs, a_s, rng.normal(10, 15), rng.normal(8, 12),
                       80 * rng.random()))
            if rng.random() < revision_rate:  # revised announcement
                ann2 = ann + np.timedelta64(int(rng.integers(5, 40)), "D")
                a2 = day_strings([ann2])[0]
                bal.append((code, qs, a2, np.exp(rng.normal(10.0, 0.5)),
                            np.exp(rng.normal(10.5, 0.5))))
                cf.append((code, qs, a2, rng.normal(1e5, 5e4)))

    def table(rows, names):
        return {n: np.array([r[j] for r in rows],
                            str if j < 3 else np.float64)
                for j, n in enumerate(names)}

    store.insert("balancesheet", table(
        bal, ("ts_code", "end_date", "f_ann_date", "total_ncl",
              "total_hldr_eqy_inc_min_int")),
        unique=("ts_code", "end_date", "f_ann_date"))
    store.insert("cashflow", table(
        cf, ("ts_code", "end_date", "f_ann_date", "n_cashflow_act")),
        unique=("ts_code", "end_date", "f_ann_date"))
    store.insert("financial_indicators", table(
        fi, ("ts_code", "end_date", "ann_date", "q_profit_yoy", "q_sales_yoy",
             "debt_to_assets")),
        unique=("ts_code", "end_date", "ann_date"))

    # --- index prices + components + SW industries -------------------------
    store.insert("index_daily_prices", {
        "ts_code": np.full(T, index_code), "trade_date": date_strs,
        "close": 3000.0 * np.cumprod(1 + mkt),
    }, unique=("ts_code", "trade_date"))
    # two snapshots; universe selection must use the latest one only
    old_members = members[: max(1, N - 2)] + [outsider]
    con = old_members + members
    store.insert("index_components", {
        "index_code": np.full(len(con), index_code),
        "trade_date": np.array([date_strs[0]] * len(old_members)
                               + [date_strs[-1]] * len(members)),
        "con_code": np.array(con),
    }, unique=("index_code", "trade_date", "con_code"))
    # a stale membership row that must lose to is_new == 'Y'
    codes = all_stocks[:2] + all_stocks
    l1 = ["801990.SI"] * 2 + l1_codes
    n_sw = len(codes)
    out_date = np.empty(n_sw, object)
    store.insert("sw_industries", {
        "ts_code": np.array(codes), "l1_code": np.array(l1),
        "l1_name": np.array([f"ind_{c[3:5]}" for c in l1_codes[:2]]
                            + [f"ind_{c[3:5]}" for c in l1_codes]),
        "in_date": np.full(n_sw, "20100101"), "out_date": out_date,
        "is_new": np.array(["N"] * 2 + ["Y"] * (N + 1)),
    })
    return {"dates": date_strs, "stocks": members, "index_code": index_code}
