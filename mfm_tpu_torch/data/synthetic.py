"""Seeded synthetic panels and tables (numpy only).

:func:`synthetic_risk_inputs` is a copy of the JAX package's
``__graft_entry__._synthetic_risk_inputs``, and
:func:`synthetic_market_panel` and :func:`synthetic_barra_table` of those
in ``mfm_tpu/data/synthetic.py`` (the modules import JAX, so the port
cannot use them): the same numpy draws in the same order, so a seed gives
both packages the same data.  :func:`panel_to_engine_fields` turns a
market panel into the tensors :class:`~mfm_tpu_torch.factors.engine.
FactorEngine` takes.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

#: the CSI300 universe of the reference's config-1 workload (T, N, P, Q)
CSI300 = (1390, 300, 31, 10)


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
