"""Seeded synthetic panels and tables (numpy only).

:func:`synthetic_risk_inputs` is a copy of the JAX package's
``__graft_entry__._synthetic_risk_inputs`` and :func:`synthetic_barra_table`
of ``mfm_tpu/data/synthetic.py::synthetic_barra_table`` (both import JAX,
so the port cannot use them): the same numpy draws in the same order, so a
seed gives both packages the same data.
"""

from __future__ import annotations

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
