"""Barra-format table -> dense risk-model arrays (counterpart of
``mfm_tpu/data/barra.py``), in numpy only.

The reference's risk model eats a long table with columns
``date, stocknames, capital, ret, industry, <styles>``
(``Barra-master/demo.py:22-38``), drops any row holding a missing value
(``demo.py:25-27``) and one-hot encodes the industry column against a code
list (``demo.py:32-35``).  Here the same table densifies into (T, N) arrays
plus a validity mask, through the row-space :class:`BarraCOO`.

The table is any column table: a pandas DataFrame, or a ``dict`` of 1-D
numpy arrays under the reference's column names (the card's machine has
no pandas); :func:`load_barra_csv` reads one from a csv without pandas.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

_BASE_COLUMNS = ("date", "stocknames", "capital", "ret", "industry")


@dataclasses.dataclass
class BarraArrays:
    """Dense inputs of :class:`mfm_tpu_torch.models.RiskModel` plus
    metadata."""

    dates: np.ndarray       # (T,) as given (string/datetime), sorted ascending
    stocks: np.ndarray      # (N,) sorted ascending, or the pinned axis
    ret: np.ndarray         # (T, N)
    cap: np.ndarray         # (T, N)
    styles: np.ndarray      # (T, N, Q)
    industry: np.ndarray    # (T, N) int in [0, P), -1 where missing
    valid: np.ndarray       # (T, N) bool
    industry_codes: np.ndarray  # (P,) the code list (one-hot column order)
    style_names: list

    @property
    def n_industries(self) -> int:
        return len(self.industry_codes)

    def factor_names(self) -> list:
        return (["country"] + list(map(str, self.industry_codes))
                + list(self.style_names))


@dataclasses.dataclass
class BarraCOO:
    """Row-space (COO) form of a barra long table: the axes plus one entry
    per surviving table row, without the dense (T, N) panels.
    :meth:`block` densifies any (date, stock) rectangle; cells no row
    covers (including a rectangle's overhang past (T, N)) densify to
    missing data (NaN / industry -1 / valid False)."""

    dates: np.ndarray           # (T,) sorted ascending
    stocks: np.ndarray          # (N,)
    industry_codes: np.ndarray  # (P,)
    style_names: list
    ti: np.ndarray              # (R,) int  date index per row
    si: np.ndarray              # (R,) int  stock index per row
    ret_v: np.ndarray           # (R,)
    cap_v: np.ndarray           # (R,)
    styles_v: np.ndarray        # (R, Q)
    industry_v: np.ndarray      # (R,) int in [0, P), -1 for unknown codes

    @property
    def n_industries(self) -> int:
        return len(self.industry_codes)

    def factor_names(self) -> list:
        return (["country"] + list(map(str, self.industry_codes))
                + list(self.style_names))

    def block(self, t0: int, t1: int, s0: int, s1: int,
              dtype=np.float64) -> dict:
        """Densify rows falling in ``[t0, t1) x [s0, s1)`` into local
        ``(t1-t0, s1-s0)`` panels (keys: ret/cap/styles/industry/valid)."""
        keep = (self.ti >= t0) & (self.ti < t1) \
            & (self.si >= s0) & (self.si < s1)
        ti, si = self.ti[keep] - t0, self.si[keep] - s0
        t, n, q = t1 - t0, s1 - s0, len(self.style_names)
        ret = np.full((t, n), np.nan, dtype)
        cap = np.full((t, n), np.nan, dtype)
        styles = np.full((t, n, q), np.nan, dtype)
        industry = np.full((t, n), -1, np.int32)
        valid = np.zeros((t, n), bool)
        ret[ti, si] = self.ret_v[keep].astype(dtype)
        cap[ti, si] = self.cap_v[keep].astype(dtype)
        styles[ti, si] = self.styles_v[keep].astype(dtype)
        industry[ti, si] = self.industry_v[keep]
        valid[ti, si] = True
        valid &= industry >= 0
        return {"ret": ret, "cap": cap, "styles": styles,
                "industry": industry, "valid": valid}

    def to_arrays(self, dtype=np.float64) -> BarraArrays:
        """The full densification (one block covering everything)."""
        b = self.block(0, len(self.dates), 0, len(self.stocks), dtype)
        return BarraArrays(
            dates=self.dates, stocks=self.stocks, ret=b["ret"], cap=b["cap"],
            styles=b["styles"], industry=b["industry"], valid=b["valid"],
            industry_codes=self.industry_codes,
            style_names=list(self.style_names),
        )


def _columns(table) -> list:
    """Column names of a DataFrame or a dict of arrays, in table order."""
    return list(table.keys() if isinstance(table, dict) else table.columns)


def _column(table, name) -> np.ndarray:
    col = table[name]
    return np.asarray(col if isinstance(table, dict) else col.to_numpy())


def _object_missing(x) -> bool:
    """pandas' notion of a missing scalar in an object column: None, NaN,
    NaT, and ``pd.NA`` (whose truth value raises TypeError)."""
    if x is None:
        return True
    try:
        return bool(x != x)
    except TypeError:
        return True
    except ValueError:  # an array-like cell is not a missing value
        return False


def _missing(col: np.ndarray) -> np.ndarray:
    """(R,) bool: the rows of one column that ``DataFrame.dropna`` drops."""
    if col.dtype.kind in "fc":
        return np.isnan(col)
    if col.dtype.kind in "mM":
        return np.isnat(col)
    if col.dtype.kind == "O":
        return np.fromiter(map(_object_missing, col), bool, len(col))
    return np.zeros(len(col), bool)


def _index_of(axis: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Position of each of ``values`` in ``axis`` (any order), -1 where a
    value is not on the axis."""
    if not len(axis):
        return np.full(len(values), -1, np.int64)
    order = np.argsort(axis, kind="stable")
    pos = np.clip(np.searchsorted(axis, values, sorter=order), 0,
                  len(axis) - 1)
    idx = order[pos]
    return np.where(axis[idx] == values, idx, -1)


def barra_frame_to_coo(
    df,
    industry_codes: Sequence | None = None,
    style_names: Sequence[str] | None = None,
    drop_any_nan: bool = True,
    stocks: Sequence | None = None,
) -> BarraCOO:
    """Long table (DataFrame or dict of columns) -> :class:`BarraCOO`.

    ``industry_codes`` fixes the one-hot column order (default: the sorted
    unique codes present; a code outside the list maps to -1, an invalid
    cell).  ``drop_any_nan`` applies the reference's row filter: a row
    missing any column, strings included, is dropped.  ``style_names``
    defaults to every column past the five base ones.  ``stocks`` pins the
    stock axis to a given ordered list (the append path aligns a slab to a
    checkpoint's universe so): listed stocks absent from the table become
    all-invalid columns, and a stock outside the list raises.
    """
    if style_names is None:
        style_names = [c for c in _columns(df) if c not in _BASE_COLUMNS]
    style_names = list(style_names)
    cols = {c: _column(df, c) for c in (*_BASE_COLUMNS, *style_names)}
    if drop_any_nan:
        drop = np.zeros(len(cols["date"]), bool)
        for name in _columns(df):
            drop |= _missing(cols[name] if name in cols
                             else _column(df, name))
        cols = {c: v[~drop] for c, v in cols.items()}
    if not len(cols["date"]):
        raise ValueError(
            "no rows survive the NaN row filter (drop_any_nan): every row "
            "has at least one missing field — check that the slab's dates "
            "lie beyond the style-factor warmup region")
    dates = np.unique(cols["date"])
    names = cols["stocknames"]
    if stocks is None:
        stocks = np.unique(names)
    else:
        stocks = np.asarray(stocks)
        unknown = np.setdiff1d(np.unique(names), stocks)
        if unknown.size:
            raise ValueError(
                f"stocknames not in the pinned stock axis: "
                f"{list(unknown[:5])}{'...' if unknown.size > 5 else ''} — "
                "a pinned (checkpoint-aligned) densification cannot admit "
                "new stocks")
    if industry_codes is None:
        industry_codes = np.unique(cols["industry"])
    industry_codes = np.asarray(industry_codes)
    n = len(names)
    return BarraCOO(
        dates=dates, stocks=stocks, industry_codes=industry_codes,
        style_names=style_names,
        ti=np.searchsorted(dates, cols["date"]),
        si=_index_of(stocks, names),
        ret_v=cols["ret"].astype(np.float64),
        cap_v=cols["capital"].astype(np.float64),
        styles_v=(np.stack([cols[c].astype(np.float64) for c in style_names],
                           axis=-1) if style_names else np.zeros((n, 0))),
        industry_v=_index_of(industry_codes, cols["industry"]).astype(np.int32),
    )


def barra_frame_to_arrays(
    df,
    industry_codes: Sequence | None = None,
    style_names: Sequence[str] | None = None,
    drop_any_nan: bool = True,
    dtype=np.float64,
    stocks: Sequence | None = None,
) -> BarraArrays:
    """Densify a barra-format long table (:func:`barra_frame_to_coo`, then
    :meth:`BarraCOO.to_arrays`)."""
    return barra_frame_to_coo(
        df, industry_codes=industry_codes, style_names=style_names,
        drop_any_nan=drop_any_nan, stocks=stocks,
    ).to_arrays(dtype)


def load_barra_csv(path, industry_info_path=None, **kw) -> BarraArrays:
    """Load the reference's CSV schema directly (``demo.py:22-35``), each
    column typed as ``pd.read_csv`` types it
    (:func:`mfm_tpu_torch.data.csvio.read_csv`, no pandas)."""
    from mfm_tpu_torch.data.csvio import read_csv

    codes = None
    if industry_info_path is not None:
        codes = read_csv(industry_info_path)["code"]
    return barra_frame_to_arrays(read_csv(path), industry_codes=codes, **kw)
