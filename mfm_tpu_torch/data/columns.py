"""Column tables without pandas: the row operations the host data layer
needs, with pandas' semantics.

A table is a ``dict`` of equal-length 1-D numpy columns in column order.
A column is float64, int64, bool, datetime64[ns], fixed-width unicode
(no missing cell), or an object array of ``str`` with ``None`` or NaN at
its missing cells (:func:`as_column` brings any sequence to one of
these).  Missing means NaN, NaT, ``None`` or ``pd.NA``.

The operations mirror the pandas calls of the reference's data layer:
:func:`sort_order` is ``sort_values`` over several keys (stable, missing
last under ascending and descending keys alike), :func:`duplicated` is
``DataFrame.duplicated`` (missing keys equal one another), :func:`ffill`
is ``groupby(by).ffill()`` and :func:`reindex` is
``Series(values, index=keys).reindex(axis)``.
"""

from __future__ import annotations

import datetime
from typing import Sequence

import numpy as np


def _is_null(v) -> bool:
    """None, NaN, NaT and ``pd.NA`` (whose truth value raises)."""
    if v is None:
        return True
    try:
        return bool(v != v)
    except (TypeError, ValueError):
        return type(v).__name__ in ("NAType", "NaTType")


def _null_mask(col: np.ndarray) -> np.ndarray:
    if col.dtype.kind == "f":
        return np.isnan(col)
    if col.dtype.kind == "M":
        return np.isnat(col)
    if col.dtype.kind == "O":
        return np.fromiter(map(_is_null, col), bool, len(col))
    return np.zeros(len(col), bool)


def _object_column(vals: list, name: str) -> np.ndarray:
    """A list of Python values as one column type (see the module doc)."""
    n = len(vals)
    nulls = [_is_null(v) for v in vals]
    live = [v for v, z in zip(vals, nulls) if not z]
    any_null = len(live) < n
    if not live:
        # all missing: float NaN where any cell is a float (pandas reads
        # [None, nan] as float64), else the Nones as they are
        if any(isinstance(v, float) for v in vals):
            return np.full(n, np.nan)
        out = np.empty(n, object)
        out[:] = vals
        return out
    if all(isinstance(v, str) for v in live):
        if not any_null:
            return np.array(vals, dtype=str)
        out = np.empty(n, object)
        out[:] = vals
        return out
    if all(isinstance(v, (bool, np.bool_)) for v in live):
        if not any_null:
            return np.array(vals, dtype=bool)
        return np.array([np.nan if z else float(v)
                         for v, z in zip(vals, nulls)])
    if all(isinstance(v, (int, float, np.integer, np.floating))
           and not isinstance(v, (bool, np.bool_)) for v in live):
        if not any_null and all(isinstance(v, (int, np.integer))
                                for v in live):
            return np.array(vals, dtype=np.int64)
        return np.array([np.nan if z else float(v)
                         for v, z in zip(vals, nulls)], np.float64)
    if all(isinstance(v, (np.datetime64, datetime.date)) for v in live):
        return np.array([np.datetime64("NaT") if z else np.datetime64(v, "ns")
                         for v, z in zip(vals, nulls)], "datetime64[ns]")
    kinds = sorted({type(v).__name__ for v in live})
    raise TypeError(f"column {name!r} mixes value types {kinds}")


def as_column(values, name: str = "") -> np.ndarray:
    """``values`` (a sequence, numpy array or pandas Series) as a column
    of one of the module's types."""
    if hasattr(values, "to_numpy") and not isinstance(values, np.ndarray):
        values = values.to_numpy()
    a = values if isinstance(values, np.ndarray) else None
    if a is None:
        vals = list(values)
        try:
            a = np.asarray(vals)
        except (ValueError, TypeError):
            return _object_column(vals, name)
        # numpy reads ["a", nan] as the strings "a" and "nan"
        if a.ndim != 1 or (a.dtype.kind == "U"
                           and not all(isinstance(v, str) for v in vals)):
            return _object_column(vals, name)
    k = a.dtype.kind
    if k == "f":
        return a.astype(np.float64, copy=False)
    if k in "iu":
        return a.astype(np.int64, copy=False)
    if k == "b":
        return a
    if k == "M":
        return a.astype("datetime64[ns]", copy=False)
    if k == "U":
        return a
    if k == "S":
        return a.astype(str)
    if k == "O":
        return _object_column(a.tolist(), name)
    raise TypeError(f"column {name!r} has unsupported dtype {a.dtype}")


def as_table(obj) -> dict:
    """A dict of columns, a pandas DataFrame (read through its ``columns``
    and ``to_numpy``, so no pandas import), or None (``{}``) as a
    table."""
    if obj is None:
        return {}
    if isinstance(obj, dict):
        return {str(k): as_column(v, str(k)) for k, v in obj.items()}
    if hasattr(obj, "columns"):
        return {str(c): as_column(obj[c].to_numpy(), str(c))
                for c in obj.columns}
    raise TypeError(f"not a table: {type(obj).__name__}")


def nrows(table: dict) -> int:
    for col in table.values():
        return len(col)
    return 0


def take(table: dict, rows) -> dict:
    """The rows ``rows`` (a bool mask or positions) of every column."""
    return {k: v[rows] for k, v in table.items()}


def select(table: dict, columns: Sequence[str]) -> dict:
    missing = [c for c in columns if c not in table]
    if missing:
        raise KeyError(f"no column(s) {missing} (have {list(table)})")
    return {c: table[c] for c in columns}


def _nulls_like(n: int, like: np.ndarray) -> np.ndarray:
    k = like.dtype.kind
    if k == "M":
        return np.full(n, np.datetime64("NaT"), "datetime64[ns]")
    if k in "fiub":
        return np.full(n, np.nan)
    out = np.empty(n, object)
    out[:] = np.nan
    return out


def concat(tables: Sequence[dict]) -> dict:
    """Row-wise concatenation, ``pd.concat(..., ignore_index=True)``: the
    union of the columns in first-seen order, missing where a table lacks
    one."""
    tables = [t for t in tables if t]
    if not tables:
        return {}
    if len(tables) == 1:
        return dict(tables[0])
    names = list(dict.fromkeys(c for t in tables for c in t))
    out = {}
    for c in names:
        like = next(t[c] for t in tables if c in t)
        parts = [t[c] if c in t else _nulls_like(nrows(t), like)
                 for t in tables]
        kinds = {p.dtype.kind for p in parts}
        if len(kinds) == 1 and kinds <= set("fiubMU"):
            out[c] = np.concatenate(parts)
        elif kinds <= set("fiu"):
            out[c] = np.concatenate([p.astype(np.float64) for p in parts])
        else:
            merged = np.empty(sum(map(len, parts)), object)
            merged[:] = [x for p in parts for x in
                         (p.astype("datetime64[us]").tolist()
                          if p.dtype.kind == "M" else p.tolist())]
            out[c] = as_column(merged, c)
    return out


def factorize(col) -> tuple[np.ndarray, int]:
    """(codes, n): each cell's rank among the column's distinct non-missing
    values in sorted order, -1 where missing; n distinct values."""
    col = np.asarray(col)
    null = _null_mask(col)
    codes = np.full(len(col), -1, np.int64)
    live = col[~null]
    if col.dtype.kind == "O":
        live = np.array(live.tolist(), dtype=str) if len(live) else \
            np.array([], str)
    uniq, inv = np.unique(live, return_inverse=True)
    codes[~null] = inv.reshape(-1)
    return codes, len(uniq)


def sort_order(table: dict, by: Sequence[str],
               ascending: bool | Sequence[bool] = True) -> np.ndarray:
    """Row order of ``sort_values(by, ascending=...)`` over several keys:
    a stable lexicographic sort, missing values last whatever the
    direction (pandas' ``lexsort_indexer``)."""
    if isinstance(ascending, bool):
        ascending = [ascending] * len(by)
    keys = []
    for c, asc in zip(by, ascending):
        codes, n = factorize(table[c])
        miss = codes < 0
        codes = np.where(miss, n, codes)
        if not asc:
            codes = np.where(miss, codes, n - codes - 1)
        keys.append(codes)
    if not keys:
        return np.arange(nrows(table))
    return np.lexsort(keys[::-1])


def sort_values(table: dict, by: Sequence[str],
                ascending: bool | Sequence[bool] = True) -> dict:
    return take(table, sort_order(table, by, ascending))


def group_ids(table: dict, by: Sequence[str]) -> np.ndarray:
    """One id per row for its tuple of ``by`` values; missing values are
    one value of their own (``DataFrame.duplicated``'s grouping)."""
    n = nrows(table)
    gid = np.zeros(n, np.int64)
    for c in by:
        codes, k = factorize(table[c])
        gid = gid * (k + 1) + (codes + 1)
        _, gid = np.unique(gid, return_inverse=True)
        gid = gid.reshape(-1).astype(np.int64)
    return gid


def duplicated(table: dict, subset: Sequence[str],
               keep: str | bool = "first") -> np.ndarray:
    """``DataFrame.duplicated(subset, keep=...)`` for ``keep`` "first",
    "last" or False."""
    gid = group_ids(table, subset)
    n = len(gid)
    if keep is False:
        _, inv, counts = np.unique(gid, return_inverse=True,
                                   return_counts=True)
        return counts[inv.reshape(-1)] > 1
    dup = np.ones(n, bool)
    if keep == "last":
        _, first = np.unique(gid[::-1], return_index=True)
        dup[n - 1 - first] = False
    else:
        _, first = np.unique(gid, return_index=True)
        dup[first] = False
    return dup


def drop_duplicates(table: dict, subset: Sequence[str],
                    keep: str = "first") -> dict:
    return take(table, ~duplicated(table, subset, keep))


def unique(col) -> list:
    """``Series.unique()`` without the missing values: the distinct values
    in order of first appearance, as Python values."""
    col = np.asarray(col)
    null = _null_mask(col)
    codes, _ = factorize(col)
    _, first = np.unique(codes[~null], return_index=True)
    rows = np.nonzero(~null)[0][np.sort(first)]
    return [_py(x) for x in col[rows]]


def nunique(col) -> int:
    return factorize(col)[1]


def _py(x):
    if isinstance(x, np.datetime64):
        return x
    return x.item() if isinstance(x, np.generic) else x


def _extreme(col, last: bool):
    col = np.asarray(col)
    live = col[~_null_mask(col)]
    if not len(live):
        return None
    if live.dtype.kind in "OU":
        vals = sorted(live.tolist())
        return vals[-1] if last else vals[0]
    return _py(live.max() if last else live.min())


def col_max(col):
    """``Series.max()``: the largest non-missing value (None when there
    is none), as a Python value (a date stays a ``numpy.datetime64``)."""
    return _extreme(col, True)


def col_min(col):
    """``Series.min()``, as :func:`col_max`."""
    return _extreme(col, False)


def isin(col, values) -> np.ndarray:
    """``Series.isin(values)``."""
    col = np.asarray(col)
    values = list(values)
    if col.dtype.kind in "UO":
        want = set(values)
        return np.fromiter((x in want for x in col.tolist()), bool, len(col))
    return np.isin(col, np.asarray(values))


def ffill(col, gid: np.ndarray) -> np.ndarray:
    """``groupby(gid).ffill()`` of one column: each missing cell takes the
    last non-missing value before it in its group (row order)."""
    col = np.asarray(col)
    n = len(col)
    if not n:
        return col.copy()
    order = np.argsort(gid, kind="stable")
    g = gid[order]
    start = np.r_[True, g[1:] != g[:-1]]
    first = np.maximum.accumulate(np.where(start, np.arange(n), 0))
    valid = ~_null_mask(col)[order]
    last = np.maximum.accumulate(np.where(valid, np.arange(n), -1))
    ok = last >= first
    src = order[np.maximum(last, 0)]
    out = col.copy()
    fill = order[ok & ~valid]
    out[fill] = col[src[ok & ~valid]]
    return out


def reindex(keys, values, axis) -> np.ndarray:
    """``Series(values, index=keys).reindex(axis)`` on numpy: each axis
    label's value, NaN where the label is absent (an int column then
    becomes float, as pandas makes it)."""
    from mfm_tpu_torch.data.barra import _index_of

    keys, values, axis = np.asarray(keys), np.asarray(values), np.asarray(axis)
    if keys.dtype.kind == "M" and axis.dtype.kind == "M":
        keys = keys.astype(axis.dtype)
    if len(np.unique(keys)) != len(keys):
        raise ValueError("cannot reindex on an axis with duplicate labels")
    at = _index_of(keys, axis)
    if (at >= 0).all():
        return values[at]
    if values.dtype.kind in "iub":
        values = values.astype(np.float64)
    elif values.dtype.kind not in "fM":
        values = values.astype(object)
    out = values[np.maximum(at, 0)]
    out[at < 0] = np.datetime64("NaT") if out.dtype.kind == "M" else np.nan
    return out


def yyyymmdd_dates(col, name: str = "") -> np.ndarray:
    """``pd.to_datetime(col.astype(str), format="%Y%m%d")`` as
    datetime64[ns]: tushare's date strings; a date column passes
    through.  ValueError on a cell of another form."""
    col = np.asarray(col)
    if col.dtype.kind == "M":
        return col.astype("datetime64[ns]")
    uniq, inv = np.unique(col.astype(str), return_inverse=True)
    iso = []
    for s in uniq.tolist():
        if len(s) != 8 or not s.isdigit():
            raise ValueError(f"time data {s!r} doesn't match format "
                             f"'%Y%m%d' (column {name!r})")
        iso.append(f"{s[:4]}-{s[4:6]}-{s[6:]}")
    return np.array(iso, "datetime64[ns]")[inv.reshape(-1)]


def yyyymmdd_numbers(col) -> np.ndarray:
    """A date column as yyyymmdd numbers, as
    ``pd.to_numeric(dt.strftime("%Y%m%d"), errors="coerce")`` gives them:
    int64, or float64 with NaN where a date is missing."""
    d = np.asarray(col).astype("datetime64[D]")
    ok = ~np.isnat(d)
    y = d.astype("datetime64[Y]").astype(np.int64) + 1970
    m = d.astype("datetime64[M]").astype(np.int64) % 12 + 1
    day = (d - d.astype("datetime64[M]")).astype(np.int64) + 1
    num = y * 10000 + m * 100 + day
    if ok.all():
        return num
    return np.where(ok, num.astype(np.float64), np.nan)


def day_strings(col) -> np.ndarray:
    """A date column as ``YYYYMMDD`` strings."""
    d = np.asarray(col).astype("datetime64[D]")
    return np.char.replace(np.datetime_as_string(d, unit="D"), "-", "")
