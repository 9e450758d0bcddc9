"""External factor cross-validation (counterpart of
``mfm_tpu/utils/crosscheck.py``), numpy-first over ``data/columns.py``.

Aligns two long-format factor tables on (date, stock) and reports
per-factor agreement statistics over the full overlap, so a vendor table
(a jqdatasdk export, a Barra delivery, a previous run) can gate a
production run.  The reference's pandas calls keep their semantics:
``drop_duplicates`` keeps the first row of a (date, code) key, the merge is
outer with its rows in key order, ``to_numeric(errors="coerce")`` turns
string sentinels into NaN, and ``Series.rank()`` gives ties their average
rank.  The report is a :class:`FactorReport`, which prints in the shape of
the reference's ``DataFrame.to_json(orient="index")``.
"""

from __future__ import annotations

import json
import math

import numpy as np

from mfm_tpu_torch.data import columns as C

#: the report's columns, in the reference's order
REPORT_COLUMNS = ("n_overlap", "pearson", "rank_corr", "max_abs_diff",
                  "mean_abs_diff", "coverage_ours", "coverage_ext")

#: ``DataFrame.to_json``'s default ``double_precision``
JSON_DOUBLE_PRECISION = 10


def _json_float(v: float, precision: int = JSON_DOUBLE_PRECISION) -> str:
    """A float as ``DataFrame.to_json`` writes it: NaN and infinities as
    ``null``; magnitudes above 1e16 - 1 or below 1e-15 in ``%g`` form at
    ``precision`` digits; others fixed-point, rounded to ``precision``
    decimals (ties to odd, as its encoder rounds) with trailing zeros
    dropped."""
    if not math.isfinite(v):
        return "null"
    neg = v < 0
    value = -v if neg else v
    if value > 1e16 - 1 or (value != 0.0 and value < 1e-15):
        return f"%.{precision}g" % v
    pow10 = float(10 ** precision)
    whole = int(value)
    tmp = (value - whole) * pow10
    frac = int(tmp)
    diff = tmp - frac
    if diff > 0.5 or (diff == 0.5 and (frac == 0 or frac & 1)):
        frac += 1
    if frac >= pow10:
        frac, whole = 0, whole + 1
    if frac:
        count = precision
        while frac % 10 == 0:
            count -= 1
            frac //= 10
        text = f"{whole}.{str(frac).rjust(count, '0')}"
    else:
        text = f"{whole}.0"
    return ("-" if neg else "") + text


def _json_key(s: str) -> str:
    return json.dumps(str(s)).replace("/", "\\/")


class FactorReport:
    """Per-factor agreement rows: ``report[factor]`` is a dict over
    :data:`REPORT_COLUMNS`, factors in the order compared."""

    def __init__(self, rows: dict):
        self.rows = dict(rows)

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, factor: str) -> dict:
        return self.rows[factor]

    @property
    def index(self) -> list:
        return list(self.rows)

    def column(self, name: str) -> np.ndarray:
        dtype = np.int64 if name == "n_overlap" else np.float64
        return np.array([r[name] for r in self.rows.values()], dtype)

    def to_json(self) -> str:
        """The reference's ``to_json(orient="index")`` text."""
        def cell(v):
            return (str(int(v)) if isinstance(v, (int, np.integer))
                    else _json_float(float(v)))

        return "{" + ",".join(
            _json_key(f) + ":{" + ",".join(
                f"{_json_key(k)}:{cell(row[k])}" for k in REPORT_COLUMNS)
            + "}" for f, row in self.rows.items()) + "}"

    def to_csv(self, path: str) -> None:
        """The reference's ``to_csv``: the factor index, then the
        columns."""
        from mfm_tpu_torch.data.csvio import write_csv

        if not self.rows:
            with open(path, "w") as fh:
                fh.write("factor\n")
            return
        write_csv(path, {"factor": np.array(self.index),
                         **{k: self.column(k) for k in REPORT_COLUMNS}})


def _to_numeric(col: np.ndarray) -> np.ndarray:
    """``pd.to_numeric(col, errors="coerce").to_numpy(float)``."""
    from mfm_tpu_torch.data.csvio import NA_VALUES, _parse_float

    if col.dtype.kind in "biuf":
        return col.astype(np.float64)
    out = np.full(len(col), np.nan)
    for i, v in enumerate(col.tolist()):
        if isinstance(v, (bool, int, float, np.number)):
            out[i] = float(v)
        elif isinstance(v, str) and v not in NA_VALUES:
            try:
                out[i] = _parse_float(v)
            except ValueError:
                pass
    return out


def _rank_average(x: np.ndarray) -> np.ndarray:
    """``Series.rank()``: 1-based ranks, ties at their average rank."""
    n = len(x)
    order = np.argsort(x, kind="mergesort")
    xs = x[order]
    edges = np.nonzero(np.r_[True, xs[1:] != xs[:-1], True])[0]
    avg = (edges[:-1] + 1 + edges[1:]) / 2.0
    ranks = np.empty(n)
    ranks[order] = np.repeat(avg, np.diff(edges))
    return ranks


def _outer_rows(a: dict, b: dict, keys: list) -> tuple:
    """The outer merge of two tables with unique keys: for each row of the
    merge, in key order, its row in ``a`` and in ``b`` (-1 where absent)."""
    na = C.nrows(a)
    gid = C.group_ids(C.concat([C.select(a, keys), C.select(b, keys)]), keys)
    ids = np.unique(gid)   # group ids rank the key tuples lexicographically
    ra = np.full(len(ids), -1, np.int64)
    rb = np.full(len(ids), -1, np.int64)
    ra[np.searchsorted(ids, gid[:na])] = np.arange(na)
    rb[np.searchsorted(ids, gid[na:])] = np.arange(len(gid) - na)
    return ra, rb


def _side(col: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """``col`` at ``rows`` as numbers, NaN where the row is absent."""
    vals = _to_numeric(col)
    out = np.full(len(rows), np.nan)
    out[rows >= 0] = vals[rows[rows >= 0]]
    return out


def crosscheck_factors(ours, external, factors: list | None = None,
                       date_col: str = "trade_date",
                       code_col: str = "ts_code") -> FactorReport:
    """Per-factor agreement between two long (date, stock, factor...)
    tables (dicts of columns or DataFrames).

    Each row: ``n_overlap`` (rows where both sides have a finite value),
    ``pearson`` and ``rank_corr`` (Spearman) over the overlap,
    ``max_abs_diff`` / ``mean_abs_diff``, and ``coverage_ours`` /
    ``coverage_ext``, the share of the union each side covers.
    """
    ours, external = C.as_table(ours), C.as_table(external)
    if factors is None:
        skip = {date_col, code_col}
        factors = [c for c in ours if c not in skip and c in external
                   and ours[c].dtype.kind in "biufc"]
    else:
        missing = [f"{f} ({side})"
                   for side, t in (("ours", ours), ("external", external))
                   for f in factors if f not in t]
        if missing:
            raise ValueError(f"factor columns not found: {missing}")
    # raw vendor pulls often repeat (date, code) rows; a cartesian merge
    # would silently double-weight them, so keep the first occurrence
    keys = [date_col, code_col]
    a = C.drop_duplicates(C.select(ours, keys + factors), keys)
    b = C.drop_duplicates(C.select(external, keys + factors), keys)
    ra, rb = _outer_rows(a, b, keys)
    rows = {}
    for f in factors:
        x, y = _side(a[f], ra), _side(b[f], rb)
        both = np.isfinite(x) & np.isfinite(y)
        either = np.isfinite(x) | np.isfinite(y)
        n = int(both.sum())
        if n >= 2 and np.nanstd(x[both]) > 0 and np.nanstd(y[both]) > 0:
            pear = float(np.corrcoef(x[both], y[both])[0, 1])
            rank = float(np.corrcoef(_rank_average(x[both]),
                                     _rank_average(y[both]))[0, 1])
        else:
            pear = rank = np.nan
        diff = np.abs(x[both] - y[both])
        ne = int(either.sum())
        rows[f] = {
            "n_overlap": n,
            "pearson": pear,
            "rank_corr": rank,
            "max_abs_diff": float(np.max(diff)) if n else np.nan,
            "mean_abs_diff": float(np.mean(diff)) if n else np.nan,
            "coverage_ours": float(np.isfinite(x).sum() / ne) if ne else 0.0,
            "coverage_ext": float(np.isfinite(y).sum() / ne) if ne else 0.0,
        }
    return FactorReport(rows)
