"""Point-in-time alignment (counterpart of ``mfm_tpu/data/pit.py``), on
column tables: statement dedup, as-of joins, fill policy.

- :func:`dedup_statements` — two-pass dedup: keep the latest announcement
  per (stock, report period), then the latest report period per (stock,
  announcement).
- :func:`asof_join` — for each (stock, trade day), the row of the
  statement table with the newest announcement date <= trade day: a
  per-stock backward ``pd.merge_asof``, as one ``searchsorted`` over a
  (stock, time) key.
- :func:`fill_missing` — per-stock ffill then fill 0 (the reference's
  per-date median fill runs after ``fillna(0)`` and is dead code there;
  ``median_fill=True`` runs the evidently intended order, ffill -> daily
  median -> 0).

Sorting and dedup follow pandas: a stable sort over several keys with
missing values last (:func:`mfm_tpu_torch.data.columns.sort_order`), and
``drop_duplicates`` treating missing keys as equal.

One deliberate divergence: the reference's ``asof_join`` numbers its
stock groups in first-seen order over left then right, so a stock with
right-side rows but no left-side rows can break the monotone key its
``searchsorted`` needs, and rows of the NEXT stock then join nothing (or
the wrong statement).  Here the groups are numbered in sorted order, so
the key is monotone and every stock joins its own statements; where the
reference's key is monotone (every store its own tests build) the two
agree bit for bit.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from mfm_tpu_torch.data.columns import (
    _null_mask,
    drop_duplicates,
    duplicated,
    ffill,
    group_ids,
    nrows,
    sort_order,
    sort_values,
    take,
    unique,
)


def dedup_statements(df: dict, by: str = "ts_code",
                     ann_col: str = "f_ann_date",
                     end_col: str = "end_date") -> dict:
    """Two-pass statement dedup."""
    df = sort_values(df, [by, end_col, ann_col], [True, True, False])
    df = drop_duplicates(df, [by, end_col])
    df = sort_values(df, [by, ann_col, end_col], [True, True, False])
    return drop_duplicates(df, [by, ann_col])


def _missing_like(col: np.ndarray, ok: np.ndarray) -> np.ndarray:
    """``Series(col).where(ok, pd.NA)``: float cells NaN, dates NaT, an
    integer column as float, anything else None."""
    if ok.all():
        return col
    k = col.dtype.kind
    if k == "f":
        return np.where(ok, col, np.nan)
    if k == "M":
        return np.where(ok, col, np.datetime64("NaT"))
    if k in "iu":
        return np.where(ok, col.astype(np.float64), np.nan)
    out = col.astype(object)
    out[~ok] = None
    return out


def _times(col) -> np.ndarray:
    return np.asarray(col).astype("datetime64[ns]").astype(np.int64)


def asof_join(left: dict, right: dict, *, left_on: str, right_on: str,
              by: str = "ts_code", suffix: str = "_stmt") -> dict:
    """Backward as-of join of ``right`` onto ``left`` per ``by`` group.

    Each left row (sorted by ``by``, ``left_on``) gets the values of the
    last right row (sorted by ``by``, ``right_on``) of its group whose
    ``right_on`` is at or before its ``left_on``; missing where there is
    none.  Right columns other than ``by`` are appended, a clashing name
    taking ``suffix``.
    """
    left = sort_values(left, [by, left_on])
    right = sort_values(right, [by, right_on])

    # stock ids in SORTED order, so (stock, time) keys are monotone over
    # the sorted right table (see the module doc)
    lb, rb = np.asarray(left[by]), np.asarray(right[by])
    ids = group_ids({by: np.concatenate([lb.astype(object), rb.astype(object)])
                     if lb.dtype != rb.dtype else np.concatenate([lb, rb])},
                    [by])
    lg, rg = ids[:len(lb)], ids[len(lb):]
    lt, rt = _times(left[left_on]), _times(right[right_on])

    # rank-compress times so (group, time) packs into one int64 key
    uniq = np.unique(np.concatenate([lt, rt]))
    stride = np.int64(len(uniq) + 1)
    lkey = lg * stride + np.searchsorted(uniq, lt)
    rkey = rg * stride + np.searchsorted(uniq, rt)
    order = np.argsort(rkey, kind="stable")
    pos = np.searchsorted(rkey[order], lkey, side="right") - 1
    ok = pos >= 0
    src = order[np.maximum(pos, 0)] if len(order) else np.zeros_like(pos)
    ok &= np.where(ok, rg[src] == lg, False) if len(order) else False

    out = dict(left)
    for c in right:
        if c == by:
            continue
        col = np.asarray(right[c])
        vals = col[src] if len(col) else np.empty(len(lg), col.dtype)
        name = c if c not in out else c + suffix
        out[name] = _missing_like(vals, ok)
    return out


def _coerce_dates(col) -> np.ndarray:
    """``pd.to_datetime(col, errors="coerce")`` for the forms a statement
    table holds: dates, tushare's ``YYYYMMDD`` and ISO strings; numbers
    count nanoseconds since 1970 as pandas counts them; anything else
    NaT."""
    col = np.asarray(col)
    if col.dtype.kind == "M":
        return col.astype("datetime64[ns]")
    if col.dtype.kind in "iuf":
        out = np.full(len(col), np.datetime64("NaT"), "datetime64[ns]")
        ok = np.isfinite(col.astype(np.float64))
        out[ok] = col[ok].astype(np.int64).astype("datetime64[ns]")
        return out
    null = _null_mask(col)
    out = np.full(len(col), np.datetime64("NaT"), "datetime64[ns]")
    cache: dict = {}
    for i in np.nonzero(~null)[0]:
        s = str(col[i]).strip()
        if s not in cache:
            iso = f"{s[:4]}-{s[4:6]}-{s[6:]}" if len(s) == 8 and s.isdigit() \
                else s
            try:
                cache[s] = np.datetime64(iso, "ns")
            except ValueError:
                cache[s] = np.datetime64("NaT")
        out[i] = cache[s]
    return out


def diagnose_statements(df: dict, by: str = "ts_code",
                        ann_col: str = "f_ann_date",
                        end_col: str = "end_date") -> dict:
    """Per-stock statement-table QC in one vectorized pass, naming the
    offenders.  Issues per stock:

    - ``missing_ann`` / ``missing_end`` — NaT/NaN key dates (these rows
      silently vanish from a PIT join's keying);
    - ``dup_ann`` / ``dup_end`` — duplicate (stock, announcement) or
      (stock, period-end) keys surviving in the input, counting EVERY row
      in a duplicate group;
    - ``ann_before_end`` — announcement dated before its own period end.

    Returns ``{"n_rows", "n_stocks", "issue_counts": {issue: row count},
    "stocks": {ts_code: [issues]}}`` — clean input gives empty dicts.
    """
    missing_cols = [c for c in (by, ann_col, end_col) if c not in df]
    if missing_cols:
        raise ValueError(
            f"not a statement table: missing column(s) {missing_cols} "
            f"(have: {sorted(df)})")
    ann = _coerce_dates(df[ann_col])
    end = _coerce_dates(df[end_col])
    ann_ok, end_ok = ~np.isnat(ann), ~np.isnat(end)
    flags = {
        "missing_ann": ~ann_ok,
        "missing_end": ~end_ok,
        "dup_ann": duplicated(df, [by, ann_col], keep=False) & ann_ok,
        "dup_end": duplicated(df, [by, end_col], keep=False) & end_ok,
        "ann_before_end": ann_ok & end_ok & (ann < end),
    }
    stocks: dict[str, list[str]] = {}
    counts: dict[str, int] = {}
    codes = np.asarray(df[by])
    for issue, mask in flags.items():
        n = int(mask.sum())
        if not n:
            continue
        counts[issue] = n
        for code in unique(codes[mask]):
            stocks.setdefault(code, []).append(issue)
    return {"n_rows": int(nrows(df)),
            "n_stocks": int(len(unique(codes))),
            "issue_counts": counts,
            "stocks": {k: stocks[k] for k in sorted(stocks)}}


def _median_by(values: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """``groupby(keys)[values].transform("median")`` (NaN skipped)."""
    gid = group_ids({"k": keys}, ["k"])
    out = np.full(len(values), np.nan)
    for g in np.unique(gid):
        rows = gid == g
        v = values[rows]
        v = v[~np.isnan(v)]
        if len(v):
            out[rows] = np.median(v)
    return out


def fill_missing(df: dict, cols: Sequence[str], by: str = "ts_code",
                 date_col: str = "trade_date",
                 median_fill: bool = False) -> dict:
    """Missing-value policy over the merged master table: sort by (stock,
    date), ffill per stock, optionally the per-date median, then 0."""
    df = take(df, sort_order(df, [by, date_col]))
    gid = group_ids(df, [by])
    for c in cols:
        df[c] = ffill(df[c], gid)
    if median_fill:
        for c in cols:
            col = np.asarray(df[c], np.float64)
            med = _median_by(col, np.asarray(df[date_col]))
            df[c] = np.where(np.isnan(col), med, col)
    for c in cols:
        col = df[c]
        if col.dtype.kind == "f":
            df[c] = np.where(np.isnan(col), 0.0, col)
    return df
