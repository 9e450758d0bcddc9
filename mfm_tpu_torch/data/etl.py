"""Incremental ETL (counterpart of ``mfm_tpu/data/etl.py``), without pandas:
the collection store, the rate limiter, the retry loop, the watermark-driven
updaters and the verification tools.

Reference mechanisms kept:

- last-date **watermark** resume per collection;
- trade-calendar-driven per-day incremental fetch;
- **rate limiting** to N calls/min and **retry** with backoff;
- duplicate-tolerant idempotent inserts (a unique key; rows whose key is
  already stored are dropped);
- delete-then-insert refresh for index components;
- verification: universe counts and missing-stock repair.

A table is a dict of numpy columns (:mod:`mfm_tpu_torch.data.columns`);
a pandas DataFrame is accepted wherever a table is, and read without
importing pandas.  :class:`PanelStore` keeps each collection as a
directory of append-only part files written with ``np.savez`` (see
:func:`write_table`); parts a parquet store wrote (``part-*.parquet``, or
a legacy ``<name>.parquet``) are read through pandas where it imports.
The vendor client, the clock and the sleeper are injectable, so the logic
is testable hermetically.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import time
from typing import Callable, Iterable, Sequence

import numpy as np

from mfm_tpu_torch.data.columns import (
    _null_mask,
    as_column,
    as_table,
    col_max,
    col_min,
    concat,
    nrows,
    nunique,
    take,
    unique,
)

#: the part file suffixes a store reads; new parts are ``.npz``
PART_SUFFIXES = (".npz", ".parquet")


class RateLimiter:
    """Sliding-window limiter: at most ``calls_per_min`` calls in 60s."""

    def __init__(self, calls_per_min: int, clock=time.monotonic, sleep=time.sleep):
        self.calls_per_min = calls_per_min
        self._clock = clock
        self._sleep = sleep
        self._stamps: list[float] = []

    def wait(self):
        now = self._clock()
        self._stamps = [t for t in self._stamps if now - t < 60.0]
        if len(self._stamps) >= self.calls_per_min:
            delay = 60.0 - (now - self._stamps[0])
            if delay > 0:
                self._sleep(delay)
        self._stamps.append(self._clock())


def with_retry(fn: Callable, attempts: int = 3, backoff_s: float = 5.0,
               sleep=time.sleep, *, exponential: bool = False,
               max_backoff_s: float = 60.0, jitter: float = 0.0,
               seed: int = 0, retryable: tuple = (Exception,),
               phase: str | None = None):
    """Call ``fn``; on a retryable exception retry up to ``attempts`` times.

    Defaults are a fixed 5 s backoff and a broad catch.  Production knobs:

    - ``exponential``: back off ``backoff_s * 2**i`` capped at
      ``max_backoff_s`` — repeated transient failures stop hammering a
      recovering upstream.
    - ``jitter``: multiply each delay by a seeded uniform draw from
      ``[1 - jitter, 1 + jitter]`` (decorrelates a fleet of daily jobs all
      retrying the same outage on the same schedule).  Seeded so a replay
      sleeps the same schedule.
    - ``retryable``: exception classes worth retrying; anything else
      (a programming error, an auth failure) re-raises IMMEDIATELY — two
      more identical attempts cannot fix a TypeError.

    On exhaustion the raised exception carries its retry history:
    ``e.attempts`` (calls made) and ``e.total_backoff_s`` (seconds slept
    between them) — the serve CLI's startup dead letter and reload failure
    log stamp these so an operator can tell "failed instantly"
    from "fought the outage for a minute".  ``phase`` additionally
    stamps ``e.phase`` so a caller several frames up can tell WHICH
    retried operation died — the fleet transport uses it to separate
    "never connected" (``phase="connect"``) from "connection lost
    mid-batch" (``phase="batch"``) in its manifest counters.
    """
    import random

    from mfm_tpu_torch.obs import instrument as _telemetry

    rng = random.Random(seed)
    last = None
    total_backoff = 0.0
    for i in range(attempts):
        try:
            result = fn()
            _telemetry.RETRY_ATTEMPTS_TOTAL.inc(
                outcome="ok" if i == 0 else "retried")
            return result
        except retryable as e:
            last = e
            if i < attempts - 1:
                delay = (min(backoff_s * (2.0 ** i), max_backoff_s)
                         if exponential else backoff_s)
                if jitter:
                    delay *= 1.0 + jitter * (2.0 * rng.random() - 1.0)
                _telemetry.RETRY_BACKOFF_SECONDS.observe(delay)
                total_backoff += delay
                sleep(delay)
    _telemetry.RETRY_ATTEMPTS_TOTAL.inc(outcome="exhausted")
    last.attempts = attempts
    last.total_backoff_s = total_backoff
    if phase is not None:
        last.phase = phase
    raise last


# -- the part format ------------------------------------------------------------

#: null kinds of a text column's mask: the cell was None, or NaN
_NONE, _NAN = 1, 2


def _encode(name: str, col) -> tuple:
    """A column as (data, null mask or None) for ``np.savez``: a text
    column with missing cells becomes fixed-width unicode plus an int8
    mask saying which cells were None and which NaN."""
    col = as_column(col, name)
    if col.dtype.kind != "O":
        return col, None
    vals = col.tolist()
    mask = np.array([_NONE if v is None else _NAN if not isinstance(v, str)
                     else 0 for v in vals], np.int8)
    data = np.array(["" if m else v for v, m in zip(vals, mask.tolist())],
                    dtype=str)
    return data, mask


def _decode(data: np.ndarray, mask: np.ndarray) -> np.ndarray:
    out = data.astype(object)
    out[mask == _NONE] = None
    out[mask == _NAN] = np.nan
    return out


def write_table(path_or_file, table) -> None:
    """One table as an ``.npz`` (``np.savez``, no pickle): ``__columns__``
    holds the names in order, ``c<j>`` the j-th column (float64, int64,
    bool, unicode or datetime64[ns]) and ``m<j>`` a text column's null
    mask, so None, NaN and NaT read back as they were written."""
    table = as_table(table)
    arrays = {"__columns__": np.array(list(table), dtype=str)}
    for j, (name, col) in enumerate(table.items()):
        data, mask = _encode(name, col)
        arrays[f"c{j}"] = data
        if mask is not None:
            arrays[f"m{j}"] = mask
    if isinstance(path_or_file, (str, os.PathLike)):
        with open(path_or_file, "wb") as fh:
            np.savez(fh, **arrays)
    else:
        np.savez(path_or_file, **arrays)


def read_table(path: str, columns: Sequence[str] | None = None) -> dict:
    """A table :func:`write_table` wrote (or, through pandas, a parquet
    file), optionally only ``columns``, in that order."""
    if path.endswith(".parquet"):
        return _read_parquet(path, columns)
    with np.load(path, allow_pickle=False) as z:
        names = z["__columns__"].tolist()
        want = names if columns is None else list(columns)
        out = {}
        for c in want:
            if c not in names:
                raise KeyError(f"{path}: no column {c!r} (have {names})")
            j = names.index(c)
            data = z[f"c{j}"]
            out[c] = _decode(data, z[f"m{j}"]) if f"m{j}" in z.files \
                else data
    return out


def _read_parquet(path: str, columns=None) -> dict:
    try:
        import pandas as pd
    except ImportError as err:
        raise ImportError(f"{path}: a parquet part is read through pandas, "
                          "which does not import here") from err
    df = pd.read_parquet(path, columns=None if columns is None
                         else list(columns))
    return {str(c): as_column(df[c].to_numpy(), str(c)) for c in df.columns}


def _table_columns(path: str) -> list:
    """Column names of one part (its data is not read)."""
    if path.endswith(".parquet"):
        try:
            import pyarrow.parquet as pq
        except ImportError as err:
            raise ImportError(f"{path}: a parquet part is read through "
                              "pyarrow, which does not import here") from err
        return list(pq.read_schema(path).names)
    with np.load(path, allow_pickle=False) as z:
        return z["__columns__"].tolist()


#: the one value every missing key cell normalizes to
_NULL = ("<null>",)


def _key_tuples(table: dict, cols: tuple) -> list:
    """Exact key tuples of every row; None, NaN and NaT normalize to one
    sentinel, so null-keyed rows dedup as ``drop_duplicates`` treats
    them."""
    lists = []
    for c in cols:
        col = table[c]
        null = _null_mask(col)
        vals = (col.view(np.int64) if col.dtype.kind == "M" else col).tolist()
        if null.any():
            vals = [_NULL if z else v for v, z in zip(vals, null.tolist())]
        lists.append(vals)
    return list(zip(*lists))


def _str_value(v):
    """``str`` of a column's min/max as pandas prints it."""
    if isinstance(v, np.datetime64):
        return np.datetime_as_string(v, unit="s").replace("T", " ")
    return str(v)


class PanelStore:
    """Collection store with unique-key dedup and watermarks: one directory
    of append-only part files per collection.

    An insert writes ONE new part instead of rewriting the collection.
    Unique-key admission keeps a per-process key-set cache per collection,
    loaded once with a key-columns-only scan and then extended part by
    part, so N inserts cost O(rows inserted).  Keys are compared exactly.
    New parts are ``.npz`` (:func:`write_table`); parquet parts and a
    legacy single-file ``<name>.parquet`` are read too (through pandas),
    so a store the reference wrote opens here.
    """

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._keys: dict = {}   # (name, unique cols) -> (keys, seen parts)

    def _legacy_path(self, name: str) -> str:
        return os.path.join(self.root, f"{name}.parquet")

    def _dir(self, name: str) -> str:
        return os.path.join(self.root, name)

    def _marker_path(self, name: str) -> str:
        return os.path.join(self._dir(name), "_compact.json")

    def _heal(self, name: str) -> None:
        """Roll an interrupted _rewrite forward (idempotent).

        The marker is written *after* the merged part and *before* any
        deletion, so its presence means the merged data is complete: finish
        the rename, drop the obsolete parts, drop the marker.  A ``.pending``
        file with no marker is an aborted write — discard it."""
        d = self._dir(name)
        if not os.path.isdir(d):
            return
        marker = self._marker_path(name)
        if os.path.exists(marker):
            with open(marker) as f:
                m = json.load(f)
            pending = os.path.join(d, m["pending"])
            final = os.path.join(d, m["final"])
            if os.path.exists(pending) and not os.path.exists(final):
                os.replace(pending, final)
            for rel in m["obsolete"]:
                p = os.path.join(self.root, rel)
                if os.path.exists(p):
                    os.remove(p)
            os.remove(marker)
            self._keys = {k: v for k, v in self._keys.items() if k[0] != name}
        for f in os.listdir(d):
            if f.endswith(".pending"):
                os.remove(os.path.join(d, f))

    def _parts(self, name: str) -> list:
        self._heal(name)
        parts = []
        if os.path.exists(self._legacy_path(name)):
            parts.append(self._legacy_path(name))
        d = self._dir(name)
        if os.path.isdir(d):
            parts += sorted(
                os.path.join(d, f) for f in os.listdir(d)
                if f.endswith(PART_SUFFIXES)
            )
        return parts

    def read(self, name: str, columns: Sequence[str] | None = None) -> dict:
        parts = self._parts(name)
        if not parts:
            return {}
        return concat([read_table(p, columns) for p in parts])

    def _key_set(self, name: str, cols: tuple) -> set:
        """Unique-key cache for one collection, kept in sync with the part
        files on disk: parts written by OTHER store instances since the last
        look are key-scanned incrementally, and any *deletion* of a seen part
        (another instance's replace_where/compact) invalidates the cache
        entirely.  Concurrent writers racing on the same collection still
        need external locking."""
        cache_key = (name, cols)
        keys, seen_parts = self._keys.get(cache_key, (set(), set()))
        current = set(self._parts(name))
        if seen_parts - current:  # a seen part vanished: cache is stale
            keys, seen_parts = set(), set()
        for p in sorted(current - seen_parts):
            keys.update(_key_tuples(read_table(p, list(cols)), cols))
            seen_parts.add(p)
        self._keys[cache_key] = (keys, seen_parts)
        return keys

    def _next_part_index(self, d: str) -> int:
        idx = -1
        for f in os.listdir(d):
            if f.startswith("part-") and (f.endswith(PART_SUFFIXES) or any(
                    f.endswith(s + ".pending") for s in PART_SUFFIXES)):
                try:
                    idx = max(idx, int(f.split("-")[1]))
                except ValueError:
                    continue
        return idx + 1

    def _write_part(self, name: str, table: dict) -> str:
        d = self._dir(name)
        os.makedirs(d, exist_ok=True)
        # max-existing-index + 1 over both part formats, NOT the file count:
        # after a rewrite removes parts, a count-based name would collide
        # with (and os.replace would clobber) a live part
        n = self._next_part_index(d)
        path = os.path.join(d, f"part-{n:06d}-{os.getpid()}.npz")
        tmp = path + ".tmp"
        write_table(tmp, table)
        os.replace(tmp, path)
        return path

    def insert(self, name: str, df, unique: Sequence[str] | None = None):
        """Append rows as one new part; rows whose ``unique`` key already
        exists (or repeats within ``df``) are dropped.  Returns the number
        of rows written."""
        df = as_table(df)
        if nrows(df) == 0:
            return 0
        if unique:
            cols = tuple(unique)
            have = self._key_set(name, cols)
            seen: set = set()
            keep = np.empty(nrows(df), bool)
            for i, k in enumerate(_key_tuples(df, cols)):
                fresh = k not in have and k not in seen
                keep[i] = fresh
                if fresh:
                    seen.add(k)
            if not keep.all():
                df = take(df, keep)
            if not nrows(df):
                return 0
            have.update(seen)
        else:
            # un-keyed insert: existing key caches for this collection are
            # no longer complete
            self._keys = {k: v for k, v in self._keys.items() if k[0] != name}
        path = self._write_part(name, df)
        if unique:
            # our own part is already reflected in the key set
            self._keys[(name, tuple(unique))][1].add(path)
        return nrows(df)

    def replace_where(self, name: str, mask_fn, df):
        """Delete rows matching ``mask_fn`` (a predicate over the stored
        table) then insert ``df`` (the index-components refresh pattern) —
        compacts the collection."""
        cur = self.read(name)
        if nrows(cur):
            cur = take(cur, ~np.asarray(mask_fn(cur), bool))
        df = as_table(df)
        self._rewrite(name, concat([cur, df]) if nrows(cur) else df)

    def replace(self, name: str, df):
        """Full refresh: the collection's contents become exactly ``df``
        (drop + ``insert_many``) — unlike an all-True ``replace_where``
        this never reads the rows being discarded.  ``None`` wipes the
        collection (the Mongo adapter's behavior — shared contract)."""
        self._rewrite(name, as_table(df))

    def compact(self, name: str):
        """Merge all parts into one (maintenance; reads stay correct
        either way)."""
        cur = self.read(name)
        if nrows(cur):
            self._rewrite(name, cur)

    def _rewrite(self, name: str, table: dict) -> None:
        """Replace the collection's contents atomically w.r.t. crashes:
        merged part first, then a marker, then deletions (see _heal)."""
        old = self._parts(name)
        d = self._dir(name)
        os.makedirs(d, exist_ok=True)
        final = f"part-{self._next_part_index(d):06d}-{os.getpid()}.npz"
        pending = final + ".pending"
        write_table(os.path.join(d, pending), table)
        marker = {
            "pending": pending, "final": final,
            "obsolete": [os.path.relpath(p, self.root) for p in old],
        }
        tmp = self._marker_path(name) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(marker, f)
        os.replace(tmp, self._marker_path(name))
        os.replace(os.path.join(d, pending), os.path.join(d, final))
        for p in old:
            os.remove(p)
        os.remove(self._marker_path(name))
        self._keys = {k: v for k, v in self._keys.items() if k[0] != name}

    def last_date(self, name: str, date_col: str = "trade_date"):
        """Watermark: newest date present."""
        parts = self._parts(name)
        if not parts:
            return None
        # a missing date column is a clean None; IO/corruption errors from
        # the column-list read or the data read propagate — they must not
        # silently reset the watermark and trigger a full refetch
        if date_col not in _table_columns(parts[0]):
            return None
        cur = self.read(name, columns=[date_col])
        return col_max(cur[date_col]) if nrows(cur) else None

    def distinct_count(self, name: str, col: str) -> int:
        parts = self._parts(name)
        if not parts:
            return 0
        cur = self.read(name, columns=[col])
        return 0 if not nrows(cur) else nunique(cur[col])


def _group_max(table: dict, key: str, col: str) -> dict:
    """``table.groupby(key)[col].max().to_dict()``."""
    keys = table[key]
    return {k: col_max(table[col][keys == k]) for k in unique(keys)}


@dataclasses.dataclass
class IncrementalUpdater:
    """Watermark-driven incremental collection updates.

    ``source`` is any object with fetch methods returning tables (the
    tushare adapter in production, a fake in tests).
    """

    store: PanelStore
    source: object
    limiter: RateLimiter | None = None
    attempts: int = 3
    backoff_s: float = 5.0
    sleep: Callable = time.sleep

    def _call(self, fn, *a, **k):
        if self.limiter is not None:
            self.limiter.wait()
        return with_retry(lambda: fn(*a, **k), self.attempts, self.backoff_s,
                          sleep=self.sleep)

    def update_daily_prices(self, trade_calendar: Iterable, name="daily_prices"):
        """Per-trade-day fetch of everything after the watermark."""
        wm = self.store.last_date(name)
        n = 0
        for day in trade_calendar:
            if wm is not None and day <= wm:
                continue
            df = self._call(self.source.fetch_daily_prices, trade_date=day)
            n += self.store.insert(name, df, unique=("ts_code", "trade_date"))
        return n

    def update_statements(self, ts_codes: Sequence[str], kind: str,
                          start_date=None, end_date=None):
        """Per-stock statement fetch (balancesheet/cashflow/income/
        fina_indicator), the reference's hours-long hot loop."""
        fetch = getattr(self.source, f"fetch_{kind}_by_stock")
        unique_key = ("ts_code", "end_date",
                      "ann_date" if kind == "financial_indicators" else "f_ann_date")
        n = 0
        for code in ts_codes:
            df = self._call(fetch, ts_code=code, start_date=start_date,
                            end_date=end_date)
            n += self.store.insert(kind, df, unique=unique_key)
        return n

    def update_index_components(self, index_codes: Sequence[str], trade_date,
                                name="index_components"):
        """Delete-then-insert per (index, date)."""
        for idx in index_codes:
            df = self._call(self.source.fetch_index_components,
                            index_code=idx, trade_date=trade_date)
            self.store.replace_where(
                name,
                lambda c, idx=idx: (np.asarray(c["index_code"]) == idx)
                & (np.asarray(c["trade_date"]) == trade_date),
                df,
            )

    def update_stock_info(self, name="stock_info") -> list:
        """Full refresh of the live A-share list; every run replaces the old
        collection and returns the ts_code universe the statement updaters
        iterate (drop + insert_many)."""
        df = as_table(self._call(self.source.fetch_stock_info))
        if not nrows(df):
            return []
        self.store.replace(name, df)
        return list(df["ts_code"].tolist())

    @staticmethod
    def _next_day(date_str) -> str:
        d = datetime.datetime.strptime(str(date_str), "%Y%m%d")
        return (d + datetime.timedelta(days=1)).strftime("%Y%m%d")

    def update_daily_index_prices(self, index_codes: Sequence[str],
                                  end_date=None,
                                  name="index_daily_prices") -> int:
        """Watermarked ranged fetch per index (start = watermark + 1 day,
        rate limited, retried, duplicate-tolerant insert).  The watermark
        is per index, so a first-seen code is fetched in full."""
        have = self.store.read(name, columns=["ts_code", "trade_date"])
        # one pass for all per-index maxima
        wms = _group_max(have, "ts_code", "trade_date") if nrows(have) else {}
        n = 0
        for code in index_codes:
            wm = wms.get(code)
            start = self._next_day(wm) if wm is not None else None
            if start is not None and end_date is not None \
                    and str(start) > str(end_date):
                continue  # this index is up to date
            df = self._call(self.source.fetch_daily_index_prices,
                            ts_code=code, start_date=start, end_date=end_date)
            n += self.store.insert(name, df, unique=("ts_code", "trade_date"))
        return n

    def update_sw_industries(self, ts_codes: Sequence[str] | None = None,
                             csv_path: str | None = None,
                             name="sw_industries") -> int:
        """Full refresh of the SW industry classification, from a csv
        (``csv_path``) or per stock through the source's
        ``fetch_sw_industries``."""
        if csv_path is not None:
            from mfm_tpu_torch.data.csvio import read_csv

            df = read_csv(csv_path)
        elif ts_codes is not None:
            frames = [as_table(self._call(self.source.fetch_sw_industries,
                                          ts_code=c)) for c in ts_codes]
            df = concat([f for f in frames if nrows(f)])
        else:
            raise ValueError("pass ts_codes or csv_path")
        if not nrows(df):
            return 0
        self.store.replace(name, df)
        return nrows(df)

    def repair_missing_stocks(self, start_date, end_date,
                              universe_name="stock_info") -> dict:
        """Detect AND refetch stocks present in the universe but absent from
        ``daily_prices`` (set difference, then a per-stock ranged
        ``daily_basic`` fetch, duplicate-tolerant insert).  Detection over
        other collections stays with :func:`find_missing_stocks`."""
        missing = find_missing_stocks(self.store, universe_name=universe_name,
                                      data_name="daily_prices",
                                      code_col="ts_code")
        n = 0
        for code in missing:
            df = self._call(self.source.fetch_daily_prices_by_stock,
                            ts_code=code, start_date=start_date,
                            end_date=end_date)
            n += self.store.insert("daily_prices", df,
                                   unique=("ts_code", "trade_date"))
        return {"missing": missing, "rows_inserted": n}

    def run_all(self, start_date, end_date,
                index_codes: Sequence[str] = ("000300.SH", "000016.SH",
                                              "000903.SH"),
                statements: Sequence[str] = ("balancesheet", "cashflow",
                                             "income", "financial_indicators"),
                components_date=None, sw: bool = True,
                sw_csv: str | None = None) -> dict:
        """Calendar-driven refresh of every collection, in the reference's
        order: stock_info -> daily_prices over the trade calendar ->
        statements per stock -> index daily prices -> index components ->
        SW industries, each step individually disableable."""
        codes = self.update_stock_info()
        cal = self._call(self.source.fetch_trade_calendar,
                         start_date=start_date, end_date=end_date)
        summary = {
            "stock_info": len(codes),
            "daily_prices": self.update_daily_prices(cal),
            "statements": {
                k: self.update_statements(codes, k, start_date, end_date)
                for k in statements
            },
            "index_daily_prices": self.update_daily_index_prices(
                index_codes, end_date=end_date),
        }
        if components_date is not None:
            self.update_index_components(index_codes, components_date)
            summary["index_components_date"] = str(components_date)
        if sw:
            summary["sw_industries"] = self.update_sw_industries(
                ts_codes=codes, csv_path=sw_csv)
        return summary


def plan_update(store: PanelStore, start_date, end_date,
                index_codes: Sequence[str] = ("000300.SH", "000016.SH",
                                              "000903.SH"),
                statements: Sequence[str] = ("balancesheet", "cashflow",
                                             "income",
                                             "financial_indicators"),
                components_date=None, sw: bool = True) -> dict:
    """Dry-run of :meth:`IncrementalUpdater.run_all`: what each step WOULD
    fetch, derived from the store's watermarks alone — zero API calls.

    Mirrors ``run_all``'s own step toggles (``components_date``/``sw``) so
    the plan previews exactly the command it is a dry run of.  Returns, per
    collection: the current watermark (or row count for full-refresh
    collections), the planned fetch range, and whether it is already up to
    date.
    """
    _next = IncrementalUpdater._next_day
    start_s, end_s = str(start_date), str(end_date)

    wm = store.last_date("daily_prices")
    # run_all only walks the [start, end] trade calendar, so an old
    # watermark never implies a pre-start backfill: clamp to start
    daily_start = max(_next(wm), start_s) if wm is not None else start_s
    n_codes = store.distinct_count("stock_info", "ts_code")
    plan: dict = {
        "range": [start_s, end_s],
        "stock_info": {"rows": int(n_codes), "action": "full refresh"},
        "daily_prices": {
            "watermark": None if wm is None else str(wm),
            "fetch_from": daily_start,
            "up_to_date": daily_start > end_s,
        },
    }
    plan["statements"] = {
        k: {
            # run_all refreshes stock_info FIRST, so an empty store means
            # the universe (and the real call count) is unknown here, not 0
            "per_stock_calls": int(n_codes) if n_codes else None,
            **({} if n_codes else
               {"note": "universe unknown until stock_info refreshes"}),
            "range": [start_s, end_s],
        }
        for k in statements
    }
    have = store.read("index_daily_prices", columns=["ts_code", "trade_date"])
    wms = _group_max(have, "ts_code", "trade_date") if nrows(have) else {}
    idx = {}
    for code in index_codes:
        w = wms.get(code)
        frm = _next(w) if w is not None else None
        idx[code] = {"watermark": None if w is None else str(w),
                     "fetch_from": frm,
                     "up_to_date": frm is not None and str(frm) > end_s}
    plan["index_daily_prices"] = idx
    if components_date is not None:
        plan["index_components"] = {
            "date": str(components_date), "indexes": list(index_codes),
            "action": "delete-then-insert refresh"}
    if sw:
        plan["sw_industries"] = {
            "rows": int(store.distinct_count("sw_industries", "ts_code")),
            "action": "full refresh"}
    return plan


def find_missing_stocks(store: PanelStore, universe_name="stock_info",
                        data_name="daily_prices", code_col="ts_code"):
    """Set-difference repair detection: the universe's codes with no row
    in ``data_name``, sorted."""
    uni = store.read(universe_name)
    dat = store.read(data_name)
    have = set(unique(dat[code_col])) if nrows(dat) else set()
    want = set(unique(uni[code_col])) if nrows(uni) else set()
    return sorted(want - have)


def verify_store(store: PanelStore, name="daily_prices", code_col="ts_code",
                 date_col="trade_date"):
    """Sanity counters: rows, distinct stocks, first and last date."""
    df = store.read(name)
    n = nrows(df)
    return {
        "rows": int(n),
        "stocks": 0 if not n else int(nunique(df[code_col])),
        "first_date": None if not n else _str_value(col_min(df[date_col])),
        "last_date": None if not n else _str_value(col_max(df[date_col])),
    }
