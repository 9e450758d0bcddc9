"""MongoDB adapter for the :class:`mfm_tpu_torch.data.etl.PanelStore`
interface (counterpart of ``mfm_tpu/data/mongo_store.py``), on column
tables.

The reference's storage layer is MongoDB (one collection per dataset,
unique indexes + ``insert_many(ordered=False)`` for duplicate-tolerant
idempotent loads).  This adapter offers the parquet-free store's methods
— ``insert`` / ``read`` / ``replace_where`` / ``replace`` / ``last_date``
/ ``distinct_count`` — so :class:`~mfm_tpu_torch.data.etl.
IncrementalUpdater`, :func:`~mfm_tpu_torch.data.prepare.
prepare_factor_inputs` and the CLI run unchanged against either.  Tables
become records (Python values; a date a ``datetime``) on the way in and
column tables on the way out.

The ``pymongo`` import is guarded; the class raises a clear error when
constructed without it.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from mfm_tpu_torch.data.columns import as_column, as_table, nrows

try:  # pragma: no cover - exercised only where pymongo exists
    import pymongo
    from pymongo.errors import BulkWriteError
except Exception:  # pragma: no cover
    pymongo = None
    BulkWriteError = None


def _transient_mongo_errors() -> tuple:
    """The pymongo exception classes that mean "try again later", resolved
    lazily so a stand-in module that defines only the errors the adapter's
    logic needs works too.  The builtin connection/timeout errors ride
    along — client libraries and injected transports surface raw socket
    failures as those.
    """
    names = ("AutoReconnect", "NetworkTimeout", "ConnectionFailure",
             "ServerSelectionTimeoutError", "ExecutionTimeout",
             "WTimeoutError")
    errs = tuple(
        t for n in names
        if isinstance(t := getattr(pymongo.errors, n, None), type)
    )
    return errs + (ConnectionError, TimeoutError)


def _values(col: np.ndarray) -> list:
    """One column as the Python values a record holds (a date as a
    ``datetime``, NaT as None)."""
    if col.dtype.kind == "M":
        return col.astype("datetime64[us]").tolist()
    return col.tolist()


class MongoPanelStore:
    """PanelStore-compatible wrapper over a ``pymongo.database.Database``.

    Unique-key enforcement is Mongo's own unique index (exact,
    server-side), with ``insert_many(ordered=False)`` continuing past
    duplicate-key errors.
    """

    def __init__(self, database):
        if pymongo is None:  # pragma: no cover
            raise ImportError("pymongo is required for MongoPanelStore")
        self.db = database
        self._indexed: set = set()  # (name, unique cols) already ensured

    # -- helpers -----------------------------------------------------------
    @staticmethod
    def _records(table: dict) -> list:
        names = list(table)
        cols = [_values(np.asarray(table[c])) for c in names]
        return [dict(zip(names, row)) for row in zip(*cols)]

    @staticmethod
    def _table(rows: list, columns=None) -> dict:
        """Records as a column table: the keys in first-seen order (NaN
        where a record lacks one), ``_id`` dropped."""
        names = list(dict.fromkeys(k for r in rows for k in r))
        names = [k for k in names if k != "_id"]
        if columns is not None:
            if not rows:
                return {c: np.array([], object) for c in columns}
            names = list(columns)
        return {k: as_column([r.get(k, np.nan) for r in rows], k)
                for k in names}

    # -- PanelStore interface ---------------------------------------------
    def insert(self, name: str, df, unique: Sequence[str] | None = None) -> int:
        """Append rows; rows whose ``unique`` key already exists are dropped
        (unique index + ``ordered=False``)."""
        df = as_table(df)
        if nrows(df) == 0:
            return 0
        coll = self.db[name]
        if unique:
            key = (name, tuple(unique))
            if key not in self._indexed:
                # once per (collection, key) per store instance — the ETL
                # statement loop calls insert thousands of times per run_all
                # and must not pay a createIndexes round-trip each time
                coll.create_index([(c, 1) for c in unique], unique=True)
                self._indexed.add(key)
        # ordered=False also for un-keyed inserts: if the collection carries
        # a unique index from an earlier keyed insert, duplicates are
        # skipped (count returned) instead of raising mid-batch — the one
        # divergence from the file store, which has no index to enforce
        try:
            res = coll.insert_many(self._records(df), ordered=False)
            return len(res.inserted_ids)
        except BulkWriteError as e:
            # only duplicate keys (11000) are tolerable; anything else
            # (oversized doc, validation, shard key) must surface — the
            # caller would otherwise advance its watermark past a silent gap
            errs = e.details.get("writeErrors", [])
            if any(we.get("code") != 11000 for we in errs):
                raise
            return e.details.get("nInserted", 0)

    def read(self, name: str, columns: Sequence[str] | None = None) -> dict:
        proj = {"_id": 0}
        if columns is not None:
            proj.update({c: 1 for c in columns})
        return self._table(list(self.db[name].find({}, proj)), columns)

    def replace_where(self, name: str, mask_fn, df) -> None:
        """Delete rows matching ``mask_fn`` (a predicate over the stored
        table, the file store's contract — so matching happens
        client-side: read, evaluate, delete by ``_id``) then insert
        ``df``."""
        coll = self.db[name]
        rows = list(coll.find({}))
        if rows:
            mask = np.asarray(mask_fn(self._table(rows)), bool)
            if mask.all():
                # full refresh: one server-side wipe, no id round-trip
                coll.delete_many({})
            else:
                ids = [r["_id"] for r, m in zip(rows, mask.tolist()) if m]
                if ids:
                    coll.delete_many({"_id": {"$in": ids}})
        df = as_table(df)
        if nrows(df):
            # through insert() for ordered=False duplicate tolerance — a
            # unique index from an earlier keyed insert must not abort the
            # refresh mid-batch
            self.insert(name, df)

    def replace(self, name: str, df) -> None:
        """Full refresh: one server-side wipe then insert (drop +
        ``insert_many``)."""
        self.db[name].delete_many({})
        df = as_table(df)
        if nrows(df):
            self.insert(name, df)

    def compact(self, name: str) -> None:
        """No-op: Mongo has no parts to merge."""

    def last_date(self, name: str, date_col: str = "trade_date"):
        key = (name, ("__date__", date_col))
        if key not in self._indexed:
            # the compound unique key (ts_code, trade_date) cannot serve a
            # sort on trade_date alone — without this, every watermark read
            # is a full collection scan.  Best-effort: a read-only role may
            # not createIndexes; the find_one below still answers, just
            # unindexed.  Only an authorization failure is cached as
            # don't-retry — a transient error (stepdown, timeout) must not
            # permanently degrade reads.
            try:
                self.db[name].create_index([(date_col, pymongo.DESCENDING)])
                self._indexed.add(key)
            except pymongo.errors.OperationFailure:
                self._indexed.add(key)
            except _transient_mongo_errors():
                pass
        doc = self.db[name].find_one(
            {date_col: {"$exists": True}}, {date_col: 1, "_id": 0},
            sort=[(date_col, pymongo.DESCENDING)],
        )
        return None if doc is None else doc[date_col]

    def distinct_count(self, name: str, col: str) -> int:
        return len(self.db[name].distinct(col))
