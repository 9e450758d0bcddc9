"""The port's collection store (``mfm_tpu_torch/data/etl.py`` PanelStore,
``data/mongo_store.py``) against the reference's.

Every store-contract case (the reference's ``tests/test_store_contract.py``
and ``tests/test_etl.py``) runs the same operations on a reference store
and on a port store, and what each read gives back must be the same rows,
column for column and cell for cell (missing cells as missing, whatever
their marker).  Three port stores: the npz part store; the port reading a
store the reference writes (parquet parts, read through pandas here); and
the Mongo adapter on ``tests/mongofake.py``.  CPU only, nothing timed.
"""

import json
import os

import numpy as np
import pandas as pd
import pytest

from mfm_tpu.data import etl as ref_etl
from mfm_tpu.data import mongo_store as ref_mongo
from mfm_tpu_torch.data import etl as port_etl
from mfm_tpu_torch.data import mongo_store as port_mongo

from tests import mongofake


# -- canonical tables -------------------------------------------------------------

def _null(x) -> bool:
    if x is None:
        return True
    try:
        return bool(x != x)
    except (TypeError, ValueError):
        return True


def _kind(a: np.ndarray, cells: list) -> str:
    if a.dtype.kind in "fiubM":
        return {"u": "i"}.get(a.dtype.kind, a.dtype.kind)
    live = [c for c in cells if c is not None]
    return "str" if live else "null"


def canon(table) -> dict:
    """A DataFrame or a column dict as {column: (kind, cells)}: cells as
    Python values, every missing marker as None, dates as ISO strings."""
    if table is None:
        return {}
    cols = list(table.columns) if hasattr(table, "columns") else list(table)
    out = {}
    for c in cols:
        col = table[c]
        a = np.asarray(col.to_numpy() if hasattr(col, "to_numpy") else col)
        if a.dtype.kind == "M":
            cells = [None if np.isnat(x) else str(x.astype("datetime64[ns]"))
                     for x in a]
        else:
            cells = [None if _null(x) else
                     (x.item() if isinstance(x, np.generic) else x)
                     for x in a.tolist()]
        out[str(c)] = (_kind(a, cells), cells)
    return out


def canon_value(v):
    if isinstance(v, (pd.DataFrame, dict)):
        return canon(v)
    if isinstance(v, (list, tuple)):
        return [canon_value(x) for x in v]
    if isinstance(v, np.generic):
        return v.item()
    return v


# -- the store pairs ----------------------------------------------------------------

class RefWritesPortReads:
    """Writes go through the reference's store (parquet parts), reads
    through the port's store on the same directory."""

    def __init__(self, root):
        self.w = ref_etl.PanelStore(root)
        self.r = port_etl.PanelStore(root)

    def insert(self, name, df, unique=None):
        return self.w.insert(name, _frame(df), unique=unique)

    def replace_where(self, name, mask_fn, df):
        return self.w.replace_where(name, mask_fn, _frame(df))

    def replace(self, name, df):
        return self.w.replace(name, None if df is None else _frame(df))

    def compact(self, name):
        return self.w.compact(name)

    def read(self, name, columns=None):
        return self.r.read(name, columns)

    def last_date(self, name, date_col="trade_date"):
        return self.r.last_date(name, date_col)

    def distinct_count(self, name, col):
        return self.r.distinct_count(name, col)


def _frame(df):
    return df if df is None or isinstance(df, pd.DataFrame) \
        else pd.DataFrame(df)


class RefFrames:
    """The reference's store fed the case's column dicts as DataFrames."""

    def __init__(self, inner):
        self.inner = inner

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def insert(self, name, df, unique=None):
        return self.inner.insert(name, _frame(df), unique=unique)

    def replace_where(self, name, mask_fn, df):
        return self.inner.replace_where(name, mask_fn, _frame(df))

    def replace(self, name, df):
        return self.inner.replace(name, None if df is None else _frame(df))


def _fake_mongo(module, monkeypatch):
    monkeypatch.setattr(module, "pymongo", mongofake)
    monkeypatch.setattr(module, "BulkWriteError", mongofake.BulkWriteError)
    return module.MongoPanelStore(mongofake.FakeDatabase())


def store_pair(backend, tmp_path, monkeypatch):
    """(reference store factory, port store factory); a file store's
    factory gives a new instance on the same root each call."""
    if backend == "npz":
        return (lambda: RefFrames(ref_etl.PanelStore(str(tmp_path / "ref"))),
                lambda: port_etl.PanelStore(str(tmp_path / "port")))
    if backend == "ref_parquet":
        return (lambda: RefFrames(ref_etl.PanelStore(str(tmp_path / "ref"))),
                lambda: RefWritesPortReads(str(tmp_path / "mixed")))
    ref = RefFrames(_fake_mongo(ref_mongo, monkeypatch))
    port = _fake_mongo(port_mongo, monkeypatch)
    return (lambda: ref), (lambda: port)


# -- the contract cases: each returns what it observed --------------------------------

def _day(day, n=3, start=0):
    return {"ts_code": [f"{600000 + start + i}.SH" for i in range(n)],
            "trade_date": [f"2024010{day}"] * n,
            "close": list(np.linspace(1.0, 2.0, n) + day)}


def _day_frame(d, n=40):
    return {"ts_code": [f"{600000 + i}.SH" for i in range(n)],
            "trade_date": [f"2024{d // 31 + 1:02d}{d % 31 + 1:02d}"] * n,
            "close": list(np.linspace(1, 2, n) + d)}


def case_insert_read_roundtrip(mk, lib):
    st = mk()
    n = st.insert("px", _day(1), unique=("ts_code", "trade_date"))
    return [n, st.read("px"), st.read("px", columns=["ts_code"])]


def case_duplicate_tolerant_insert(mk, lib):
    st, u = mk(), ("ts_code", "trade_date")
    mixed = {k: _day(1)[k] + _day(2)[k] for k in _day(1)}
    return [st.insert("px", _day(1), unique=u),
            st.insert("px", _day(1), unique=u),
            st.insert("px", mixed, unique=u), st.read("px")]


def case_replace_where_refresh(mk, lib):
    st = mk()
    st.insert("comp", {"index_code": ["A", "A", "B"],
                       "trade_date": ["20240101"] * 3,
                       "con_code": ["x", "y", "z"]})
    st.replace_where(
        "comp",
        lambda c: (c["index_code"] == "A") & (c["trade_date"] == "20240101"),
        {"index_code": ["A"], "trade_date": ["20240101"], "con_code": ["w"]})
    return [st.read("comp")]


def case_replace_full_refresh(mk, lib):
    st = mk()
    st.replace("info", _day(1, n=4))
    a = st.read("info")
    st.replace("info", _day(2, n=2))
    b = st.read("info")
    st.replace("info", None)
    return [a, b, len(canon(st.read("info")).get("ts_code", (0, []))[1])]


def case_last_date_watermark(mk, lib):
    st = mk()
    out = [st.last_date("px")]
    st.insert("px", _day(1), unique=("ts_code", "trade_date"))
    st.insert("px", _day(3), unique=("ts_code", "trade_date"))
    st.insert("info", {"ts_code": ["600000.SH"]})
    return out + [st.last_date("px"), st.last_date("info")]


def case_distinct_count(mk, lib):
    st = mk()
    st.insert("px", _day(1, n=4), unique=("ts_code", "trade_date"))
    st.insert("px", _day(2, n=4), unique=("ts_code", "trade_date"))
    return [st.distinct_count("px", "ts_code"),
            st.distinct_count("px", "trade_date"),
            st.distinct_count("nothing", "ts_code")]


def case_updater_watermark_resume(mk, lib):
    calls = []

    class Src:
        def fetch_daily_prices(self, trade_date):
            calls.append(trade_date)
            return _frame(_day(int(trade_date[-1])))

    up = lib.IncrementalUpdater(store=mk(), source=Src(),
                                sleep=lambda s: None)
    cal = ["20240101", "20240102", "20240103"]
    n1 = up.update_daily_prices(cal)
    calls.clear()
    n2 = up.update_daily_prices(cal + ["20240104"])
    return [n1, n2, list(calls), up.store.read("daily_prices")]


def case_null_keys_dedup(mk, lib):
    st = mk()
    df = {"ts_code": ["A", "A"], "end_date": ["20240331", "20240630"],
          "f_ann_date": [None, np.nan], "n_cashflow_act": [1.0, 2.0]}
    u = ("ts_code", "end_date", "f_ann_date")
    return [st.insert("cashflow", df, unique=u),
            st.insert("cashflow", df, unique=u),
            mk().insert("cashflow", df, unique=u), st.read("cashflow")]


def case_compact_preserves_contents(mk, lib):
    st, u = mk(), ("ts_code", "trade_date")
    for d in range(5):
        st.insert("y", _day_frame(d, n=3), unique=u)
    before = st.read("y")
    st.compact("y")
    return [before, st.read("y"), st.insert("y", _day_frame(0, n=3),
                                            unique=u)]


def case_repeated_rewrites_do_not_clobber(mk, lib):
    st = mk()
    st.insert("c", {"index_code": ["i"], "trade_date": ["d1"],
                    "con_code": ["A"]})
    for day in ("d2", "d3"):
        st.replace_where(
            "c", lambda cur, day=day: cur["trade_date"] == day,
            {"index_code": ["i"], "trade_date": [day], "con_code": ["A"]})
    for d in range(3):
        st.insert("y", _day_frame(d, n=2), unique=("ts_code", "trade_date"))
    st.compact("y")
    for d in range(3, 7):
        st.insert("y", _day_frame(d, n=2), unique=("ts_code", "trade_date"))
    return [st.read("c"), st.read("y")]


def case_second_instance_inserts_are_seen(mk, lib):
    a, b, u = mk(), mk(), ("ts_code", "trade_date")
    return [a.insert("d", _day_frame(0, n=2), unique=u),
            b.insert("d", _day_frame(1, n=2), unique=u),
            a.insert("d", _day_frame(1, n=2), unique=u), a.read("d")]


def case_cross_instance_deletion(mk, lib):
    a, b = mk(), mk()
    u = ("index_code", "trade_date", "con_code")
    row = {"index_code": ["i"], "trade_date": ["d1"], "con_code": ["A"]}
    n1 = a.insert("c", row, unique=u)
    b.replace_where("c", lambda cur: cur["trade_date"] == "d1",
                    {"index_code": ["i"], "trade_date": ["d2"],
                     "con_code": ["A"]})
    return [n1, a.insert("c", row, unique=u), a.read("c")]


def case_mixed_types_and_nulls(mk, lib):
    st = mk()
    st.insert("t", {"s": ["a", None, "c"], "f": [1.5, np.nan, -0.0],
                    "i": [1, 2, 3], "b": [True, False, True],
                    "d": pd.to_datetime(["2024-01-02", None,
                                         "2024-03-04"]).to_numpy()})
    st.insert("t", {"s": ["d"], "f": [2.0], "i": [4], "b": [False],
                    "d": pd.to_datetime(["2024-05-06"]).to_numpy()})
    return [st.read("t"), st.read("t", columns=["d", "s"])]


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}
#: cases that need two instances on one root (file stores only)
FILE_ONLY = {"second_instance_inserts_are_seen", "cross_instance_deletion",
             "null_keys_dedup", "compact_preserves_contents",
             "repeated_rewrites_do_not_clobber"}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("backend", ["npz", "ref_parquet", "mongo"])
def test_store_contract_matches_the_reference(backend, case, tmp_path,
                                              monkeypatch):
    if backend == "mongo" and case in FILE_ONLY:
        case = "insert_read_roundtrip"   # the Mongo adapter has one instance
    ref_mk, port_mk = store_pair(backend, tmp_path, monkeypatch)
    want = canon_value(CASES[case](ref_mk, ref_etl))
    got = canon_value(CASES[case](port_mk, port_etl))
    assert got == want


# -- the file store's own protocol ----------------------------------------------------

def test_npz_parts_read_back_bit_for_bit(tmp_path):
    """The part format: every column type, NaN/None/NaT as written, column
    order kept, float bits kept."""
    rng = np.random.default_rng(0)
    f = rng.standard_normal(50) * 10.0 ** rng.integers(-300, 300, 50)
    f[[3, 7]] = [np.nan, -0.0]
    s = np.array([f"s{i}" for i in range(50)], object)
    s[4], s[9] = None, np.nan
    d = np.datetime64("2024-01-01", "ns") + np.arange(50).astype(
        "timedelta64[h]")
    d[5] = np.datetime64("NaT")
    table = {"z": f, "a": s, "i": rng.integers(-9, 9, 50), "d": d,
             "b": rng.random(50) < 0.5, "u": np.array(["x"] * 50)}
    path = str(tmp_path / "t.npz")
    port_etl.write_table(path, table)
    got = port_etl.read_table(path)
    assert list(got) == list(table)
    assert np.array_equal(got["z"].view(np.int64), f.view(np.int64))
    assert got["a"][4] is None and got["a"][9] != got["a"][9]
    assert got["a"][[0, 1]].tolist() == ["s0", "s1"]
    assert np.array_equal(got["d"], d, equal_nan=True)
    for c in ("i", "b", "u"):
        assert np.array_equal(got[c], table[c]) and got[c].dtype.kind == \
            table[c].dtype.kind
    with np.load(path, allow_pickle=False) as z:
        assert z["__columns__"].tolist() == list(table)


def test_interrupted_rewrite_heals_without_duplicates(tmp_path):
    """A crash after the merged part and the marker but before the
    deletions: a fresh instance rolls the rewrite forward."""
    store = port_etl.PanelStore(str(tmp_path))
    u = ("ts_code", "trade_date")
    for d in range(3):
        store.insert("y", _day_frame(d, n=2), unique=u)
    before = canon(store.read("y"))
    old = store._parts("y")
    d = store._dir("y")
    final = f"part-{store._next_part_index(d):06d}-999.npz"
    port_etl.write_table(os.path.join(d, final), store.read("y"))
    with open(store._marker_path("y"), "w") as f:
        json.dump({"pending": final + ".pending", "final": final,
                   "obsolete": [os.path.relpath(p, store.root)
                                for p in old]}, f)
    fresh = port_etl.PanelStore(str(tmp_path))
    assert canon(fresh.read("y")) == before
    assert not os.path.exists(store._marker_path("y"))
    assert fresh.insert("y", _day_frame(0, n=2), unique=u) == 0


def test_heals_a_rewrite_the_reference_left_half_done(tmp_path):
    """The same crash window in a parquet store the reference wrote: the
    port's heal rolls it forward and reads what the reference reads."""
    ref = ref_etl.PanelStore(str(tmp_path))
    for d in range(3):
        ref.insert("y", pd.DataFrame(_day_frame(d, n=2)),
                   unique=("ts_code", "trade_date"))
    want = canon(ref.read("y"))
    old = ref._parts("y")
    d = ref._dir("y")
    final = f"part-{ref._next_part_index(d):06d}-999.parquet"
    ref.read("y").to_parquet(os.path.join(d, final), index=False)
    with open(ref._marker_path("y"), "w") as f:
        json.dump({"pending": final + ".pending", "final": final,
                   "obsolete": [os.path.relpath(p, ref.root)
                                for p in old]}, f)
    assert canon(port_etl.PanelStore(str(tmp_path)).read("y")) == want
    assert len(os.listdir(d)) == 1


def test_port_inserts_into_a_reference_store(tmp_path):
    """Dedup admission across formats: npz parts appended to a store of
    parquet parts (and a legacy single file) skip the keys already there,
    and part indices never collide."""
    legacy = pd.DataFrame({"ts_code": ["A", "B"], "trade_date": ["d1", "d1"],
                           "close": [1.0, 2.0]})
    legacy.to_parquet(str(tmp_path / "x.parquet"), index=False)
    ref = ref_etl.PanelStore(str(tmp_path))
    ref.insert("x", pd.DataFrame({"ts_code": ["C"], "trade_date": ["d1"],
                                  "close": [3.0]}),
               unique=("ts_code", "trade_date"))
    port = port_etl.PanelStore(str(tmp_path))
    added = port.insert("x", {"ts_code": ["A", "D"], "trade_date": ["d1", "d1"],
                              "close": [9.0, 4.0]},
                        unique=("ts_code", "trade_date"))
    assert added == 1
    parts = sorted(os.listdir(tmp_path / "x"))
    assert [p.split("-")[1] for p in parts] == ["000000", "000001"]
    assert parts[1].endswith(".npz")
    got = port.read("x")
    assert got["ts_code"].tolist() == ["A", "B", "C", "D"]
    assert got["close"].tolist() == [1.0, 2.0, 3.0, 4.0]


def test_insert_appends_without_rescanning(tmp_path, monkeypatch):
    """After the one-time key scan, N inserts read no stored rows."""
    store = port_etl.PanelStore(str(tmp_path))
    reads = []
    orig = port_etl.read_table

    def counting(path, columns=None):
        reads.append((os.path.basename(path), columns))
        return orig(path, columns)

    monkeypatch.setattr(port_etl, "read_table", counting)
    for d in range(30):
        store.insert("daily_prices", _day_frame(d),
                     unique=("ts_code", "trade_date"))
    assert reads == []
    monkeypatch.setattr(port_etl, "read_table", orig)
    s2 = port_etl.PanelStore(str(tmp_path))
    assert s2.insert("daily_prices", _day_frame(0),
                     unique=("ts_code", "trade_date")) == 0
    assert s2.last_date("daily_prices") == _day_frame(29)["trade_date"][0]


def test_corrupt_part_does_not_reset_watermark(tmp_path):
    store = port_etl.PanelStore(str(tmp_path))
    store.insert("daily_prices", _day_frame(0),
                 unique=("ts_code", "trade_date"))
    part = store._parts("daily_prices")[0]
    with open(part, "wb") as f:
        f.write(b"not an npz")
    with pytest.raises(Exception):
        store.last_date("daily_prices")   # surfaced, not None
    s2 = port_etl.PanelStore(str(tmp_path / "s2"))
    s2.insert("z", {"a": [1]})
    assert s2.last_date("z") is None


def test_parquet_part_without_pandas_names_the_part(tmp_path, monkeypatch):
    ref_etl.PanelStore(str(tmp_path)).insert(
        "x", pd.DataFrame(_day(1)), unique=("ts_code", "trade_date"))
    monkeypatch.setitem(__import__("sys").modules, "pandas", None)
    with pytest.raises(ImportError, match="part-000000"):
        port_etl.PanelStore(str(tmp_path)).read("x")


# -- the Mongo adapter's own paths ----------------------------------------------------

def test_mongo_null_key_rows_collide(monkeypatch):
    """Mongo's non-sparse unique index treats a missing key as null: of
    two null-keyed rows one is admitted."""
    st = _fake_mongo(port_mongo, monkeypatch)
    u = ("ts_code", "trade_date")
    assert st.insert("px", {"ts_code": ["600000.SH"],
                            "trade_date": ["20240101"], "close": [1.0]},
                     unique=u) == 1
    nokey = {"ts_code": ["600001.SH", "600001.SH"],
             "trade_date": [None, None], "close": [2.0, 3.0]}
    assert st.insert("px", nokey, unique=u) == 1
    assert len(st.read("px")["ts_code"]) == 2


def test_mongo_last_date_index_fallback(monkeypatch):
    """An authorization failure is cached as don't-retry; a transient
    error is retried and the index built."""
    st = _fake_mongo(port_mongo, monkeypatch)
    st.insert("px", _day(1), unique=("ts_code", "trade_date"))
    coll = st.db["px"]
    coll.fail_create_index = mongofake.OperationFailure("not authorized")
    assert st.last_date("px") == "20240101"
    assert ("px", ("__date__", "trade_date")) in st._indexed
    coll.fail_create_index = None
    st.insert("px", _day(2), unique=("ts_code", "trade_date"))
    assert st.last_date("px") == "20240102"
    assert ("trade_date",) not in coll.plain_indexes

    st2 = _fake_mongo(port_mongo, monkeypatch)
    st2.insert("px", _day(1), unique=("ts_code", "trade_date"))
    coll2 = st2.db["px"]
    coll2.fail_create_index = ConnectionError("primary stepdown")
    assert st2.last_date("px") == "20240101"
    assert ("px", ("__date__", "trade_date")) not in st2._indexed
    coll2.fail_create_index = None
    assert st2.last_date("px") == "20240101"
    assert ("trade_date",) in coll2.plain_indexes


def test_mongo_dates_round_trip_as_datetimes(monkeypatch):
    st = _fake_mongo(port_mongo, monkeypatch)
    d = np.array(["2024-01-02", "NaT"], "datetime64[ns]")
    st.insert("t", {"d": d, "x": [1.0, 2.0]})
    got = st.read("t")
    assert np.array_equal(got["d"], d, equal_nan=True)
    assert got["x"].tolist() == [1.0, 2.0]
