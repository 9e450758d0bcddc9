"""The port's ETL layer (``mfm_tpu_torch/data/etl.py`` updaters, planner and
checks, ``data/xlsx.py``, ``data/tushare_source.py``, the store faults of
``utils/chaos.py``) against the reference's.

Each updater runs against a fake source serving the same synthetic truth
to both packages (no network); the store each package ends with must hold
the same rows, and each summary, plan and check must be the same record.
CPU only.
"""

import numpy as np
import pandas as pd
import pytest

from mfm_tpu.data import etl as ref_etl
from mfm_tpu.data import xlsx as ref_xlsx
from mfm_tpu.utils import chaos as ref_chaos
from mfm_tpu_torch.data import etl, xlsx
from mfm_tpu_torch.data.columns import isin, nrows, take
from mfm_tpu_torch.data.synthetic import synthetic_collections
from mfm_tpu_torch.data.tushare_source import TushareSource
from mfm_tpu_torch.utils import chaos

from tests.test_etl_updaters import COLLECTIONS
from tests.test_etl_updaters import FullFakeSource as RefFakeSource
from tests.test_torch_store import canon
from tests.test_xlsx import write_xlsx


class FullFakeSource:
    """The synthetic truth tables through the tushare fetch surface, as
    column tables (the reference's fake serves the same rows as
    DataFrames)."""

    def __init__(self, truth, dates):
        self.t = truth
        self.dates = dates

    def _rows(self, name, **eq):
        df = self.t[name]
        keep = np.ones(nrows(df), bool)
        for col, v in eq.items():
            keep &= np.asarray(df[col]) == v
        return take(df, keep)

    def fetch_stock_info(self):
        return dict(self.t["stock_info"])

    def fetch_trade_calendar(self, start_date, end_date):
        return [d for d in self.dates if start_date <= d <= end_date]

    def fetch_daily_prices(self, trade_date):
        return self._rows("daily_prices", trade_date=trade_date)

    def fetch_daily_prices_by_stock(self, ts_code, start_date=None,
                                    end_date=None):
        df = self._rows("daily_prices", ts_code=ts_code)
        d = np.asarray(df["trade_date"])
        keep = np.ones(len(d), bool)
        if start_date is not None:
            keep &= d >= start_date
        if end_date is not None:
            keep &= d <= end_date
        return take(df, keep)

    def fetch_balancesheet_by_stock(self, ts_code, start_date=None,
                                    end_date=None):
        return self._rows("balancesheet", ts_code=ts_code)

    def fetch_cashflow_by_stock(self, ts_code, start_date=None, end_date=None):
        return self._rows("cashflow", ts_code=ts_code)

    def fetch_income_by_stock(self, ts_code, start_date=None, end_date=None):
        return {c: np.array([], str)
                for c in ("ts_code", "end_date", "f_ann_date")}

    def fetch_financial_indicators_by_stock(self, ts_code, start_date=None,
                                            end_date=None):
        return self._rows("financial_indicators", ts_code=ts_code)

    def fetch_daily_index_prices(self, ts_code, start_date=None,
                                 end_date=None):
        df = self._rows("index_daily_prices", ts_code=ts_code)
        d = np.asarray(df["trade_date"])
        keep = np.ones(len(d), bool)
        if start_date is not None:
            keep &= d >= start_date
        if end_date is not None:
            keep &= d <= end_date
        return take(df, keep)

    def fetch_index_components(self, index_code, trade_date):
        return self._rows("index_components", index_code=index_code,
                          trade_date=trade_date)

    def fetch_sw_industries(self, ts_code):
        return self._rows("sw_industries", ts_code=ts_code)


@pytest.fixture(scope="module")
def truth(tmp_path_factory):
    d = tmp_path_factory.mktemp("truth")
    s = etl.PanelStore(str(d))
    meta = synthetic_collections(s, T=100, N=16, n_industries=4, seed=7)
    tables = {n: s.read(n) for n in COLLECTIONS}
    frames = {n: pd.DataFrame({c: (v.astype(object) if v.dtype.kind == "U"
                                   else v) for c, v in t.items()})
              for n, t in tables.items()}
    return tables, frames, meta


def _same_stores(port, ref):
    for name in COLLECTIONS + ("income",):
        assert canon(port.read(name)) == canon(ref.read(name)), name


def test_run_all_is_the_references(truth, tmp_path):
    tables, frames, meta = truth
    dates = list(meta["dates"])
    start, end = dates[0], dates[-1]
    kw = dict(index_codes=(meta["index_code"],), components_date=end)
    port = etl.PanelStore(str(tmp_path / "port"))
    ref = ref_etl.PanelStore(str(tmp_path / "ref"))
    up = etl.IncrementalUpdater(port, FullFakeSource(tables, dates),
                                sleep=lambda s: None)
    rup = ref_etl.IncrementalUpdater(ref, RefFakeSource(frames, dates),
                                     sleep=lambda s: None)
    got, want = up.run_all(start, end, **kw), rup.run_all(start, end, **kw)
    assert got == want
    _same_stores(port, ref)
    # watermarks and dedup: a second run fetches nothing new
    assert up.run_all(start, end, index_codes=kw["index_codes"]) == \
        rup.run_all(start, end, index_codes=kw["index_codes"])
    _same_stores(port, ref)


def test_repair_missing_stocks_is_the_references(truth, tmp_path):
    tables, frames, meta = truth
    dates = list(meta["dates"])
    gone = meta["stocks"][0]
    daily, rdaily = tables["daily_prices"], frames["daily_prices"]
    port = etl.PanelStore(str(tmp_path / "port"))
    ref = ref_etl.PanelStore(str(tmp_path / "ref"))
    port.insert("stock_info", tables["stock_info"], unique=("ts_code",))
    ref.insert("stock_info", frames["stock_info"], unique=("ts_code",))
    port.insert("daily_prices",
                take(daily, np.asarray(daily["ts_code"]) != gone),
                unique=("ts_code", "trade_date"))
    ref.insert("daily_prices", rdaily[rdaily["ts_code"] != gone],
               unique=("ts_code", "trade_date"))
    assert etl.find_missing_stocks(port) == ref_etl.find_missing_stocks(ref)

    src, rsrc = FullFakeSource(tables, dates), RefFakeSource(frames, dates)

    def by_stock(ts_code, start_date=None, end_date=None):
        df = rdaily[rdaily["ts_code"] == ts_code]
        return df[(df["trade_date"] >= start_date)
                  & (df["trade_date"] <= end_date)].copy()

    rsrc.fetch_daily_prices_by_stock = by_stock
    up = etl.IncrementalUpdater(port, src, sleep=lambda s: None)
    rup = ref_etl.IncrementalUpdater(ref, rsrc, sleep=lambda s: None)
    got = up.repair_missing_stocks(dates[0], dates[-1])
    assert got == rup.repair_missing_stocks(dates[0], dates[-1])
    assert gone in got["missing"] and got["rows_inserted"] > 0
    _same_stores(port, ref)
    assert up.repair_missing_stocks(dates[0], dates[-1]) == \
        {"missing": [], "rows_inserted": 0}


def test_index_watermark_and_sw_csv_are_the_references(truth, tmp_path):
    tables, frames, meta = truth
    dates = list(meta["dates"])
    port = etl.PanelStore(str(tmp_path / "port"))
    ref = ref_etl.PanelStore(str(tmp_path / "ref"))
    up = etl.IncrementalUpdater(port, FullFakeSource(tables, dates),
                                sleep=lambda s: None)
    rup = ref_etl.IncrementalUpdater(ref, RefFakeSource(frames, dates),
                                     sleep=lambda s: None)
    for codes, end in (([meta["index_code"]], dates[50]),
                       ([meta["index_code"], "000016.SH"], dates[-1])):
        assert up.update_daily_index_prices(codes, end_date=end) == \
            rup.update_daily_index_prices(codes, end_date=end)
    csv = tmp_path / "sw.csv"
    frames["sw_industries"].to_csv(csv, index=False)
    assert up.update_sw_industries(csv_path=str(csv)) == \
        rup.update_sw_industries(csv_path=str(csv))
    assert canon(port.read("sw_industries")) == \
        canon(ref.read("sw_industries"))
    with pytest.raises(ValueError, match="ts_codes or csv_path"):
        up.update_sw_industries()


def _plan_store(root, pkg, frame):
    st = pkg.PanelStore(str(root))
    st.insert("stock_info", frame({"ts_code": ["a", "b", "c"]}))
    st.insert("daily_prices", frame({
        "ts_code": ["a", "b"], "trade_date": ["20240105", "20240103"],
        "close": [1.0, 2.0]}))
    st.insert("index_daily_prices", frame({
        "ts_code": ["000300.SH"], "trade_date": ["20240110"],
        "close": [3000.0]}))
    return st


@pytest.mark.parametrize("kw", [
    {},
    {"index_codes": ["000300.SH", "000016.SH"]},
    {"components_date": "20240108", "sw": False, "statements": ()},
])
@pytest.mark.parametrize("start", ["20240101", "20240106"])
def test_plan_update_and_checks_are_the_references(tmp_path, kw, start):
    port = _plan_store(tmp_path / "port", etl, dict)
    ref = _plan_store(tmp_path / "ref", ref_etl, pd.DataFrame)
    assert etl.plan_update(port, start, "20240108", **kw) == \
        ref_etl.plan_update(ref, start, "20240108", **kw)
    empty = etl.PanelStore(str(tmp_path / "empty"))
    rempty = ref_etl.PanelStore(str(tmp_path / "rempty"))
    assert etl.plan_update(empty, start, "20240108", **kw) == \
        ref_etl.plan_update(rempty, start, "20240108", **kw)
    for store, rstore in ((port, ref), (empty, rempty)):
        assert etl.verify_store(store) == ref_etl.verify_store(rstore)
        assert etl.find_missing_stocks(store) == \
            ref_etl.find_missing_stocks(rstore)


def test_rate_limiter_sleeps_as_the_reference():
    def drive(cls):
        now, sleeps = [0.0], []
        rl = cls(3, clock=lambda: now[0], sleep=lambda s: sleeps.append(s))
        for step in (1.0, 1.0, 1.0, 0.5, 30.0, 0.1, 0.1, 61.0, 0.0):
            rl.wait()
            now[0] += step
        return sleeps

    assert drive(etl.RateLimiter) == drive(ref_etl.RateLimiter)
    assert drive(etl.RateLimiter)[0] == pytest.approx(57.0)


def test_updater_rides_out_a_flaky_store_and_source(truth, tmp_path):
    """The store faults against ``with_retry``: a store failing its first
    two inserts and a fetch failing twice cost two 5 s backoffs each, and
    the rows land once — as in the reference."""
    tables, frames, meta = truth
    dates = list(meta["dates"])[:3]

    def run(pkg, chaos_mod, src, root):
        sleeps = []
        inner = pkg.PanelStore(str(root))
        store = chaos_mod.FlakyStore(inner, n_failures=2)
        src.fetch_daily_prices = chaos_mod.flaky(src.fetch_daily_prices, 2)
        up = pkg.IncrementalUpdater(store, src, sleep=sleeps.append)
        raised = []   # the store's fault is not retried: the run stops
        while True:
            try:
                n = up.update_daily_prices(dates)
                break
            except ConnectionError as err:
                raised.append(str(err))
        return sleeps, raised, n, inner.read("daily_prices")

    got = run(etl, chaos, FullFakeSource(tables, dates), tmp_path / "p")
    want = run(ref_etl, ref_chaos, RefFakeSource(frames, dates),
               tmp_path / "r")
    assert got[:3] == want[:3] and got[0] == [5.0, 5.0]
    assert len(got[1]) == 2 and got[2] > 0
    assert canon(got[3]) == canon(want[3])

    calls = []
    fn = chaos.flaky(lambda: calls.append(1) or "ok", 2)
    assert etl.with_retry(fn, attempts=3, sleep=lambda s: None) == "ok"
    with pytest.raises(ConnectionError, match="injected"):
        etl.with_retry(chaos.flaky(lambda: "ok", 3), attempts=3,
                       sleep=lambda s: None)


def test_tushare_source_gives_tables_from_an_injected_client():
    class Client:
        def daily_basic(self, **kw):
            return pd.DataFrame({"ts_code": ["a"], "trade_date": ["20240102"],
                                 "close": [1.5]})

        def trade_cal(self, **kw):
            return pd.DataFrame({"cal_date": ["20240102", "20240103"]})

    src = TushareSource(client=Client())
    got = src.fetch_daily_prices("20240102")
    assert isinstance(got, dict) and got["close"].tolist() == [1.5]
    assert src.fetch_trade_calendar("20240101", "20240105") == \
        ["20240102", "20240103"]


def test_xlsx_readers_are_the_references(tmp_path):
    il = str(tmp_path / "index_list.xlsx")
    write_xlsx(il, [("Sheet1", [
        ["ts_code", "name", "base_point", "flag"],
        ["000300.SH", "CSI300", 1000.0, None],
        ["000905.SH", None, 1000.0, "x"],
    ])])
    assert canon(xlsx.read_index_list(il)) == \
        canon(ref_xlsx.read_index_list(il))
    edb = str(tmp_path / "edb.xlsx")
    rows = [["Wind"], ["指标名称", "中信行业指数:计算机", "中信行业指数:银行"],
            ["频率", "日", "日"], ["单位", "点", "点"],
            [38352.0, 1000.0, 1000.0], [38356.0, 997.85, None],
            [38357.0, True, 3.0]]
    write_xlsx(edb, [("中信", rows), ("申万", rows[1:3])])
    for sheet in (0, "中信", 1):
        assert canon(xlsx.read_industry_index_prices(edb, sheet)) == \
            canon(ref_xlsx.read_industry_index_prices(edb, sheet))
    assert xlsx.read_xlsx(edb, 0) == ref_xlsx.read_xlsx(edb, 0)
    with pytest.raises(ValueError, match="指标名称"):
        xlsx.read_industry_index_prices(il, sheet=0)

    port = etl.PanelStore(str(tmp_path / "p"))
    ref = ref_etl.PanelStore(str(tmp_path / "r"))
    for _ in range(2):   # the second ingest adds nothing
        got = xlsx.ingest_workbooks(port, index_list=il, industry_index=edb)
        want = ref_xlsx.ingest_workbooks(ref, index_list=il,
                                         industry_index=edb)
        assert got == want
    for name in ("index_list", "industry_index_prices"):
        assert canon(port.read(name)) == canon(ref.read(name))


def test_isin_matches_pandas():
    col = np.array(["a", "b", "c", "a"])
    assert isin(col, ["a", "c"]).tolist() == \
        pd.Series(col).isin(["a", "c"]).tolist()
