"""The port's point-in-time layer, generator and prepare path
(``mfm_tpu_torch/data/pit.py``, ``synthetic.synthetic_collections``,
``data/prepare.py``) against the reference's, bit for bit.

Inputs are made from seeds with numpy.  Every comparison is exact
(``equal_nan``; dates compared as datetime64[ns], missing markers as
missing): the port sorts, dedups, joins and fills with pandas' semantics.

One place differs on purpose: the reference's ``asof_join`` numbers
stock groups in first-seen order, so when a stock has statements but no
left rows and sorts before a stock that has them, its key is not monotone
and the next stock joins nothing (``mfm_tpu/data/pit.py:58,72``).  The
port joins per stock, as a ``pd.merge_asof`` loop does; the tests below
pin both that the port equals the loop and that the reference does not.
"""

import numpy as np
import pandas as pd
import pytest

from mfm_tpu.data import pit as ref_pit
from mfm_tpu.data import prepare as ref_prep
from mfm_tpu.data.etl import PanelStore as RefStore
from mfm_tpu.data.synthetic import synthetic_collections as ref_collections
from mfm_tpu_torch.data import pit, prepare
from mfm_tpu_torch.data.etl import PanelStore
from mfm_tpu_torch.data.synthetic import synthetic_collections

from tests.test_torch_store import canon

COLLECTIONS = ("stock_info", "daily_prices", "balancesheet", "cashflow",
               "financial_indicators", "index_daily_prices",
               "index_components", "sw_industries")


def as_dict(df) -> dict:
    """A reference frame as the port's input table."""
    out = {}
    for c in df.columns:
        a = df[c].to_numpy()
        if a.dtype.kind == "M":
            a = a.astype("datetime64[ns]")
        out[c] = a
    return out


def same_table(got: dict, want) -> bool:
    return canon(got) == canon(want)


@pytest.fixture(scope="module", params=[
    dict(T=120, N=30, n_industries=5, seed=3),
    dict(T=80, N=12, n_industries=4, seed=11, missing=0.1, listing_gap=0.5,
         revision_rate=0.6, start="2021-03-27"),
])
def stores(request, tmp_path_factory):
    root = tmp_path_factory.mktemp("pit")
    kw = request.param
    ref_meta = ref_collections(RefStore(str(root / "ref")), **kw)
    meta = synthetic_collections(PanelStore(str(root / "port")), **kw)
    return (RefStore(str(root / "ref")), PanelStore(str(root / "port")),
            ref_meta, meta)


def test_synthetic_collections_are_the_references(stores):
    ref, port, ref_meta, meta = stores
    for name in COLLECTIONS:
        assert same_table(port.read(name), ref.read(name)), name
    assert list(meta["dates"]) == list(ref_meta["dates"])
    assert meta["stocks"] == ref_meta["stocks"]


@pytest.mark.parametrize("median_fill", [False, True])
def test_load_and_prepare_data_is_the_references(stores, median_fill):
    ref, port, _, _ = stores
    want = ref_prep.load_and_prepare_data(ref, median_fill=median_fill)
    got = prepare.load_and_prepare_data(port, median_fill=median_fill)
    for g, w in zip(got, want):
        assert same_table(g, w)


@pytest.mark.parametrize("median_fill", [False, True])
def test_prepare_factor_inputs_is_the_references(stores, median_fill):
    ref, port, _, _ = stores
    want = ref_prep.prepare_factor_inputs(ref, median_fill=median_fill)
    got = prepare.prepare_factor_inputs(port, median_fill=median_fill)
    assert list(got.fields) == list(want.fields)
    for k in want.fields:
        assert got.fields[k].dtype == want.fields[k].dtype, k
        assert np.array_equal(got.fields[k], want.fields[k],
                              equal_nan=True), k
    assert np.array_equal(got.index_close, want.index_close, equal_nan=True)
    assert got.industry_l1.tolist() == want.industry_l1.tolist()
    assert np.array_equal(got.dates, want.dates.astype("datetime64[ns]"))
    assert got.stocks.tolist() == want.stocks.tolist()


def _statements(seed, n=120):
    """A raw statement table: string dates with holes, duplicate keys,
    revisions and announcements before their period end."""
    rng = np.random.default_rng(seed)
    ends = ["20190331", "20190630", "20190930", "20191231", None]
    anns = ["20190415", "20190420", "20190801", "20191030", "20200120",
            "20190301", None]
    return pd.DataFrame({
        "ts_code": rng.choice(["600000.SH", "600001.SH", "600002.SH",
                               "000001.SZ"], n),
        "end_date": rng.choice(np.array(ends, object), n),
        "f_ann_date": rng.choice(np.array(anns, object), n),
        "v": rng.standard_normal(n),
    })


@pytest.mark.parametrize("seed", range(4))
def test_dedup_statements_is_the_references(seed):
    df = _statements(seed)
    want = ref_pit.dedup_statements(df)
    assert same_table(pit.dedup_statements(as_dict(df)), want)
    want = ref_prep.dedup_indicators(df.rename(columns={
        "f_ann_date": "ann_date"}))
    got = prepare.dedup_indicators(as_dict(df.rename(columns={
        "f_ann_date": "ann_date"})))
    assert same_table(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_diagnose_statements_is_the_references(seed):
    df = _statements(seed)
    assert pit.diagnose_statements(as_dict(df)) == \
        ref_pit.diagnose_statements(df)
    with pytest.raises(ValueError, match="not a statement table"):
        pit.diagnose_statements({"ts_code": np.array(["a"])})


@pytest.mark.parametrize("seed", range(3))
def test_fill_missing_is_the_references(seed):
    rng = np.random.default_rng(seed)
    n = 200
    df = pd.DataFrame({
        "ts_code": rng.choice(["b", "a", "c", "d"], n),
        "trade_date": pd.to_datetime("2020-01-01") + pd.to_timedelta(
            rng.permutation(n) % 60, "D"),
        "x": np.where(rng.random(n) < 0.4, np.nan, rng.standard_normal(n)),
        "y": np.where(rng.random(n) < 0.7, np.nan, rng.standard_normal(n)),
        "keep": rng.standard_normal(n),
    })
    for median in (False, True):
        want = ref_pit.fill_missing(df.copy(), ["x", "y"], median_fill=median)
        got = pit.fill_missing(as_dict(df), ["x", "y"], median_fill=median)
        assert same_table(got, want), median


def _asof_tables(seed, drop=None):
    """Trade-day rows (left) and announcement rows (right) for 6 stocks in
    shuffled order; ``drop`` removes one stock's left rows only."""
    rng = np.random.default_rng(seed)
    stocks = [f"{600000 + i}.SH" for i in range(6)]
    days = pd.bdate_range("2020-01-01", periods=40).to_numpy()
    left, right = [], []
    for s in stocks:
        for d in days[rng.random(40) < 0.7]:
            left.append((s, d))
        anns = np.sort(rng.choice(
            pd.date_range("2019-12-01", periods=80).to_numpy(), 5,
            replace=False))
        for a in anns:
            right.append((s, a, rng.standard_normal(),
                          a - np.timedelta64(int(rng.integers(20, 60)), "D")))
    L = pd.DataFrame(left, columns=["ts_code", "trade_date"])
    R = pd.DataFrame(right, columns=["ts_code", "ann", "v", "end"])
    if drop is not None:
        L = L[L["ts_code"] != stocks[drop]]
    L = L.sample(frac=1.0, random_state=seed).reset_index(drop=True)
    R = R.sample(frac=1.0, random_state=seed + 1).reset_index(drop=True)
    for df in (L, R):
        for c in df.columns:
            if df[c].dtype.kind == "M":
                df[c] = df[c].astype("datetime64[ns]")
    return L, R


def merge_asof_loop(L, R):
    """The reference's promised semantics: a backward ``pd.merge_asof``
    per stock over (stock, date)-sorted tables."""
    L = L.sort_values(["ts_code", "trade_date"],
                      kind="mergesort").reset_index(drop=True)
    parts = []
    for code in pd.unique(L["ts_code"]):
        lg = L[L["ts_code"] == code]
        rg = R[R["ts_code"] == code].drop(columns=["ts_code"]).sort_values(
            "ann", kind="mergesort")
        parts.append(pd.merge_asof(lg, rg, left_on="trade_date",
                                   right_on="ann", direction="backward"))
    return pd.concat(parts, ignore_index=True)


@pytest.mark.parametrize("seed", range(6))
def test_asof_join_is_the_reference_where_its_keys_are_sorted(seed):
    L, R = _asof_tables(seed)
    want = ref_pit.asof_join(L, R, left_on="trade_date", right_on="ann")
    got = pit.asof_join(as_dict(L), as_dict(R), left_on="trade_date",
                        right_on="ann")
    assert same_table(got, want)
    assert same_table(got, merge_asof_loop(L, R))


@pytest.mark.parametrize("seed", range(6))
def test_asof_join_is_per_stock_where_the_reference_misjoins(seed):
    """A stock with statements but no trade-day rows, sorting before
    others: the port equals the per-stock merge_asof loop."""
    L, R = _asof_tables(seed, drop=1)
    got = pit.asof_join(as_dict(L), as_dict(R), left_on="trade_date",
                        right_on="ann")
    assert same_table(got, merge_asof_loop(L, R))


def test_the_reference_asof_join_misjoins_such_tables():
    """The finding in ROADMAP.md §C, pinned: whether the reference's
    ``searchsorted`` over its unsorted key lands right depends on the
    search path, and on 11 of these 30 tables it does not."""
    wrong = []
    for seed in range(30):
        L, R = _asof_tables(seed, drop=1)
        ref = ref_pit.asof_join(L, R, left_on="trade_date", right_on="ann")
        wrong.append(not same_table(as_dict(ref), merge_asof_loop(L, R)))
    assert sum(wrong) == 11


def test_prepare_with_a_constituent_without_prices(tmp_path):
    """The reference zero-fills the NEXT stock's fundamentals when a
    constituent has no price rows; the port's master table for every other
    stock is what the whole store gives."""
    kw = dict(T=120, N=30, n_industries=5, seed=3, missing=0,
              listing_gap=0)
    whole = PanelStore(str(tmp_path / "whole"))
    synthetic_collections(whole, **kw)
    gap_dir = str(tmp_path / "gap")
    ref_gap = RefStore(gap_dir)
    ref_collections(ref_gap, **kw)
    px = ref_gap.read("daily_prices")
    ref_gap.replace("daily_prices", px[px["ts_code"] != "600001.SH"])
    got, _, _ = prepare.load_and_prepare_data(PanelStore(gap_dir))
    full, _, _ = prepare.load_and_prepare_data(whole)
    keep = full["ts_code"] != "600001.SH"
    assert same_table(got, {k: v[keep] for k, v in full.items()})
    ref, _, _ = ref_prep.load_and_prepare_data(ref_gap)
    bad = ref[ref["ts_code"] == "600002.SH"]["total_ncl"].to_numpy()
    good = got["total_ncl"][got["ts_code"] == "600002.SH"]
    assert (bad == 0.0).sum() > 100 and (good != 0.0).all()
