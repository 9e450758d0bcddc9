"""Master-panel orchestration (counterpart of ``mfm_tpu/data/prepare.py``),
without pandas: a :class:`~mfm_tpu_torch.data.etl.PanelStore` to the
inputs of :class:`mfm_tpu_torch.factors.engine.FactorEngine`.

1. universe = latest index constituents;
2. load the six collections, projected to the pipeline's columns;
3. statement dedup — two-pass for balancesheet/cashflow, single-pass for
   financial indicators;
4. chained point-in-time as-of joins on announcement dates;
5. missing-value policy: per-stock ffill then 0 (see
   :func:`mfm_tpu_torch.data.pit.fill_missing`);
6. densify the long master table into the (T, N) field dict, plus the
   aligned index close series and per-stock SW L1 industry codes.

Tables are dicts of numpy columns (:mod:`mfm_tpu_torch.data.columns`);
dates come out as datetime64[ns].  The reference's documented deviations
hold here too: the index is a parameter defaulting to CSI300
(``000300.SH``), and the announcement/report date columns are ffilled but
never zero-filled, so a row with no report yet gets ``end_date_code = -1``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np

from mfm_tpu_torch.data.columns import (
    col_max,
    drop_duplicates,
    ffill,
    group_ids,
    isin,
    nrows,
    reindex,
    select,
    sort_values,
    take,
    yyyymmdd_dates,
)
from mfm_tpu_torch.data.pit import asof_join, dedup_statements, fill_missing
from mfm_tpu_torch.panel import Panel

#: projections per collection
DAILY_FIELDS = ("close", "total_mv", "circ_mv", "pb", "turnover_rate", "pe_ttm")
BALANCE_FIELDS = ("total_ncl", "total_hldr_eqy_inc_min_int")
INDICATOR_FIELDS = ("q_profit_yoy", "q_sales_yoy", "debt_to_assets")
CASHFLOW_FIELDS = ("n_cashflow_act",)

#: the master-table fill set, numeric part
FILL_FIELDS = ("pe_ttm", "pb", "total_ncl", "total_hldr_eqy_inc_min_int",
               "debt_to_assets", "q_sales_yoy", "q_profit_yoy",
               "n_cashflow_act")
#: announcement/report date columns, ffilled but never zero-filled (see
#: module docstring)
FILL_DATE_COLS = ("balance_sheet_f_ann_date", "financial_indicators_ann_date",
                  "cashflow_f_ann_date", "end_date")


def _to_dt(df: dict, col: str) -> dict:
    out = dict(df)
    out[col] = yyyymmdd_dates(out[col], col)
    return out


def _rename(df: dict, mapping: dict) -> dict:
    return {mapping.get(k, k): v for k, v in df.items()}


def latest_index_constituents(store, index_code: str) -> list:
    """Universe selection: constituents at the newest trade_date recorded for
    ``index_code``."""
    comp = store.read("index_components")
    if not nrows(comp):
        raise ValueError("index_components collection is empty")
    comp = take(comp, np.asarray(comp["index_code"]) == index_code)
    if not nrows(comp):
        raise ValueError(f"no index_components rows for {index_code!r}")
    latest = col_max(comp["trade_date"])
    con = np.asarray(comp["con_code"])[np.asarray(comp["trade_date"])
                                       == latest]
    return sorted(set(con.tolist()))


def dedup_indicators(df: dict, by="ts_code", ann_col="ann_date",
                     end_col="end_date") -> dict:
    """The financial-indicator dedup is SINGLE-pass: keep the latest report
    period per (stock, announcement date)."""
    df = sort_values(df, [by, ann_col, end_col], [True, True, False])
    return drop_duplicates(df, [by, ann_col])


def _window(df: dict, col: str, lo, hi) -> dict:
    """Rows with ``lo <= df[col] <= hi`` (each bound optional; a date
    column compares against the bound read as a date)."""
    c = np.asarray(df[col])
    keep = np.ones(len(c), bool)
    for bound, ge in ((lo, True), (hi, False)):
        if bound is None:
            continue
        b = yyyymmdd_dates([bound])[0] if c.dtype.kind == "M" else bound
        keep &= (c >= b) if ge else (c <= b)
    return take(df, keep)


def load_and_prepare_data(
    store,
    index_code: str = "000300.SH",
    start_date: str | None = "20200101",
    end_date: str | None = None,
    fin_start_date: str | None = "20190101",
    median_fill: bool = False,
):
    """Store -> (master long table, index prices table, sw industry table),
    each a dict of numpy columns; :func:`prepare_factor_inputs` densifies
    them."""
    universe = latest_index_constituents(store, index_code)

    daily = store.read("daily_prices")
    daily = take(daily, isin(daily["ts_code"], universe))
    daily = _window(daily, "trade_date", start_date, end_date)
    daily = _to_dt(select(daily, ["ts_code", "trade_date", *DAILY_FIELDS]),
                   "trade_date")

    def _stmt(name, ann_col, cols):
        df = store.read(name)
        if not nrows(df):
            raise ValueError(f"collection {name!r} is empty")
        df = take(df, isin(df["ts_code"], universe))
        df = _window(df, "end_date", fin_start_date, end_date)
        df = select(df, ["ts_code", ann_col, "end_date", *cols])
        return _to_dt(_to_dt(df, ann_col), "end_date")

    balance = dedup_statements(
        _stmt("balancesheet", "f_ann_date", BALANCE_FIELDS))
    cashflow = dedup_statements(
        _stmt("cashflow", "f_ann_date", CASHFLOW_FIELDS))
    indicators = dedup_indicators(
        _stmt("financial_indicators", "ann_date", INDICATOR_FIELDS))

    index_px = store.read("index_daily_prices")
    index_px = take(index_px, np.asarray(index_px["ts_code"]) == index_code)
    index_px = _window(index_px, "trade_date", start_date, end_date)
    index_px = _to_dt(select(index_px, ["ts_code", "trade_date", "close"]),
                      "trade_date")

    sw = store.read("sw_industries")
    sw = {c: sw[c] for c in ("ts_code", "l1_code", "l1_name", "in_date",
                             "out_date", "is_new") if c in sw}

    # --- PIT join chain -----------------------------------------------------
    # rename the announcement columns up front; drop the balancesheet and
    # indicator report periods so the surviving end_date is the cashflow's
    balance = _rename(balance, {"f_ann_date": "balance_sheet_f_ann_date"})
    del balance["end_date"]
    indicators = _rename(indicators,
                         {"ann_date": "financial_indicators_ann_date"})
    del indicators["end_date"]
    cashflow = _rename(cashflow, {"f_ann_date": "cashflow_f_ann_date"})

    master = asof_join(daily, balance, left_on="trade_date",
                       right_on="balance_sheet_f_ann_date")
    master = asof_join(master, indicators, left_on="trade_date",
                       right_on="financial_indicators_ann_date")
    master = asof_join(master, cashflow, left_on="trade_date",
                       right_on="cashflow_f_ann_date")

    # --- fill policy --------------------------------------------------------
    master = fill_missing(master, FILL_FIELDS, median_fill=median_fill)
    gid = group_ids(master, ["ts_code"])
    for c in FILL_DATE_COLS:
        if c in master:
            master[c] = ffill(master[c], gid)
    return master, index_px, sw


def sw_l1_map(sw: dict, stocks: Sequence) -> np.ndarray:
    """Per-stock SW L1 code, aligned to ``stocks``: current membership wins
    (``is_new == 'Y'`` where the column exists, else the last record), NaN
    for a stock with no record."""
    df = sw
    if nrows(df) and "is_new" in df:
        cur = take(df, np.asarray(df["is_new"]) == "Y")
        df = cur if nrows(cur) else df
    if not nrows(df):
        return np.full(len(stocks), np.nan, object)
    df = drop_duplicates(df, ["ts_code"], keep="last")
    out = reindex(df["ts_code"], df["l1_code"], np.asarray(stocks))
    return out.astype(object) if out.dtype.kind != "O" else out


@dataclasses.dataclass
class PreparedData:
    """Dense FactorEngine inputs + metadata, ready for
    :func:`mfm_tpu_torch.pipeline.run_factor_pipeline`."""

    fields: Dict[str, np.ndarray]   # (T, N) float arrays + int end_date_code
    index_close: np.ndarray         # (T,)
    industry_l1: np.ndarray         # (N,) SW L1 codes
    dates: np.ndarray               # (T,) datetime64[ns]
    stocks: np.ndarray              # (N,)


def prepare_factor_inputs(
    store,
    index_code: str = "000300.SH",
    start_date: str | None = "20200101",
    end_date: str | None = None,
    fin_start_date: str | None = "20190101",
    median_fill: bool = False,
) -> PreparedData:
    """The full store -> FactorEngine-fields path: universe, collections,
    dedup, PIT joins, fill, densify."""
    master, index_px, sw = load_and_prepare_data(
        store, index_code, start_date, end_date, fin_start_date, median_fill)
    return densify(master, index_px, sw)


def densify(master: dict, index_px: dict, sw: dict) -> PreparedData:
    """The master table, index prices and SW table as :class:`PreparedData`
    (:func:`prepare_factor_inputs`' last step)."""
    value_cols = list(dict.fromkeys(DAILY_FIELDS + FILL_FIELDS))
    p = Panel.from_long(master, value_cols=value_cols)

    # report id for the TTM kernel: rank-encode the (ffilled, never
    # zero-filled) cashflow end_date; NaT -> -1
    ed = np.asarray(master["end_date"])
    none = np.isnat(ed)
    codes = np.unique(ed[~none])
    rid_long = np.where(none, -1, np.searchsorted(codes, ed))
    rid = np.full((p.T, p.N), -1, np.int32)
    rid[np.searchsorted(p.dates, np.asarray(master["trade_date"])),
        np.searchsorted(p.stocks, np.asarray(master["ts_code"]))] = rid_long
    fields = dict(p.fields)
    fields["end_date_code"] = rid

    index_close = reindex(index_px["trade_date"], index_px["close"],
                          p.dates).astype(np.float64)
    return PreparedData(
        fields=fields,
        index_close=index_close,
        industry_l1=sw_l1_map(sw, p.stocks),
        dates=np.asarray(p.dates),
        stocks=np.asarray(p.stocks),
    )
