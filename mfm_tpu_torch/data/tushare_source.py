"""Tushare Pro adapter, the fetch layer (counterpart of
``mfm_tpu/data/tushare_source.py``).

Wraps the same endpoints with the token taken from the environment and
the client injectable for tests.  The client's frames come back as column
tables (:func:`mfm_tpu_torch.data.columns.as_table`, which reads a
DataFrame without importing pandas).  The ``tushare`` import is guarded:
constructing :class:`TushareSource` without a client and without tushare
raises a clear error, and everything downstream
(:mod:`mfm_tpu_torch.data.etl`) accepts any object with the same fetch
methods.
"""

from __future__ import annotations

import os

from mfm_tpu_torch.data.columns import as_table

BALANCESHEET_FIELDS = (
    "ts_code,ann_date,f_ann_date,end_date,report_type,comp_type,"
    "total_share,cap_rese,undistr_porfit,surplus_rese,special_rese,"
    "money_cap,total_assets,total_liab,total_hldr_eqy_inc_min_int,"
    "total_ncl,total_cur_liab"
)
CASHFLOW_FIELDS = (
    "ts_code,ann_date,f_ann_date,end_date,comp_type,report_type,"
    "net_profit,finan_exp,c_fr_sale_sg,c_inf_fr_operate_a,"
    "n_cashflow_act,n_cashflow_inv_act,n_cash_flows_fnc_act"
)
INCOME_FIELDS = (
    "ts_code,ann_date,f_ann_date,end_date,report_type,comp_type,"
    "basic_eps,diluted_eps,total_revenue,revenue,operate_profit,"
    "total_profit,n_income,n_income_attr_p"
)
FINA_INDICATOR_FIELDS = (
    "ts_code,ann_date,end_date,eps,dt_eps,total_revenue_ps,revenue_ps,"
    "bps,roe,roa,npta,debt_to_assets,q_profit_yoy,q_sales_yoy,"
    "q_op_yoy,ocf_yoy,roe_yoy"
)
DAILY_BASIC_FIELDS = (
    "ts_code,trade_date,close,turnover_rate,turnover_rate_f,volume_ratio,"
    "pe,pe_ttm,pb,ps,ps_ttm,dv_ratio,dv_ttm,total_share,float_share,"
    "free_share,total_mv,circ_mv"
)


class TushareSource:
    """Fetch methods named to match
    :class:`mfm_tpu_torch.data.etl.IncrementalUpdater`; each returns a
    column table."""

    def __init__(self, client=None, token: str | None = None):
        if client is None:
            try:
                import tushare as ts
            except ImportError as e:  # pragma: no cover
                raise ImportError(
                    "tushare is not installed; pass an explicit client or use "
                    "a fake source"
                ) from e
            token = token or os.environ.get("TUSHARE_TOKEN")
            if not token:
                raise ValueError("set TUSHARE_TOKEN or pass token=")
            ts.set_token(token)
            client = ts.pro_api()
        self.pro = client

    # --- market data -----------------------------------------------------
    def fetch_stock_info(self):
        return as_table(self.pro.stock_basic(
            exchange="", list_status="L",
            fields="ts_code,symbol,name,area,industry,list_date"))

    def fetch_daily_prices(self, trade_date):
        return as_table(self.pro.daily_basic(trade_date=trade_date,
                                             fields=DAILY_BASIC_FIELDS))

    def fetch_daily_prices_by_stock(self, ts_code, start_date=None,
                                    end_date=None):
        # the repair tool's per-stock variant
        return as_table(self.pro.daily_basic(
            ts_code=ts_code, start_date=start_date, end_date=end_date,
            fields=DAILY_BASIC_FIELDS))

    def fetch_trade_calendar(self, start_date, end_date):
        cal = as_table(self.pro.trade_cal(exchange="SSE",
                                          start_date=start_date,
                                          end_date=end_date, is_open="1"))
        return list(cal["cal_date"].tolist())

    # --- statements (per stock) -----------------------------------------
    def fetch_balancesheet_by_stock(self, ts_code, start_date=None,
                                    end_date=None):
        return as_table(self.pro.balancesheet(
            ts_code=ts_code, start_date=start_date, end_date=end_date,
            fields=BALANCESHEET_FIELDS))

    def fetch_cashflow_by_stock(self, ts_code, start_date=None, end_date=None):
        return as_table(self.pro.cashflow(
            ts_code=ts_code, start_date=start_date, end_date=end_date,
            fields=CASHFLOW_FIELDS))

    def fetch_income_by_stock(self, ts_code, start_date=None, end_date=None):
        return as_table(self.pro.income(
            ts_code=ts_code, start_date=start_date, end_date=end_date,
            fields=INCOME_FIELDS))

    def fetch_financial_indicators_by_stock(self, ts_code, start_date=None,
                                            end_date=None):
        return as_table(self.pro.fina_indicator(
            ts_code=ts_code, start_date=start_date, end_date=end_date,
            fields=FINA_INDICATOR_FIELDS))

    # --- indices ---------------------------------------------------------
    def fetch_index_info(self):
        return as_table(self.pro.index_basic(market="SSE"))

    def fetch_daily_index_prices(self, ts_code, start_date=None,
                                 end_date=None):
        return as_table(self.pro.index_daily(
            ts_code=ts_code, start_date=start_date, end_date=end_date))

    def fetch_index_components(self, index_code, trade_date):
        return as_table(self.pro.index_weight(index_code=index_code,
                                              trade_date=trade_date))

    def fetch_sw_industries(self, ts_code):
        return as_table(self.pro.index_member_all(ts_code=ts_code))
