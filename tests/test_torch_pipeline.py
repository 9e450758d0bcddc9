"""The port's risk pipeline (``mfm_tpu_torch/pipeline.py``,
``data/barra.py``, ``data/synthetic.py``) against the JAX package's on the
CPU, at float64.

Both packages get the same barra table from ``synthetic_barra_table``
(the reference as a DataFrame, the port as a dict of numpy columns, its
pandas-free form) and the same injected ``sim_covs``; the reference runs
its Brent-Luk Jacobi (``MFM_EIGH_CPU_JACOBI_BATCH=1``), the port's
algorithm.  Outputs, tables and analytics are held to rtol 1e-8; the
append from a checkpoint is bitwise the suffix of a full run inside the
port, and within rtol 1e-8 across the packages in both directions.  The
reference configs use ``seed=13``, which changes no number under injected
draws and keeps these compiled steps apart from other files' in a shared
process.
"""

import dataclasses
import datetime
import subprocess
import sys
import textwrap
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from mfm_tpu import pipeline as ref_pipeline
from mfm_tpu.config import PipelineConfig as RefPipelineConfig
from mfm_tpu.config import QuarantinePolicy as RefPolicy
from mfm_tpu.config import RiskModelConfig as RefConfig
from mfm_tpu.data import barra as ref_barra
from mfm_tpu.data.synthetic import synthetic_barra_table as ref_table
from mfm_tpu_torch import PipelineConfig, RiskModelConfig
from mfm_tpu_torch.config import MeshConfig
from mfm_tpu_torch.convert import (
    pipeline_config_from_reference,
    state_to_numpy,
)
from mfm_tpu_torch.data import barra
from mfm_tpu_torch.data.synthetic import synthetic_barra_table
from mfm_tpu_torch.pipeline import (
    append_risk_pipeline,
    date_stamp,
    run_risk_pipeline,
    save_pipeline_state,
)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
T, N, P, Q, M = 120, 60, 6, 4, 8
K = 1 + P + Q
T0 = 100  # the checkpoint's dates; 20 appended
REF_RISK = {
    "default": RefConfig(eigen_n_sims=M, seed=13),
    "guarded": RefConfig(eigen_n_sims=M, seed=13,
                         quarantine=RefPolicy(enabled=True)),
    "incremental": RefConfig(eigen_n_sims=M, eigen_incremental=True,
                             seed=13),
}
TABLES = ("factor_returns", "r_squared", "specific_returns",
          "final_covariance", "lambda_series")


@pytest.fixture(autouse=True)
def _reference_jacobi(monkeypatch):
    monkeypatch.setenv("MFM_EIGH_CPU_JACOBI_BATCH", "1")


def _ref_cfg(mode):
    return RefPipelineConfig(risk=REF_RISK[mode], dtype="float64")


def _cfg(mode):
    return pipeline_config_from_reference(dataclasses.asdict(_ref_cfg(mode)))


@pytest.fixture(scope="module")
def case():
    df, style_names = ref_table(T=T, N=N, P=P, Q=Q, seed=0)
    table, names = synthetic_barra_table(T=T, N=N, P=P, Q=Q, seed=0)
    assert names == style_names
    d = np.random.default_rng(1).standard_normal((M, K, T))
    d -= d.mean(axis=-1, keepdims=True)
    sim = np.einsum("mkt,mlt->mkl", d, d) / (T - 1)
    return df, table, sim


def _injected(mode, sim, port):
    if mode == "incremental":
        return {}
    return {"sim_covs": torch.from_numpy(sim) if port else jnp.asarray(sim),
            "sim_length": T}


def _head(table, n_dates):
    """The table's rows on its first ``n_dates`` dates (DataFrame or dict)."""
    cut = np.unique(np.asarray(table["date"]))[n_dates]
    if isinstance(table, pd.DataFrame):
        return table[table["date"] < cut]
    keep = np.asarray(table["date"]) < cut
    return {k: np.asarray(v)[keep] for k, v in table.items()}


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, what, rtol=1e-8):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    if want.dtype.kind not in "fc":
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    finite = np.isfinite(want)
    scale = np.abs(want[finite]).max() if finite.any() else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-12 * scale,
                               err_msg=what)


def _close_outputs(got, want, what):
    for f in want._fields:
        _close(getattr(got, f), getattr(want, f), f"{what}: {f}")


# -- barra ingest ---------------------------------------------------------

def _messy_table(table):
    """The synthetic table with missing values in a float column, a style
    and the (string) industry column."""
    t = {k: np.array(v, dtype=object if k == "industry" else None, copy=True)
         for k, v in table.items()}
    rng = np.random.default_rng(2)
    R = len(t["ret"])
    t["ret"][rng.random(R) < 0.01] = np.nan
    t["style_1"][rng.random(R) < 0.01] = np.nan
    t["industry"][rng.random(R) < 0.01] = None
    return t


COO_FIELDS = ("dates", "stocks", "industry_codes", "ti", "si", "ret_v",
              "cap_v", "styles_v", "industry_v")


@pytest.mark.parametrize("variant", ["plain", "messy", "unknown_codes",
                                     "pinned_stocks", "keep_nan_rows"])
def test_barra_ingest_matches_reference_from_dataframe_and_dict(case,
                                                                variant):
    _, table, _ = case
    table = _messy_table(table) if variant != "plain" else table
    kw = {}
    if variant == "unknown_codes":
        # a code the table lacks, and two of its codes left out (-> -1)
        kw["industry_codes"] = np.array(["sw00", "sw03", "sw04", "sw05",
                                         "sw99"])
    if variant == "pinned_stocks":
        stocks = np.unique(table["stocknames"])[::-1]
        kw["stocks"] = np.concatenate([stocks, ["999999.SZ"]])
    if variant == "keep_nan_rows":
        kw["drop_any_nan"] = False
        table = {k: v for k, v in table.items() if k != "industry"}
        table["industry"] = np.asarray(_messy_table(case[1])["industry"],
                                       dtype=str)
    df = pd.DataFrame(table)
    want = ref_barra.barra_frame_to_coo(df, **kw)
    want_arrays = want.to_arrays()
    for src in (df, table):
        got = barra.barra_frame_to_coo(src, **kw)
        assert got.style_names == want.style_names
        for f in COO_FIELDS:
            a, b = getattr(got, f), getattr(want, f)
            np.testing.assert_array_equal(a, b, err_msg=f)
            if b.dtype.kind in "fiu":
                assert a.dtype == b.dtype, f
        arrays = got.to_arrays()
        for f in ("ret", "cap", "styles", "industry", "valid"):
            np.testing.assert_array_equal(getattr(arrays, f),
                                          getattr(want_arrays, f), err_msg=f)
        assert arrays.factor_names() == want_arrays.factor_names()
    if variant == "unknown_codes":
        assert (got.industry_v == -1).any()
    if variant == "pinned_stocks":
        assert not arrays.valid[:, -1].any()


def test_barra_ingest_refuses_a_stock_off_the_pinned_axis(case):
    _, table, _ = case
    stocks = np.unique(table["stocknames"])[1:]
    for src in (table, pd.DataFrame(table)):
        with pytest.raises(ValueError, match="pinned stock axis"):
            barra.barra_frame_to_coo(src, stocks=stocks)
    empty = {k: v[:0] for k, v in table.items()}
    with pytest.raises(ValueError, match="no rows survive"):
        barra.barra_frame_to_coo(empty)


def test_synthetic_barra_table_is_the_reference_table(case):
    df, table, _ = case
    assert list(table) == list(df.columns)
    for k, v in table.items():
        assert v.ndim == 1 and len(v) == len(df)
        np.testing.assert_array_equal(v, df[k].to_numpy(), err_msg=k)


@pytest.mark.parametrize("d", [
    "2020-01-02", "20200102", " 2021-12-31 ", "2020-01-02 15:30:00",
    np.str_("20231130"), np.datetime64("2020-03-04"),
    np.datetime64("2020-03-04T23:59:59"), np.datetime64("1969-12-31T12:00"),
    np.datetime64("NaT"), pd.Timestamp("2021-06-30 10:00"),
    datetime.date(2022, 2, 3), datetime.datetime(2022, 2, 3, 4, 5),
    "not a date",
    # the forms pd.Timestamp reads beyond ISO
    "2023/11/30", "30/11/2023", "11/30/2023", "Nov 30 2023", "2023-1-5",
    "01/02/2023", "2023.11.30", "30-Nov-2023", "November 30, 2023",
    "Thursday, November 30, 2023", "2023 Nov 30", "2023/11/30 15:30",
    np.str_("2023/11/30"), "Nov 2023", "2023/11", "11/2023",
    # and what it refuses
    "2023/02/30", "13/13/2023", "2023-13-01", "20231301", "30/11/2023 25:00",
])
def test_date_stamp_is_the_reference_stamp(d):
    # a dict table's dates are np.str_, a DataFrame's str: the port stamps
    # both as the reference stamps the DataFrame's
    with warnings.catch_warnings():  # pandas warns on day-first parses
        warnings.simplefilter("ignore", UserWarning)
        want = ref_pipeline.date_stamp(str(d) if isinstance(d, np.str_)
                                       else d)
    assert date_stamp(d) == want


@pytest.mark.parametrize("d", [20231130, np.int64(20231130),
                               np.int32(20200102)])
def test_date_stamp_reads_an_eight_digit_integer_as_yyyymmdd(d):
    """``pd.read_csv`` of a tushare date column gives integers.  The
    reference stamps every one ``"1970-01-01"`` (``pd.Timestamp`` counts
    an integer as nanoseconds), so it can never append such a table; the
    port stamps the integer as the ISO date its digits name, as it stamps
    the same 8-digit string."""
    assert ref_pipeline.date_stamp(d) == "1970-01-01"
    assert date_stamp(d) == date_stamp(str(int(d))) \
        == f"{int(d) // 10000}-{int(d) // 100 % 100:02d}-{int(d) % 100:02d}"
    assert date_stamp(123) == "123" and date_stamp(True) == "True"


# -- the whole pipeline ---------------------------------------------------

@pytest.fixture(scope="module")
def runs(case):
    df, table, sim = case
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MFM_EIGH_CPU_JACOBI_BATCH", "1")
        ref = ref_pipeline.run_risk_pipeline(
            df, config=_ref_cfg("default"), **_injected("default", sim, False))
    port = run_risk_pipeline(table, config=_cfg("default"), device="cpu",
                             **_injected("default", sim, True))
    return ref, port


def test_run_risk_pipeline_matches_reference(runs):
    ref, port = runs
    assert port.outputs.eigen_valid.any()
    _close_outputs(port.outputs, ref.outputs, "run_risk_pipeline")
    for name in TABLES:
        got, want = getattr(port, name)(), getattr(ref, name)()
        assert list(got.index) == list(want.index), name
        assert list(got.columns) == list(want.columns), name
        _close(got.to_numpy(), want.to_numpy(), name)


def test_specific_and_portfolio_risk_match_reference(runs):
    ref, port = runs
    for got, want in zip(port.specific_risk(), ref.specific_risk()):
        assert list(got.columns) == list(want.columns)
        _close(got.to_numpy(), want.to_numpy(), "specific_risk")
    a = port.arrays
    t = T - 1
    _, valid, _ = port._design(slice(t, t + 1))
    w = np.where(valid[0].numpy(), np.arange(N) % 7 + 1.0, 0.0)
    w /= w.sum()
    got, want = port.portfolio_risk(w, t=t), ref.portfolio_risk(w, t=t)
    assert got["date"] == want["date"] == a.dates[t]
    for k in ("factor_var", "specific_var", "total_vol"):
        _close(got[k], want[k], k)
    for k in ("factor_exposures", "factor_risk_contribution"):
        assert list(got[k].index) == list(want[k].index)
        _close(got[k].to_numpy(), want[k].to_numpy(), k)
    for bad in (T, -T - 1):
        with pytest.raises(IndexError):
            port.portfolio_risk(w, t=bad)
    with pytest.raises(ValueError, match="outside"):
        port.portfolio_risk(np.where(valid[0].numpy(), 0.0, 1.0), t=t)


def test_portfolio_bias_matches_reference(runs):
    ref, port = runs
    got, want = port.portfolio_bias(n_portfolios=20, burn_in=60), \
        ref.portfolio_bias(n_portfolios=20, burn_in=60)
    assert "after_burn_in_60" in got
    assert got == want


def test_load_risk_pipeline_result_matches_reference(case, runs, tmp_path):
    """A pipeline output directory as the reference's CLI writes it (barra
    table, industry code list, risk_outputs.npz) rehydrates alike."""
    from mfm_tpu.data.artifacts import save_risk_outputs as ref_save_outputs
    from mfm_tpu_torch.pipeline import load_risk_pipeline_result

    df, _, _ = case
    ref = runs[0]
    df.to_csv(tmp_path / "barra_data.csv", index=False)
    pd.DataFrame({"code": np.unique(df["industry"])}).to_csv(
        tmp_path / "industry_info.csv", index=False)
    ref_save_outputs(str(tmp_path / "risk_outputs.npz"), ref.outputs,
                     meta={"dates": [date_stamp(ref.arrays.dates[0]),
                                     date_stamp(ref.arrays.dates[-1])]})
    want = ref_pipeline.load_risk_pipeline_result(str(tmp_path))
    got = load_risk_pipeline_result(str(tmp_path), device="cpu")
    assert got.model is None and got.state is None
    _close_outputs(got.outputs, want.outputs, "rehydrated")
    for f in ("dates", "stocks", "ret", "cap", "styles", "industry", "valid"):
        np.testing.assert_array_equal(getattr(got.arrays, f),
                                      getattr(want.arrays, f), err_msg=f)
    assert got.portfolio_bias(n_portfolios=5) == \
        want.portfolio_bias(n_portfolios=5)
    ref_save_outputs(str(tmp_path / "risk_outputs.npz"), ref.outputs,
                     meta={"dates": ["2019-01-02", "2019-06-28"]})
    with pytest.raises(ValueError, match="artifact was saved for"):
        load_risk_pipeline_result(str(tmp_path), device="cpu")


# -- the daily append -----------------------------------------------------

def _same(a, b) -> bool:
    a, b = _np(a), _np(b)
    return np.array_equal(a, b, equal_nan=a.dtype.kind in "fc")


@pytest.mark.parametrize("mode", ["default", "guarded", "incremental"])
def test_append_is_the_bitwise_suffix_of_a_full_run(case, tmp_path, mode):
    _, table, sim = case
    cfg, kw = _cfg(mode), _injected(mode, sim, True)
    full = run_risk_pipeline(table, config=cfg, with_state=True,
                             device="cpu", **kw)
    head = run_risk_pipeline(_head(table, T0), config=cfg, with_state=True,
                             device="cpu", **kw)
    path = str(tmp_path / "ckpt" / "state.npz")
    save_pipeline_state(path, head)
    app = append_risk_pipeline(path, table, config=cfg, device="cpu")
    assert list(app.arrays.dates) == list(full.arrays.dates[T0:])
    for f in full.outputs._fields:
        assert _same(getattr(app.outputs, f), getattr(full.outputs, f)[T0:]), f
    got, want = state_to_numpy(app.state), state_to_numpy(full.state)
    # the init-time T*M; and the trailing-universe ring, which a full run
    # seeds in date order and the updates rotate (same counts, same median)
    for k in ("eigen_batch_hint", "guard_ring", "guard_ring_pos"):
        got.pop(k, None), want.pop(k, None)
    for k, v in want.items():
        assert _same(got[k], v) if isinstance(v, np.ndarray) else got[k] == v, k
    assert app.state.last_date == full.state.last_date \
        == date_stamp(table["date"][-1])
    if mode == "guarded":
        assert not app.report.quarantined.any()
    # the checkpoint already covers the table: nothing to append
    save_pipeline_state(path, app)
    with pytest.raises(ValueError, match="already covers"):
        append_risk_pipeline(path, table, config=cfg, device="cpu")


def test_guarded_append_quarantines_a_collapsed_date(case, tmp_path):
    _, table, sim = case
    cfg, kw = _cfg("guarded"), _injected("guarded", sim, True)
    head = run_risk_pipeline(_head(table, T0), config=cfg, with_state=True,
                             device="cpu", **kw)
    path = str(tmp_path / "state.npz")
    save_pipeline_state(path, head)
    dates = np.unique(table["date"])
    bad_date = dates[T0 + 5]
    industry = table["industry"]
    first = np.zeros(len(industry), bool)
    for code in np.unique(industry):  # each industry's first member stays
        first |= table["stocknames"] == table["stocknames"][industry == code][0]
    on_date = np.nonzero(table["date"] == bad_date)[0]
    rng = np.random.default_rng(3)
    droppable = on_date[~first[on_date]]
    drop = rng.choice(droppable, int(0.6 * len(on_date)), replace=False)
    keep = np.ones(len(industry), bool)
    keep[drop] = False
    poisoned = {k: v[keep] for k, v in table.items()}
    app = append_risk_pipeline(path, poisoned, config=cfg, device="cpu")
    assert np.nonzero(app.report.quarantined.numpy())[0].tolist() == [5]
    assert int(app.state.quarantine_count) == 1


def _dated(case, mode):
    """(mode, DataFrame, dict table) of an append case: ``slash_dates`` is
    the default mode over the tables with YYYY/MM/DD date strings."""
    df, table, _ = case
    if mode != "slash_dates":
        return mode, df, table
    table = dict(table, date=np.char.replace(table["date"], "-", "/"))
    return "default", pd.DataFrame(table), table


@pytest.mark.parametrize("mode", ["default", "incremental", "slash_dates"])
def test_reference_checkpoint_appends_in_the_port(case, tmp_path, mode):
    mode, df, table = _dated(case, mode)
    sim = case[2]
    head = ref_pipeline.run_risk_pipeline(
        _head(df, T0), config=_ref_cfg(mode), with_state=True,
        **_injected(mode, sim, False))
    path = str(tmp_path / "ref" / "state.npz")
    ref_pipeline.save_pipeline_state(path, head)
    want = ref_pipeline.append_risk_pipeline(path, df, config=_ref_cfg(mode))
    got = append_risk_pipeline(path, table, config=_cfg(mode), device="cpu")
    assert len(got.arrays.dates) == T - T0
    assert list(got.arrays.dates) == list(want.arrays.dates)
    _close_outputs(got.outputs, want.outputs, f"{mode} append")
    assert got.state.stamp == want.state.stamp
    assert got.state.last_date == want.state.last_date


@pytest.mark.parametrize("mode", ["default", "incremental", "slash_dates"])
def test_port_checkpoint_appends_in_the_reference(case, tmp_path, mode):
    mode, df, table = _dated(case, mode)
    sim = case[2]
    head = run_risk_pipeline(_head(table, T0), config=_cfg(mode),
                             with_state=True, device="cpu",
                             **_injected(mode, sim, True))
    path = str(tmp_path / "port" / "state.npz")
    save_pipeline_state(path, head)
    want = append_risk_pipeline(path, table, config=_cfg(mode), device="cpu")
    got = ref_pipeline.append_risk_pipeline(path, df, config=_ref_cfg(mode))
    assert len(got.arrays.dates) == len(want.arrays.dates) == T - T0
    _close_outputs(got.outputs, want.outputs, f"{mode} append")
    assert got.state.last_date == want.state.last_date


# -- configuration and what is left out -----------------------------------

def test_pipeline_config_from_reference_keeps_the_risk_config():
    from mfm_tpu.config import FactorConfig as RefFactorConfig
    from mfm_tpu.config import RollingSpec as RefRollingSpec
    from mfm_tpu_torch import FactorConfig, RollingSpec

    factors = RefFactorConfig(
        beta=RefRollingSpec(window=40, half_life=10, min_periods=8),
        rstr_lag=5, factors_to_run=("SIZE", "BETA"),
        ortho_rules=(("volatility", ("BETA",)),))
    ref = RefPipelineConfig(risk=RefConfig(eigen_n_sims=17, seed=3,
                                           eigen_mc_dtype="bfloat16"),
                            factors=factors, dtype="float64", block=32,
                            rolling_impl="block")
    got = pipeline_config_from_reference(dataclasses.asdict(ref))
    assert got.risk.identity() == ref.risk.identity()
    assert got.dtype == "float64" and got.mesh == MeshConfig()
    assert got.block == 32 and got.rolling_impl == "block"
    assert isinstance(got.factors, FactorConfig)
    assert got.factors.beta == RollingSpec(window=40, half_life=10,
                                           min_periods=8)
    assert dataclasses.asdict(got.factors) == dataclasses.asdict(factors)
    assert pipeline_config_from_reference(
        dataclasses.asdict(RefPipelineConfig())) == PipelineConfig()
    assert PipelineConfig().dtype == "float32"
    # the mesh is ported (§A 16d): any shard counts carry over
    assert pipeline_config_from_reference(
        {"mesh": {"n_date_shards": 2, "n_stock_shards": 1}}).mesh \
        == MeshConfig(2, 1)
    with pytest.raises(ValueError):
        pipeline_config_from_reference({"no_such_field": 1})
    with pytest.raises(ValueError):
        PipelineConfig(dtype="float16")


@pytest.mark.parametrize("call,item", [("run", 16), ("append", 16)],
                         ids=["<lambda>-16_0", "<lambda>-16_1"])
def test_parts_left_out_raise_naming_their_roadmap_item(call, item, case,
                                                        tmp_path,
                                                        monkeypatch):
    """``mesh=`` is ported (§A 16d): on a virtual 2x2 mesh the shard-local
    pipeline run is bitwise the dense run (its arrays left undensified),
    and the sharded guarded append is bitwise the unsharded append,
    outputs and state; both within 1e-8 of the reference's ``mesh=`` runs
    at float64."""
    import jax

    from mfm_tpu.parallel.mesh import make_mesh as ref_make_mesh
    from mfm_tpu_torch._device import VIRTUAL_DEVICES_ENV
    from mfm_tpu_torch.parallel.mesh import make_mesh

    monkeypatch.setenv(VIRTUAL_DEVICES_ENV, "4")
    mesh = make_mesh(2, 2, device="cpu")
    df, table, sim = case
    if call == "run":
        cfg, kw = _cfg("default"), _injected("default", sim, True)
        dense = run_risk_pipeline(table, config=cfg, device="cpu", **kw)
        got = run_risk_pipeline(table, config=cfg, device="cpu", mesh=mesh,
                                **kw)
        assert not got.arrays.densified
        for f in dense.outputs._fields:
            assert _same(getattr(got.outputs, f),
                         getattr(dense.outputs, f)), f
        want = ref_pipeline.run_risk_pipeline(
            df, config=_ref_cfg("default"),
            mesh=ref_make_mesh(2, 2, devices=jax.devices()[:4]),
            **_injected("default", sim, False))
        _close_outputs(got.outputs, want.outputs, "mesh run")
        return
    cfg, kw = _cfg("guarded"), _injected("guarded", sim, True)
    head = run_risk_pipeline(_head(table, T0), config=cfg, with_state=True,
                             device="cpu", **kw)
    paths = [str(tmp_path / name / "state.npz") for name in ("a", "b", "c")]
    for path in paths:
        save_pipeline_state(path, head)
    plain = append_risk_pipeline(paths[0], table, config=cfg, device="cpu")
    sharded = append_risk_pipeline(paths[1], table, config=cfg, device="cpu",
                                   mesh=mesh)
    for f in plain.outputs._fields:
        assert _same(getattr(sharded.outputs, f),
                     getattr(plain.outputs, f)), f
    for f in plain.report._fields:
        assert _same(getattr(sharded.report, f), getattr(plain.report, f)), f
    got, want = state_to_numpy(sharded.state), state_to_numpy(plain.state)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert _same(got[k], v) if isinstance(v, np.ndarray) \
            else got[k] == v, k
    ref = ref_pipeline.append_risk_pipeline(
        paths[2], df, config=_ref_cfg("guarded"),
        mesh=ref_make_mesh(2, 2, devices=jax.devices()[:4]))
    _close_outputs(sharded.outputs, ref.outputs, "mesh append")
    with pytest.raises(ValueError, match="must divide"):
        append_risk_pipeline(paths[0], table, config=cfg, device="cpu",
                             mesh=make_mesh(3, 1, device="cpu"))


def test_query_engine_is_left_out(runs):
    """Formerly left out (ROADMAP.md §A 10), now ported: the default
    engine of the last date serves the adjusted covariance, stale 0, and
    answers as the reference's does."""
    ref, port = runs
    got, want = port.query_engine(), ref.query_engine()
    assert got.staleness == want.staleness == 0
    assert got.factor_names == want.factor_names
    _close(got._cov, port.outputs.vr_cov[-1], "served cov", rtol=0)
    W = np.abs(np.random.default_rng(4).standard_normal((3, N))) \
        * np.asarray(want._X).any(1)
    for f, g, w in zip(want.query(W)._fields, got.query(W), want.query(W)):
        _close(g, w, f)


def test_pipeline_runs_without_pandas():
    """Importing the port and running the pipeline with its analytics on a
    dict table needs no pandas."""
    code = textwrap.dedent("""
        import sys
        sys.modules["pandas"] = None
        import numpy as np
        import torch
        import mfm_tpu_torch
        from mfm_tpu_torch import pipeline
        from mfm_tpu_torch.data import barra, synthetic
        from mfm_tpu_torch.models.bias import bias_stats_summary
        torch.set_num_threads(2)
        table, _ = synthetic.synthetic_barra_table(T=80, N=30, P=3, Q=2)
        cfg = mfm_tpu_torch.PipelineConfig(
            risk=mfm_tpu_torch.RiskModelConfig(eigen_n_sims=4))
        r = pipeline.run_risk_pipeline(table, config=cfg, device="cpu")
        raw, shrunk = r._specific_panels(42.0, 10, 1.0, 10)
        w = np.where(r._design(slice(79, 80))[1][0].numpy(), 1.0, 0.0)
        risk = r._portfolio_risk(w / w.sum(), -1, None, 42.0, 10, 1.0, 10)
        bias = r.portfolio_bias(n_portfolios=5, burn_in=40)
        o = r.outputs
        summary = bias_stats_summary(o.nw_cov, o.nw_valid, o.eigen_cov,
                                     o.eigen_valid, o.factor_ret, burn_in=40)
        assert np.isfinite(risk["total_vol"]) and "pandas" not in str(bias)
        assert summary["all_valid_dates"]["eigen_adjusted"]["bias"]
        try:
            r.factor_returns()
        except ImportError:
            print("tables need pandas")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "tables need pandas"
