"""The port's factor production end to end (``mfm_tpu_torch/pipeline.py``
``run_factor_pipeline`` and its parts, ``data/synthetic.py``
``synthetic_market_panel``) against the JAX package's, on the CPU.

Both packages get the same raw market panel (bitwise: the same numpy
draws), produce the barra table, and run the risk model over it with the
same injected ``sim_covs``; the reference runs its Brent-Luk Jacobi
(``MFM_EIGH_CPU_JACOBI_BATCH=1``), the port's algorithm.  At float64 the
table, the factors and the nine risk outputs are held to rtol 1e-8 with
identical NaN patterns; at float32 the factors sit within the ``factors``
budgets of ``tools/parity_budget.json``.
"""

import dataclasses
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from mfm_tpu import pipeline as ref_pipeline
from mfm_tpu.config import FactorConfig as RefFactorConfig
from mfm_tpu.config import PipelineConfig as RefPipelineConfig
from mfm_tpu.config import RiskModelConfig as RefConfig
from mfm_tpu.config import RollingSpec as RefRollingSpec
from mfm_tpu.data import synthetic as ref_synthetic
from mfm_tpu.factors.engine import FactorEngine as RefFactorEngine
from mfm_tpu_torch import FactorEngine, PipelineConfig
from mfm_tpu_torch.convert import budget_check, pipeline_config_from_reference
from mfm_tpu_torch.data import synthetic
from mfm_tpu_torch.pipeline import (
    BARRA_OUTPUT_STYLES,
    assemble_barra_table,
    run_factor_pipeline,
    run_risk_pipeline,
    shift_ret_next_period,
)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
M = 8
FIELDS = ("close", "total_mv", "circ_mv", "turnover_rate", "pb", "pe_ttm",
          "n_cashflow_act", "end_date_code", "q_profit_yoy", "q_sales_yoy",
          "total_ncl", "total_hldr_eqy_inc_min_int", "debt_to_assets")
SHORT = RefFactorConfig(
    beta=RefRollingSpec(window=40, half_life=10, min_periods=8),
    rstr_total=60, rstr_lag=5, rstr_half_life=15, rstr_min_periods=8,
    dastd=RefRollingSpec(window=40, half_life=8, min_periods=8),
    cmra_window=30,
    stom=RefRollingSpec(window=10, min_periods=7),
    stoq=RefRollingSpec(window=21, min_periods=14),
    stoa=RefRollingSpec(window=42, min_periods=21),
)


@pytest.fixture(autouse=True)
def _reference_jacobi(monkeypatch):
    monkeypatch.setenv("MFM_EIGH_CPU_JACOBI_BATCH", "1")


def _close(got, want, what, rtol=1e-8):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    if want.dtype.kind not in "fc":
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want),
                                  err_msg=f"{what}: NaN pattern")
    m = np.isfinite(want)
    scale = np.abs(want[m]).max() if m.any() else 0.0
    np.testing.assert_allclose(got[m], want[m], rtol=rtol, atol=1e-12 * scale,
                               err_msg=what)


def _inputs(data):
    l1 = np.array([f"sw{c:02d}" for c in data["industry"]])
    return ({k: data[k] for k in FIELDS}, data["index_close"], l1,
            data["dates"], data["stocks"])


def _ref_config(dtype="float64", impl="scan"):
    return RefPipelineConfig(factors=SHORT, dtype=dtype, rolling_impl=impl,
                             risk=RefConfig(eigen_n_sims=M, seed=13))


def _config(dtype="float64", impl="scan"):
    return pipeline_config_from_reference(
        dataclasses.asdict(_ref_config(dtype, impl)))


# -- the synthetic market panel ---------------------------------------------------

@pytest.mark.parametrize("seed", [0, 11])
def test_synthetic_market_panel_is_the_reference_panel(seed):
    got = synthetic.synthetic_market_panel(T=150, N=30, n_industries=6,
                                           seed=seed)
    want = ref_synthetic.synthetic_market_panel(T=150, N=30, n_industries=6,
                                                seed=seed)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert synthetic.PANEL_META_KEYS == ref_synthetic.PANEL_META_KEYS
    fields = synthetic.panel_to_engine_fields(got, torch.float32, "cpu")
    ref_fields = ref_synthetic.panel_to_engine_fields(want, jnp.float32)
    assert list(fields) == list(ref_fields)
    for k, v in ref_fields.items():
        assert fields[k].dtype == (torch.float32 if k != "end_date_code"
                                   else torch.int64), k
        np.testing.assert_array_equal(fields[k].numpy(), np.asarray(v),
                                      err_msg=k)


# -- the barra table ------------------------------------------------------------------

def test_shift_ret_next_period_is_the_reference():
    ret = np.array([[0.1, 0.01], [0.2, np.nan], [0.3, 0.03], [np.nan, 0.04]])
    got = shift_ret_next_period(ret, np.isfinite(ret))
    np.testing.assert_array_equal(
        got, [[0.2, 0.03], [0.3, np.nan], [np.nan, 0.04], [np.nan, np.nan]])
    rng = np.random.default_rng(2)
    ret = rng.standard_normal((60, 9))
    obs = rng.random(ret.shape) > 0.25
    ret[~obs] = np.nan
    ret[rng.random(ret.shape) < 0.05] = np.nan  # observed, NaN return
    np.testing.assert_array_equal(
        shift_ret_next_period(ret, obs),
        ref_pipeline.shift_ret_next_period(ret, obs))


@pytest.fixture(scope="module")
def panel():
    return synthetic.synthetic_market_panel(T=140, N=30, n_industries=5,
                                            seed=11, missing=0.02,
                                            listing_gap=0.2)


def test_assemble_barra_table_is_the_reference_frame(panel):
    fields, index_close, l1, dates, stocks = _inputs(panel)
    factors = {k: np.asarray(v) for k, v in RefFactorEngine(
        ref_synthetic.panel_to_engine_fields(panel, jnp.float64),
        jnp.asarray(index_close), config=SHORT).run().items()}
    args = (dates, stocks, l1, fields["circ_mv"], panel["observed"])
    got = assemble_barra_table(factors, *args)
    assert list(got) == ["date", "stocknames", "capital", "ret", "industry"] \
        + [dst for _, dst in BARRA_OUTPUT_STYLES]
    assert all(isinstance(v, np.ndarray) and v.ndim == 1 for v in got.values())
    pd.testing.assert_frame_equal(
        pd.DataFrame(got), ref_pipeline.assemble_barra_table(factors, *args))


@pytest.fixture(scope="module")
def chains(panel):
    """The reference's and the port's raw-panel -> barra -> risk chains
    at float64, with the same injected sim_covs."""
    args = _inputs(panel)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MFM_EIGH_CPU_JACOBI_BATCH", "1")
        ref_barra, ref_factors = ref_pipeline.run_factor_pipeline(
            *args, _ref_config())
        got_barra, got_factors = run_factor_pipeline(*args, _config(),
                                                     device="cpu")
        T1 = len(np.unique(ref_barra["date"]))
        K = 1 + len(np.unique(ref_barra["industry"])) + 10
        d = np.random.default_rng(1).standard_normal((M, K, T1))
        d -= d.mean(axis=-1, keepdims=True)
        sim = np.einsum("mkt,mlt->mkl", d, d) / (T1 - 1)
        ref = ref_pipeline.run_risk_pipeline(
            ref_barra, config=_ref_config(), sim_covs=jnp.asarray(sim),
            sim_length=T1)
    port = run_risk_pipeline(got_barra, config=_config(), device="cpu",
                             sim_covs=torch.from_numpy(sim), sim_length=T1)
    return (ref_barra, ref_factors, ref), (got_barra, got_factors, port)


def test_run_factor_pipeline_matches_reference(chains):
    (ref_barra, ref_factors, _), (got_barra, got_factors, _) = chains
    assert set(got_factors) == set(ref_factors)
    for k, v in ref_factors.items():
        assert isinstance(got_factors[k], np.ndarray), k
        _close(got_factors[k], v, k)
    got = pd.DataFrame(got_barra)
    assert list(got.columns) == list(ref_barra.columns)
    assert len(got) == len(ref_barra)
    for c in ref_barra.columns:
        _close(got[c].to_numpy(), ref_barra[c].to_numpy(), c)


def test_factor_to_risk_chain_matches_reference(chains):
    (ref_barra, _, ref), (_, _, port) = chains
    # the ingest drops rows with a NaN style: fewer dates than the panel's
    assert len(port.arrays.dates) == len(ref.arrays.dates) < 140
    assert port.arrays.n_industries == ref.arrays.n_industries == 5
    assert bool(port.outputs.eigen_valid.any())
    for f in ref.outputs._fields:
        _close(getattr(port.outputs, f), getattr(ref.outputs, f), f)


@pytest.mark.parametrize("impl", ["scan", "block"])
def test_float32_factors_within_the_parity_budgets(impl):
    """The port at float32 against the reference at float32, both on the
    CPU, at the default windows: every output within its ``factors``
    budget (``default`` where the file names none), NaN patterns equal."""
    data = synthetic.synthetic_market_panel(T=600, N=30, n_industries=5,
                                            seed=4)
    want = RefFactorEngine(
        ref_synthetic.panel_to_engine_fields(data, jnp.float32),
        jnp.asarray(data["index_close"], jnp.float32), block=32,
        rolling_impl=impl).run()
    got = FactorEngine(
        synthetic.panel_to_engine_fields(data, torch.float32, "cpu"),
        torch.tensor(data["index_close"], dtype=torch.float32), block=32,
        rolling_impl=impl, device="cpu").run()
    assert all(v.dtype == torch.float32 for v in got.values())
    budget = json.loads((ROOT / "tools" / "parity_budget.json").read_text())
    records, failed = budget_check(
        {k: v.numpy() for k, v in got.items()},
        {k: np.asarray(v, np.float64) for k, v in want.items()},
        budget["factors"])
    assert set(records) == set(want)
    assert not failed, (failed, records)


def test_pipeline_config_validates_the_factor_fields():
    cfg = PipelineConfig()
    assert cfg.rolling_impl == "scan" and cfg.block is None
    assert dataclasses.asdict(cfg.factors) == dataclasses.asdict(
        RefFactorConfig())
    with pytest.raises(ValueError, match="rolling_impl"):
        PipelineConfig(rolling_impl="loop")
    for bad in (0, -3, True, 2.0):
        with pytest.raises(ValueError, match="block"):
            PipelineConfig(block=bad)
    with pytest.raises(ValueError, match="unknown to the port's FactorConfig"):
        pipeline_config_from_reference({"factors": {"beta_window": 3}})


def test_factor_pipeline_runs_without_pandas():
    """Raw panel -> barra table -> risk model, with pandas unimportable."""
    code = textwrap.dedent("""
        import sys
        sys.modules["pandas"] = None
        import numpy as np
        import torch
        from mfm_tpu_torch import (FactorConfig, PipelineConfig,
                                   RiskModelConfig, RollingSpec,
                                   run_factor_pipeline, run_risk_pipeline)
        from mfm_tpu_torch.data.synthetic import synthetic_market_panel
        torch.set_num_threads(2)
        data = synthetic_market_panel(T=120, N=24, n_industries=3, seed=2)
        fields = {k: v for k, v in data.items()
                  if k not in ("dates", "stocks", "industry", "index_close",
                               "observed")}
        cfg = PipelineConfig(
            factors=FactorConfig(
                beta=RollingSpec(40, 10, 8), rstr_total=60, rstr_lag=5,
                rstr_half_life=15, rstr_min_periods=8,
                dastd=RollingSpec(40, 8, 8), cmra_window=30,
                stom=RollingSpec(10, None, 7), stoq=RollingSpec(21, None, 14),
                stoa=RollingSpec(42, None, 21)),
            risk=RiskModelConfig(eigen_n_sims=4))
        table, factors = run_factor_pipeline(
            fields, data["index_close"], data["industry"].astype(str),
            data["dates"], data["stocks"], cfg, device="cpu")
        r = run_risk_pipeline(table, config=cfg, device="cpu")
        assert np.isfinite(r.outputs.factor_ret.numpy()).all()
        print(len(table["date"]) > 0, r.arrays.n_industries)
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "True 3"
