"""The port's risk-model path (``mfm_tpu_torch``) against the JAX package on
the CPU, stage by stage and as a whole.

Both packages get the same numpy panel, made from a seed, and the same
injected Monte-Carlo ``sim_covs`` carried across by
``mfm_tpu_torch.convert`` (``jax.random`` and ``torch.Generator`` cannot
give the same draws).  At float64 the reference runs its own Brent-Luk
Jacobi (``MFM_EIGH_CPU_JACOBI_BATCH=1``) at the port's sweep caps, so the
two compute the same decomposition; at float32 the outputs are held within
the per-stage ``risk`` budgets of ``tools/parity_budget.json``.
"""

import ast
import dataclasses
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from mfm_tpu.config import RiskModelConfig as RefConfig
from mfm_tpu.models.eigen import auto_eigen_chunk as ref_auto_eigen_chunk
from mfm_tpu.models.newey_west import newey_west_expanding as ref_nw
from mfm_tpu.models.risk_model import RiskModel as RefRiskModel
from mfm_tpu.models.vol_regime import vol_regime_adjust_by_time as ref_vr
from mfm_tpu.ops import masked as ref_masked
from mfm_tpu.ops.xreg import regress_panel as ref_regress_panel
from mfm_tpu_torch import RiskModel, RiskModelConfig
from mfm_tpu_torch.convert import (
    budget_check,
    config_from_reference,
    outputs_to_numpy,
    to_port,
)
from mfm_tpu_torch.data.synthetic import synthetic_risk_inputs
from mfm_tpu_torch.models.eigen import (
    auto_eigen_chunk,
    eigen_risk_adjust_by_time,
    simulated_eigen_covs,
)
from mfm_tpu_torch.models.newey_west import (
    newey_west_expanding,
    newey_west_expanding_resume,
)
from mfm_tpu_torch.models.vol_regime import (
    vol_regime_adjust_by_time,
    vol_regime_adjust_resume,
)
from mfm_tpu_torch.ops import masked
from mfm_tpu_torch.ops.xreg import regress_panel

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
FIELDS = ("factor_ret", "specific_ret", "r2", "nw_cov", "nw_valid",
          "eigen_cov", "eigen_valid", "vr_cov", "lamb")
PANEL = ("ret", "cap", "styles", "industry", "valid")


def _case(T, N, P, Q, M, seed=0):
    """Seeded numpy panel + injected sim_covs (np.cov of M (K, T) draws)."""
    panel = dict(zip(PANEL, synthetic_risk_inputs(T, N, P, Q, seed=seed)))
    K = 1 + P + Q
    d = np.random.default_rng(seed + 1).standard_normal((M, K, T))
    d -= d.mean(axis=-1, keepdims=True)
    panel["sim_covs"] = np.einsum("mkt,mlt->mkl", d, d) / (T - 1)
    return panel


def _ref_run(case, P, M, dtype):
    """The reference's eager ``run`` with its Jacobi eigh route."""
    cast = {k: (v.astype(dtype) if v.dtype.kind == "f" else v)
            for k, v in case.items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MFM_EIGH_CPU_JACOBI_BATCH", "1")
        rm = RefRiskModel(*(jnp.asarray(cast[k]) for k in PANEL),
                          n_industries=P, config=RefConfig(eigen_n_sims=M))
        out = rm.run(sim_covs=jnp.asarray(cast["sim_covs"]),
                     sim_length=case["ret"].shape[0])
    return {k: np.asarray(v) for k, v in out._asdict().items()}


def _port_run(case, P, M, dtype):
    cfg = config_from_reference(dataclasses.asdict(RefConfig(eigen_n_sims=M)))
    t = to_port(case, "cpu", dtype)
    rm = RiskModel(*(t[k] for k in PANEL), n_industries=P, config=cfg,
                   device="cpu")
    out = rm.run_fused(sim_covs=t["sim_covs"], sim_length=case["ret"].shape[0])
    return outputs_to_numpy(out)


SMALL = dict(T=80, N=40, P=4, Q=3, M=8)  # K = 8 (even), pinv n = 7 (odd)


@pytest.fixture(scope="module")
def small_f64():
    c = SMALL
    case = _case(c["T"], c["N"], c["P"], c["Q"], c["M"])
    return (_ref_run(case, c["P"], c["M"], np.float64),
            _port_run(case, c["P"], c["M"], torch.float64))


def _assert_same(got, want, rtol):
    """Elementwise ``rtol``; entries that cancel to near zero (residuals,
    off-diagonal covariances) are held to 1e-12 of the field's scale
    instead.  NaN positions must agree too (assert_allclose's equal_nan)."""
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want)
    else:
        finite = np.isfinite(want)
        scale = np.abs(want[finite]).max() if finite.any() else 0.0
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-12 * scale)


@pytest.mark.parametrize("field", FIELDS)
def test_run_fused_matches_reference_f64(small_f64, field):
    ref, port = small_f64
    assert port[field].shape == ref[field].shape
    _assert_same(port[field], ref[field], rtol=1e-8)


def test_run_fused_matches_reference_f64_at_csi300_width():
    """K = 42 (P=31, Q=10) as on the main path, at small T and M."""
    T, N, P, Q, M = 56, 96, 31, 10, 3
    case = _case(T, N, P, Q, M, seed=3)
    ref = _ref_run(case, P, M, np.float64)
    port = _port_run(case, P, M, torch.float64)
    assert port["nw_valid"].any() and port["eigen_valid"].any()
    for f in FIELDS:
        _assert_same(port[f], ref[f], rtol=1e-8)


def test_run_fused_within_f32_budgets():
    c = SMALL
    case = _case(c["T"], c["N"], c["P"], c["Q"], c["M"], seed=5)
    ref = _ref_run(case, c["P"], c["M"], np.float32)
    port = _port_run(case, c["P"], c["M"], torch.float32)
    budget = json.loads((ROOT / "tools" / "parity_budget.json").read_text())
    records, failed = budget_check(port, ref, budget["risk"])
    assert not failed, (failed, records)


@pytest.mark.parametrize("P", [0, 4])
def test_regress_panel_matches_reference(P):
    """Both industry branches, with the pure-factor exposure check."""
    case = _case(30, 40, max(P, 1), 3, 1, seed=P)  # P=0 ignores the codes
    ref = ref_regress_panel(*(jnp.asarray(case[k].astype(np.float64)
                                          if case[k].dtype.kind == "f"
                                          else case[k]) for k in PANEL),
                            n_industries=P, return_exposure=True)
    t = to_port(case, "cpu", torch.float64)
    got = regress_panel(*(t[k] for k in PANEL), n_industries=P,
                        return_exposure=True)
    assert got.exposure.shape == (30, 1 + P + 3, 1 + P + 3)
    for g, r in zip(got, ref):
        _assert_same(g.numpy(), np.asarray(r), rtol=1e-8)


def test_newey_west_matches_reference_and_resumes_bitwise():
    rng = np.random.default_rng(8)
    x = 0.01 * rng.standard_normal((60, 5))
    covs_ref, valid_ref = ref_nw(jnp.asarray(x), q=2, half_life=20.0)
    xt = torch.from_numpy(x)
    covs, valid = newey_west_expanding(xt, q=2, half_life=20.0)
    _assert_same(covs.numpy(), np.asarray(covs_ref), rtol=1e-9)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_ref))
    c1, v1, carry = newey_west_expanding_resume(xt[:25], q=2, half_life=20.0)
    c2, v2, _ = newey_west_expanding_resume(xt[25:], q=2, half_life=20.0,
                                            carry=carry)
    assert torch.equal(torch.cat([c1, c2]), covs)
    assert torch.equal(torch.cat([v1, v2]), valid)


def test_vol_regime_matches_reference_and_resumes_bitwise():
    rng = np.random.default_rng(9)
    T, K = 50, 4
    f = 0.01 * rng.standard_normal((T, K))
    X = rng.standard_normal((T, K, 3 * K))
    covs = 1e-4 * np.einsum("tik,tjk->tij", X, X) / (3 * K)
    valid = np.arange(T) >= 6
    covs[~valid] = np.nan
    adj_ref, lamb_ref = ref_vr(jnp.asarray(f), jnp.asarray(covs),
                               jnp.asarray(valid), half_life=10.0)
    ft, ct, vt = (torch.from_numpy(a) for a in (f, covs, valid))
    adj, lamb = vol_regime_adjust_by_time(ft, ct, vt, half_life=10.0)
    _assert_same(adj.numpy(), np.asarray(adj_ref), rtol=1e-10)
    _assert_same(lamb.numpy(), np.asarray(lamb_ref), rtol=1e-10)
    a1, l1, carry = vol_regime_adjust_resume(ft[:20], ct[:20], vt[:20],
                                             half_life=10.0)
    a2, l2, _ = vol_regime_adjust_resume(ft[20:], ct[20:], vt[20:],
                                         half_life=10.0, carry=carry)
    assert torch.equal(torch.cat([l1, l2]), lamb)
    assert torch.equal(torch.cat([a1, a2]).nan_to_num(), adj.nan_to_num())


def test_eigen_chunked_equals_unchunked_bitwise():
    rng = np.random.default_rng(10)
    T, K, M = 13, 6, 5
    X = rng.standard_normal((T, K, 40))
    covs = torch.from_numpy(np.einsum("tik,tjk->tij", X, X) / 40)
    valid = torch.from_numpy(np.arange(T) != 4)
    d = rng.standard_normal((M, K, 200))
    d -= d.mean(axis=-1, keepdims=True)
    sim = torch.from_numpy(np.einsum("mkt,mlt->mkl", d, d) / 199)
    full = eigen_risk_adjust_by_time(covs, valid, sim, sim_length=200)
    for chunk in (1, 4, 12):
        part = eigen_risk_adjust_by_time(covs, valid, sim, sim_length=200,
                                         chunk=chunk)
        assert torch.equal(part[0].nan_to_num(), full[0].nan_to_num())
        assert torch.equal(part[1], full[1])
    assert torch.isnan(full[0][4]).all() and not full[1][4]


def test_simulated_eigen_covs_is_np_cov_of_its_draws_and_seeded():
    K, L, M = 5, 64, 3
    sim = simulated_eigen_covs(torch.Generator().manual_seed(7), K, L, M,
                               dtype=torch.float64)
    draws = torch.randn((M, K, L), generator=torch.Generator().manual_seed(7),
                        dtype=torch.float64).numpy()
    want = np.stack([np.cov(draws[m]) for m in range(M)])
    np.testing.assert_allclose(sim.numpy(), want, rtol=1e-12, atol=1e-14)
    again = simulated_eigen_covs(torch.Generator().manual_seed(7), K, L, M,
                                 dtype=torch.float64)
    other = simulated_eigen_covs(torch.Generator().manual_seed(8), K, L, M,
                                 dtype=torch.float64)
    assert torch.equal(sim, again) and not torch.equal(sim, other)


def test_run_draws_from_config_seed_when_nothing_is_injected():
    case = _case(40, 30, 3, 2, 4)
    t = to_port(case, "cpu", torch.float64)
    cfg = RiskModelConfig(eigen_n_sims=4, seed=11)

    def run():
        return RiskModel(*(t[k] for k in PANEL), n_industries=3, config=cfg,
                         device="cpu").run_fused()

    a, b = run(), run()
    assert torch.equal(a.vr_cov.nan_to_num(), b.vr_cov.nan_to_num())
    sim = simulated_eigen_covs(torch.Generator().manual_seed(11), 6, 40, 4,
                               dtype=torch.float64)
    c = RiskModel(*(t[k] for k in PANEL), n_industries=3, config=cfg,
                  device="cpu").run(sim_covs=sim, sim_length=40)
    assert torch.equal(a.vr_cov.nan_to_num(), c.vr_cov.nan_to_num())


def test_risk_model_runs_on_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the check is for one without")
    case = _case(20, 20, 2, 2, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        RiskModel(*(case[k] for k in PANEL), n_industries=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        RiskModel(*(case[k] for k in PANEL), n_industries=2, device="cuda")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference_package():
    files = sorted((ROOT / "mfm_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "mfm_tpu", "__graft_entry__"), \
                f"{path.relative_to(ROOT)} imports {mod}"


@pytest.mark.parametrize("fields", [
    {"eigen_mc_dtype": "bfloat16"},
    {"nw_method": "associative"},
    {"mesh": {"n_date_shards": 2, "n_stock_shards": 1}},
])
def test_unported_features_raise(fields):
    if "eigen_mc_dtype" in fields:  # ported: the bfloat16 Monte-Carlo
        port = config_from_reference(fields)
        assert port.identity() == RefConfig(**fields).identity()
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        config_from_reference(fields)


@pytest.mark.parametrize("quarantine", [
    {}, {"quarantine": {"enabled": True}},
    {"quarantine": {"enabled": True, "mad_k": 6.0, "universe_window": 21}},
])
def test_config_from_reference_keeps_every_field_and_identity(quarantine):
    from mfm_tpu.config import QuarantinePolicy as RefPolicy

    q = ({"quarantine": RefPolicy(**quarantine["quarantine"])}
         if quarantine else {})
    ref = RefConfig(eigen_n_sims=17, eigen_chunk=5, eigen_sim_sweeps=4, seed=3,
                    **q)
    port = config_from_reference(dataclasses.asdict(ref))
    assert port.identity() == ref.identity()
    assert port.quarantine.enabled == bool(quarantine)
    assert port.eigen_chunk == 5
    with pytest.raises(ValueError):
        RiskModelConfig(eigen_chunk=0)
    with pytest.raises(ValueError):
        config_from_reference({"no_such_field": 1})


def test_auto_eigen_chunk_decides_like_the_reference():
    # fits -> full batch; far past the host cap -> the same slab size
    for T, M, K in ((100, 10, 8), (10_000, 100, 42)):
        assert auto_eigen_chunk(T, M, K, 4, device="cpu") == \
            ref_auto_eigen_chunk(T, M, K, 4, backend="cpu")


def test_masked_ops_match_reference():
    rng = np.random.default_rng(12)
    x = rng.standard_normal((6, 30))
    x[rng.random(x.shape) < 0.2] = np.nan
    x[5, 1:] = np.nan  # a single-survivor section
    cap = np.exp(rng.standard_normal((6, 30)))
    m = rng.random(x.shape) > 0.1
    xt, capt, mt = (torch.from_numpy(a) for a in (x, cap, m))
    pairs = [
        (masked.masked_mean(xt, mt), ref_masked.masked_mean(x, m)),
        (masked.masked_var(xt, mt, ddof=1), ref_masked.masked_var(x, m, ddof=1)),
        (masked.masked_std(xt, mt), ref_masked.masked_std(x, m)),
        (masked.masked_weighted_mean(xt, capt, mt),
         ref_masked.masked_weighted_mean(x, cap, m)),
        (masked.winsorize_cs(xt), ref_masked.winsorize_cs(x)),
        (masked.zscore_cap_weighted(xt, capt, mt),
         ref_masked.zscore_cap_weighted(x, cap, m)),
    ]
    X = rng.standard_normal((30, 2))
    pairs.append((masked.masked_ols_residuals(xt[0], torch.from_numpy(X)),
                  ref_masked.masked_ols_residuals(x[0], X)))
    for got, want in pairs:
        _assert_same(got.numpy(), np.asarray(want), rtol=1e-9)


def test_synthetic_panel_is_the_reference_panel():
    ours = synthetic_risk_inputs(12, 20, 3, 2, seed=4)
    theirs = __graft_entry__._synthetic_risk_inputs(12, 20, 3, 2, seed=4)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, np.asarray(b))
