"""The bfloat16 eigen Monte-Carlo of the port (``eigen_mc_dtype=
"bfloat16"``) against the JAX package on the CPU.

- With the simulated covariances injected (default mode) or the draw
  tensor carried in a checkpoint (incremental mode), the bfloat16 G
  assembly — the rounded scale factors' outer product, then one rounded
  multiply, cast up for the eighs — gives the reference's outputs at
  float64 to rtol 1e-8.
- The port's own bfloat16 draws are another realization than its float32
  ones, so they are gated like the reference's: the eigenfactor bias stat
  within ``tools/parity_budget.json`` ``eigen_mc_bf16`` at its own shape
  and seed.
- bfloat16 draw buckets are prefix-stable, and a bfloat16 incremental
  checkpoint round-trips bitwise and loads in both packages.

The reference runs its Brent-Luk Jacobi (``MFM_EIGH_CPU_JACOBI_BATCH=1``);
its configs use ``seed=17`` to keep these compiled steps apart from other
files' in a shared process.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfm_tpu.config import RiskModelConfig as RefConfig
from mfm_tpu.data import artifacts as ref_artifacts
from mfm_tpu.models import eigen as ref_eigen
from mfm_tpu.models.risk_model import RiskModel as RefRiskModel
from mfm_tpu_torch import RiskModel, RiskModelConfig
from mfm_tpu_torch.convert import (
    config_from_reference,
    outputs_to_numpy,
    state_to_numpy,
)
from mfm_tpu_torch.data.artifacts import load_risk_state, save_risk_state
from mfm_tpu_torch.models import eigen
from mfm_tpu_torch.models.bias import eigenfactor_bias_stat

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
T, N, P, Q, M = 48, 24, 4, 3, 8
K = 1 + P + Q
T0 = 36
REF_BF16 = RefConfig(eigen_n_sims=M, eigen_mc_dtype="bfloat16", seed=17)
REF_IBF16 = RefConfig(eigen_n_sims=M, eigen_mc_dtype="bfloat16",
                      eigen_incremental=True, seed=17)


@pytest.fixture(autouse=True)
def _reference_jacobi(monkeypatch):
    monkeypatch.setenv("MFM_EIGH_CPU_JACOBI_BATCH", "1")


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(21)
    panels = (
        rng.normal(0, 0.02, (T, N)),
        rng.lognormal(10, 1, (T, N)),
        rng.normal(size=(T, N, Q)),
        rng.integers(0, P, (T, N)).astype(np.int32),
        rng.random((T, N)) > 0.05,
    )
    d = rng.standard_normal((M, K, T))
    d -= d.mean(axis=-1, keepdims=True)
    return panels, np.einsum("mkt,mlt->mkl", d, d) / (T - 1)


def _ref_model(panels, sl, cfg):
    # jnp.array copies: the reference's fused steps donate their inputs
    return RefRiskModel(*(jnp.array(np.asarray(p)[sl]) for p in panels),
                        n_industries=P, config=cfg)


def _port_model(panels, sl, cfg):
    return RiskModel(*(np.asarray(p)[sl] for p in panels), n_industries=P,
                     config=config_from_reference(dataclasses.asdict(cfg)),
                     device="cpu")


def _close(got, want, what, rtol=1e-8):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    if want.dtype.kind != "f":
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    finite = np.isfinite(want)
    scale = np.abs(want[finite]).max() if finite.any() else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-12 * scale,
                               err_msg=what)


def _close_outputs(got, want, what):
    for name, w in want._asdict().items():
        _close(got[name], w, f"{what}: {name}")


def test_bf16_assembly_matches_reference_with_injected_sim_covs(case):
    panels, sim = case
    want = _ref_model(panels, slice(None), REF_BF16).run(
        sim_covs=jnp.asarray(sim), sim_length=T)
    got = _port_model(panels, slice(None), REF_BF16).run_fused(
        sim_covs=torch.from_numpy(sim), sim_length=T)
    assert got.eigen_valid.any()
    _close_outputs(outputs_to_numpy(got), want, "bf16 run")
    # and it is not the float32-assembly path
    f64 = _port_model(panels, slice(None), dataclasses.replace(
        REF_BF16, eigen_mc_dtype=None)).run_fused(
        sim_covs=torch.from_numpy(sim), sim_length=T)
    ev = got.eigen_valid
    assert not torch.equal(got.eigen_cov[ev], f64.eigen_cov[ev])


def test_bf16_assembly_rounds_twice_in_order():
    """G = bf16(bf16(s s') * bf16(C)), cast up: not one rounding of the
    float32 product."""
    g = torch.Generator().manual_seed(3)
    s = torch.rand((5, K), generator=g, dtype=torch.float64) * 0.1
    C = torch.randn((1, M, K, K), generator=g, dtype=torch.float64)
    G = eigen._assemble_g(s, C.to(torch.bfloat16), torch.bfloat16)
    S = (s.to(torch.bfloat16).double()[:, :, None]
         * s.to(torch.bfloat16).double()[:, None, :]).to(torch.bfloat16)
    want = (S.double()[:, None] * C.to(torch.bfloat16).double()
            ).to(torch.bfloat16).double()
    assert G.dtype == torch.float64 and torch.equal(G, want)
    once = (s[:, None, :, None] * C * s[:, None, None, :]).to(
        torch.bfloat16).double()
    assert not torch.equal(G, once)


def test_simulated_eigen_covs_bf16_semantics():
    """bf16 draws, the mean accumulated in the compute dtype and rounded
    back, demeaned samples in bf16, the Gram exact in the compute dtype."""
    L = 64
    got = eigen.simulated_eigen_covs(torch.Generator().manual_seed(4), K, L,
                                     M, dtype=torch.float64,
                                     mc_dtype="bfloat16")
    draws = torch.randn((M, K, L), generator=torch.Generator().manual_seed(4),
                        dtype=torch.bfloat16)
    mu = draws.double().mean(-1, keepdim=True).to(torch.bfloat16)
    d = (draws - mu).double().numpy()
    want = np.einsum("mkt,mlt->mkl", d, d) / (L - 1)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-15)


def test_bf16_parity_within_budget():
    """The port's own bfloat16 draws keep the eigenfactor bias stat within
    the frozen budget of its float32 draws, at the budget's shape and
    seed (``tools/parity_budget.json``: ``eigen_mc_bf16``)."""
    entry = json.loads((ROOT / "tools" / "parity_budget.json").read_text())[
        "eigen_mc_bf16"]
    shp = entry["shape"]
    Tb, Nb = shp["T"], shp["N"]
    Pb, Qb, Mb = shp["n_industries"], shp["n_styles"], shp["n_sims"]
    rng = np.random.default_rng(entry["seed"])
    panels = (
        (rng.standard_normal((Tb, Nb)) * 0.02).astype(np.float32),
        rng.uniform(1.0, 5.0, (Tb, Nb)).astype(np.float32),
        rng.standard_normal((Tb, Nb, Qb)).astype(np.float32),
        rng.integers(0, Pb, (Tb, Nb)).astype(np.int32),
        rng.uniform(size=(Tb, Nb)) > 0.05,
    )
    stats = {}
    for mc in (None, "bfloat16"):
        cfg = RiskModelConfig(eigen_n_sims=Mb, eigen_sim_length=Tb,
                              eigen_mc_dtype=mc)
        out = RiskModel(*panels, n_industries=Pb, config=cfg,
                        device="cpu").run()
        stats[mc] = eigenfactor_bias_stat(out.eigen_cov, out.eigen_valid,
                                          out.factor_ret).numpy()
    delta = np.max(np.abs(np.abs(stats["bfloat16"] - 1.0)
                          - np.abs(stats[None] - 1.0)))
    assert np.isfinite(delta) and delta <= entry["bias_abs_delta"], delta


def test_bf16_draw_buckets_are_prefix_stable():
    d64 = eigen.simulated_eigen_draws(0, K, 64, M, mc_dtype="bfloat16")
    d128 = eigen.simulated_eigen_draws(0, K, 128, M, mc_dtype="bfloat16")
    assert d64.dtype == torch.bfloat16 and d64.shape == (M, K, 64)
    assert torch.equal(d128[..., :64], d64)
    f32 = eigen.simulated_eigen_draws(0, K, 64, M)
    assert not torch.equal(f32, d64.float())


def test_bf16_incremental_checkpoint_round_trips_bitwise(case, tmp_path):
    panels, _ = case
    _, st = _port_model(panels, slice(0, T0), REF_IBF16).init_state()
    assert st.eig_draws.dtype == torch.bfloat16
    path = str(tmp_path / "state.npz")
    save_risk_state(path, st)
    loaded, meta = load_risk_state(path, "cpu")
    assert meta["eig_draws_dtype"] == "bfloat16"
    assert loaded.eig_draws.dtype == torch.bfloat16
    assert torch.equal(loaded.eig_draws, st.eig_draws)
    a = state_to_numpy(loaded)
    b = state_to_numpy(st)
    assert a["eig_draws"].dtype == np.uint16
    for k, v in b.items():
        assert (np.array_equal(a[k], v) if isinstance(v, np.ndarray)
                else a[k] == v), k
    o_mem, s_mem = _port_model(panels, slice(T0, T), REF_IBF16).update(st)
    o_dsk, s_dsk = _port_model(panels, slice(T0, T), REF_IBF16).update(loaded)
    for f in o_mem._fields:
        assert torch.equal(getattr(o_dsk, f).nan_to_num(),
                           getattr(o_mem, f).nan_to_num()), f
    for k in ("eig_R", "eig_p", "eig_n"):
        assert torch.equal(getattr(s_dsk, k), getattr(s_mem, k)), k


def _ref_copy(state):
    return jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), state)


def test_reference_bf16_checkpoint_resumes_in_the_port(case, tmp_path):
    """The reference's bf16 draws (jax.random) carried into the port: its
    update matches the reference continuing the same state."""
    panels, _ = case
    _, ref_state = _ref_model(panels, slice(0, T0), REF_IBF16).init_state()
    path = str(tmp_path / "ref" / "state.npz")
    ref_artifacts.save_risk_state(path, _ref_copy(ref_state))
    state, meta = load_risk_state(path, "cpu")
    assert meta["eig_draws_dtype"] == "bfloat16"
    np.testing.assert_array_equal(
        state.eig_draws.view(torch.int16).numpy().view(np.uint16),
        np.asarray(ref_state.eig_draws).view(np.uint16))
    want, _ = _ref_model(panels, slice(T0, T), REF_IBF16).update(
        _ref_copy(ref_state))
    got, _ = _port_model(panels, slice(T0, T), REF_IBF16).update(state)
    _close_outputs(outputs_to_numpy(got), want, "bf16 incremental update")


def test_port_bf16_checkpoint_resumes_in_the_reference(case, tmp_path):
    panels, _ = case
    _, st = _port_model(panels, slice(0, T0), REF_IBF16).init_state()
    path = str(tmp_path / "port" / "state.npz")
    save_risk_state(path, st)
    loaded, _ = ref_artifacts.load_risk_state(path)
    assert loaded.eig_draws.dtype == jnp.bfloat16
    want, _ = _port_model(panels, slice(T0, T), REF_IBF16).update(st)
    got, _ = _ref_model(panels, slice(T0, T), REF_IBF16).update(loaded)
    _close_outputs(outputs_to_numpy(want), got, "bf16 incremental update")


def test_auto_eigen_chunk_decides_like_the_reference_under_bf16(monkeypatch):
    """Under eigen_mc_dtype the chunk is sized by the Monte-Carlo dtype's
    itemsize (2 for bf16), doubling it; an explicit chunk ignores it."""
    monkeypatch.setattr(ref_eigen, "_memory_headroom_bytes",
                        lambda backend: 64 * 1024 ** 2)
    monkeypatch.setattr(eigen, "_memory_headroom_bytes",
                        lambda device: 64 * 1024 ** 2)
    Tc, Mc = 64, 64
    panels = (np.zeros((Tc, 4)), np.ones((Tc, 4)), np.zeros((Tc, 4, 3)),
              np.zeros((Tc, 4), np.int32), np.ones((Tc, 4), bool))
    for chunk, mc, want in (("auto", None, 16), ("auto", "bfloat16", 32),
                            (7, "bfloat16", 7)):
        ref_cfg = RefConfig(eigen_chunk=chunk, eigen_n_sims=Mc,
                            eigen_mc_dtype=mc)
        ref = RefRiskModel(*(jnp.asarray(p) for p in panels),
                           n_industries=28, config=ref_cfg)
        port = RiskModel(*panels, n_industries=28, device="cpu",
                         config=config_from_reference(
                             dataclasses.asdict(ref_cfg)))
        assert port.K == 32
        assert port._resolve_eigen_chunk(Mc, itemsize=4) == \
            ref._resolve_eigen_chunk(Mc, itemsize=4) == want
