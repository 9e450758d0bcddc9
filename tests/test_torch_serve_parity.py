"""The serving step across packages, in both directions, at float64.

Forward: a checkpoint the JAX package's ``init_state`` wrote goes through
``mfm_tpu_torch.convert.state_from_reference`` into the port, whose
``update`` / ``update_guarded`` (with a NaN-poisoned date) / incremental
``update`` are held against the JAX package continuing the same state —
outputs, guard report and carries within rtol 1e-8.  Back: the port's
``save_risk_state`` file is loaded by the JAX package, whose update is held
against the JAX package continuing its own state.

The reference runs its Brent-Luk Jacobi (``MFM_EIGH_CPU_JACOBI_BATCH=1``),
the port's algorithm, and ``jax.random`` cannot give ``torch.Generator``'s
draws, so both get the same injected ``sim_covs`` (or, in the incremental
mode, the reference's draw tensor, carried inside its checkpoint).  The
reference configs use ``seed=5``: the seed changes no number under
injected draws, and it keeps these compiled steps (whose eigh route is set
at trace time) apart from other files' steps in a shared process.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfm_tpu.config import QuarantinePolicy as RefPolicy
from mfm_tpu.config import RiskModelConfig as RefConfig
from mfm_tpu.data import artifacts as ref_artifacts
from mfm_tpu.models.risk_model import RiskModel as RefRiskModel
from mfm_tpu_torch import RiskModel
from mfm_tpu_torch.convert import (
    config_from_reference,
    outputs_to_numpy,
    report_to_numpy,
    state_from_reference,
    state_to_numpy,
)
from mfm_tpu_torch.data.artifacts import save_risk_state

torch.set_num_threads(2)

T, N, P, Q, M = 48, 24, 4, 3, 8
K = 1 + P + Q
T0 = 30
REF_CFG = RefConfig(eigen_n_sims=M, eigen_sim_length=T, seed=5)
REF_GCFG = dataclasses.replace(REF_CFG, quarantine=RefPolicy(enabled=True))
REF_ICFG = RefConfig(eigen_n_sims=M, eigen_incremental=True, seed=5)
STATE_KEYS = ("nw_t", "nw_S", "nw_A", "nw_Z", "nw_Ps", "nw_hs", "nw_gs",
              "nw_Slags", "nw_xlags", "vr_num", "vr_den")
GUARD_KEYS = ("guard_last_good_cov", "guard_staleness",
              "guard_quarantine_count", "guard_ring", "guard_ring_pos")
EIG_KEYS = ("eig_R", "eig_p", "eig_n")


@pytest.fixture(autouse=True)
def _reference_jacobi(monkeypatch):
    monkeypatch.setenv("MFM_EIGH_CPU_JACOBI_BATCH", "1")


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(11)
    panels = (
        rng.normal(0, 0.02, (T, N)),
        rng.lognormal(10, 1, (T, N)),
        rng.normal(size=(T, N, Q)),
        rng.integers(0, P, (T, N)).astype(np.int32),
        rng.random((T, N)) > 0.05,
    )
    bad = np.array(panels[0], copy=True)
    bad[T0 + 4, : int(round(0.6 * N))] = np.nan
    d = rng.standard_normal((M, K, T))
    d -= d.mean(axis=-1, keepdims=True)
    sim_covs = np.einsum("mkt,mlt->mkl", d, d) / (T - 1)
    return panels, (bad,) + panels[1:], sim_covs


def _ref_model(panels, sl, cfg):
    # jnp.array copies: the reference's fused steps donate their inputs
    return RefRiskModel(*(jnp.array(np.asarray(p)[sl]) for p in panels),
                        n_industries=P, config=cfg)


def _port_model(panels, sl, cfg):
    return RiskModel(*(np.asarray(p)[sl] for p in panels), n_industries=P,
                     config=config_from_reference(dataclasses.asdict(cfg)),
                     device="cpu")


def _ref_copy(state):
    return jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), state)


def _ref_init(panels, cfg, sim_covs):
    m = _ref_model(panels, slice(0, T0), cfg)
    if cfg.eigen_incremental:
        return m.init_state()
    return m.init_state(sim_covs=jnp.asarray(sim_covs), sim_length=T)


def _ref_state_numpy(state, tmp_path):
    """A reference state as the npz arrays its own saver writes."""
    path = str(tmp_path / "ref_view" / "state.npz")
    ref_artifacts.save_risk_state(path, _ref_copy(state))
    arrays, _ = ref_artifacts.load_artifact(path, fenced=True)
    return arrays


def _close(got, want, what, rtol=1e-8):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    if want.dtype.kind != "f":
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    finite = np.isfinite(want)
    scale = np.abs(want[finite]).max() if finite.any() else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-12 * scale,
                               err_msg=what)


def _close_outputs(got, want, msg):
    for name, w in want.items():
        _close(got[name], w, f"{msg}: {name}")


def _close_states(got, want, keys, msg):
    for k in keys:
        w = want[k]
        if k == "guard_quarantine_count":
            # under x64 the reference's jnp.sum promotes the count to
            # int64 after a guarded update; both keep int32 otherwise
            w = w.astype(np.asarray(got[k]).dtype)
        _close(got[k], w, f"{msg}: {k}")


@pytest.mark.parametrize("mode", ["default", "guarded", "incremental"])
def test_reference_checkpoint_resumes_in_the_port(case, tmp_path, mode):
    """JAX init_state -> JAX save_risk_state npz -> the port -> update,
    against JAX's own update of the same slab."""
    panels, bad, sim_covs = case
    cfg = {"default": REF_CFG, "guarded": REF_GCFG,
           "incremental": REF_ICFG}[mode]
    _, ref_state = _ref_init(panels, cfg, sim_covs)
    path = str(tmp_path / "ckpt" / "state.npz")
    ref_artifacts.save_risk_state(path, _ref_copy(ref_state))
    state, meta = state_from_reference(path, "cpu")
    assert meta["kind"] == "risk_state"
    assert state.stamp == ref_state.stamp
    assert state.t == T0

    slab = bad if mode != "default" else panels
    ref_m = _ref_model(slab, slice(T0, T), cfg)
    port_m = _port_model(slab, slice(T0, T), cfg)
    if mode == "guarded":
        ref_out, ref_rep, ref_next = ref_m.update_guarded(_ref_copy(ref_state))
        out, rep, nxt = port_m.update_guarded(state)
        got_rep, want_rep = report_to_numpy(rep), {
            k: np.asarray(v) for k, v in ref_rep._asdict().items()}
        assert got_rep["quarantined"].sum() == 1
        for k in ("quarantined", "reasons", "staleness"):
            np.testing.assert_array_equal(got_rep[k], want_rep[k], err_msg=k)
        _close(got_rep["served_cov"], want_rep["served_cov"], "served_cov")
    else:
        ref_out, ref_next = ref_m.update(_ref_copy(ref_state))
        out, nxt = port_m.update(state)
    _close_outputs(outputs_to_numpy(out),
                   {k: np.asarray(v) for k, v in ref_out._asdict().items()},
                   mode)
    keys = STATE_KEYS + (GUARD_KEYS if mode == "guarded" else ()) + (
        EIG_KEYS if mode == "incremental" else ())
    got = state_to_numpy(nxt)
    _close_states(got, _ref_state_numpy(ref_next, tmp_path), keys, mode)
    assert got["sim_length"] == ref_next.sim_length
    assert got["eigen_batch_hint"] == ref_next.eigen_batch_hint


@pytest.mark.parametrize("mode", ["default", "guarded"])
def test_port_checkpoint_resumes_in_the_reference(case, tmp_path, mode):
    """The port's init_state -> the port's save_risk_state npz -> JAX
    load_risk_state -> JAX update, against JAX continuing its own state."""
    panels, bad, sim_covs = case
    cfg = REF_GCFG if mode == "guarded" else REF_CFG
    _, port_state = _port_model(panels, slice(0, T0), cfg).init_state(
        sim_covs=torch.from_numpy(sim_covs), sim_length=T)
    path = str(tmp_path / "port" / "state.npz")
    save_risk_state(path, port_state)
    loaded, _ = ref_artifacts.load_risk_state(path)
    _, own = _ref_init(panels, cfg, sim_covs)
    assert loaded.stamp == own.stamp

    keys = STATE_KEYS + (GUARD_KEYS if mode == "guarded" else ())
    _close_states(_ref_state_numpy(loaded, tmp_path),
                  _ref_state_numpy(own, tmp_path), keys, "loaded state")
    step = "update_guarded" if mode == "guarded" else "update"
    slab = bad if mode == "guarded" else panels
    a = getattr(_ref_model(slab, slice(T0, T), cfg), step)(loaded)
    b = getattr(_ref_model(slab, slice(T0, T), cfg), step)(_ref_copy(own))
    for name in a[0]._fields:
        _close(getattr(a[0], name), getattr(b[0], name), f"{mode}: {name}")
    _close_states(_ref_state_numpy(a[-1], tmp_path),
                  _ref_state_numpy(b[-1], tmp_path), keys, f"{mode} carry")
    if mode == "guarded":
        np.testing.assert_array_equal(np.asarray(a[1].quarantined),
                                      np.asarray(b[1].quarantined))
        assert np.asarray(a[1].quarantined).sum() == 1


def test_port_incremental_checkpoint_resumes_in_the_reference(case, tmp_path):
    """An incremental checkpoint carries the port's own draw tensor, which
    the reference cannot redraw, so the JAX update from it is held against
    the port's update from the same state."""
    panels, _, _ = case
    _, port_state = _port_model(panels, slice(0, T0), REF_ICFG).init_state()
    path = str(tmp_path / "port" / "state.npz")
    save_risk_state(path, port_state)
    loaded, _ = ref_artifacts.load_risk_state(path)
    ref_out, ref_next = _ref_model(panels, slice(T0, T), REF_ICFG).update(
        loaded)
    out, nxt = _port_model(panels, slice(T0, T), REF_ICFG).update(port_state)
    _close_outputs(outputs_to_numpy(out),
                   {k: np.asarray(v) for k, v in ref_out._asdict().items()},
                   "incremental")
    _close_states(state_to_numpy(nxt), _ref_state_numpy(ref_next, tmp_path),
                  STATE_KEYS + EIG_KEYS, "incremental carry")
