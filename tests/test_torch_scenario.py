"""The port's scenario engine (``mfm_tpu_torch/scenario``: specs, the
batched kernel, the engine, the replay and counterfactual resolvers, the
manifests) against the JAX package's, on the CPU.

- Specs and manifests are wire formats: ``to_dict``, the canonical JSON
  and ``spec_hash`` equal the reference's byte for byte, ``validate_spec``
  gives the reference's problems, and a manifest either package writes
  audits clean in the other.
- ``ScenarioEngine.run`` at float64 on the same inputs: covariances within
  rtol 1e-10 (1e-9 on projected lanes, where the port's Jacobi meets
  LAPACK's eigh), statuses and problems equal, ``psd_projected`` equal on
  every lane whose stressed minimum eigenvalue lies outside
  1e3·eps·lambda_max of zero (the lanes inside that band are counted and
  reported, and compared like the others).
- Inside the port, bitwise: the identity lane is the base, a batch equals
  its singles across a bucket boundary, poisoned specs leave their
  batchmates' bytes alone, a counterfactual equals a manual
  ``update_guarded`` with the same operands.
- Counterfactuals against the reference run from one checkpoint the
  reference saved, read by ``convert.state_from_reference`` (both sides
  hold the same ``sim_covs``), within rtol 1e-8.
"""

import dataclasses
import io
import json
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfm_tpu.config import QuarantinePolicy as RefPolicy
from mfm_tpu.config import RiskModelConfig as RefConfig
from mfm_tpu.data import artifacts as ref_artifacts
from mfm_tpu.models.risk_model import RiskModel as RefRiskModel
from mfm_tpu.scenario import PRESETS as REF_PRESETS
from mfm_tpu.scenario import ScenarioBuilder as RefBuilder
from mfm_tpu.scenario import ScenarioEngine as RefEngine
from mfm_tpu.scenario import ScenarioSpec as RefSpec
from mfm_tpu.scenario import audit_scenario_manifest as ref_audit
from mfm_tpu.scenario import build_scenario_manifest as ref_build
from mfm_tpu.scenario import make_counterfactual_fn as ref_cf_fn
from mfm_tpu.scenario import make_replay_lookup as ref_replay_lookup
from mfm_tpu.scenario import replay_lookup_from_result as ref_from_result
from mfm_tpu.scenario import validate_spec as ref_validate
from mfm_tpu.scenario import write_scenario_manifest as ref_write
from mfm_tpu_torch import RiskModel
from mfm_tpu_torch.convert import config_from_reference, state_from_reference
from mfm_tpu_torch.obs import instrument as obs
from mfm_tpu_torch.scenario import (
    PRESETS,
    ScenarioBuilder,
    ScenarioEngine,
    ScenarioManifestError,
    ScenarioSpec,
    audit_scenario_manifest,
    build_scenario_manifest,
    clone_state,
    make_counterfactual_fn,
    make_replay_lookup,
    preset,
    read_scenario_manifest,
    replay_lookup_from_result,
    scenario_manifest_path_for,
    validate_spec,
    write_scenario_manifest,
)
from mfm_tpu_torch.serve import QueryEngine, QueryServer, ServePolicy
from mfm_tpu_torch.serve.guard import REASON_FORCED

torch.set_num_threads(2)

K = 6
RTOL = 1e-10          # same inputs, elementwise math in another order
PROJ_RTOL = 1e-9      # projected lanes: the port's Jacobi vs LAPACK's eigh
CF_RTOL = 1e-8        # counterfactual re-runs: the repo's golden level


def _base_cov(seed=0, k=K, dtype=np.float64):
    """A well-conditioned PSD baseline covariance."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(k, k))
    return ((a @ a.T + 1e-2 * np.eye(k)) * 1e-4).astype(dtype)


def _mixed_specs(B=ScenarioBuilder, preset_of=preset):
    """Nine healthy specs spanning every transform axis (S=9 crosses the
    8 -> 32 bucket boundary vs the S=1 singles); corr-meltup projects."""
    return [
        (ScenarioSpec if B is ScenarioBuilder else RefSpec).identity(),
        B("shock-add").shock("f0", add=2e-3).build(),
        B("shock-mult").shock("f1", mult=2.0).build(),
        B("shock-both").shock("f2", add=1e-3, mult=0.5).build(),
        B("regime-hot").vol_regime(3.0).build(),
        B("corr-up").correlation(0.3).build(),
        B("combo").shock("f3", mult=1.5).vol_regime(1.2)
        .correlation(-0.4).build(),
        preset_of("crash-2015-analog"),
        preset_of("corr-meltup"),
    ]


def _poison(B=ScenarioBuilder):
    return [
        B("p-nan").shock("f0", add=math.nan).build(),
        B("p-corr").correlation(-1.5).build(),
        B("p-vol").vol_regime(-1.0).build(),
        B("p-factor").shock("not-a-factor", add=1e-3).build(),
    ]


def _ref_preset(name):
    return REF_PRESETS[name]


@pytest.fixture(scope="module")
def engine():
    return ScenarioEngine(_base_cov(), device="cpu")


# -- specs: the wire format ---------------------------------------------------

def _built_specs(B):
    return [
        B("drill").shock("f1", add=1e-3, mult=2.0).shock("f0", add=-5e-4)
        .vol_regime(1.5).correlation(0.3).replay("2024-01-02", "2024-02-29")
        .flip("2024-03-04").flip("2024-03-05", heal=True).build(),
        B("plain").build(),
        B("scaled").shock("f5", mult=0.25).shock("f5", mult=2.0).build(),
    ]


@pytest.mark.parametrize("which", list(PRESETS) + ["drill", "plain",
                                                  "scaled", "twin"])
def test_spec_wire_format_and_hash_are_the_reference(which):
    if which in PRESETS:
        port, ref = preset(which), REF_PRESETS[which]
    elif which == "twin":
        kw = dict(name="drill", shift={"f0": -5e-4, "f1": 1e-3},
                  scale={"f1": 2.0}, vol_mult=1.5, corr_beta=0.3,
                  replay=("2024-01-02", "2024-02-29"),
                  flip_quarantine=("2024-03-04",),
                  flip_heal=("2024-03-05",))
        port, ref = ScenarioSpec(**kw), RefSpec(**kw)
    else:
        names = ["drill", "plain", "scaled"]
        port = _built_specs(ScenarioBuilder)[names.index(which)]
        ref = _built_specs(RefBuilder)[names.index(which)]
    assert port.to_dict() == ref.to_dict()
    assert port.to_json() == ref.to_json()
    assert port.spec_hash() == ref.spec_hash()
    assert port.kinds == ref.kinds and port.is_identity == ref.is_identity
    assert port.shocks_identity == ref.shocks_identity
    # each package reads the other's wire form back to an equal spec
    assert ScenarioSpec.from_json(ref.to_json()) == port
    assert RefSpec.from_json(port.to_json()) == ref
    if which == "twin":   # dict-built and builder-built hash identically
        assert port.spec_hash() == _built_specs(ScenarioBuilder)[0].spec_hash()


@pytest.mark.parametrize("bad", [["not", "a", "dict"],
                                 {"schema_version": 99, "name": "x"},
                                 {"vol_mult": 2.0}])
def test_spec_from_dict_rejects_bad_wire_forms_as_the_reference(bad):
    with pytest.raises(ValueError) as got:
        ScenarioSpec.from_dict(bad)
    with pytest.raises(ValueError) as want:
        RefSpec.from_dict(bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [
    {}, {"shift": (("f0", math.nan),)}, {"scale": (("f0", -1.0),)},
    {"shift": (("nope", 1.0),)}, {"scale": (("f1", math.inf),)},
    {"vol_mult": 0.0}, {"vol_mult": math.inf}, {"corr_beta": -1.5},
    {"corr_beta": math.nan}, {"replay": ("2024-06-01", "2024-01-01")},
    {"flip_quarantine": ("2024-01-05",), "flip_heal": ("2024-01-05",)},
    {"name": ""},
])
def test_validate_spec_problems_are_the_reference(kw):
    names = [f"f{i}" for i in range(K)]
    kw = {"name": "s", **kw}
    got = validate_spec(ScenarioSpec(**kw), names)
    assert got == ref_validate(RefSpec(**kw), names)
    assert bool(got) == (kw != {"name": "s"})
    assert validate_spec(ScenarioSpec(**kw)) == ref_validate(RefSpec(**kw))


def test_preset_catalog_is_the_reference_and_admissible(engine):
    assert sorted(PRESETS) == sorted(REF_PRESETS)
    for name in PRESETS:
        assert validate_spec(preset(name), engine.factor_names) == []
    with pytest.raises(KeyError, match="unknown preset"):
        preset("dot-com-analog")


# -- the engine against the reference -----------------------------------------

def _band(min_eig, cov):
    """|min_eig| inside 1e3 * eps * lambda_max of zero: the gate's
    decision may differ between Jacobi and LAPACK there."""
    lam_max = float(np.linalg.eigvalsh(np.asarray(cov, np.float64))[-1])
    return abs(min_eig) <= 1e3 * np.finfo(np.float64).eps * lam_max


@pytest.mark.parametrize("k,seed", [(6, 0), (10, 3), (42, 0)])
def test_engine_run_is_the_reference(k, seed, record_property):
    cov = _base_cov(seed, k)
    names = [f"f{i}" for i in range(k)]
    port = ScenarioEngine(cov, factor_names=names, device="cpu")
    ref = RefEngine(cov, factor_names=names)

    def specs(B, preset_of):
        out = _mixed_specs(B, preset_of) + _poison(B)
        if k == 42:   # bench config 7's mix, S <= 32
            for i in range(32 - len(out)):
                b = B(f"s{i}").shock(names[i % k], add=1e-4 * (1 + i % 7))
                b.vol_regime(1.0 + 0.1 * (i % 5))
                if i % 3 == 0:
                    b.correlation(0.2 + 0.1 * (i % 4))
                out.append(b.build())
        return out

    got = port.run(specs(ScenarioBuilder, preset))
    want = ref.run(specs(RefBuilder, _ref_preset))
    in_band = 0
    for g, w in zip(got, want):
        assert g.spec.to_json() == w.spec.to_json()
        assert (g.status, g.problems) == (w.status, w.problems), g.spec.name
        if not w.ok:
            assert g.cov is None
            continue
        lam_max = float(np.linalg.eigvalsh(w.cov)[-1])
        if _band(w.min_eig_stressed, w.cov):
            in_band += 1
        else:
            assert g.psd_projected == w.psd_projected, g.spec.name
        rtol = PROJ_RTOL if w.psd_projected else RTOL
        np.testing.assert_allclose(g.cov, w.cov, rtol=rtol,
                                   atol=rtol * lam_max, err_msg=g.spec.name)
        np.testing.assert_allclose(g.factor_vol, w.factor_vol, rtol=rtol)
        np.testing.assert_array_equal(g.base_factor_vol, w.base_factor_vol)
        assert abs(g.min_eig_stressed - w.min_eig_stressed) <= \
            PROJ_RTOL * lam_max, g.spec.name
        assert g.cov.dtype == w.cov.dtype == np.float64
    record_property("lanes_in_gate_band", in_band)
    assert any(w.psd_projected for w in want), "no lane exercised the gate"


# -- bitwise anchors inside the port ------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_identity_scenario_is_bitwise_baseline(dtype):
    eng = ScenarioEngine(_base_cov(dtype=dtype), device="cpu")
    res, = eng.run([ScenarioSpec.identity()])
    assert res.ok and not res.psd_projected and res.min_eig_stressed == 0.0
    assert res.cov.tobytes() == eng.cov.tobytes()
    np.testing.assert_array_equal(res.vol_delta(), 0)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_batch_equals_singles_across_bucket_boundary(dtype):
    eng = ScenarioEngine(_base_cov(dtype=dtype), device="cpu")
    specs = _mixed_specs()
    batch = eng.run(specs)              # S=9 -> bucket 32
    assert any(r.psd_projected for r in batch)
    for spec, got in zip(specs, batch):
        want, = eng.run([spec])         # S=1 -> bucket 8
        assert got.ok and want.ok
        assert got.cov.tobytes() == want.cov.tobytes(), spec.name
        assert got.psd_projected == want.psd_projected, spec.name
        assert got.min_eig_stressed == want.min_eig_stressed, spec.name
    pinned = eng.run(specs, bucket=128)
    for got, want in zip(pinned, batch):
        assert got.cov.tobytes() == want.cov.tobytes()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_corr_stress_past_cone_is_projected_psd(dtype):
    # stressed correlations (x1.9, clipped) of this sign pattern are
    # provably indefinite: [[1,.95,.95],[.95,1,-.95],[.95,-.95,1]]
    corr = np.array([[1.0, 0.5, 0.5],
                     [0.5, 1.0, -0.5],
                     [0.5, -0.5, 1.0]])
    sigma = np.array([0.01, 0.02, 0.03])
    cov = (corr * np.outer(sigma, sigma)).astype(dtype)
    eng = ScenarioEngine(cov, device="cpu")
    before = int(obs.SCENARIO_PSD_PROJECTIONS_TOTAL.value())
    res, = eng.run([ScenarioBuilder("meltup").correlation(0.9).build()])
    assert res.ok and res.psd_projected
    assert res.min_eig_stressed < 0
    eigs = np.linalg.eigvalsh(res.cov)          # at compute dtype
    assert eigs.min() >= 0, f"projected cov not PSD: min eig {eigs.min()}"
    assert int(obs.SCENARIO_PSD_PROJECTIONS_TOTAL.value()) == before + 1
    want, = RefEngine(cov).run([RefBuilder("meltup").correlation(0.9)
                                .build()])
    assert want.psd_projected
    np.testing.assert_allclose(res.cov, want.cov, rtol=0, atol=1e-5 *
                               np.abs(want.cov).max() if dtype == np.float32
                               else PROJ_RTOL * np.abs(want.cov).max())


def test_poisoned_specs_reject_without_touching_batchmates(engine):
    healthy = _mixed_specs()
    poison = _poison()
    mixed = [poison[0]] + healthy[:4] + [poison[1], poison[2]] \
        + healthy[4:] + [poison[3]]
    res = {r.spec.name: r for r in engine.run(mixed)}
    for p in poison:
        r = res[p.name]
        assert r.status == "rejected" and r.problems and r.cov is None
        assert r.vol_delta() is None
    for want in engine.run(healthy):
        got = res[want.spec.name]
        assert got.ok
        assert got.cov.tobytes() == want.cov.tobytes(), want.spec.name


def test_run_refuses_malformed_batches(engine):
    with pytest.raises(ValueError, match="at least one"):
        engine.run([])
    with pytest.raises(ValueError, match="duplicate scenario names"):
        engine.run([ScenarioSpec.identity("x"), ScenarioSpec.identity("x")])
    with pytest.raises(ValueError, match="bucket"):
        engine.run(_mixed_specs(), bucket=4)
    with pytest.raises(ValueError, match="non-finite"):
        ScenarioEngine(np.full((3, 3), np.nan), device="cpu")
    with pytest.raises(ValueError, match="factor names"):
        ScenarioEngine(_base_cov(), factor_names=["just-one"], device="cpu")


def test_scenario_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is taken")
    with pytest.raises(RuntimeError, match="CUDA"):
        ScenarioEngine(_base_cov())


# -- replay -------------------------------------------------------------------

def test_replay_lookup_is_the_reference():
    dates = [f"2024-01-{d:02d}" for d in (2, 3, 4, 5)]
    covs = np.stack([np.eye(2) * (i + 1) for i in range(4)])
    valid = np.array([True, True, False, True])
    port = make_replay_lookup(dates, torch.from_numpy(covs),
                              valid=torch.from_numpy(valid))
    ref = ref_replay_lookup(dates, covs, valid=valid)
    for window in [("2024-01-02", "2024-01-04"), ("2024-01-01", "2024-12-31"),
                   ("2024/01/03", "20240103"), ("2023-01-01", "2023-12-31")]:
        got, want = port(*window), ref(*window)
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port("2024-01-02", "2024-01-04"), covs[1])
    with pytest.raises(ValueError, match="need"):
        make_replay_lookup(dates, covs[:2])


@pytest.mark.parametrize("guarded", [False, True])
def test_replay_lookup_from_result_is_the_reference(guarded):
    rng = np.random.default_rng(4)
    T = 5
    dates = [f"2024-03-{d:02d}" for d in range(4, 4 + T)]
    vr = rng.standard_normal((T, 3, 3))
    served = rng.standard_normal((T, 3, 3))
    ev = np.array([False, True, True, False, True])
    quar = np.array([False, False, True, False, False])

    def result(wrap):
        report = (types.SimpleNamespace(served_cov=wrap(served),
                                        quarantined=wrap(quar))
                  if guarded else None)
        return types.SimpleNamespace(
            arrays=types.SimpleNamespace(dates=dates), report=report,
            outputs=types.SimpleNamespace(vr_cov=wrap(vr),
                                          eigen_valid=wrap(ev)))

    port = replay_lookup_from_result(result(torch.from_numpy))
    ref = ref_from_result(result(np.asarray))
    for a in range(T):
        for b in range(a, T):
            got, want = port(dates[a], dates[b]), ref(dates[a], dates[b])
            assert (got is None) == (want is None), (a, b)
            if want is not None:
                np.testing.assert_array_equal(got, want)


def test_replay_scenarios_rebase_the_shock(engine):
    dates = ["2024-01-02", "2024-01-03"]
    hist = np.stack([_base_cov(7), _base_cov(8)])
    eng = ScenarioEngine(engine.cov, replay_lookup=make_replay_lookup(
        dates, hist), device="cpu")
    plain, shocked, missing = eng.run([
        ScenarioBuilder("rp").replay(*dates).build(),
        ScenarioBuilder("rp-hot").replay(*dates).vol_regime(2.0).build(),
        ScenarioBuilder("rp-miss").replay("1999-01-01", "1999-12-31").build(),
    ])
    # identity transform on a replayed base: that base, bitwise
    assert plain.ok and plain.cov.tobytes() == hist[1].tobytes()
    # shocked replay == shocking an engine whose baseline IS the window
    want, = ScenarioEngine(hist[1], device="cpu").run(
        [ScenarioBuilder("rp-hot").vol_regime(2.0).build()])
    assert shocked.cov.tobytes() == want.cov.tobytes()
    assert missing.status == "rejected"
    assert any("not in the engine's history" in p for p in missing.problems)
    # against the reference engine with the same history
    ref = RefEngine(engine.cov, replay_lookup=ref_replay_lookup(dates, hist))
    ref_shocked, = ref.run([RefBuilder("rp-hot").replay(*dates)
                            .vol_regime(2.0).build()])
    np.testing.assert_allclose(shocked.cov, ref_shocked.cov, rtol=RTOL)
    # no history wired in: replay specs reject instead of guessing
    none, = engine.run([ScenarioBuilder("rp").replay(*dates).build()])
    assert none.status == "rejected"


# -- quarantine counterfactuals (real guarded re-runs) ------------------------

T, N, P, Q = 32, 16, 3, 2
T0 = 24
REF_GCFG = RefConfig(eigen_n_sims=8, eigen_sim_length=T, seed=7,
                     quarantine=RefPolicy(enabled=True))
GCFG = config_from_reference(dataclasses.asdict(REF_GCFG))
SLAB_DATES = [f"2024-02-{d:02d}" for d in range(1, T - T0 + 1)]


@pytest.fixture(autouse=True)
def _reference_jacobi(monkeypatch):
    monkeypatch.setenv("MFM_EIGH_CPU_JACOBI_BATCH", "1")


def _panels(seed=0, poison=False):
    rng = np.random.default_rng(seed)
    panels = [
        rng.normal(0, 0.02, (T, N)),
        rng.lognormal(10, 1, (T, N)),
        rng.normal(size=(T, N, Q)),
        rng.integers(0, P, (T, N)).astype(np.int32),
        rng.random((T, N)) > 0.05,
    ]
    if poison:
        panels[0][T0 + 1, : int(0.6 * N)] = np.nan
    return panels


def _ref_model(panels, sl=slice(None)):
    return RefRiskModel(*(jnp.array(np.asarray(p)[sl]) for p in panels),
                        n_industries=P, config=REF_GCFG)


def _port_model(panels, sl=slice(None)):
    return RiskModel(*(np.asarray(p)[sl] for p in panels), n_industries=P,
                     config=GCFG, device="cpu")


def _ref_copy(state):
    return jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), state)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A guarded prefix checkpoint the reference saved, as both packages'
    states (the port's read through convert.state_from_reference)."""
    import os

    os.environ["MFM_EIGH_CPU_JACOBI_BATCH"] = "1"
    try:
        d = np.random.default_rng(9).standard_normal((8, 1 + P + Q, T))
        sim_covs = np.einsum("mkt,mlt->mkl", d, d) / (T - 1)
        _, ref_st = _ref_model(_panels(), slice(0, T0)).init_state(
            sim_covs=jnp.asarray(sim_covs), sim_length=T)
        path = str(tmp_path_factory.mktemp("cf") / "state.npz")
        ref_artifacts.save_risk_state(path, _ref_copy(ref_st))
    finally:
        del os.environ["MFM_EIGH_CPU_JACOBI_BATCH"]
    st, _ = state_from_reference(path, "cpu")
    return ref_st, st


@pytest.mark.parametrize("case", ["quarantine", "heal"])
def test_counterfactual_is_a_real_rerun_bitwise(checkpoint, case):
    _, st = checkpoint
    panels = _panels(poison=case == "heal")
    slab = _port_model(panels, slice(T0, T))
    _, rep0, _ = slab.update_guarded(clone_state(st))
    base = rep0.served_cov[-1].numpy()
    cf = make_counterfactual_fn(slab, st, SLAB_DATES)
    eng = ScenarioEngine(base, counterfactual_fn=cf, device="cpu")
    i = 2 if case == "quarantine" else 1
    got, = eng.run([ScenarioBuilder("what-if")
                    .flip(SLAB_DATES[i], heal=case == "heal").build()])
    assert got.ok
    # the manual world: the same slab and operands, by hand
    pre = np.zeros(T - T0, np.uint32)
    heal = np.zeros(T - T0, bool)
    if case == "quarantine":
        pre[i] = REASON_FORCED
    else:
        heal[i] = True
        assert bool(rep0.quarantined[i])
    _, rep, _ = _port_model(panels, slice(T0, T)).update_guarded(
        clone_state(st), pre_reasons=pre, heal_mask=heal)
    assert bool(rep.quarantined[i]) == (case == "quarantine")
    want = rep.served_cov[-1].numpy()
    assert got.cov.tobytes() == want.tobytes()
    assert got.cov.tobytes() != base.tobytes()


@pytest.mark.parametrize("case", ["quarantine", "heal"])
def test_counterfactual_is_the_reference_from_one_checkpoint(checkpoint,
                                                             case):
    ref_st, st = checkpoint
    panels = _panels(poison=case == "heal")
    i = 2 if case == "quarantine" else 1
    heal = case == "heal"
    port_cf = make_counterfactual_fn(_port_model(panels, slice(T0, T)), st,
                                     SLAB_DATES)
    ref_cf = ref_cf_fn(_ref_model(panels, slice(T0, T)), _ref_copy(ref_st),
                       SLAB_DATES)
    flips = ((), (SLAB_DATES[i],)) if heal else ((SLAB_DATES[i],), ())
    got, want = port_cf(*flips), np.asarray(ref_cf(*flips))
    np.testing.assert_allclose(got, want, rtol=CF_RTOL,
                               atol=1e-12 * np.abs(want).max())
    spec = (ScenarioBuilder("cf").flip(SLAB_DATES[i], heal=heal)
            .vol_regime(1.5).build())
    r_spec = RefBuilder("cf").flip(SLAB_DATES[i], heal=heal).vol_regime(
        1.5).build()
    g, = ScenarioEngine(got, counterfactual_fn=port_cf, device="cpu").run(
        [spec])
    w, = RefEngine(want, counterfactual_fn=ref_cf).run([r_spec])
    np.testing.assert_allclose(g.cov, w.cov, rtol=CF_RTOL,
                               atol=1e-12 * np.abs(w.cov).max())


def test_counterfactual_leaves_the_state_alone(checkpoint):
    _, st = checkpoint
    def leaves(state):
        out = {}
        for f in dataclasses.fields(state):
            v = getattr(state, f.name)
            for i, x in enumerate(v if isinstance(v, tuple) else (v,)):
                if torch.is_tensor(x):
                    out[f"{f.name}{i}"] = x
        return out

    before = {k: v.numpy().tobytes() for k, v in leaves(st).items()}
    twin = leaves(clone_state(st))
    assert twin.keys() == before.keys() and "nw_carry1" in twin
    for name, x in leaves(st).items():
        assert twin[name].numpy().tobytes() == before[name]
        assert twin[name].data_ptr() != x.data_ptr(), name
    cf = make_counterfactual_fn(_port_model(_panels(), slice(T0, T)), st,
                                SLAB_DATES)
    cf((SLAB_DATES[0],), ())
    assert {k: v.numpy().tobytes() for k, v in leaves(st).items()} == before


def test_counterfactual_guard_rails(checkpoint):
    _, st = checkpoint
    cf = make_counterfactual_fn(_port_model(_panels(), slice(T0, T)), st,
                                SLAB_DATES)
    eng = ScenarioEngine(st.last_good_cov, counterfactual_fn=cf,
                         device="cpu")
    outside, ambiguous = eng.run([
        ScenarioBuilder("cf-outside").flip("1999-01-01").build(),
        ScenarioBuilder("cf-replay").flip(SLAB_DATES[0])
        .replay("2024-01-01", "2024-01-31").build(),
    ])
    assert outside.status == "rejected"
    assert any("outside the slab" in p for p in outside.problems)
    assert ambiguous.status == "rejected"
    assert any("compose ambiguously" in p for p in ambiguous.problems)
    bare, = ScenarioEngine(_base_cov(), device="cpu").run(
        [ScenarioBuilder("cf").flip("2024-02-01").build()])
    assert bare.status == "rejected"
    with pytest.raises(ValueError, match="slab dates"):
        make_counterfactual_fn(_port_model(_panels(), slice(T0, T)), st,
                               SLAB_DATES[:-1])


def test_from_risk_state_serves_the_guarded_checkpoint(checkpoint):
    _, st = checkpoint
    meta = {"style_names": ["size", "mom"], "industry_codes": [3, 5, 9]}
    eng = ScenarioEngine.from_risk_state(st, meta, device="cpu")
    assert eng.cov.tobytes() == st.last_good_cov.numpy().tobytes()
    assert eng.factor_names == ["country", "3", "5", "9", "size", "mom"]
    assert eng.staleness == int(st.staleness)
    ucfg = dataclasses.replace(GCFG, quarantine=dataclasses.replace(
        GCFG.quarantine, enabled=False))
    _, st_u = RiskModel(*_panels(), n_industries=P, config=ucfg,
                        device="cpu").init_state()
    with pytest.raises(ValueError, match="no served covariance"):
        ScenarioEngine.from_risk_state(st_u)


# -- serving scenario tables --------------------------------------------------

def test_query_engines_answer_scenario_lines_as_with_cov(engine):
    names = engine.factor_names
    template = QueryEngine(engine.cov, factor_names=names, device="cpu")
    results = engine.run(_mixed_specs() + _poison()[:1])
    table = engine.query_engines(results, template)
    assert sorted(table) == sorted(r.spec.name for r in results if r.ok)
    # a still clock: the registry's latency histogram is process-wide
    srv = QueryServer(template, ServePolicy(), health="ok", scenarios=table,
                      clock=lambda: 100.0)
    w = np.random.default_rng(2).standard_normal(K).round(6).tolist()
    lines = [json.dumps({"id": n, "weights": w, "scenario": n})
             for n in ("corr-meltup", "regime-hot", "p-nan")]
    buf = io.StringIO()
    srv.run(lines, buf)
    out = {r["id"]: r for r in map(json.loads, buf.getvalue().splitlines())}
    assert out["p-nan"]["outcome"] == "dead_letter"
    for name in ("corr-meltup", "regime-hot"):
        r = next(x for x in results if x.spec.name == name)
        want = template.with_cov(r.cov).query(np.asarray([w]))
        assert out[name]["scenario_id"] == name
        assert out[name]["total_vol"] == float(want.total_vol[0])
        assert out[name]["contribution"] == want.contribution[0].tolist()


# -- manifests ----------------------------------------------------------------

def _manifest_pair(engine):
    specs = _mixed_specs() + _poison()[:1]
    port = build_scenario_manifest(engine.run(specs), engine.factor_names,
                                   stamp_json='{"cfg": 1}', backend="cpu",
                                   staleness=0)
    ref_specs = _mixed_specs(RefBuilder, _ref_preset) + _poison(RefBuilder)[:1]
    ref = ref_build(RefEngine(engine.cov).run(ref_specs),
                    engine.factor_names, stamp_json='{"cfg": 1}',
                    backend="cpu", staleness=0)
    return port, ref


def _same_json(got, want, path="$"):
    """Equal structure, keys and strings; numbers within PROJ_RTOL."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            _same_json(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same_json(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert isinstance(got, float), path
        assert (math.isnan(got) and math.isnan(want)) or math.isclose(
            got, want, rel_tol=PROJ_RTOL, abs_tol=1e-12), (path, got, want)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def test_manifest_is_the_reference_field_for_field(engine):
    port, ref = _manifest_pair(engine)
    _same_json(json.loads(json.dumps(port)), json.loads(json.dumps(ref)))
    assert port["n_ok"] == 9 and port["n_rejected"] == 1
    assert port["n_psd_projected"] >= 1


def test_manifest_sensitivity_blocks_are_the_reference(engine, tmp_path):
    """``build_scenario_manifest(sensitivities=)``: each ok entry gains
    the grad engine's rows as its ``sensitivity`` block, rejected entries
    none; field for field the reference's (numbers within PROJ_RTOL), and
    the manifest still audits clean in both packages."""
    from mfm_tpu.grad import GradEngine as RefGradEngine
    from mfm_tpu_torch.grad import GradEngine

    specs = _mixed_specs() + _poison()[:1]
    ref_specs = _mixed_specs(RefBuilder, _ref_preset) + _poison(RefBuilder)[:1]
    x = np.linspace(-0.2, 0.4, K)
    sens = {e["name"]: e for e in GradEngine(
        engine.cov, device="cpu").sensitivities(specs, x)}
    ref_sens = {e["name"]: e for e in RefGradEngine(
        engine.cov).sensitivities(ref_specs, x)}
    port = build_scenario_manifest(engine.run(specs), engine.factor_names,
                                   sensitivities=sens)
    ref = ref_build(RefEngine(engine.cov).run(ref_specs),
                    engine.factor_names, sensitivities=ref_sens)
    blocks = [e for e in port["scenarios"] if "sensitivity" in e]
    assert len(blocks) == port["n_ok"] == 9
    assert "sensitivity" not in port["scenarios"][-1]
    assert set(blocks[0]["sensitivity"]) == {
        "vol", "nondifferentiable", "d_vol_mult", "d_corr_beta", "d_shift",
        "d_scale", "d_exposure"}
    _same_json(json.loads(json.dumps(port)), json.loads(json.dumps(ref)))
    path = write_scenario_manifest(str(tmp_path), port)
    for audit in (audit_scenario_manifest, ref_audit):
        assert audit(path)[0] == []


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_manifest_audits_clean_in_both_packages(engine, tmp_path, writer):
    port, ref = _manifest_pair(engine)
    man = dict(port if writer == "port" else ref,
               summary=obs.scenario_summary_from_registry())
    write = write_scenario_manifest if writer == "port" else ref_write
    path = write(str(tmp_path), man)
    assert path == scenario_manifest_path_for(str(tmp_path))
    back = read_scenario_manifest(str(tmp_path))
    assert back["n_scenarios"] == 10 and back["n_ok"] == 9
    for audit in (audit_scenario_manifest, ref_audit):
        problems, warnings = audit(path)
        assert problems == []
        assert any("p-nan" in w for w in warnings)

    tampered = read_scenario_manifest(path)
    tampered["scenarios"][1]["spec"]["vol_mult"] = 99.0   # edited results
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(tampered, fh)
    for audit in (audit_scenario_manifest, ref_audit):
        problems, _ = audit(path)
        assert any("spec hash mismatch" in p for p in problems)


def test_manifest_read_flags_tears_and_foreign_files(engine, tmp_path):
    man = build_scenario_manifest(engine.run(_mixed_specs()[:2]),
                                  engine.factor_names)
    path = write_scenario_manifest(str(tmp_path), man)
    with open(path, "w", encoding="utf-8") as fh:          # torn write
        fh.write(json.dumps(man)[: len(json.dumps(man)) // 2])
    with pytest.raises(ScenarioManifestError, match="torn"):
        read_scenario_manifest(path)
    with open(path, "w", encoding="utf-8") as fh:          # wrong artifact
        json.dump({"schema_version": 1, "kind": "checkpoint_manifest",
                   "scenarios": []}, fh)
    with pytest.raises(ScenarioManifestError, match="not a scenario"):
        read_scenario_manifest(path)
    with pytest.raises(ScenarioManifestError, match="unreadable"):
        read_scenario_manifest(str(tmp_path / "nope.json"))
