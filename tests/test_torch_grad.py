"""The port's differentiable-risk subsystem (``mfm_tpu_torch/grad``)
against the JAX package's (``mfm_tpu/grad``), on the CPU at float64: a
counterpart of each test of ``tests/test_grad.py`` (but the compile
contract of the served construct path, which waits for a recompile
counter), each held against the reference on the same inputs, plus the
engine on a checkpoint the reference saved.

Tolerances:

- construction (min-vol, risk parity): weights and vols within rtol
  1e-10 of the reference (measured ~1e-14; the solves contract, so the
  last-bit differences of ``exp`` and of the sums' order stay there);
- the hedge overlay: within 1e-10 at 50 steps, where its projected
  normalized gradient still contracts; at its default 200 steps it
  amplifies a last-bit difference to ~1e-7, the reference's own response
  to a one-ulp change of its input (measured in the test), so there the
  overlay is held to 1e-6 and the vol to rtol 1e-6;
- sensitivities: rtol 1e-9 of the reference, outside an eigen-gap band
  (the port's Jacobi and LAPACK agree to ~1e-12 relative and the eigh
  gradient divides by the gap): a lane is in the band when its stressed
  covariance has two eigenvalues closer than GAP_BAND * lambda_max or a
  minimum eigenvalue inside GATE_BAND * eps * lambda_max of the gate's
  zero; such lanes are counted and left out of the comparison, and the
  ``nondifferentiable`` flags are equal outside it; against central
  differences as the reference's test holds its own (rel 1e-6, abs 1e-9);
- reverse stress: theta* within atol 1e-9 and the vols within rtol 1e-9
  of the reference on each lane whose reference ascent stays outside the
  band at every step (replayed here step by step); lanes inside it are
  counted.

Inside the port everything is bitwise: a batch equals its singles
across a bucket boundary (reverse, sensitivities, every solver), the
grad-safe PSD gate's forward is the serving gate's.
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfm_tpu.config import QuarantinePolicy as RefPolicy
from mfm_tpu.config import RiskModelConfig as RefConfig
from mfm_tpu.data import artifacts as ref_artifacts
from mfm_tpu.grad import GradEngine as RefGradEngine
from mfm_tpu.grad import hedge_batch as ref_hedge
from mfm_tpu.grad import minvol_batch as ref_minvol
from mfm_tpu.grad import read_grad_report as ref_read_report
from mfm_tpu.grad import riskparity_batch as ref_riskparity
from mfm_tpu.grad import sensitivity_batch as ref_sensitivity
from mfm_tpu.grad import write_grad_report as ref_write_report
from mfm_tpu.grad.reverse import stressed_vol as ref_stressed_vol
from mfm_tpu.models.risk_model import RiskModel as RefRiskModel
from mfm_tpu.scenario import PRESETS as REF_PRESETS
from mfm_tpu.scenario.kernel import psd_project as ref_psd_project
from mfm_tpu.scenario.kernel import stress_cov as ref_stress_cov
from mfm_tpu.serve import QueryEngine as RefQueryEngine
from mfm_tpu.serve import QueryServer as RefQueryServer
from mfm_tpu.serve import ServePolicy as RefServePolicy
from mfm_tpu_torch.convert import state_from_reference
from mfm_tpu_torch.grad import (
    GRAD_REPORT_NAME,
    GradEngine,
    ShockBall,
    hedge_batch,
    minvol_batch,
    read_grad_report,
    reverse_stress_batch,
    riskparity_batch,
    sensitivity_batch,
    write_grad_report,
)
from mfm_tpu_torch.grad.engine import (
    HEDGE_ETA,
    HEDGE_STEPS,
    MINVOL_ETA,
    MINVOL_STEPS,
    REVERSE_STEP,
    RISKPARITY_ETA,
    RISKPARITY_STEPS,
)
from mfm_tpu_torch.grad.report import GradReportError, build_grad_report
from mfm_tpu_torch.models.risk_model import portfolio_vol
from mfm_tpu_torch.scenario import (
    PRESETS,
    ScenarioBuilder,
    ScenarioEngine,
    ScenarioSpec,
)
from mfm_tpu_torch.scenario.kernel import psd_project, scenario_batch
from mfm_tpu_torch.scenario.kernel import stress_cov
from mfm_tpu_torch.serve import QueryEngine, QueryServer, ServePolicy

torch.set_num_threads(2)

K = 6
RTOL = 1e-10          # construction: contracting solves, last bits apart
HEDGE_TOL = 1e-6      # the hedge at 200 steps: see the module docstring
SENS_RTOL = 1e-9      # through the eigh gradient, outside the gap band
REV_TOL = 1e-9        # reverse stress, outside the gap band
GAP_BAND = 1e-6       # relative eigen-gap below which lanes are counted
GATE_BAND = 1e3       # |min eig| within this many eps * lambda_max of 0
EPS = float(np.finfo(np.float64).eps)


def _cov(K=K, seed=0):
    """The reference test's covariance recipe: well-conditioned, vol
    ~1e-2."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((K, K)) / np.sqrt(K)
    return (a @ a.T + 1e-3 * np.eye(K)) * 1e-4


def _pad(rows, B, K=K):
    out = np.zeros((B, K))
    out[:len(rows)] = rows
    return out


def _t(a):
    return torch.tensor(np.asarray(a, np.float64))


def _j(a):
    return jnp.asarray(np.asarray(a, np.float64))


def _names(k=K):
    return [f"f{i}" for i in range(k)]


def _engines(cov=None, names=None):
    cov = _cov() if cov is None else cov
    names = names or _names(cov.shape[0])
    return (GradEngine(cov, factor_names=names, device="cpu"),
            RefGradEngine(cov, factor_names=names))


def _in_band(cov_s) -> bool:
    """Is a stressed covariance inside the eigen-gap band (two eigenvalues
    within GAP_BAND * lambda_max) or the gate's band?"""
    w = np.linalg.eigvalsh(np.asarray(cov_s, np.float64))
    scale = max(abs(w[0]), abs(w[-1]))
    return bool(np.diff(w).min() < GAP_BAND * scale
                or abs(w[0]) <= GATE_BAND * EPS * scale)


def _ref_path_in_band(cov, x, ball, steps, step=REVERSE_STEP) -> bool:
    """Replay the reference's ascent for one book step by step: does its
    stressed covariance enter the band at any step (the start and the end
    included)?"""
    lo, hi = (jnp.asarray(v, jnp.float64) for v in ball.bounds(K))
    cov_j, x_j = _j(cov), _j(x)

    @jax.jit
    def body(theta):
        g = jax.grad(ref_stressed_vol)(theta, cov_j, x_j)
        g = jnp.where(jnp.isfinite(g), g, 0.0)
        dirn = g / (jnp.sqrt(jnp.sum(g * g)) + 1e-30)
        cov_s = ref_stress_cov(cov_j, theta[:K], theta[K:2 * K],
                               theta[2 * K], theta[2 * K + 1])
        return jnp.clip(theta + step * (hi - lo) * dirn, lo, hi), cov_s

    theta = jnp.asarray(np.r_[np.zeros(K), np.ones(K), 1.0, 0.0])
    for _ in range(steps + 1):
        theta, cov_s = body(theta)
        if _in_band(cov_s):
            return True
    return False


def _theta_of(entry, names):
    spec = entry["spec"]
    return np.r_[[dict(spec["shift"]).get(f, 0.0) for f in names],
                 [dict(spec["scale"]).get(f, 1.0) for f in names],
                 spec["vol_mult"], spec["corr_beta"]]


def _hold_reverse(got, want, cov, W, ball, steps, names):
    """Hold each lane to the reference; a lane that differs must be one
    whose reference ascent entered the band.  Returns the count of such
    lanes."""
    in_band = 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["label"] == w["label"]
        assert g["vol_base"] == pytest.approx(w["vol_base"], rel=RTOL)
        tg, tw = _theta_of(g, names), _theta_of(w, names)
        same = (np.abs(tg - tw).max() <= REV_TOL
                and g["vol_worst"] == pytest.approx(w["vol_worst"],
                                                    rel=REV_TOL)
                and g["admissible"] == w["admissible"])
        if not same:
            assert _ref_path_in_band(cov, W[i], ball, steps), \
                f"lane {i} differs outside the eigen-gap band"
            in_band += 1
    return in_band


# -- PSD-gate forward parity --------------------------------------------------

@pytest.mark.parametrize("corr_beta,expect_fired", [
    (0.0, False),    # untouched world: gate closed, output IS the input
    (0.9, True),     # corr melt-up clips off-diagonals -> indefinite
])
def test_psd_gate_forward_parity(corr_beta, expect_fired):
    """psd_project is the grad-safe twin of the serving gate: bitwise the
    port's scenario_batch on both branches, and the reference's
    psd_project within rtol 1e-9 (Jacobi against LAPACK when it fires)."""
    cov = _cov()
    shift, scale = np.zeros((1, K)), np.ones((1, K))
    vm, cb = np.array([1.3]), np.array([corr_beta])
    cov_s = stress_cov(_t(cov), _t(shift), _t(scale), _t(vm), _t(cb))
    grad_cov, grad_needs, grad_min = psd_project(cov_s)
    serve_cov, serve_needs, serve_min = scenario_batch(
        _t(cov)[None], _t(shift), _t(scale), _t(vm), _t(cb),
        torch.tensor([False]))

    assert bool(grad_needs[0]) == bool(serve_needs[0]) == expect_fired
    assert torch.equal(grad_cov, serve_cov)
    assert torch.equal(grad_min, serve_min)
    if not expect_fired:
        assert torch.equal(grad_cov, cov_s)
    else:
        lam = np.linalg.eigvalsh(grad_cov[0].numpy())
        assert float(serve_min[0]) < 0
        assert lam[0] >= -K * EPS * lam[-1]

    ref_cov, ref_needs, ref_min = ref_psd_project(ref_stress_cov(
        _j(cov), _j(shift[0]), _j(scale[0]), _j(vm[0]), _j(cb[0])))
    assert bool(ref_needs) == expect_fired
    np.testing.assert_allclose(grad_cov[0].numpy(), np.asarray(ref_cov),
                               rtol=1e-9, atol=1e-9 * np.abs(ref_cov).max())
    assert float(grad_min[0]) == pytest.approx(float(ref_min), rel=1e-9,
                                               abs=1e-18)


# -- analytic sensitivities vs central differences ----------------------------

def test_sensitivity_rows_match_central_differences():
    """Every Jacobian block of one backward against central differences of
    the same forward at float64, at a point that FIRES the projection gate
    (so the grad-safe gate differentiates the projected branch), and
    against the reference's vjp on the same inputs."""
    K4 = 4
    cov = _cov(K4, seed=0)
    shift = np.array([0.002, -0.001, 0.0005, 0.00025])
    scale = np.array([1.1, 0.9, 1.05, 1.0])
    vm, cb = 1.5, 0.3
    x = np.array([0.3, -0.2, 0.5, 0.1])

    def vol_of(sh, sc, m, b, xx):
        cov_s = stress_cov(_t(cov), _t(sh)[None], _t(sc)[None],
                           _t([m]), _t([b]))
        cov_p, _, _ = psd_project(cov_s)
        return float(portfolio_vol(cov_p, _t(xx)[None])[0])

    got = [o.numpy() for o in sensitivity_batch(
        _t(cov)[None], _t(shift)[None], _t(scale)[None], _t([vm]), _t([cb]),
        _t(x))]
    vol, d_shift, d_scale, d_vm, d_cb, d_x = got
    assert vol[0] == pytest.approx(vol_of(shift, scale, vm, cb, x), rel=1e-14)
    assert psd_project(stress_cov(_t(cov), _t(shift)[None], _t(scale)[None],
                                  _t([vm]), _t([cb])))[1][0]

    h = 1e-6
    for j in range(K4):
        e = np.zeros(K4)
        e[j] = h
        fd = (vol_of(shift + e, scale, vm, cb, x)
              - vol_of(shift - e, scale, vm, cb, x)) / (2 * h)
        assert d_shift[0, j] == pytest.approx(fd, rel=1e-6, abs=1e-9)
        fd = (vol_of(shift, scale + e, vm, cb, x)
              - vol_of(shift, scale - e, vm, cb, x)) / (2 * h)
        assert d_scale[0, j] == pytest.approx(fd, rel=1e-6, abs=1e-9)
        fd = (vol_of(shift, scale, vm, cb, x + e)
              - vol_of(shift, scale, vm, cb, x - e)) / (2 * h)
        assert d_x[0, j] == pytest.approx(fd, rel=1e-6, abs=1e-9)
    fd = (vol_of(shift, scale, vm + h, cb, x)
          - vol_of(shift, scale, vm - h, cb, x)) / (2 * h)
    assert d_vm[0] == pytest.approx(fd, rel=1e-6, abs=1e-9)
    fd = (vol_of(shift, scale, vm, cb + h, x)
          - vol_of(shift, scale, vm, cb - h, x)) / (2 * h)
    assert d_cb[0] == pytest.approx(fd, rel=1e-6, abs=1e-9)

    want = [np.asarray(o) for o in ref_sensitivity(
        _j(cov)[None], _j(shift)[None], _j(scale)[None], _j([vm]), _j([cb]),
        _j(x))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=SENS_RTOL,
                                   atol=SENS_RTOL * np.abs(w).max())


def _sens_specs(Builder, presets):
    return ([ScenarioSpec.identity() if Builder is ScenarioBuilder
             else type(presets["corr-meltup"]).identity()]
            + [presets[n] for n in sorted(presets)]
            + [Builder(f"s{i}").shock(f"f{i % K}", add=1e-3 * (i + 1))
               .vol_regime(1.0 + 0.2 * i).correlation(0.15 * i).build()
               for i in range(6)]
            + [Builder("bogus").shock("nope", add=0.01).build()])


def test_engine_sensitivity_entries():
    """Host-layer contract, entry for entry the reference's: ok lanes
    carry name-keyed Jacobian rows, rejected specs carry problems and NO
    rows, identity lanes report the local gradient at the unshocked
    world."""
    from mfm_tpu.scenario import ScenarioBuilder as RefBuilder

    names = _names()
    eng, ref = _engines()
    x = np.linspace(0.1, 0.6, K)
    specs = _sens_specs(ScenarioBuilder, PRESETS)
    got = eng.sensitivities(specs, x)
    want = ref.sensitivities(_sens_specs(RefBuilder, REF_PRESETS), x)
    ident, bogus = got[0], got[-1]

    assert ident["status"] == "ok" and not ident["problems"]
    assert set(ident["d_shift"]) == set(names)
    assert ident["vol"] == pytest.approx(
        float(portfolio_vol(_t(eng.cov), _t(x))))
    assert ident["d_vol_mult"] == pytest.approx(ident["vol"], rel=1e-6)
    crash = got[1 + sorted(PRESETS).index("crash-2015-analog")]
    assert crash["status"] == "ok" and crash["vol"] > ident["vol"]
    assert bogus["status"] == "rejected" and bogus["problems"]
    assert "d_shift" not in bogus

    in_band = 0
    for spec, g, w in zip(specs, got, want):
        assert sorted(g) == sorted(w)
        assert (g["name"], g["status"], g["problems"]) == \
            (w["name"], w["status"], w["problems"])
        if g["status"] != "ok":
            continue
        cov_s = ref_stress_cov(
            _j(eng.cov), *(_j(v) for v in eng._scen._shock_vectors(spec)),
            _j(spec.vol_mult), _j(spec.corr_beta))
        if _in_band(cov_s):
            in_band += 1
            continue
        assert g["nondifferentiable"] == w["nondifferentiable"]
        assert g["vol"] == pytest.approx(w["vol"], rel=SENS_RTOL)
        scale = max(abs(v) for v in w["d_exposure"].values())
        for key in ("d_shift", "d_scale", "d_exposure"):
            assert sorted(g[key]) == sorted(w[key])
            for f in w[key]:
                assert g[key][f] == pytest.approx(
                    w[key][f], rel=SENS_RTOL, abs=SENS_RTOL * scale), key
        for key in ("d_vol_mult", "d_corr_beta"):
            assert g[key] == pytest.approx(w[key], rel=SENS_RTOL,
                                           abs=SENS_RTOL * scale), key
    assert in_band <= 2, in_band   # corr-meltup's clipped world at most


def test_sensitivity_batch_equals_singles_bitwise():
    eng, _ = _engines()
    x = np.linspace(-0.3, 0.5, K)
    specs = _sens_specs(ScenarioBuilder, PRESETS)[:-1]
    batch = eng.sensitivities(specs, x, bucket=32)
    for i, spec in enumerate(specs):
        single, = eng.sensitivities([spec], x, bucket=8)
        assert single == batch[i], spec.name


# -- reverse stress testing ---------------------------------------------------

def test_reverse_batch_equals_singles_across_bucket_boundary():
    """Batch-of-9 at bucket 32 == 9 singles at bucket 8, bitwise, and the
    batch is the reference's outside the band."""
    eng, ref = _engines()
    rng = np.random.default_rng(1)
    W = rng.standard_normal((9, K)) * 0.4
    labels = [f"x{i}" for i in range(9)]

    batch = eng.reverse_stress(W, bucket=32, steps=60, labels=labels)
    for i in range(9):
        single, = eng.reverse_stress(W[i:i + 1], bucket=8, steps=60,
                                     labels=[labels[i]])
        assert single == batch[i], f"lane {i} diverged from its solo run"
    want = ref.reverse_stress(W, bucket=32, steps=60, labels=labels)
    in_band = _hold_reverse(batch, want, eng.cov, W, ShockBall(), 60,
                            eng.factor_names)
    assert in_band <= 2, in_band


def test_reverse_pad_lanes_stay_at_the_identity_start():
    eng, _ = _engines()
    x = np.linspace(-0.3, 0.5, K)
    lo, hi = (_t(v) for v in ShockBall().bounds(K))
    theta0 = _t(np.tile(np.r_[np.zeros(K), np.ones(K), 1.0, 0.0], (8, 1)))
    theta, vol, vol0 = reverse_stress_batch(
        _t(eng.cov), _t(_pad(x[None], 8)), theta0, lo, hi,
        torch.tensor(REVERSE_STEP, dtype=torch.float64), 20)
    assert torch.equal(theta[1:], theta0[1:])
    assert torch.equal(vol0[1:], torch.zeros(7, dtype=torch.float64))
    assert not torch.equal(theta[0], theta0[0])


def test_reverse_worst_case_admissible_and_dominates_presets():
    """The worst shock the ascent returns is admissible, REPLAYABLE
    through the forward scenario path to the same vol, and at least every
    preset drill's vol; and it is the reference's outside the band."""
    names = _names()
    cov = _cov()
    eng, ref = _engines(cov)
    rng = np.random.default_rng(2)
    x = rng.standard_normal(K) * 0.4

    entry, = eng.reverse_stress(x[None])
    assert entry["admissible"]
    assert entry["vol_worst"] >= entry["vol_base"]
    assert entry["vol_delta"] == pytest.approx(
        entry["vol_worst"] - entry["vol_base"])

    scen = ScenarioEngine(cov, factor_names=names, device="cpu")
    results = scen.run([ScenarioSpec.from_dict(entry["spec"])]
                       + [PRESETS[n] for n in sorted(PRESETS)])
    replay, presets = results[0], results[1:]
    assert replay.status == "ok"
    assert float(portfolio_vol(_t(replay.cov), _t(x))) == \
        pytest.approx(entry["vol_worst"], rel=1e-6)
    for r in presets:
        preset_vol = float(portfolio_vol(_t(r.cov), _t(x)))
        assert entry["vol_worst"] >= preset_vol * (1 - 1e-9), r.spec.name

    want = ref.reverse_stress(x[None])
    assert _hold_reverse([entry], want, cov, x[None], ShockBall(), 200,
                         names) == 0


def test_reverse_respects_a_tighter_ball():
    """Shrinking the ball shrinks the answer: the box is a real
    constraint; and both answers are the reference's."""
    eng, ref = _engines()
    x = np.linspace(-0.3, 0.5, K)
    tight = ShockBall(shift_max=0.001, scale_range=0.1,
                      vol_mult_hi=1.5, corr_beta_hi=0.2)
    wide, = eng.reverse_stress(x[None], steps=60)
    small, = eng.reverse_stress(x[None], ball=tight, steps=60)
    assert small["admissible"]
    assert tight.contains(_theta_of(small, eng.factor_names), K)
    assert small["vol_worst"] < wide["vol_worst"]
    from mfm_tpu.grad import ShockBall as RefBall
    for got, ball, rball in ((wide, ShockBall(), None),
                             (small, tight, RefBall(**tight.to_dict()))):
        want = ref.reverse_stress(x[None], ball=rball, steps=60)
        assert _hold_reverse([got], want, eng.cov, x[None], ball, 60,
                             eng.factor_names) == 0


# -- portfolio construction ---------------------------------------------------

def _hold(got, want, rtol=RTOL):
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=rtol * max(np.abs(w).max(), 1e-300))


def test_minvol_matches_closed_form_two_asset():
    """With two assets and no binding box, x1* = (F22 - F12) / (F11 + F22
    - 2 F12); the KKT residual at the solution ~0; the reference's
    numbers."""
    F = np.array([[4.0, 0.5], [0.5, 1.0]]) * 1e-4
    star = (F[1, 1] - F[0, 1]) / (F[0, 0] + F[1, 1] - 2 * F[0, 1])
    args = (np.full((1, 2), 0.5), F, np.zeros(2), np.ones(2))
    got = [o.numpy() for o in minvol_batch(
        *(_t(a) for a in args), _t(MINVOL_ETA), MINVOL_STEPS)]
    x, vol, kkt = got
    assert x[0, 0] == pytest.approx(star, abs=1e-6)
    assert x[0, 1] == pytest.approx(1 - star, abs=1e-6)
    assert float(kkt[0]) < 1e-6
    assert float(vol[0]) == pytest.approx(float(np.sqrt(x[0] @ F @ x[0])),
                                          rel=1e-12)
    want = ref_minvol(*(_j(a) for a in args), _j(MINVOL_ETA),
                      jnp.int32(MINVOL_STEPS))
    _hold(got[:2], want[:2])
    # the KKT residual is rounding noise here: absolute
    assert abs(float(kkt[0]) - float(want[2][0])) < 1e-12


def test_minvol_kkt_residual_small_at_k6():
    eng, ref = _engines()
    res = eng.construct_solve("min_vol", np.full((3, K), 1.0 / K))
    assert res["weights"].shape == (3, K)
    np.testing.assert_allclose(res["weights"].sum(axis=1), 1.0, rtol=1e-9)
    assert np.all(res["weights"] >= 0)
    assert np.all(res["diag"] < 1e-3)
    want = ref.construct_solve("min_vol", np.full((3, K), 1.0 / K))
    _hold([res[k] for k in ("weights", "vols")],
          [want[k] for k in ("weights", "vols")])
    np.testing.assert_allclose(res["diag"], want["diag"], rtol=1e-6,
                               atol=1e-12)


def test_riskparity_equalizes_contributions():
    D = np.diag([4e-4, 1e-4])
    got = [o.numpy() for o in riskparity_batch(
        _t(np.full((1, 2), 0.5)), _t(D), _t(RISKPARITY_ETA),
        RISKPARITY_STEPS)]
    np.testing.assert_allclose(got[0][0], [1 / 3, 2 / 3], atol=1e-9)
    assert float(got[2][0]) < 1e-9
    cov = _cov()
    dense = [o.numpy() for o in riskparity_batch(
        _t(np.full((1, K), 1.0 / K)), _t(cov), _t(RISKPARITY_ETA),
        RISKPARITY_STEPS)]
    x = dense[0][0]
    rc = x * (cov @ x)
    assert rc.max() - rc.min() < 1e-8 * rc.mean()
    assert float(dense[2][0]) < 1e-6
    for args, out in (((np.full((1, 2), 0.5), D), got),
                      ((np.full((1, K), 1.0 / K), cov), dense)):
        want = ref_riskparity(*(_j(a) for a in args), _j(RISKPARITY_ETA),
                              jnp.int32(RISKPARITY_STEPS))
        _hold(out[:2], want[:2])


def _minvol_reference(cov):
    """Exact min-vol on the simplex (no binding upper box) by active-set
    elimination."""
    n = cov.shape[0]
    act = np.ones(n, bool)
    for _ in range(n):
        kc = int(act.sum())
        A = np.zeros((kc + 1, kc + 1))
        A[:kc, :kc] = 2.0 * cov[np.ix_(act, act)]
        A[:kc, kc] = 1.0
        A[kc, :kc] = 1.0
        b = np.zeros(kc + 1)
        b[kc] = 1.0
        xs = np.linalg.solve(A, b)[:kc]
        if (xs >= -1e-12).all():
            x = np.zeros(n)
            x[act] = np.clip(xs, 0.0, None)
            return x
        act[np.where(act)[0][int(xs.argmin())]] = False
    raise AssertionError("active-set elimination did not terminate")


def test_minvol_converges_on_negative_correlation_cov():
    """The annealed schedule lands on the active-set optimum where a
    constant step would orbit it; the reference's numbers."""
    corr = np.array([[1.0, -0.9, -0.2, 0.3],
                     [-0.9, 1.0, 0.1, -0.4],
                     [-0.2, 0.1, 1.0, -0.6],
                     [0.3, -0.4, -0.6, 1.0]])
    sig = np.array([0.02, 0.025, 0.015, 0.03])
    cov = corr * np.outer(sig, sig)
    assert (cov @ np.full(4, 0.25) < 0).any()
    ref_x = _minvol_reference(cov)
    args = (np.full((1, 4), 0.25), cov, np.zeros(4), np.ones(4))
    got = [o.numpy() for o in minvol_batch(
        *(_t(a) for a in args), _t(MINVOL_ETA), MINVOL_STEPS)]
    np.testing.assert_allclose(got[0][0], ref_x, atol=1e-8)
    assert float(got[1][0]) == pytest.approx(
        float(np.sqrt(ref_x @ cov @ ref_x)), rel=1e-10)
    assert float(got[2][0]) < 1e-8
    _hold(got[:2], ref_minvol(*(_j(a) for a in args), _j(MINVOL_ETA),
                              jnp.int32(MINVOL_STEPS))[:2])


def _hedge_case():
    cov = _cov()
    rng = np.random.default_rng(3)
    x0 = rng.standard_normal(K) * 0.3
    mask = np.array([1.0, 1.0, 0.0, 0.0, 1.0, 0.0])
    return cov, x0, mask, 0.25


def _assert_conditioning(got, want, nudged):
    """Where the port is farther than RTOL from the reference, the
    reference itself moves by at least a thousandth of that distance when
    its covariance moves by one ulp: the solve's own conditioning."""
    dist = np.abs(np.asarray(got) - np.asarray(want)).max()
    if dist > RTOL * np.abs(want).max():
        assert np.abs(np.asarray(nudged) - np.asarray(want)).max() \
            > 1e-3 * dist


def test_hedge_reduces_vol_and_respects_mask_and_box():
    cov, x0, mask, hmax = _hedge_case()
    args = (_pad(x0[None], 8), np.zeros((8, K)), cov, _pad(mask[None], 8))
    got = [o.numpy() for o in hedge_batch(
        *(_t(a) for a in args), _t(hmax), _t(HEDGE_ETA), HEDGE_STEPS)]
    xt, h, vol = got[0][0], got[1][0], got[2]
    base_vol = float(portfolio_vol(_t(cov), _t(x0)))
    assert float(vol[0]) < base_vol
    assert np.all(h[mask == 0] == 0)
    assert np.all(np.abs(h) <= hmax + 1e-12)
    np.testing.assert_array_equal(xt[mask == 0], x0[mask == 0])
    assert np.all(got[0][1:] == 0) and np.all(got[1][1:] == 0)

    want = [np.asarray(o) for o in ref_hedge(
        *(_j(a) for a in args), _j(hmax), _j(HEDGE_ETA),
        jnp.int32(HEDGE_STEPS))]
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=HEDGE_TOL)
    np.testing.assert_allclose(got[2], want[2], rtol=HEDGE_TOL)
    # the reference's own response to a one-ulp change of its book: as
    # large as the port's distance from it, the solve's conditioning
    _assert_conditioning(got[1], want[1], ref_hedge(
        *(_j(a) for a in args[:2]), _j(np.nextafter(cov, 1.0)),
        _j(args[3]), _j(hmax), _j(HEDGE_ETA), jnp.int32(HEDGE_STEPS))[1])
    # before the anneal's tail, where the iteration still contracts, the
    # port is the reference within RTOL
    short = [o.numpy() for o in hedge_batch(
        *(_t(a) for a in args), _t(hmax), _t(HEDGE_ETA), 50)]
    _hold(short, ref_hedge(*(_j(a) for a in args), _j(hmax), _j(HEDGE_ETA),
                           jnp.int32(50)))


@pytest.mark.parametrize("solver", ["min_vol", "risk_parity", "hedge"])
def test_construct_batch_equals_singles_bitwise(solver):
    """Batch-of-9 at bucket 32 == 9 singles at bucket 8 for every solver,
    and all-zero pad lanes stay EXACTLY zero."""
    cov = _t(_cov())
    rng = np.random.default_rng(4)
    W = np.abs(rng.standard_normal((9, K)))
    W = W / W.sum(axis=1, keepdims=True)
    steps = 60

    def solve(rows, B):
        xs0 = _t(_pad(rows, B))
        if solver == "min_vol":
            return minvol_batch(xs0, cov, _t(np.zeros(K)), _t(np.ones(K)),
                                _t(MINVOL_ETA), steps)
        if solver == "risk_parity":
            return riskparity_batch(xs0, cov, _t(RISKPARITY_ETA), steps)
        return hedge_batch(xs0, _t(np.zeros((B, K))), cov,
                           _t(_pad(np.ones_like(rows), B)), _t(0.5),
                           _t(HEDGE_ETA), steps)

    batch = [o.numpy() for o in solve(W, 32)]
    for i in range(9):
        single = [o.numpy() for o in solve(W[i:i + 1], 8)]
        for b, s in zip(batch, single):
            assert np.array_equal(b[i], s[0]), f"lane {i} diverged"
    assert np.all(batch[0][9:] == 0)


# -- the engine on a checkpoint the reference saved ---------------------------

T, T0, N, P, Q = 48, 40, 24, 3, 2
KS = 1 + P + Q


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A guarded checkpoint the reference saved, as both packages'
    states (the port's read through convert.state_from_reference)."""
    import os

    rng = np.random.default_rng(0)
    panels = [rng.normal(0, 0.02, (T, N)), rng.lognormal(10, 1, (T, N)),
              rng.normal(size=(T, N, Q)),
              rng.integers(0, P, (T, N)).astype(np.int32),
              rng.random((T, N)) > 0.05]
    cfg = RefConfig(eigen_n_sims=8, eigen_sim_length=T, seed=7,
                    quarantine=RefPolicy(enabled=True))
    os.environ["MFM_EIGH_CPU_JACOBI_BATCH"] = "1"
    try:
        d = np.random.default_rng(9).standard_normal((8, KS, T))
        sim_covs = np.einsum("mkt,mlt->mkl", d, d) / (T - 1)
        _, ref_st = RefRiskModel(
            *(jnp.array(p[:T0]) for p in panels), n_industries=P,
            config=cfg).init_state(sim_covs=jnp.asarray(sim_covs),
                                   sim_length=T)
        ref_st = jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True),
                                        ref_st)
        path = str(tmp_path_factory.mktemp("grad") / "state.npz")
        ref_artifacts.save_risk_state(path, ref_st)
    finally:
        del os.environ["MFM_EIGH_CPU_JACOBI_BATCH"]
    st, _ = state_from_reference(path, "cpu")
    meta = {"style_names": ["size", "mom"], "industry_codes": [3, 5, 9]}
    return ref_st, st, meta


def test_from_risk_state_on_a_reference_checkpoint(checkpoint):
    ref_st, st, meta = checkpoint
    eng = GradEngine.from_risk_state(st, meta, device="cpu")
    ref = RefGradEngine.from_risk_state(ref_st, meta)
    assert eng.factor_names == ref.factor_names == [
        "country", "3", "5", "9", "size", "mom"]
    assert eng.cov.tobytes() == np.asarray(ref.cov).tobytes()
    assert eng.staleness == ref.staleness

    rng = np.random.default_rng(11)
    W = rng.standard_normal((3, KS)) * 0.3
    got = eng.construct_solve("min_vol", W)
    want = ref.construct_solve("min_vol", W)
    # 2,000 steps leave this covariance's min-vol unconverged (KKT
    # ~1.5e-4): the weights are held at HEDGE_TOL within the reference's
    # own one-ulp conditioning, the vols at RTOL
    np.testing.assert_allclose(got["weights"], want["weights"], rtol=0,
                               atol=HEDGE_TOL)
    _assert_conditioning(got["weights"], want["weights"], RefGradEngine(
        np.nextafter(np.asarray(ref.cov), 1.0),
        factor_names=ref.factor_names).construct_solve("min_vol",
                                                       W)["weights"])
    _hold([got["vols"]], [want["vols"]])
    got = eng.construct_solve("risk_parity", np.abs(W))
    want = ref.construct_solve("risk_parity", np.abs(W))
    _hold([got["weights"], got["vols"]], [want["weights"], want["vols"]])

    entries = eng.reverse_stress(W, steps=40)
    assert _hold_reverse(entries, ref.reverse_stress(W, steps=40), eng.cov,
                         W, ShockBall(), 40, eng.factor_names) <= 1
    presets = [PRESETS[n] for n in sorted(PRESETS)]
    got = eng.sensitivities(presets, W[0])
    want = ref.sensitivities([REF_PRESETS[n] for n in sorted(REF_PRESETS)],
                             W[0])
    for g, w in zip(got, want):
        assert g["vol"] == pytest.approx(w["vol"], rel=SENS_RTOL)

    with pytest.raises(ValueError, match="no served covariance"):
        GradEngine.from_risk_state(types.SimpleNamespace(guarded=False))


def test_grad_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GradEngine(_cov())


# -- grad reports -------------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "reference"])
def test_grad_report_round_trips_between_packages(tmp_path, writer):
    eng, _ = _engines()
    entries = eng.reverse_stress(np.linspace(-0.3, 0.5, K)[None], steps=20)
    report = build_grad_report("reverse_stress", entries,
                               stamp_json='{"cfg": 1}', backend="cpu",
                               staleness=0, params={"steps": 20})
    write = write_grad_report if writer == "port" else ref_write_report
    path = write(str(tmp_path), report)
    assert path.endswith(GRAD_REPORT_NAME)
    for read in (read_grad_report, ref_read_report):
        back = read(str(tmp_path))
        assert back["grad_kind"] == "reverse_stress"
        assert back["entries"] == json.loads(json.dumps(entries))
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(json.dumps(report)[:40])
    with pytest.raises(GradReportError, match="torn"):
        read_grad_report(path)


# -- serve-side construction --------------------------------------------------

K4 = 4


def _serve_cov():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((K4, K4)) / 2
    return (a @ a.T + 1e-3 * np.eye(K4)) * 1e-4, rng.standard_normal(K4)


def _serve_engines():
    cov, bench = _serve_cov()
    names = ["country", "ind0", "size", "mom"]
    return (QueryEngine(cov, factor_names=names, benchmarks={"idx": bench},
                        device="cpu"),
            RefQueryEngine(cov, factor_names=names,
                           benchmarks={"idx": bench}))


def _req(rid, w=None, **kw):
    return json.dumps({"id": rid,
                       "weights": [0.1] * K4 if w is None else w, **kw})


def _hold_responses(got, want):
    """Same fields; numbers within RTOL (HEDGE_TOL for hedge answers)."""
    assert sorted(got) == sorted(want)
    for rid in want:
        g, w = got[rid], want[rid]
        assert sorted(g) == sorted(w), rid
        tol = HEDGE_TOL if w.get("solver") == "hedge" else RTOL
        for k in w:
            if isinstance(w[k], float):
                assert g[k] == pytest.approx(w[k], rel=tol, abs=tol), (rid, k)
            elif isinstance(w[k], list) and w[k] and isinstance(w[k][0],
                                                                 float):
                np.testing.assert_allclose(g[k], w[k], rtol=tol, atol=tol)
            elif k != "trace_id":
                assert g[k] == w[k], (rid, k)


def test_serve_construct_end_to_end():
    """Construction requests ride the query loop: same admission, same
    stamps, answers from the grad solvers against the SERVED covariance;
    a mixed drain answers risk queries on the exact pre-construct path;
    every response the reference's."""
    eng, ref_eng = _serve_engines()
    lines = [_req("q1"), _req("c1", construct="min_vol"),
             _req("c2", construct={"solver": "risk_parity"}),
             _req("c3", construct={"solver": "hedge",
                                   "hedge_factors": ["size", "mom"],
                                   "hmax": 0.5})]
    outs = []
    for srv in (QueryServer(eng, ServePolicy(default_deadline_s=60.0),
                            health="ok", clock=lambda: 100.0),
                RefQueryServer(ref_eng,
                               RefServePolicy(default_deadline_s=60.0),
                               health="ok", clock=lambda: 100.0)):
        for ln in lines:
            srv.submit_line(ln)
        outs.append({r["id"]: r for r in srv.drain()})
    out, want = outs
    assert len(out) == 4 and all(r["ok"] for r in out.values())
    assert "kind" not in out["q1"]
    for rid, solver in (("c1", "min_vol"), ("c2", "risk_parity"),
                        ("c3", "hedge")):
        r = out[rid]
        assert r["kind"] == "construct" and r["solver"] == solver
        assert len(r["weights"]) == K4 and r["total_vol"] > 0
        assert r["health"] == "ok" and r["scenario_id"] is None
    assert sum(out["c1"]["weights"]) == pytest.approx(1.0, rel=1e-9)
    assert min(out["c2"]["weights"]) > 0
    assert out["c3"]["weights"][:2] == [0.1, 0.1]

    ge = GradEngine(_serve_cov()[0], factor_names=eng.factor_names,
                    device="cpu")
    res = ge.construct_solve("min_vol", np.full((1, K4), 0.1))
    assert out["c1"]["total_vol"] == float(res["vols"][0])
    _hold_responses(out, want)


def test_serve_construct_bad_solver_dead_letters(tmp_path):
    from mfm_tpu_torch.serve.server import REQ_REASON_BAD_CONSTRUCT
    eng, ref_eng = _serve_engines()
    bad_lines = [_req("b1", construct="sharpe_max"),
                 _req("b2", construct={"solver": "hedge",
                                       "hedge_factors": ["bogus"]}),
                 _req("b3", construct={"solver": "hedge", "hmax": -1}),
                 _req("b4", construct=7),
                 _req("b5", construct="min_vol", sweep=True)]
    recs = []
    for srv_cls, pol, e, name in ((QueryServer, ServePolicy, eng, "port"),
                                  (RefQueryServer, RefServePolicy, ref_eng,
                                   "ref")):
        dl = str(tmp_path / f"{name}.jsonl")
        srv = srv_cls(e, pol(), health="ok", dead_letter_path=dl,
                      clock=lambda: 100.0)
        resps = [srv.submit_line(ln)[0] for ln in bad_lines]
        srv.close()
        recs.append((resps, [json.loads(ln) for ln in open(dl)]))
    (got, got_dl), (want, want_dl) = recs
    assert got[0]["outcome"] == "dead_letter"
    assert got[0]["reasons"] == ["bad_construct"]
    assert got[1]["reasons"] == ["bad_construct"]
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k != "trace_id"} == \
            {k: v for k, v in w.items() if k != "trace_id"}
    assert [r["id"] for r in got_dl] == ["b1", "b2", "b3", "b4", "b5"]
    assert all(r["mask"] & REQ_REASON_BAD_CONSTRUCT for r in got_dl[:4])
    for g, w in zip(got_dl, want_dl):
        assert {k: v for k, v in g.items() if k not in ("trace_id", "ts")} \
            == {k: v for k, v in w.items() if k not in ("trace_id", "ts")}


def test_serve_construct_scenario_tagged_solves_stressed_world():
    """A scenario-tagged construct request solves against the STRESSED
    covariance: under a pure vol-regime doubling the min-vol weights are
    unchanged (argmin is scale-free) but the reported vol doubles."""
    eng, _ = _serve_engines()
    cov, _ = _serve_cov()
    sc = ScenarioEngine(cov, factor_names=eng.factor_names, device="cpu")
    results = sc.run([ScenarioBuilder("hot").vol_regime(2.0).build()])
    server = QueryServer(eng, ServePolicy(default_deadline_s=60.0),
                         health="ok", clock=lambda: 100.0,
                         scenarios=sc.query_engines(results, eng))
    server.submit_line(_req("plain", construct="min_vol"))
    server.submit_line(_req("hot", construct="min_vol", scenario="hot"))
    out = {r["id"]: r for r in server.drain()}
    assert out["hot"]["scenario_id"] == "hot"
    np.testing.assert_allclose(out["hot"]["weights"],
                               out["plain"]["weights"], atol=1e-9)
    assert out["hot"]["total_vol"] == pytest.approx(
        2.0 * out["plain"]["total_vol"], rel=1e-9)


def test_serve_construct_batch_is_its_singles_bitwise():
    """A drained batch of construct lines answers each line as the same
    line drained alone (bucket 32 against bucket 8), byte for byte."""
    eng, _ = _serve_engines()
    rng = np.random.default_rng(5)
    lines = [_req(f"c{i}", np.round(0.2 * rng.standard_normal(K4),
                                    6).tolist(),
                  construct=("min_vol", "risk_parity")[i % 2])
             for i in range(20)]

    def serve(batch):
        srv = QueryServer(eng, ServePolicy(default_deadline_s=60.0),
                          health="ok", clock=lambda: 100.0)
        for ln in batch:
            srv.submit_line(ln)
        return {r["id"]: json.dumps(r, sort_keys=True) for r in srv.drain()}

    together = serve(lines)
    for ln in lines:
        assert serve([ln]) == {json.loads(ln)["id"]:
                               together[json.loads(ln)["id"]]}


def test_warm_index_seeds_near_miss_solves():
    """With a WarmStartIndex, a near-miss book is seeded from the cached
    cold solution at a quarter of the steps and says so in its
    ``warm_start`` stanza; cold answers carry no such field and are
    unchanged; the reference answers the same lines the same way."""
    from mfm_tpu.serve.cache import WarmStartIndex as RefWarm
    from mfm_tpu_torch.serve.cache import WarmStartIndex

    eng, ref_eng = _serve_engines()
    lines = [_req("cold", [0.1, 0.2, 0.3, 0.4], construct="min_vol"),
             _req("near", [0.1, 0.2, 0.3, 0.401], construct="min_vol"),
             _req("far", [0.9, -0.2, 0.05, 0.1], construct="min_vol")]
    outs = []
    for srv_cls, pol, e, warm in ((QueryServer, ServePolicy, eng,
                                   WarmStartIndex()),
                                  (RefQueryServer, RefServePolicy, ref_eng,
                                   RefWarm())):
        srv = srv_cls(e, pol(default_deadline_s=60.0), health="ok",
                      clock=lambda: 100.0, warm_index=warm)
        out = {}
        for ln in lines:     # one line a drain: the index fills in between
            srv.submit_line(ln)
            out.update({r["id"]: r for r in srv.drain()})
        outs.append((out, warm.stats()))
    (got, stats), (want, ref_stats) = outs
    assert "warm_start" not in got["cold"] and "warm_start" not in got["far"]
    assert got["near"]["warm_start"] == {
        "used": True, "steps": MINVOL_STEPS // 4,
        "steps_saved": MINVOL_STEPS - MINVOL_STEPS // 4, "parity": "seeded"}
    plain = QueryServer(eng, ServePolicy(default_deadline_s=60.0),
                        health="ok", clock=lambda: 100.0)
    plain.submit_line(lines[0])
    assert plain.drain()[0]["weights"] == got["cold"]["weights"]
    assert stats == ref_stats
    _hold_responses(got, want)
