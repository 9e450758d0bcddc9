"""The port's streaming sweep (``mfm_tpu_torch/scenario/sweep.py`` and the
fold of ``scenario/kernel.py``) against the JAX package's, on the CPU.

- **Samplers** are host numpy in both packages: the same seed gives the
  same blocks, byte for byte.
- **Port vs reference** on the same sweep at float64: the counts dict and
  the histograms exactly; the top-k vols within rtol 1e-9 (offender lanes
  go through each package's PSD gate: Jacobi here, LAPACK there), with
  equal scenario indices wherever the vols are not tied within that
  tolerance.
- **Inside the port, bitwise:** streaming == materializing (the top-k
  and the histogram of a sweep equal those of the same thetas run through
  ``ScenarioEngine.run`` and ``book_vols``), the top-1 spec round-trips
  to the identical vol for one book and for all books, poisoned lanes
  leave the healthy lanes' answers alone, and ties keep the reference's
  ``lax.top_k`` rule (the lower index wins).
- **Manifests** either package writes audit clean in the other.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfm_tpu.grad.engine import ShockBall as RefBall
from mfm_tpu.obs import instrument as ref_obs
from mfm_tpu.scenario import GridSampler as RefGrid
from mfm_tpu.scenario import ReplaySampler as RefReplay
from mfm_tpu.scenario import SobolSampler as RefSobol
from mfm_tpu.scenario import SweepEngine as RefSweepEngine
from mfm_tpu.scenario import UniformSampler as RefUniform
from mfm_tpu.scenario import audit_sweep_manifest as ref_audit
from mfm_tpu.scenario import build_sweep_manifest as ref_build
from mfm_tpu.scenario import monthly_replay_windows as ref_windows
from mfm_tpu.scenario import theta_to_spec as ref_theta_to_spec
from mfm_tpu.scenario import write_sweep_manifest as ref_write
from mfm_tpu.scenario import kernel as ref_kernel
from mfm_tpu_torch.grad import ShockBall
from mfm_tpu_torch.obs import instrument as obs
from mfm_tpu_torch.scenario import (
    GridSampler,
    ReplaySampler,
    ScenarioSpec,
    SobolSampler,
    SweepEngine,
    SweepManifestError,
    UniformSampler,
    audit_sweep_manifest,
    build_sweep_manifest,
    monthly_replay_windows,
    read_sweep_manifest,
    sweep_manifest_path_for,
    theta_to_spec,
    write_sweep_manifest,
)
from mfm_tpu_torch.scenario.kernel import (
    _init_sweep_carry,
    _merge_into_carry,
    book_vols,
)

torch.set_num_threads(2)

K = 10
RTOL = 1e-9           # offender lanes: the port's Jacobi vs LAPACK's eigh
NAMES = [f"f{i}" for i in range(K)]
BALL = dict(shift_max=5e-3, scale_range=0.4, vol_mult_lo=1.0,
            vol_mult_hi=3.0, corr_beta_lo=0.0, corr_beta_hi=0.9)


def _base_cov(seed=0, k=K, dtype=np.float64):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(k, k))
    return ((a @ a.T + 1e-2 * np.eye(k)) * 1e-4).astype(dtype)


def _books(n=2, seed=5, k=K, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, k)) / np.sqrt(k)).astype(dtype)


def _ball():
    # deliberately spicy: corr_beta up to 0.9 pushes lanes past the
    # certificate, so the offender exact path is exercised, not idle
    return ShockBall(**BALL)


def _engine(dtype=np.float64, **kw):
    return SweepEngine(_base_cov(dtype=dtype), factor_names=NAMES,
                       device="cpu", **kw)


def _vols(covs, xs):
    return book_vols(torch.from_numpy(np.asarray(covs)),
                     torch.from_numpy(np.asarray(xs))).numpy()


def _materialized(engine, ths, xs, keep=None):
    """Every theta through ``ScenarioEngine.run`` (the exact forward path,
    PSD gate included) and the same ``book_vols``: the lane indices kept,
    their (B, S) vols, and the projected count."""
    keep = range(len(ths)) if keep is None else keep
    specs = [theta_to_spec(ths[i], engine.factor_names, f"sweep-{i}")
             for i in keep]
    results = engine._scen.run(specs)
    ok = [i for i, r in zip(keep, results) if r.ok]
    vols = _vols(np.stack([r.cov for r in results if r.ok]), xs)
    return ok, vols, sum(r.psd_projected for r in results if r.ok)


def _table(ok, vols, top_k):
    """Top-k by descending vol, the earlier scenario index first on ties."""
    out = []
    for b in range(vols.shape[0]):
        order = sorted(range(len(ok)), key=lambda j: (-vols[b, j], ok[j]))
        out.append([(float(vols[b, j]), int(ok[j])) for j in order[:top_k]])
    return out


def _top(book):
    return [(e["vol"], e["src"]) for e in book["top"]]


# -- samplers -----------------------------------------------------------------

@pytest.mark.parametrize("kind", ["uniform", "sobol", "grid", "replay"])
def test_sampler_blocks_are_the_reference(kind):
    if kind == "uniform":
        port = UniformSampler(_ball(), K, 300, seed=12)
        ref = RefUniform(RefBall(**BALL), K, 300, seed=12)
    elif kind == "sobol":
        port = SobolSampler(_ball(), K, 100, seed=2, cb_levels=9)
        ref = RefSobol(RefBall(**BALL), K, 100, seed=2, cb_levels=9)
    elif kind == "grid":
        port = GridSampler(_ball(), K, n_vol=5, n_corr=7)
        ref = RefGrid(RefBall(**BALL), K, n_vol=5, n_corr=7)
    else:
        wins = [("2024-01-03", "2024-01-19"), ("2024-02-01", "2024-02-14")]
        port, ref = ReplaySampler(wins, K), RefReplay(wins, K)
    got, want = list(port.blocks(64)), list(ref.blocks(64))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert port.describe() == ref.describe()
    assert port.cb_values.tobytes() == ref.cb_values.tobytes()
    assert tuple(port.windows) == tuple(ref.windows)
    if kind == "sobol":
        assert port.describe()["qmc"] in ("sobol", "uniform-fallback")
    if kind == "uniform":   # a different seed moves the draws
        other = UniformSampler(_ball(), K, 300, seed=13)
        assert next(iter(other.blocks(64)))[0].tobytes() != got[0][0].tobytes()


def test_monthly_replay_windows_are_the_reference():
    dates = (list(np.arange("2024-01-03", "2024-01-20",
                            dtype="datetime64[D]"))
             + list(np.arange("2024-02-01", "2024-02-15",
                              dtype="datetime64[D]")))
    wins = monthly_replay_windows(dates)
    assert wins == ref_windows(dates) == [("2024-01-03", "2024-01-19"),
                                          ("2024-02-01", "2024-02-14")]
    assert monthly_replay_windows([]) == []


def test_shock_ball_and_theta_to_spec_are_the_reference():
    ball, ref = _ball(), RefBall(**BALL)
    assert ball.to_dict() == ref.to_dict() and ball.bounds(K) == ref.bounds(K)
    th = next(iter(UniformSampler(ball, K, 8, seed=1).blocks(8)))[0]
    for t in list(th) + [th[0] * 1.0]:
        assert ball.contains(t, K) == ref.contains(t, K)
        assert theta_to_spec(t, NAMES, "x", replay=("a", "b")).spec_hash() \
            == ref_theta_to_spec(t, NAMES, "x", replay=("a", "b")).spec_hash()
    assert not ball.contains(th[0] * 10, K)


# -- book_vols and the merge against the reference ----------------------------

def test_book_vols_is_the_reference():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((7, K, K))
    covs = np.einsum("sij,skj->sik", a, a) * 1e-4
    xs = _books(3)
    want = np.asarray(ref_kernel.book_vols(jnp.asarray(covs),
                                           jnp.asarray(xs)))
    np.testing.assert_allclose(_vols(covs, xs), want, rtol=1e-12)


def test_merge_keeps_the_reference_tie_rule():
    """Planted ties: equal vols inside a chunk and against the carry.  The
    stable descending sort keeps lax.top_k's order — carried entries
    first, then earlier chunk lanes."""
    B, k, TH, bins = 2, 4, 2 * K + 2, 8
    rng = np.random.default_rng(0)
    th = rng.standard_normal((6, TH))
    lo, width = np.zeros(B), np.full(B, 0.25)
    chunks = [
        (np.array([[1.0, 2.0, 2.0, 0.5, 2.0, 1.0],
                   [0.7, 0.7, 0.7, 0.7, 0.7, 0.7]]),
         np.array([True, True, True, True, False, True])),
        (np.array([[2.0, 2.0, 1.0, 3.0, 2.0, 0.1],
                   [0.7, 0.9, 0.7, 0.7, np.nan, 0.7]]),
         np.array([True, True, True, True, False, True])),
    ]
    port = _init_sweep_carry(B, k, TH, bins, torch.float64, "cpu")
    ref = ref_kernel._init_sweep_carry(B, k, TH, bins, jnp.float64)
    for c, (vols, take) in enumerate(chunks):
        src = np.arange(6, dtype=np.int32) + 6 * c
        base = np.zeros(6, np.int32)
        reject = ~take
        projected = np.zeros(6, bool)
        port = _merge_into_carry(
            port, *(torch.from_numpy(x) for x in (
                vols, th, src, base, take, reject, projected, lo, width)))
        ref = ref_kernel._merge_into_carry(
            ref, *(jnp.asarray(x) for x in (
                vols, th, src, base, take, reject, projected, lo, width)))
    names = ("top_vol", "top_theta", "top_src", "top_base", "hist", "counts")
    for name, g, w in zip(names, port, ref):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_array_equal(port[2].numpy(), [[9, 1, 2, 6],
                                                    [7, 0, 1, 2]])


# -- streaming == materializing (bitwise, inside the port) --------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_streaming_top_k_and_histogram_are_the_materializing_engine(dtype):
    engine = _engine(dtype)
    xs = _books(dtype=dtype)
    res = engine.sweep(xs, UniformSampler(_ball(), K, 600, seed=3),
                       chunk=128, top_k=12, bins=32, refine=None)
    assert res.counts["n_ok"] == 600 and res.counts["n_rejected"] == 0
    assert res.counts["n_offenders"] > 0
    ths = np.concatenate([th for th, _, _ in
                          UniformSampler(_ball(), K, 600, seed=3).blocks(128)])
    ok, vols, n_proj = _materialized(engine, ths, xs)
    for b, (book, want) in enumerate(zip(res.books, _table(ok, vols, 12))):
        assert _top(book) == want, f"book {b} top-k diverged"
        lo, w = book["hist"]["lo"], book["hist"]["bin_width"]
        bi = np.clip(((vols[b] - dtype(lo)) / dtype(w)).astype(np.int32),
                     0, 31)
        np.testing.assert_array_equal(book["hist"]["counts"],
                                      np.bincount(bi, minlength=32))
    assert res.counts["n_psd_projected"] == n_proj > 0


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_top1_spec_round_trips_bitwise(dtype):
    """The worst case is REPLAYABLE: its embedded spec re-runs through the
    ordinary forward engine to the identical vol, priced for that book
    alone and beside every book."""
    engine = _engine(dtype)
    xs = _books(3, dtype=dtype)
    res = engine.sweep(xs, UniformSampler(_ball(), K, 256, seed=1),
                       chunk=128, top_k=4, refine=None)
    for b, book in enumerate(res.books):
        top = book["top"][0]
        [r] = engine._scen.run([ScenarioSpec.from_dict(top["spec"])])
        assert r.ok, r.problems
        alone = _vols(r.cov[None], xs[b:b + 1])[0, 0]
        beside = _vols(r.cov[None], xs)[b, 0]
        assert float(alone) == float(beside) == top["vol"]


# -- port vs reference on the same sweep --------------------------------------

@pytest.mark.parametrize("case", ["uniform", "sobol", "grid"])
def test_sweep_is_the_reference(case):
    xs = _books()
    if case == "uniform":
        args = (UniformSampler(_ball(), K, 600, seed=3),
                RefUniform(RefBall(**BALL), K, 600, seed=3), 128)
    elif case == "sobol":
        args = (SobolSampler(_ball(), K, 300, seed=2),
                RefSobol(RefBall(**BALL), K, 300, seed=2), 64)
    else:
        args = (GridSampler(_ball(), K, n_vol=9, n_corr=11),
                RefGrid(RefBall(**BALL), K, n_vol=9, n_corr=11), 32)
    got = _engine().sweep(xs, args[0], chunk=args[2], top_k=10, bins=48)
    want = RefSweepEngine(_base_cov(), factor_names=NAMES).sweep(
        xs, args[1], chunk=args[2], top_k=10, bins=48, refine=None)
    assert got.counts == want.counts
    assert got.sampler == want.sampler
    assert (got.chunk, got.chunk_bucket, got.top_k, got.bins) == \
        (want.chunk, want.chunk_bucket, want.top_k, want.bins)
    # a lane whose bin position lies within RTOL of a bin edge may land on
    # either side in the two packages (the grid puts whole rows there:
    # vol_mult * bins / hist_span is an integer); every other lane must
    # land in the same bin
    ths = np.concatenate([th for th, _, _ in args[0].blocks(args[2])])
    _, vols, _ = _materialized(_engine(), ths, xs)
    for b, (g, w) in enumerate(zip(got.books, want.books)):
        assert g["label"] == w["label"]
        pos = vols[b] / g["hist"]["bin_width"]
        on_edge = int((np.abs(pos - np.round(pos)) <= RTOL * pos).sum())
        moved = np.abs(np.subtract(g["hist"]["counts"],
                                   w["hist"]["counts"])).sum()
        assert sum(g["hist"]["counts"]) == sum(w["hist"]["counts"])
        assert moved <= 2 * on_edge, (moved, on_edge)
        if case != "grid":
            assert on_edge == 0
        np.testing.assert_allclose(g["vol_base"], w["vol_base"], rtol=1e-14)
        gv = np.array([e["vol"] for e in g["top"]])
        wv = np.array([e["vol"] for e in w["top"]])
        np.testing.assert_allclose(gv, wv, rtol=RTOL)
        for j, (ge, we) in enumerate(zip(g["top"], w["top"])):
            tied = np.abs(wv - wv[j]) <= RTOL * wv[j]
            if tied.sum() == 1:
                assert ge["src"] == we["src"], (j, ge["src"], we["src"])
                assert ge["spec_hash"] == we["spec_hash"]


# -- rejected-lane exclusion --------------------------------------------------

class _PoisonSampler:
    """Wraps a sampler, overwriting chosen lanes with inadmissible thetas
    (NaN shift / corr_beta past the -1 pole)."""

    kind = "poison"

    def __init__(self, inner, poison_every=7):
        self.inner = inner
        self.cb_values = inner.cb_values
        self.windows = inner.windows
        self.n = inner.n
        self.every = poison_every

    def blocks(self, chunk):
        i = 0
        for th, bidx, lv in self.inner.blocks(chunk):
            th = th.copy()
            for j in range(len(th)):
                if (i + j) % self.every == 0:
                    if (i + j) % (2 * self.every) == 0:
                        th[j, 0] = np.nan
                    else:
                        th[j, -1] = -1.5
            i += len(th)
            yield th, bidx, lv

    def describe(self):
        return {"kind": self.kind, "n": self.n}


def test_rejected_lanes_excluded_and_counted():
    engine = _engine()
    xs = _books()
    res = engine.sweep(xs, _PoisonSampler(
        UniformSampler(_ball(), K, 256, seed=4)), chunk=64, top_k=8)
    poisoned = {i for i in range(256) if i % 7 == 0}
    assert res.counts["n_rejected"] == len(poisoned)
    assert res.counts["n_ok"] == 256 - len(poisoned)
    assert res.counts["n_scenarios"] == 256
    for book in res.books:
        assert not ({e["src"] for e in book["top"]} & poisoned)
        assert sum(book["hist"]["counts"]) == 256 - len(poisoned)
    want = RefSweepEngine(_base_cov(), factor_names=NAMES).sweep(
        xs, _PoisonSampler(RefUniform(RefBall(**BALL), K, 256, seed=4)),
        chunk=64, top_k=8, refine=None)
    assert res.counts == want.counts


def test_healthy_lanes_unmoved_by_poisoned_batchmates():
    """The poisoned run's top-k equals the materializing engine over ONLY
    the healthy lanes — per-lane isolation, streamed."""
    engine = _engine()
    xs = _books()
    res = engine.sweep(xs, _PoisonSampler(
        UniformSampler(_ball(), K, 256, seed=4), 7), chunk=64, top_k=8)
    ths = np.concatenate([th for th, _, _ in UniformSampler(
        _ball(), K, 256, seed=4).blocks(64)])
    healthy = [i for i in range(256) if i % 7 != 0]
    ok, vols, _ = _materialized(engine, ths, xs, keep=healthy)
    assert ok == healthy
    for book, want in zip(res.books, _table(ok, vols, 8)):
        assert _top(book) == want


# -- replay sweeps ------------------------------------------------------------

def test_replay_sweep_serves_windows_identity():
    win_cov = _base_cov(seed=7)
    seen = []

    def lookup(start, end):
        seen.append((start, end))
        return torch.from_numpy(win_cov)

    eng = _engine(replay_lookup=lookup)
    xs = _books(1)
    res = eng.sweep(xs, ReplaySampler([("2024-01-02", "2024-01-31")], K),
                    chunk=8, top_k=2)
    assert seen == [("2024-01-02", "2024-01-31")]
    assert res.counts["n_ok"] == 1
    top = res.books[0]["top"][0]
    assert top["base_window"] == ["2024-01-02", "2024-01-31"]
    assert top["vol"] == float(_vols(win_cov[None], xs)[0, 0])
    spec = ScenarioSpec.from_dict(top["spec"])
    assert spec.replay == ("2024-01-02", "2024-01-31")


@pytest.mark.parametrize("lookup", [None, "miss", "raise"])
def test_unresolvable_window_rejects_its_lanes(lookup):
    fn = {None: None, "miss": lambda s, e: None,
          "raise": lambda s, e: 1 / 0}[lookup]
    eng = _engine(replay_lookup=fn)
    res = eng.sweep(_books(1), ReplaySampler([("1999-01-01", "1999-01-31")],
                                             K), chunk=8, top_k=2)
    assert res.counts["n_ok"] == 0 and res.counts["n_rejected"] == 1
    assert res.sampler.get("window_problems")
    assert res.books[0]["top"] == []


def test_unported_options_raise_naming_their_roadmap_items(monkeypatch):
    """``mesh=`` is ported (§A 16d): each chunk's lanes split over every
    shard of a virtual 2x2 mesh, the carry, books and library replicated;
    the result is bitwise the unsharded sweep's, offenders and histogram
    included."""
    from mfm_tpu_torch._device import VIRTUAL_DEVICES_ENV
    from mfm_tpu_torch.parallel.mesh import make_mesh

    monkeypatch.setenv(VIRTUAL_DEVICES_ENV, "4")
    mesh = make_mesh(2, 2, device="cpu")
    for dtype in (np.float64, np.float32):
        xs = _books(3, dtype=dtype)
        want = _engine(dtype).sweep(
            xs, UniformSampler(ShockBall(), K, 3000, seed=4), chunk=512,
            top_k=4)
        eng = _engine(dtype, mesh=mesh)
        assert eng.mesh is mesh and eng.device == mesh.first_device
        got = eng.sweep(xs, UniformSampler(ShockBall(), K, 3000, seed=4),
                        chunk=512, top_k=4)
        assert json.dumps(got.to_dict(), sort_keys=True) == json.dumps(
            want.to_dict(), sort_keys=True)
        assert got.counts["n_chunks"] >= 6


REFINE = {"steps": 20, "n_local": 32, "seed": 2}


def _refined(case):
    """One refined sweep in both packages: the sampler's own ball, or the
    full preset-covering ShockBall for the ascent and the local stage."""
    xs = _books()
    port_opts, ref_opts = dict(REFINE), dict(REFINE)
    if case == "full_ball":
        port_opts["ball"], ref_opts["ball"] = ShockBall(), RefBall()
    got = _engine().sweep(xs, UniformSampler(_ball(), K, 96, seed=1),
                          chunk=32, top_k=4, refine=port_opts)
    want = RefSweepEngine(_base_cov(), factor_names=NAMES).sweep(
        xs, RefUniform(RefBall(**BALL), K, 96, seed=1), chunk=32, top_k=4,
        refine=ref_opts)
    return got, want


def _spec_theta(spec):
    return np.r_[[dict(spec["shift"]).get(f, 0.0) for f in NAMES],
                 [dict(spec["scale"]).get(f, 1.0) for f in NAMES],
                 spec["vol_mult"], spec["corr_beta"]]


@pytest.mark.parametrize("case", ["sampler_ball", "full_ball"])
def test_refined_sweep_is_the_reference(case):
    """``sweep(refine=)`` against the reference's: counts exactly, the
    refinement blocks' numbers within RTOL (their specs' thetas within
    1e-9: the ascent runs through each package's eigh), the final top-k
    vols within RTOL with the same origins and scenario indices wherever
    the vols are not tied.  The port's spec hashes are its own specs'."""
    got, want = _refined(case)
    assert got.counts == want.counts
    assert got.counts["n_scenarios"] > got.counts["n_coarse"]
    assert len(got.refined) == len(want.refined) == 2
    for g, w in zip(got.refined, want.refined):
        assert sorted(g) == sorted(w)
        for k in ("seed_count", "ascent_steps", "n_local", "local_span",
                  "admissible", "improved"):
            assert g[k] == w[k], k
        for k in ("vol_coarse_top1", "vol_ascent_best", "vol_final_top1"):
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL)
        np.testing.assert_allclose(_spec_theta(g["theta_spec"]),
                                   _spec_theta(w["theta_spec"]), rtol=0,
                                   atol=1e-9)
        assert g["theta_spec_hash"] == ScenarioSpec.from_dict(
            g["theta_spec"]).spec_hash()
    for g, w in zip(got.books, want.books):
        gv = np.array([e["vol"] for e in g["top"]])
        wv = np.array([e["vol"] for e in w["top"]])
        np.testing.assert_allclose(gv, wv, rtol=RTOL)
        for j, (ge, we) in enumerate(zip(g["top"], w["top"])):
            if (np.abs(wv - wv[j]) <= RTOL * wv[j]).sum() == 1:
                assert (ge["src"], ge["origin"]) == (we["src"], we["origin"])


def test_refined_worst_case_improves_is_admissible_and_audits_clean(
        tmp_path):
    """Each book's refined worst case beats (or equals) its coarse top-1
    and is admissible; the refined sweep is deterministic to the bit; its
    manifest audits clean in both packages."""
    got, _ = _refined("full_ball")
    again, _ = _refined("full_ball")
    assert json.dumps(got.to_dict()) == json.dumps(again.to_dict())
    for blk in got.refined:
        assert blk["improved"] and blk["admissible"]
        assert blk["vol_final_top1"] >= blk["vol_coarse_top1"]
    assert any(e["origin"] == "refined" for b in got.books for e in b["top"])
    path = write_sweep_manifest(str(tmp_path), build_sweep_manifest(
        got, backend="cpu", staleness=0))
    for audit in (audit_sweep_manifest, ref_audit):
        assert audit(path)[0] == []


def test_preset_dominance_is_the_reference():
    xs = _books()
    got_e, want_e = _engine(), RefSweepEngine(_base_cov(), factor_names=NAMES)
    got = got_e.preset_dominance(got_e.sweep(
        xs, UniformSampler(_ball(), K, 128, seed=2), chunk=64), xs)
    want = want_e.preset_dominance(want_e.sweep(
        xs, RefUniform(RefBall(**BALL), K, 128, seed=2), chunk=64,
        refine=None), xs)
    for g, w in zip(got, want):
        assert g["label"] == w["label"]
        assert g["dominates_all"] == w["dominates_all"]
        np.testing.assert_allclose(g["vol_worst"], w["vol_worst"], rtol=RTOL)
        for gp, wp in zip(g["presets"], w["presets"]):
            assert (gp["preset"], gp["dominated"]) == \
                (wp["preset"], wp["dominated"])
            np.testing.assert_allclose(gp["vol"], wp["vol"], rtol=RTOL)


# -- manifests ----------------------------------------------------------------

def _results():
    xs = _books()
    port = _engine().sweep(xs, UniformSampler(_ball(), K, 64, seed=6),
                           chunk=32, top_k=4)
    ref = RefSweepEngine(_base_cov(), factor_names=NAMES).sweep(
        xs, RefUniform(RefBall(**BALL), K, 64, seed=6), chunk=32, top_k=4,
        refine=None)
    return port, ref


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_sweep_manifest_audits_clean_in_both_packages(tmp_path, writer):
    port, ref = _results()
    build, write = ((build_sweep_manifest, write_sweep_manifest)
                    if writer == "port" else (ref_build, ref_write))
    res = port if writer == "port" else ref
    man = build(res, backend="cpu", staleness=0,
                summary=obs.sweep_summary_from_registry())
    assert man["summary"]["sweep_lanes"]["ok"] >= res.counts["n_ok"]
    path = write(str(tmp_path), man)
    assert path == sweep_manifest_path_for(str(tmp_path))
    back = read_sweep_manifest(path)
    assert back["sweep"]["counts"] == res.counts
    for audit in (audit_sweep_manifest, ref_audit):
        assert audit(path)[0] == []
    # the two packages' manifests of one sweep carry the same fields
    other = (ref_build if writer == "port" else build_sweep_manifest)(
        ref if writer == "port" else port, backend="cpu", staleness=0,
        summary=ref_obs.sweep_summary_from_registry())
    assert sorted(man) == sorted(other)
    assert sorted(man["sweep"]) == sorted(other["sweep"])
    assert [sorted(b) for b in man["sweep"]["books"]] == \
        [sorted(b) for b in other["sweep"]["books"]]

    man["sweep"]["books"][0]["top"][0]["spec_hash"] = "0" * 64
    path = write(str(tmp_path), man)
    for audit in (audit_sweep_manifest, ref_audit):
        assert any("spec hash mismatch" in p for p in audit(path)[0])


def test_sweep_manifest_torn_write_detected(tmp_path):
    path = str(tmp_path / "sweep_manifest.json")
    with open(path, "w", encoding="utf-8") as fh:
        fh.write('{"schema_version": 1, "kind": "sweep_man')
    with pytest.raises(SweepManifestError, match="torn"):
        read_sweep_manifest(path)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"schema_version": 1, "kind": "scenario_manifest"}, fh)
    with pytest.raises(SweepManifestError, match="not a sweep"):
        read_sweep_manifest(path)
