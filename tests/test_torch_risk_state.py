"""The port's daily serving step on the CPU: its own bitwise contracts.

``RiskModel.init_state`` / ``update`` / ``update_guarded`` of
``mfm_tpu_torch`` must continue a full-history run BITWISE (``torch.equal``,
never a tolerance) at float64 and float32: across the q-lag and t <= K
warm-up cuts, for single-date updates, slabs and their composition, for
quarantined dates (the carry after (good, BAD, good) is the carry after
(good, good)), through the npz checkpoint, and in the incremental eigen
mode across a draw-bucket rollover.  The parity of the same step with the
JAX package is ``tests/test_torch_serve_parity.py``.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from mfm_tpu_torch import RiskModel, RiskModelConfig
from mfm_tpu_torch.config import QuarantinePolicy
from mfm_tpu_torch.data.artifacts import (
    ArtifactCorruptError,
    ArtifactStaleError,
    load_risk_outputs,
    load_risk_state,
    read_pointer,
    save_risk_outputs,
    save_risk_state,
)
from mfm_tpu_torch.models.eigen import draw_bucket
from mfm_tpu_torch.serve.guard import (
    REASON_DATE_ORDER,
    REASON_NAN_DENSITY,
    host_date_reasons,
)

torch.set_num_threads(2)

T, N, P, Q = 48, 24, 4, 3
K = 1 + P + Q
CFG = RiskModelConfig(eigen_n_sims=8, eigen_sim_length=48)
GCFG = dataclasses.replace(CFG, quarantine=QuarantinePolicy(enabled=True))
ICFG = RiskModelConfig(eigen_n_sims=8, eigen_incremental=True)
DTYPES = [torch.float64, torch.float32]


def _panels(seed=0, T=T):
    rng = np.random.default_rng(seed)
    return (
        rng.normal(0, 0.02, (T, N)),
        rng.lognormal(10, 1, (T, N)),
        rng.normal(size=(T, N, Q)),
        rng.integers(0, P, (T, N)),
        rng.random((T, N)) > 0.05,
    )


def _model(panels, sl=slice(None), cfg=CFG, dtype=torch.float64):
    ps = [np.asarray(p)[sl] for p in panels]
    ps = [torch.from_numpy(p).to(dtype) if p.dtype.kind == "f"
          else torch.from_numpy(p) for p in ps]
    return RiskModel(*ps, n_industries=P, config=cfg, device="cpu")


def _poison(panels, t, frac=0.6):
    """60% of date ``t``'s universe returns go NaN while valid stays True."""
    ret = np.array(panels[0], copy=True)
    ret[t, : int(round(frac * N))] = np.nan
    return (ret,) + tuple(panels[1:])


def _leaves(state, guard=False):
    t, S, A, Z, Ps, hs, gs, Slags, xlags = state.nw_carry
    out = [t, S, A, Z, *Ps, *hs, *gs, *Slags, *xlags, state.vr_num,
           state.vr_den]
    if state.eig_R is not None:
        out += [state.eig_R, state.eig_p, state.eig_n]
    if guard:
        out += [state.last_good_cov, state.staleness, state.guard_ring,
                state.guard_ring_pos]
    return out


def _same(a, b):
    """Bitwise equality in the same dtype, NaN in the same places."""
    if a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    return torch.equal(torch.isnan(a), torch.isnan(b)) and \
        torch.equal(a.nan_to_num(), b.nan_to_num())


def _assert_outputs_equal(got, want, msg, rows=None):
    for name in want._fields:
        g, w = getattr(got, name), getattr(want, name)
        if rows is not None:
            g, w = g[rows[0]], w[rows[1]]
        assert _same(g, w), f"{msg}: {name}"


def _assert_carries_equal(a, b, msg, guard=False):
    for i, (x, y) in enumerate(zip(_leaves(a, guard), _leaves(b, guard))):
        assert _same(x, y), f"{msg}: carry leaf {i}"


def _suffix(out, a, b=None):
    return type(out)(*(x[a:b] for x in out))


def _cat(rows):
    return type(rows[0])(*(torch.cat([getattr(r, f) for r in rows])
                           for f in rows[0]._fields))


@pytest.fixture(scope="module")
def panels():
    return _panels()


@pytest.fixture(scope="module", params=DTYPES, ids=["f64", "f32"])
def full(request, panels):
    dtype = request.param
    return dtype, _model(panels, dtype=dtype).init_state()


# T0 = 1, 2 sit inside the q-lag warm-up (q = 2); 5 inside the t <= K
# invalid region (K = 8); 20 and 40 are plain mid-history cuts.  T0 = 1 is
# also the one-date init slab.
@pytest.mark.parametrize("T0", [1, 2, 5, 20, 40])
def test_update_is_bitwise_suffix_of_full_run(panels, full, T0):
    dtype, (full_out, full_state) = full
    out0, st = _model(panels, slice(0, T0), dtype=dtype).init_state()
    _assert_outputs_equal(out0, _suffix(full_out, 0, T0), f"T0={T0} prefix")

    # single-date updates (all of them from T0 = 40 on, else four), then
    # the rest as one slab
    singles = T if T - T0 <= 8 else T0 + 4
    seq, rows = st, []
    for t in range(T0, singles):
        o, seq = _model(panels, slice(t, t + 1), dtype=dtype).update(seq)
        rows.append(o)
    if singles < T:
        o, seq = _model(panels, slice(singles, T), dtype=dtype).update(seq)
        rows.append(o)
    _assert_outputs_equal(_cat(rows), _suffix(full_out, T0),
                          f"T0={T0} singles (+ slab) suffix")

    # the whole remainder as ONE slab
    o_slab, st_slab = _model(panels, slice(T0, T), dtype=dtype).update(st)
    _assert_outputs_equal(o_slab, _suffix(full_out, T0), f"T0={T0} slab")
    _assert_carries_equal(seq, st_slab, f"T0={T0} singles-vs-slab carry")
    _assert_carries_equal(st_slab, full_state, f"T0={T0} slab-vs-full carry")
    assert st_slab.t == seq.t == full_state.t == T
    assert st_slab.sim_length == full_state.sim_length == 48


def test_update_does_not_write_into_its_state(panels, full):
    dtype, _ = full
    _, st = _model(panels, slice(0, 20), cfg=GCFG, dtype=dtype).init_state()
    before = copy.deepcopy(st)
    bad = _poison(panels, 22)
    o1, _ = _model(panels, slice(20, 30), cfg=GCFG, dtype=dtype).update(st)
    _model(bad, slice(20, 30), cfg=GCFG, dtype=dtype).update_guarded(st)
    _assert_carries_equal(st, before, "state after update", guard=True)
    assert int(st.quarantine_count) == int(before.quarantine_count) == 0
    o2, _ = _model(panels, slice(20, 30), cfg=GCFG, dtype=dtype).update(st)
    _assert_outputs_equal(o2, o1, "the old state stays usable")


def test_stamp_is_the_reference_tuple(panels, full):
    dtype, (_, st) = full
    name = "float64" if dtype == torch.float64 else "float32"
    assert st.stamp == (P, Q, N, name, CFG.identity())
    assert st.eigen_batch_hint == T * 8


# (T0, offset of the poisoned date): inside the q-lag warm-up, inside
# t <= K, and mid-history
@pytest.mark.parametrize("T0,off", [(1, 0), (2, 3), (20, 5), (40, 6)])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_quarantined_date_is_excised_bitwise(panels, T0, off, dtype):
    t_bad = T0 + off
    bad = _poison(panels, t_bad)
    _, st = _model(panels, slice(0, T0), cfg=GCFG, dtype=dtype).init_state()
    o_g, rep, st_g = _model(bad, slice(T0, T), cfg=GCFG,
                            dtype=dtype).update_guarded(st)
    q = rep.quarantined.numpy()
    assert q[off] and q.sum() == 1, "exactly the poisoned date quarantines"
    assert int(rep.reasons[off]) == REASON_NAN_DENSITY
    assert rep.reasons.dtype == torch.int32

    keep = np.r_[T0:t_bad, t_bad + 1:T]
    o_r, rep_r, st_r = _model(panels, keep, cfg=GCFG,
                              dtype=dtype).update_guarded(st)
    assert not rep_r.quarantined.any()
    healthy = np.r_[0:off, off + 1:T - T0]
    _assert_outputs_equal(o_g, o_r, f"T0={T0} off={off} healthy rows",
                          rows=(healthy, slice(None)))
    _assert_carries_equal(st_g, st_r, f"T0={T0} off={off}", guard=True)
    assert int(st_g.quarantine_count) == 1 and st_g.t == st_r.t
    assert not o_g.nw_valid[off] and not o_g.eigen_valid[off]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_clean_guarded_run_is_bitwise_unguarded(panels, dtype):
    """Guards on a healthy feed change nothing: the guarded init and a
    guarded slab give the unguarded outputs bitwise, nothing quarantines,
    and served_cov is vr_cov at eigen-valid dates."""
    out_u, _ = _model(panels, dtype=dtype).init_state()
    out_g, _ = _model(panels, cfg=GCFG, dtype=dtype).init_state()
    _assert_outputs_equal(out_g, out_u, "guarded init vs unguarded init")

    _, gst = _model(panels, slice(0, 20), cfg=GCFG, dtype=dtype).init_state()
    _, ust = _model(panels, slice(0, 20), dtype=dtype).init_state()
    o_u, ust2 = _model(panels, slice(20, T), dtype=dtype).update(ust)
    o_g, rep, gst2 = _model(panels, slice(20, T), cfg=GCFG,
                            dtype=dtype).update_guarded(gst)
    _assert_outputs_equal(o_g, o_u, "guarded slab vs unguarded slab")
    _assert_carries_equal(gst2, ust2, "guarded vs unguarded carry")
    assert not rep.quarantined.any() and int(gst2.quarantine_count) == 0
    ev = o_g.eigen_valid
    assert ev.any()
    assert torch.equal(rep.served_cov[ev], o_g.vr_cov[ev])
    assert not rep.staleness[ev].any()


def test_staleness_counts_and_served_cov(panels):
    """(good, BAD, BAD, good): staleness 0, 1, 2, 0; both bad dates serve
    the good date's covariance bitwise; the recovery date its own."""
    _, st = _model(panels, slice(0, 20), cfg=GCFG).init_state()
    bad = _poison(_poison(panels, 21), 22)
    o, rep, st2 = _model(bad, slice(20, 24), cfg=GCFG).update_guarded(st)
    assert rep.quarantined.tolist() == [False, True, True, False]
    assert rep.staleness.tolist() == [0, 1, 2, 0]
    assert rep.staleness.dtype == torch.int32
    assert torch.equal(rep.served_cov[1], o.vr_cov[0])
    assert torch.equal(rep.served_cov[2], o.vr_cov[0])
    assert torch.equal(rep.served_cov[3], o.vr_cov[3])
    assert torch.equal(st2.last_good_cov, o.vr_cov[3])
    assert int(st2.staleness) == 0 and int(st2.quarantine_count) == 2
    # the host date-order pre-check and a heal mask ride along
    pre = host_date_reasons(["2020-01-02"], last_date="2020-01-02")
    _, rep, _ = _model(panels, slice(20, 21), cfg=GCFG).update_guarded(
        st, pre_reasons=pre)
    assert rep.quarantined.tolist() == [True]
    assert rep.reasons.tolist() == [REASON_DATE_ORDER]
    _, rep, st3 = _model(panels, slice(20, 21), cfg=GCFG).update_guarded(
        st, pre_reasons=pre, heal_mask=[True])
    assert rep.quarantined.tolist() == [False]
    assert rep.reasons.tolist() == [REASON_DATE_ORDER]
    assert int(st3.quarantine_count) == 0


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("cfg", [GCFG, ICFG], ids=["guarded", "incremental"])
def test_state_npz_roundtrip_is_bitwise(panels, tmp_path, dtype, cfg):
    """A checkpoint written and reloaded continues exactly like the
    in-process state: every leaf in its dtype, the stamp, the counts."""
    _, st = _model(panels, slice(0, 40), cfg=cfg, dtype=dtype).init_state(
        last_date="2020-02-10")
    path = str(tmp_path / "state.npz")
    save_risk_state(path, st, meta={"note": "test"})
    loaded, meta = load_risk_state(path, "cpu")
    assert meta["note"] == "test" and meta["kind"] == "risk_state"
    assert loaded.stamp == st.stamp and loaded.last_date == "2020-02-10"
    assert loaded.sim_length == st.sim_length
    assert loaded.eigen_batch_hint == st.eigen_batch_hint
    guarded = cfg.quarantine.enabled
    assert loaded.guarded == guarded
    _assert_carries_equal(loaded, st, "roundtrip", guard=guarded)
    for f in ("sim_covs", "eig_draws", "quarantine_count"):
        a, b = getattr(loaded, f), getattr(st, f)
        assert (a is None) == (b is None) and (a is None or _same(a, b)), f

    bad = _poison(panels, 43)
    step = "update_guarded" if guarded else "update"
    mem = getattr(_model(bad, slice(40, T), cfg=cfg, dtype=dtype), step)(st)
    dsk = getattr(_model(bad, slice(40, T), cfg=cfg, dtype=dtype), step)(
        loaded)
    _assert_outputs_equal(dsk[0], mem[0], "disk-vs-memory update")
    _assert_carries_equal(dsk[-1], mem[-1], "disk-vs-memory carry",
                          guard=guarded)
    if guarded:
        assert torch.equal(dsk[1].served_cov, mem[1].served_cov)
        assert dsk[1].quarantined.tolist() == mem[1].quarantined.tolist()


def test_risk_outputs_roundtrip(panels, tmp_path):
    out, _ = _model(panels, slice(0, 12)).init_state()
    path = str(tmp_path / "outputs.npz")
    save_risk_outputs(path, out, meta={"k": 1})
    got, meta = load_risk_outputs(path, "cpu")
    assert meta["k"] == 1
    _assert_outputs_equal(got, out, "outputs roundtrip")


def test_checkpoint_fencing_refuses_torn_and_stale_files(panels, tmp_path):
    _, st = _model(panels, slice(0, 12), cfg=GCFG).init_state()
    path = str(tmp_path / "state.npz")
    save_risk_state(path, st)
    old = (tmp_path / "state.npz").read_bytes()
    save_risk_state(path, st)
    assert read_pointer(path)["generation"] == 2
    assert load_risk_state(path, "cpu")[1]["generation"] == 2

    (tmp_path / "state.npz").write_bytes(old)  # a restored backup
    with pytest.raises(ArtifactStaleError, match="generation 1"):
        load_risk_state(path, "cpu")
    assert load_risk_state(path, "cpu", force=True)[1]["generation"] == 1

    torn = str(tmp_path / "torn.npz")
    save_risk_state(torn, st)
    data = (tmp_path / "torn.npz").read_bytes()
    (tmp_path / "torn.npz").write_bytes(data[: len(data) // 2])
    with pytest.raises(ArtifactCorruptError):
        load_risk_state(torn, "cpu")
    with pytest.raises(ArtifactCorruptError):
        load_risk_state(torn, "cpu", force=True)


def test_checkpoint_heals_the_pointer_forward(panels, tmp_path):
    """A writer that died between the rename and the pointer swap leaves a
    file one generation ahead of latest.json; the load heals the pointer."""
    import json

    _, st = _model(panels, slice(0, 12), cfg=GCFG).init_state()
    path = str(tmp_path / "state.npz")
    save_risk_state(path, st)
    ptr = tmp_path / "latest.json"
    first = ptr.read_text()
    save_risk_state(path, st)
    ptr.write_text(first)  # the swap never happened
    assert read_pointer(path)["generation"] == 1
    _, meta = load_risk_state(path, "cpu")
    assert meta["generation"] == 2
    assert json.loads(ptr.read_text())["state.npz"]["generation"] == 2


# -- incremental eigen mode ------------------------------------------------------

TI = 80  # a bucket rollover (64 -> 128) lies inside the update


@pytest.fixture(scope="module")
def inc_panels():
    return _panels(seed=1, T=TI)


@pytest.fixture(scope="module")
def inc_full(inc_panels):
    return _model(inc_panels, cfg=ICFG).init_state()


# both cuts at or above 4K = 32 dates, where the sweep tier of the
# simulated eighs no longer moves up to T = 80 (the contract holds inside
# one tier); 60 crosses the rollover at 65 on the single-date path
@pytest.mark.parametrize("T0", [40, 60])
def test_incremental_update_is_bitwise_suffix_across_rollover(
        inc_panels, inc_full, T0):
    full_out, full_state = inc_full
    assert full_state.sim_covs is None and full_state.eig_R is not None
    assert full_state.eig_draws.shape[-1] == draw_bucket(TI) == 128
    out0, st = _model(inc_panels, slice(0, T0), cfg=ICFG).init_state()
    assert st.eig_draws.shape[-1] == 64
    _assert_outputs_equal(out0, _suffix(full_out, 0, T0), f"T0={T0} prefix")

    seq, rows = st, []
    for t in range(T0, T0 + 6):
        o, seq = _model(inc_panels, slice(t, t + 1), cfg=ICFG).update(seq)
        rows.append(o)
    o, seq = _model(inc_panels, slice(T0 + 6, TI), cfg=ICFG).update(seq)
    rows.append(o)
    _assert_outputs_equal(_cat(rows), _suffix(full_out, T0),
                          f"T0={T0} singles + slab")
    o_slab, st_slab = _model(inc_panels, slice(T0, TI), cfg=ICFG).update(st)
    _assert_outputs_equal(o_slab, _suffix(full_out, T0), f"T0={T0} slab")
    _assert_carries_equal(seq, st_slab, f"T0={T0} singles-vs-slab carry")
    _assert_carries_equal(st_slab, full_state, f"T0={T0} slab-vs-full carry")
    assert seq.sim_length == st_slab.sim_length == TI
    assert torch.equal(seq.eig_draws, full_state.eig_draws)
    assert int(seq.eig_n) == TI


def test_incremental_run_fused_is_init_state(inc_panels, inc_full):
    full_out, _ = inc_full
    out = _model(inc_panels, cfg=ICFG).run_fused()
    _assert_outputs_equal(out, full_out, "run_fused vs init_state")


def test_incremental_excision_consumes_no_draw_column(inc_panels):
    """(good, BAD, good) == (good, good) on the eigen carry and the dates
    after the bad one; the date count still counts the served date."""
    gcfg = dataclasses.replace(ICFG, quarantine=QuarantinePolicy(enabled=True))
    T0 = 40
    _, st = _model(inc_panels, slice(0, T0), cfg=gcfg).init_state()
    bad = _poison(inc_panels, T0 + 2)
    o_b, rep, st_b = _model(bad, slice(T0, T0 + 6), cfg=gcfg).update_guarded(
        st)
    assert rep.quarantined.tolist() == [False, False, True, False, False,
                                        False]
    keep = np.r_[T0:T0 + 2, T0 + 3:T0 + 6]
    o_r, _, st_r = _model(inc_panels, keep, cfg=gcfg).update_guarded(st)
    _assert_carries_equal(st_b, st_r, "excision", guard=True)
    assert int(st_b.eig_n) == int(st_r.eig_n) == T0 + 5
    assert st_b.sim_length == st_r.sim_length + 1
    _assert_outputs_equal(o_b, o_r, "rows around the quarantined date",
                          rows=(np.r_[0:2, 3:6], slice(None)))


# -- refusals --------------------------------------------------------------------

def test_update_rejects_mismatched_identity(panels):
    _, st = _model(panels, slice(0, 20)).init_state()
    other = RiskModelConfig(eigen_n_sims=8, eigen_sim_length=48,
                            nw_half_life=99.0)
    with pytest.raises(ValueError, match="stamp"):
        _model(panels, slice(20, T), cfg=other).update(st)
    with pytest.raises(ValueError, match="stamp"):
        _model(panels, slice(20, T), dtype=torch.float32).update(st)
    narrow = tuple(np.asarray(p)[:, :-1] for p in panels)
    ps = [torch.from_numpy(p[20:]) for p in narrow]
    with pytest.raises(ValueError, match="stamp"):
        RiskModel(*ps, n_industries=P, config=CFG, device="cpu").update(st)
    retuned = dataclasses.replace(
        GCFG, quarantine=QuarantinePolicy(enabled=True, mad_k=5.0))
    _, gst = _model(panels, slice(0, 20), cfg=GCFG).init_state()
    with pytest.raises(ValueError, match="stamp"):
        _model(panels, slice(20, T), cfg=retuned).update_guarded(gst)


def test_state_requires_scan_method(panels):
    """The port cannot build an associative config yet, so the refusal is
    reached with a config that claims the method after construction."""
    cfg = RiskModelConfig(eigen_n_sims=8, eigen_sim_length=48)
    object.__setattr__(cfg, "nw_method", "associative")
    with pytest.raises(ValueError, match="scan"):
        _model(panels, cfg=cfg).init_state()
    _, st = _model(panels, slice(0, 20)).init_state()
    st = dataclasses.replace(st, stamp=st.stamp[:4] + (cfg.identity(),))
    with pytest.raises(ValueError, match="scan"):
        _model(panels, slice(20, T), cfg=cfg).update(st)
    with pytest.raises(ValueError, match="scan"):
        _model(panels, slice(20, T), cfg=cfg).update_guarded(st)


def test_update_guarded_refusals(panels):
    _, st = _model(panels, slice(0, 20), cfg=GCFG).init_state()
    with pytest.raises(ValueError, match="quarantine.enabled"):
        _model(panels, slice(20, T)).update_guarded(st)
    stripped = dataclasses.replace(
        st, last_good_cov=None, staleness=None, quarantine_count=None,
        guard_ring=None, guard_ring_pos=None)
    assert not stripped.guarded
    with pytest.raises(ValueError, match="degraded-mode leaves"):
        _model(panels, slice(20, T), cfg=GCFG).update_guarded(stripped)


def test_incremental_refuses_injected_draws(panels):
    m = _model(panels, cfg=ICFG)
    with pytest.raises(ValueError, match="injected"):
        m.init_state(sim_covs=torch.zeros((8, K, K), dtype=torch.float64))
    with pytest.raises(ValueError, match="injected"):
        m.init_state(generator=torch.Generator().manual_seed(3))
    with pytest.raises(ValueError, match="injected"):
        m.run_fused(sim_covs=torch.zeros((8, K, K), dtype=torch.float64))
    with pytest.raises(ValueError, match="injected"):
        m.run(generator=torch.Generator().manual_seed(3))


def test_serving_entry_points_run_on_cuda_unless_asked_for_the_cpu(
        panels, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the check is for one without")
    _, st = _model(panels, slice(0, 12), cfg=GCFG).init_state()
    path = str(tmp_path / "state.npz")
    save_risk_state(path, st)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_risk_state(path)
    with pytest.raises(RuntimeError, match="CUDA"):
        RiskModel(*(np.asarray(p)[12:] for p in panels), n_industries=P,
                  config=GCFG)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_one_date_update_at_csi300_width_is_bitwise(dtype):
    """A one-date update at the main path's width (N=300, K=42), where
    the CPU's BLAS takes other paths than at the narrow test width (a
    batched matrix-vector product at batch one went to gemv and summed in
    another order): still bitwise the suffix of the full run."""
    from mfm_tpu_torch.data.synthetic import synthetic_risk_inputs

    Tw, Nw, Pw, Qw = 6, 300, 31, 10
    ps = synthetic_risk_inputs(Tw, Nw, Pw, Qw, seed=2)
    cfg = RiskModelConfig(eigen_n_sims=2, eigen_sim_length=Tw)

    def model(sl):
        t = [torch.from_numpy(np.asarray(p)[sl]) for p in ps]
        t = [x.to(dtype) if x.is_floating_point() else x for x in t]
        return RiskModel(*t, n_industries=Pw, config=cfg, device="cpu")

    full_out, full_state = model(slice(None)).init_state()
    _, st = model(slice(0, Tw - 1)).init_state()
    o, st = model(slice(Tw - 1, Tw)).update(st)
    _assert_outputs_equal(o, _suffix(full_out, Tw - 1), "one-date update")
    _assert_carries_equal(st, full_state, "one-date carry")


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_normal_matrices_keep_their_bits_at_any_batch_position(dtype):
    """``ops/xreg._gram`` (the regression's normal matrices X'WX) gives a
    date the same bits wherever it sits in a batch of any size, on the
    CPU: a batched matrix product there does not (MKL gives a matrix at
    an odd position other bits than at position 0), which broke update ==
    suffix for one-date updates, padded to 16 copies of the date at
    position 0."""
    from mfm_tpu_torch.ops.xreg import _gram

    rng = np.random.default_rng(3)
    for k, n in ((K - 1, N), (41, 300)):
        Xr = torch.from_numpy(rng.standard_normal((48, n, k))).to(dtype)
        XtW = Xr.transpose(-1, -2) * torch.from_numpy(
            rng.random((48, 1, n))).to(dtype)
        full = _gram(XtW, Xr)
        for t in (0, 1, 21, 23, 47):
            for rows in (1, 2, 16):
                one = _gram(XtW[t:t + 1].expand(rows, k, n),
                            Xr[t:t + 1].expand(rows, n, k))
                assert _same(one[0], full[t]), (k, t, rows)
