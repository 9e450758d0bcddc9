"""The Newey-West scan kernel (``mfm_tpu_torch/csrc/newey_west_scan.cu``)
against the loop it replaces on the card.

On the CPU: ``newey_west_expanding_resume`` runs the plain loop and
launches nothing; the wrapper refuses what the kernel does not take; and
the kernel's arithmetic, transcribed into PyTorch thread by thread (a
(K, K) grid of threads, each with its own copies of the vector and scalar
recursions), gives the loop's bits, which is what the kernel is held to
on the card.

On the card (tests marked ``card``; without a card they skip): the
kernel's covariances, ``valid`` and every carry tensor are bitwise the
loop's (the same function with the loop in the kernel's place), NaN in
the same places, across shapes, lags, half-lives, dtypes, resumes, skip
masks and T = 0 and T = 1 slabs; a rebuild and each serving step launch
it once; and the port's bitwise contracts hold with it on the main path.
Run them there with ``python -m pytest --noconftest -m card
tests/test_torch_newey_west_kernel.py``.  Inputs are made with numpy
from a seed.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

from mfm_tpu_torch import RiskModel, RiskModelConfig, cli
from mfm_tpu_torch._device import VIRTUAL_DEVICES_ENV
from mfm_tpu_torch.config import QuarantinePolicy
from mfm_tpu_torch.data.synthetic import synthetic_risk_inputs
from mfm_tpu_torch.models import newey_west as NW
from mfm_tpu_torch.models import risk_model
from mfm_tpu_torch.obs import trace
from mfm_tpu_torch.ops import _build
from mfm_tpu_torch.ops import newey_west_cuda as C
from mfm_tpu_torch.parallel.mesh import (
    make_mesh,
    pad_to_mesh,
    shard_panel,
    use_mesh,
)

torch.set_num_threads(2)

DTYPES = [torch.float32, torch.float64]
DT_IDS = ["f32", "f64"]
_INT_VIEW = {torch.float32: torch.int32, torch.float64: torch.int64}


def _series(T, K, seed, dtype, device="cpu"):
    """AR(1) factor returns around 1% a day, (T, K)."""
    rng = np.random.default_rng(seed)
    f = 0.01 * rng.standard_normal((T, K))
    for t in range(1, T):
        f[t] += 0.3 * f[t - 1]
    return torch.from_numpy(f).to(dtype=dtype, device=device)


def _leaves(carry) -> list:
    t, S, A, Z, Ps, hs, gs, Slags, xlags = carry
    return [t, S, A, Z, *Ps, *hs, *gs, *Slags, *xlags]


def _bitwise(a, b) -> bool:
    """Same dtype, shape and bit patterns; NaN (any payload) in the same
    places counts as equal."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    a, b = a.cpu(), b.cpu()
    if not a.is_floating_point():
        return torch.equal(a, b)
    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        return False
    view = _INT_VIEW[a.dtype]
    return torch.equal(a.masked_fill(nan, 0).view(view),
                       b.masked_fill(nan, 0).view(view))


def _assert_same(got, want, what):
    covs, valid, carry = got
    assert _bitwise(covs, want[0]), f"{what}: covs"
    assert _bitwise(valid, want[1]), f"{what}: valid"
    for i, (x, y) in enumerate(zip(_leaves(carry), _leaves(want[2]))):
        assert _bitwise(x, y), f"{what}: carry leaf {i}"


# -- the CPU: the loop, and the wrapper's refusals ---------------------------

def test_the_cpu_runs_the_loop_and_launches_nothing(monkeypatch):
    x = _series(40, 6, 0, torch.float64)
    before = C.launch_total()
    got = NW.newey_west_expanding_resume(x, q=2, half_life=20.0)
    assert C.launch_total() == before

    def refuse(*args):
        raise AssertionError("the CPU reached the kernel's wrapper")

    monkeypatch.setattr(NW, "newey_west_scan_cuda", refuse)
    _assert_same(NW.newey_west_expanding_resume(x, q=2, half_life=20.0),
                 got, "cpu")


def _sums(K, q, dtype=torch.float64):
    return NW.nw_init_carry(K, q, dtype)[1:]


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16,
                                   torch.int32])
def test_the_wrapper_refuses_other_dtypes(dtype):
    x = torch.zeros((4, 3), dtype=dtype)
    with pytest.raises(TypeError, match="float32 or float64"):
        C.check(x, 2, _sums(3, 2))


@pytest.mark.parametrize("q", [-1, C.MAX_Q + 1])
def test_the_wrapper_refuses_q_outside_the_kernel(q):
    x = torch.zeros((4, 3), dtype=torch.float64)
    with pytest.raises(ValueError, match=rf"takes q in \[0, {C.MAX_Q}\]"):
        C.check(x, q, _sums(3, max(q, 0)))


def test_the_wrapper_refuses_inputs_that_require_grad():
    x = torch.zeros((4, 3), dtype=torch.float64, requires_grad=True)
    with pytest.raises(ValueError, match="no backward"):
        C.check(x, 2, _sums(3, 2))
    sums = list(_sums(3, 2))
    sums[1] = sums[1].clone().requires_grad_(True)
    with pytest.raises(ValueError, match="no backward"):
        C.check(x.detach(), 2, tuple(sums))


@pytest.mark.parametrize("fault", ["dtype", "shape", "layout", "lags"])
def test_the_wrapper_refuses_a_carry_it_cannot_take(fault):
    x = torch.zeros((4, 3), dtype=torch.float64)
    sums = list(_sums(3, 2))
    if fault == "dtype":
        sums[0] = sums[0].float()
    elif fault == "shape":
        sums[1] = torch.zeros((3, 4), dtype=torch.float64)
    elif fault == "layout":
        sums[1] = torch.zeros((3, 4), dtype=torch.float64)[:, :3]
    else:
        sums[3] = sums[3][:1]
    with pytest.raises(ValueError, match="carry"):
        C.check(x, 2, tuple(sums))


def test_the_wrapper_refuses_a_cpu_series():
    x = torch.zeros((4, 3), dtype=torch.float64)
    lam = torch.tensor(0.5, dtype=torch.float64)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        C.newey_west_scan_cuda(x, lam, 2, 0, _sums(3, 2), [False] * 4)


def test_max_q_is_the_kernels_lag_limit():
    """``MAX_Q`` is the source's ``kMaxQ``, the source instantiates the
    kernel at every q up to it, and ``--nw-lags`` names it."""
    text = (_build.CSRC / f"{C.SOURCE}.cu").read_text()
    assert re.findall(r"constexpr int kMaxQ = (\d+);", text) == [str(C.MAX_Q)]
    cases = [int(c) for c in
             re.findall(r"case (\d+): return launch<T, \1>", text)]
    assert cases == list(range(C.MAX_Q + 1))
    assert f"q <= {C.MAX_Q}" in cli._NW_LAGS_HELP


@pytest.mark.parametrize("method,device,refused", [
    ("scan", "cuda", True), ("scan", "cpu", False),
    ("associative", "cuda", False)])
def test_a_model_on_the_card_refuses_lags_past_the_kernel(method, device,
                                                          refused):
    """More lags than the kernel takes are refused when a model on the
    card is built (before any stage runs); the associative method there,
    and the CPU's loop, take them."""
    cfg = RiskModelConfig(nw_lags=C.MAX_Q + 1, nw_method=method)
    check = lambda c: risk_model._require_kernel_lags(c, torch.device(device))
    check(dataclasses.replace(cfg, nw_lags=C.MAX_Q))
    if refused:
        with pytest.raises(ValueError, match=rf"takes q in \[0, {C.MAX_Q}\]"):
            check(cfg)
    else:
        check(cfg)


def test_a_cpu_model_runs_more_lags_than_the_kernel_takes():
    panels = _panels(torch.float64, "cpu")
    cfg = dataclasses.replace(CFG, nw_lags=C.MAX_Q + 1)
    out = _model(panels, cfg=cfg).run_fused()
    want = NW.newey_west_expanding(out.factor_ret, C.MAX_Q + 1, min_valid=1
                                   + PM + QM)
    assert _bitwise(out.nw_cov, want[0]) and _bitwise(out.nw_valid, want[1])


# -- the kernel's arithmetic, thread by thread, on the CPU -------------------

def _transcribed_scan(ret, lam, q, t, sums, skip):
    """``csrc/newey_west_scan.cu`` in PyTorch: a (K, K) grid of threads,
    thread (i, j) holding A_ij, P^l_ij, P^l_ji and its own copies of S,
    h^l, the S and x lags at i and at j, Z and g^l; each operation the
    kernel's, elementwise over the grid.  Returns ``(covs, sums_out)``
    read off the grid as the kernel writes them."""
    T, K = ret.shape
    dtype = ret.dtype
    S, A, Z, Ps, hs, gs, Slags, xlags = sums

    def col(v):  # index i of thread (i, j)
        return v[:, None].expand(K, K).clone()

    def row(v):  # index j of thread (i, j)
        return v[None, :].expand(K, K).clone()

    def grid(s):
        return s.expand(K, K).clone()

    lam = grid(lam)
    one, zero = torch.ones((), dtype=dtype), torch.zeros((), dtype=dtype)
    c = [torch.tensor(1.0 - (l + 1) / (1.0 + q), dtype=torch.float64)
         .to(dtype) for l in range(q)]
    A, Z, Si, Sj = A.clone(), grid(Z), col(S), row(S)
    Pij = [p.clone() for p in Ps]
    Pji = [p.t().clone() for p in Ps]
    hi, hj = [col(h) for h in hs], [row(h) for h in hs]
    g = [grid(x) for x in gs]
    Sli, Slj = [col(s) for s in Slags], [row(s) for s in Slags]
    xli, xlj = [col(x) for x in xlags], [row(x) for x in xlags]
    covs = torch.empty((T, K, K), dtype=dtype)
    for d in range(T):
        xi, xj = col(ret[d]), row(ret[d])
        t1 = t + 1
        Sni, Snj = lam * Si + xi, lam * Sj + xj
        An = lam * A + xi * xj
        Zn = lam * Z + one
        heads = [one if t1 <= l + 1 else zero for l in range(q)]
        Pnij = [lam * Pij[l] + xli[l] * xj for l in range(q)]
        Pnji = [lam * Pji[l] + xlj[l] * xi for l in range(q)]
        hni = [lam * hi[l] + xi * heads[l] for l in range(q)]
        hnj = [lam * hj[l] + xj * heads[l] for l in range(q)]
        gn = [lam * g[l] + heads[l] for l in range(q)]
        mui, muj = Sni / Zn, Snj / Zn
        mumu = mui * muj
        V = An / Zn - mumu
        for l in range(q):
            ai, aj = Sni - hni[l], Snj - hnj[l]
            zm = (Zn - gn[l]) * mumu
            Gij = (Pnij[l] - Sli[l] * muj - mui * aj + zm) / Zn
            Gji = (Pnji[l] - Slj[l] * mui - muj * ai + zm) / Zn
            V = V + c[l] * (Gij + Gji)
        covs[d] = V
        if skip[d]:
            continue
        t = t1
        Si, Sj, A, Z = Sni, Snj, An, Zn
        Pij, Pji, hi, hj, g = Pnij, Pnji, hni, hnj, gn
        if q:
            Sli, Slj = [Sni] + Sli[:-1], [Snj] + Slj[:-1]
            xli, xlj = [xi] + xli[:-1], [xj] + xlj[:-1]
    return covs, (Sj[0], A, Z[0, 0], tuple(Pij), tuple(h[0] for h in hj),
                  tuple(x[0, 0] for x in g), tuple(s[0] for s in Slj),
                  tuple(x[0] for x in xlj))


@pytest.mark.parametrize("q", [0, 1, 2, 3])
@pytest.mark.parametrize("half_life", [252.0, 20.0, 1.5])
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_the_kernels_arithmetic_is_the_loops_bitwise(monkeypatch, q,
                                                     half_life, dtype):
    """A NaN date and the first date masked, a resume mid-history: the
    transcription gives the loop's covs, valid and carry to the bit."""
    T, K = 30, 5
    x = _series(T, K, q, dtype)
    x[9] = float("nan")
    mask = torch.zeros(T, dtype=torch.bool)
    mask[[0, 9, 10]] = True
    want = [NW.newey_west_expanding_resume(x[:13], q, half_life,
                                           skip_mask=mask[:13])]
    want.append(NW.newey_west_expanding_resume(
        x[13:], q, half_life, carry=want[0][2], skip_mask=mask[13:]))
    monkeypatch.setattr(NW, "_scan_loop", _transcribed_scan)
    got = NW.newey_west_expanding_resume(x[:13], q, half_life,
                                         skip_mask=mask[:13])
    _assert_same(got, want[0], "first slab")
    got = NW.newey_west_expanding_resume(x[13:], q, half_life, carry=got[2],
                                         skip_mask=mask[13:])
    _assert_same(got, want[1], "resumed slab")


# -- the card ----------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    return torch.device("cuda")


def _both(monkeypatch, *args, **kw):
    """``newey_west_expanding_resume`` on the card through the kernel (one
    launch, counted), then with the loop in the kernel's place."""
    before = C.launch_total()
    got = NW.newey_west_expanding_resume(*args, **kw)
    assert C.launch_total() == before + 1
    with monkeypatch.context() as m:
        m.setattr(NW, "newey_west_scan_cuda", NW._scan_loop)
        want = NW.newey_west_expanding_resume(*args, **kw)
    return got, want


SHAPES = [(1390, 42), (2500, 42), (2500, 73), (61, 1), (61, 5), (61, 11),
          (61, 64)]


@pytest.mark.card
@pytest.mark.parametrize("T,K", SHAPES, ids=[f"{t}x{k}" for t, k in SHAPES])
@pytest.mark.parametrize("q", [0, 1, 2, 3])
@pytest.mark.parametrize("half_life", [252.0, 20.0, 1.5])
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_kernel_is_the_loop_bitwise(card, monkeypatch, T, K, q, half_life,
                                    dtype):
    x = _series(T, K, T + K + q, dtype, card)
    got, want = _both(monkeypatch, x, q, half_life)
    _assert_same(got, want, f"{T}x{K} q={q} hl={half_life}")


@pytest.mark.card
@pytest.mark.parametrize("min_valid", [0, 3, 50])
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_kernel_min_valid_is_the_loops(card, monkeypatch, min_valid, dtype):
    x = _series(80, 11, min_valid, dtype, card)
    got, want = _both(monkeypatch, x, 2, 20.0, min_valid=min_valid)
    _assert_same(got, want, f"min_valid={min_valid}")


@pytest.mark.card
@pytest.mark.parametrize("q", [0, 2, 3])
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_kernel_resumes_bitwise(card, monkeypatch, q, dtype):
    """Slabs [0:0], [0:1], [1:1], [1:37], [37:150], [150:299], [299:300]
    from each other's carries: each slab bitwise the loop's from the same
    carry, and together bitwise one uninterrupted kernel run."""
    T, K = 300, 42
    x = _series(T, K, 5, dtype, card)
    full, full_loop = _both(monkeypatch, x, q, 252.0)
    _assert_same(full, full_loop, "full run")
    cuts = [0, 0, 1, 1, 37, 150, 299, 300]
    carry, covs, valid = None, [], []
    for a, b in zip(cuts, cuts[1:]):
        got, want = _both(monkeypatch, x[a:b], q, 252.0, min_valid=K,
                          carry=carry)
        _assert_same(got, want, f"slab [{a}:{b}]")
        covs.append(got[0])
        valid.append(got[1])
        carry = got[2]
    _assert_same((torch.cat(covs), torch.cat(valid), carry), full,
                 "resumed vs full")


MASKS = {
    "nan_date": [17],
    "first_date": [0],
    "scattered": [0, 1, 5, 6, 40, 119],
    "every_date": list(range(120)),
    "none_set": [],
}


@pytest.mark.card
@pytest.mark.parametrize("kind", list(MASKS))
@pytest.mark.parametrize("q", [2, 3])
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_kernel_excises_skipped_dates_bitwise(card, monkeypatch, kind, q,
                                              dtype):
    """A masked date's candidate is written and its state dropped: covs
    (NaN at a NaN date), valid and carry bitwise the loop's, in one slab
    and resumed across the masked dates."""
    T, K = 120, 42
    x = _series(T, K, 8, dtype, card)
    if kind == "nan_date":
        x[17] = float("nan")
    mask = torch.zeros(T, dtype=torch.bool, device=card)
    mask[MASKS[kind]] = True
    got, want = _both(monkeypatch, x, q, 20.0, skip_mask=mask)
    _assert_same(got, want, kind)
    first, _ = _both(monkeypatch, x[:18], q, 20.0, skip_mask=mask[:18])
    rest, rest_loop = _both(monkeypatch, x[18:], q, 20.0, carry=first[2],
                            skip_mask=mask[18:])
    _assert_same(rest, rest_loop, f"{kind} resumed")
    assert _bitwise(torch.cat([first[0], rest[0]]), got[0]), kind
    for i, (a, b) in enumerate(zip(_leaves(rest[2]), _leaves(got[2]))):
        assert _bitwise(a, b), f"{kind}: resumed carry leaf {i}"


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_kernel_t0_and_t1_slabs(card, monkeypatch, dtype):
    """A T = 0 slab passes the carry through (the fresh carry and one
    mid-history); a T = 1 slab is one date of the full run."""
    K, q = 42, 2
    x = _series(50, K, 3, dtype, card)
    for carry in (None, NW.newey_west_expanding_resume(x[:30], q)[2]):
        got, want = _both(monkeypatch, x[:0], q, carry=carry)
        assert got[0].shape == (0, K, K) and got[1].shape == (0,)
        _assert_same(got, want, "T = 0")
        if carry is not None:
            for i, (a, b) in enumerate(zip(_leaves(got[2]), _leaves(carry))):
                assert _bitwise(a, b), f"T = 0 passes leaf {i} through"
    head = NW.newey_west_expanding_resume(x[:30], q)
    one, one_loop = _both(monkeypatch, x[30:31], q, carry=head[2])
    _assert_same(one, one_loop, "T = 1")
    full = NW.newey_west_expanding_resume(x[:31], q)
    assert _bitwise(one[0], full[0][30:]) and _bitwise(one[2][2], full[2][2])


@pytest.mark.card
def test_the_kernel_refuses_on_the_card(card):
    x = _series(10, 4, 0, torch.float32, card)
    with pytest.raises(TypeError, match="float32 or float64"):
        NW.newey_west_expanding_resume(x.half(), 2)
    with pytest.raises(ValueError, match="takes q in"):
        NW.newey_west_expanding_resume(x, C.MAX_Q + 1)
    panels = _panels(torch.float32, card)
    with pytest.raises(ValueError, match="takes q in"):
        _model(panels, cfg=dataclasses.replace(CFG, nw_lags=C.MAX_Q + 1))
    with pytest.raises(ValueError, match="no backward"):
        NW.newey_west_expanding_resume(x.requires_grad_(True), 2)


# -- the card: the main path and the port's bitwise contracts ----------------

TM, NM, PM, QM = 48, 40, 4, 3
CFG = RiskModelConfig(eigen_n_sims=8, eigen_sim_length=48)
GCFG = dataclasses.replace(CFG, quarantine=QuarantinePolicy(enabled=True))


def _panels(dtype, device, T=TM, N=NM, seed=0):
    ret, cap, styles, industry, valid = synthetic_risk_inputs(T, N, PM, QM,
                                                              seed=seed)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(
        device=device, dtype=dtype if a.dtype.kind == "f" else None)
        for a in (ret, cap, styles, industry, valid))


def _model(panels, sl=slice(None), cfg=CFG):
    return RiskModel(*(p[sl] for p in panels), n_industries=PM, config=cfg,
                     device=panels[0].device)


def _outputs_same(got, want, what):
    for name in want._fields:
        assert _bitwise(getattr(got, name), getattr(want, name)), \
            f"{what}: {name}"


@pytest.mark.card
def test_a_rebuild_and_each_serving_step_launch_the_kernel_once(card):
    panels = _panels(torch.float32, card)
    trace.reset_tracing()
    trace.set_stage_tracing(True)
    try:
        steps = {
            "run_fused": lambda: _model(panels).run_fused(),
            "init_state": lambda: _model(panels, slice(0, 40)).init_state(),
        }
        _, st = steps["init_state"]()
        steps["update"] = lambda: _model(panels, slice(40, 48)).update(st)
        steps["update_guarded"] = lambda: _model(
            panels, slice(40, 48), cfg=GCFG).update_guarded(
                _model(panels, slice(0, 40), cfg=GCFG).init_state()[1])
        for name, step in steps.items():
            trace.reset_tracing()
            before = C.launch_total()
            step()
            torch.cuda.synchronize()
            nw = [s for s in trace.spans() if s.name == "risk.newey_west"]
            assert nw[-1].attrs["nw_launches"] == 1, name
            assert C.launch_total() - before == len(nw), name
    finally:
        trace.set_stage_tracing(False)
        trace.reset_tracing()


@pytest.mark.card
@pytest.mark.parametrize("T0", [1, 2, 20, 40])
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_card_update_is_the_suffix_of_the_full_run(card, T0, dtype):
    panels = _panels(dtype, card)
    full_out, full_st = _model(panels).init_state()
    _, st = _model(panels, slice(0, T0)).init_state()
    seq = st
    for t in range(T0, min(T0 + 3, TM)):
        _, seq = _model(panels, slice(t, t + 1)).update(seq)
    out, st_slab = _model(panels, slice(T0, TM)).update(st)
    _outputs_same(out, type(full_out)(*(x[T0:] for x in full_out)),
                  f"T0={T0} slab")
    for i, (a, b) in enumerate(zip(_leaves(st_slab.nw_carry),
                                   _leaves(full_st.nw_carry))):
        assert _bitwise(a, b), f"T0={T0}: Newey-West carry leaf {i}"
    assert st_slab.t == full_st.t == TM


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_card_clean_guarded_run_is_bitwise_unguarded(card, dtype):
    panels = _panels(dtype, card)
    _outputs_same(_model(panels, cfg=GCFG).init_state()[0],
                  _model(panels).init_state()[0], "guarded init")
    _, gst = _model(panels, slice(0, 20), cfg=GCFG).init_state()
    _, ust = _model(panels, slice(0, 20)).init_state()
    o_u, ust2 = _model(panels, slice(20, TM)).update(ust)
    o_g, rep, gst2 = _model(panels, slice(20, TM),
                            cfg=GCFG).update_guarded(gst)
    assert not rep.quarantined.any()
    _outputs_same(o_g, o_u, "guarded slab")
    for i, (a, b) in enumerate(zip(_leaves(gst2.nw_carry),
                                   _leaves(ust2.nw_carry))):
        assert _bitwise(a, b), f"guarded Newey-West carry leaf {i}"


@pytest.mark.card
@pytest.mark.parametrize("nd,ns", [(2, 2), (4, 2)])
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_card_sharded_run_is_bitwise_unsharded(card, monkeypatch, nd, ns,
                                               dtype):
    """``run_fused`` on a virtual mesh of the card (an uneven panel, so
    the mesh pads): every field bitwise the unsharded run's."""
    monkeypatch.setenv(VIRTUAL_DEVICES_ENV, str(nd * ns))
    panels = _panels(dtype, card, T=35, N=33, seed=2)
    mesh = make_mesh(nd, ns, device=card)
    padded = tuple(pad_to_mesh(p, mesh) for p in panels)
    base = RiskModel(*padded, n_industries=PM, config=CFG,
                     device=card).run_fused()
    with use_mesh(mesh):
        out = RiskModel(*shard_panel(padded, mesh), n_industries=PM,
                        config=CFG, device=card).run_fused()
    _outputs_same(out, base, f"{nd}x{ns}")
