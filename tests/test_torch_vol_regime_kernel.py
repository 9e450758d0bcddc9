"""The vol-regime scan kernel (``mfm_tpu_torch/csrc/vol_regime_scan.cu``)
against the loop it replaces on the card.

On the CPU: ``vol_regime_adjust_resume`` runs the plain loop and launches
nothing; the wrapper refuses what the kernel does not take; and the
kernel's arithmetic, transcribed into PyTorch step by step (the movers'
loads and products a chunk at a time, the one thread's chain, the movers'
ratios and square roots), gives the loop's bits, which is what the kernel
is held to on the card.

On the card (tests marked ``card``; without a card they skip): the
kernel's ``fvm2`` and ``lamb``, the adjusted covariances and both carry
leaves are bitwise the loop's (the same function with the loop in the
kernel's place), NaN in the same places, across shapes, half-lives,
dtypes, resumes, skip masks and T = 0 and T = 1 slabs; a rebuild and each
serving step launch it once; and the port's bitwise contracts hold with
it on the main path.  Run them there with ``python -m pytest --noconftest
-m card tests/test_torch_vol_regime_kernel.py``.  Inputs are made with
numpy from a seed.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

from mfm_tpu_torch import RiskModel, RiskModelConfig
from mfm_tpu_torch._device import VIRTUAL_DEVICES_ENV
from mfm_tpu_torch.config import QuarantinePolicy
from mfm_tpu_torch.data.synthetic import synthetic_risk_inputs
from mfm_tpu_torch.models import vol_regime as VR
from mfm_tpu_torch.obs import trace
from mfm_tpu_torch.ops import _build
from mfm_tpu_torch.ops import vol_regime_cuda as C
from mfm_tpu_torch.parallel.mesh import (
    make_mesh,
    pad_to_mesh,
    shard_panel,
    use_mesh,
)

torch.set_num_threads(2)

DTYPES = [torch.float32, torch.float64]
DT_IDS = ["f32", "f64"]
HALF_LIVES = [42.0, 252.0, 1.5]
_INT_VIEW = {torch.float32: torch.int32, torch.float64: torch.int64}
#: the kernel's dates a pipeline step, read from its source
K_CHUNK = int(re.search(r"constexpr int kChunk = (\d+);",
                        (_build.CSRC / f"{C.SOURCE}.cu").read_text()).group(1))


def _inputs(T, K, seed, dtype, device="cpu", n_invalid=5, nan_dates=()):
    """AR(1) factor returns around 1% a day and covariances around their
    scale, (T, K) and (T, K, K): the first ``n_invalid`` dates invalid
    (NaN covariances, ``valid`` False), each of ``nan_dates`` valid with a
    NaN variance."""
    rng = np.random.default_rng(seed)
    f = 0.01 * rng.standard_normal((T, K))
    for t in range(1, T):
        f[t] += 0.3 * f[t - 1]
    noise = 1e-5 * rng.standard_normal((T, K, K))
    covs = 1e-4 * (1.0 + rng.random((T, 1, 1))) * np.eye(K) + (
        noise + noise.transpose(0, 2, 1)) / 2
    valid = np.ones(T, dtype=bool)
    covs[:n_invalid] = np.nan
    valid[:n_invalid] = False
    for t in nan_dates:
        covs[t, K // 2, K // 2] = np.nan
    return (torch.from_numpy(f).to(dtype=dtype, device=device),
            torch.from_numpy(covs).to(dtype=dtype, device=device),
            torch.from_numpy(valid).to(device=device))


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
    """``(vr_cov, lamb, (num, den))`` bitwise, leaf by leaf."""
    adj, lamb, (num, den) = got
    assert _bitwise(adj, want[0]), f"{what}: vr_cov"
    assert _bitwise(lamb, want[1]), f"{what}: lamb"
    assert _bitwise(num, want[2][0]), f"{what}: carry num"
    assert _bitwise(den, want[2][1]), f"{what}: carry den"


def _mask(T, dates, device="cpu"):
    m = torch.zeros(T, dtype=torch.bool, device=device)
    m[list(dates)] = True
    return m


MASKS = {
    "none": None,
    "nan_date": [17],
    "first_date": [0],
    "scattered": [0, 1, 5, 6, 30, 39],
    "every_date": "all",
}


def _mask_for(kind, T, device="cpu"):
    dates = MASKS[kind]
    if dates is None:
        return None
    return _mask(T, range(T) if dates == "all" else
                 [d for d in dates if d < T], device)


def _leading_invalid(kind):
    """Invalid dates at the head of a series: none where the first date
    is masked, so that the mask excises a date that moves the sums."""
    return 0 if kind == "first_date" else 5


# -- the CPU: the loop, and the wrapper's refusals ---------------------------

def test_the_cpu_runs_the_loop_and_launches_nothing(monkeypatch):
    args = _inputs(40, 6, 0, torch.float64)
    before = C.launch_total()
    got = VR.vol_regime_adjust_resume(*args, half_life=20.0)
    assert C.launch_total() == before

    def refuse(*a):
        raise AssertionError("the CPU reached the kernel's wrapper")

    monkeypatch.setattr(VR, "vol_regime_scan_cuda", refuse)
    _assert_same(VR.vol_regime_adjust_resume(*args, half_life=20.0), got,
                 "cpu")


def _parts(T=4, dtype=torch.float64):
    """Arguments the wrapper takes: B2z, okf, no mask, lam, carry."""
    return (torch.zeros(T, dtype=dtype), torch.ones(T, dtype=dtype), None,
            torch.tensor(0.9, dtype=dtype), VR.vr_init_carry(dtype))


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16,
                                   torch.int32])
def test_the_wrapper_refuses_other_dtypes(dtype):
    b2z, okf, _, lam, carry = _parts()
    with pytest.raises(TypeError, match="float32 or float64"):
        C.check(b2z.to(dtype), okf.to(dtype), None, lam.to(dtype),
                tuple(x.to(dtype) for x in carry))


@pytest.mark.parametrize("length", [0, 3, 5])
def test_the_wrapper_refuses_a_mask_of_another_length(length):
    b2z, okf, _, lam, carry = _parts(T=4)
    with pytest.raises(ValueError, match=rf"skip_mask has {length} dates, "
                                         r"the slab 4"):
        C.check(b2z, okf, torch.zeros(length, dtype=torch.bool), lam, carry)


@pytest.mark.parametrize("fault", ["dtype", "layout"])
def test_the_wrapper_refuses_a_mask_it_cannot_read(fault):
    b2z, okf, _, lam, carry = _parts(T=4)
    mask = (torch.zeros(4, dtype=torch.uint8) if fault == "dtype"
            else torch.zeros(8, dtype=torch.bool)[::2])
    with pytest.raises(ValueError, match="contiguous bool"):
        C.check(b2z, okf, mask, lam, carry)


@pytest.mark.parametrize("fault", ["dtype", "shape", "count"])
def test_the_wrapper_refuses_a_carry_it_cannot_take(fault):
    b2z, okf, _, lam, (num, den) = _parts()
    carry = {"dtype": (num.float(), den),
             "shape": (num, den.reshape(1)),
             "count": (num,)}[fault]
    with pytest.raises(ValueError, match="carry"):
        C.check(b2z, okf, None, lam, carry)


@pytest.mark.parametrize("fault", ["okf", "lam"])
def test_the_wrapper_refuses_mismatched_series(fault):
    b2z, okf, _, lam, carry = _parts()
    if fault == "okf":
        okf = okf[:3]
    else:
        lam = torch.ones(2, dtype=b2z.dtype)
    with pytest.raises(ValueError, match=fault):
        C.check(b2z, okf, None, lam, carry)


@pytest.mark.parametrize("which", ["b2z", "carry"])
def test_the_wrapper_refuses_inputs_that_require_grad(which):
    b2z, okf, _, lam, (num, den) = _parts()
    if which == "b2z":
        b2z = b2z.clone().requires_grad_(True)
    else:
        den = den.clone().requires_grad_(True)
    with pytest.raises(ValueError, match="no backward"):
        C.check(b2z, okf, None, lam, (num, den))


def test_the_wrapper_refuses_a_cpu_series():
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        C.vol_regime_scan_cuda(*_parts())


# -- the kernel's arithmetic, step by step, on the CPU -----------------------

def _transcribed_scan(B2z, okf, skip_mask, lam, carry, chunk=K_CHUNK):
    """``csrc/vol_regime_scan.cu`` in PyTorch: a chunk at a time, the
    movers' products ``okf * B2z`` (elementwise), the chain's walk (each
    date's candidate sums, kept unless the date is skipped, the sums after
    it stored), then the movers' ratios and square roots (elementwise);
    each operation the kernel's.  Returns ``(fvm2, lamb, (num, den))``."""
    T = B2z.shape[0]
    zero = torch.zeros((), dtype=B2z.dtype)
    skip = (torch.zeros(T, dtype=torch.bool) if skip_mask is None
            else torch.as_tensor(skip_mask, dtype=torch.bool).reshape(-1))
    num, den = carry
    fvm2, lamb = torch.empty_like(B2z), torch.empty_like(B2z)
    for base in range(0, T, chunk):
        sl = slice(base, min(base + chunk, T))
        add, ok, sk = okf[sl] * B2z[sl], okf[sl].clone(), skip[sl]
        nums, dens = torch.empty_like(add), torch.empty_like(add)
        for k in range(add.shape[0]):
            nn = lam * num + add[k]
            dd = lam * den + ok[k]
            if not sk[k]:
                num, den = nn, dd
            nums[k], dens[k] = num, den
        f = torch.where(dens > zero, nums / dens, zero)
        fvm2[sl], lamb[sl] = f, torch.sqrt(f)
    return fvm2, lamb, (num, den)


def _run_split(args, half_life, mask, T0):
    """``vol_regime_adjust_resume`` over dates [0:T0] then [T0:T] from the
    first slab's carry; the two slabs' outputs joined."""
    f, c, v = args
    sl = (slice(0, T0), slice(T0, None))
    a = VR.vol_regime_adjust_resume(
        f[sl[0]], c[sl[0]], v[sl[0]], half_life,
        skip_mask=None if mask is None else mask[sl[0]])
    b = VR.vol_regime_adjust_resume(
        f[sl[1]], c[sl[1]], v[sl[1]], half_life, carry=a[2],
        skip_mask=None if mask is None else mask[sl[1]])
    return torch.cat([a[0], b[0]]), torch.cat([a[1], b[1]]), b[2]


@pytest.mark.parametrize("mask_kind", list(MASKS))
@pytest.mark.parametrize("half_life", HALF_LIVES)
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_the_kernels_arithmetic_is_the_loops_bitwise(monkeypatch, mask_kind,
                                                     half_life, dtype):
    """A run of invalid dates first, dates with a NaN variance, the mask,
    one pass and resumes at several T0, at the kernel's chunk and at a
    chunk of 7: the transcription gives the loop's vr_cov, lamb and carry
    to the bit."""
    T, K = 40, 5
    args = _inputs(T, K, int(half_life) + T, dtype, nan_dates=(9, 17, 33),
                   n_invalid=_leading_invalid(mask_kind))
    mask = _mask_for(mask_kind, T)
    want = {T0: _run_split(args, half_life, mask, T0)
            for T0 in (0, 1, 13, 29, T)}
    for chunk in (K_CHUNK, 7):
        monkeypatch.setattr(VR, "_scan_loop", lambda *a, c=chunk:
                            _transcribed_scan(*a, chunk=c))
        for T0, w in want.items():
            _assert_same(_run_split(args, half_life, mask, T0), w,
                         f"chunk {chunk}, T0 = {T0}")
    _assert_same(want[0], want[T], "resumed at 0 vs one pass")


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_the_transcription_takes_t0_and_t1_slabs(monkeypatch, dtype):
    """A T = 0 slab passes the carry through (fresh and mid-history); a
    T = 1 slab is one date of the full run; loop and transcription
    agree on both."""
    f, c, v = _inputs(30, 4, 3, dtype)
    head = VR.vol_regime_adjust_resume(f[:20], c[:20], v[:20])
    full = VR.vol_regime_adjust_resume(f[:21], c[:21], v[:21])
    cases = {"T = 0 fresh": (f[:0], c[:0], v[:0], None),
             "T = 0 mid": (f[20:20], c[20:20], v[20:20], head[2]),
             "T = 1": (f[20:21], c[20:21], v[20:21], head[2])}
    want = {name: VR.vol_regime_adjust_resume(*a[:3], carry=a[3])
            for name, a in cases.items()}
    monkeypatch.setattr(VR, "_scan_loop", _transcribed_scan)
    for name, a in cases.items():
        got = VR.vol_regime_adjust_resume(*a[:3], carry=a[3])
        _assert_same(got, want[name], name)
    assert want["T = 0 fresh"][1].shape == (0,)
    assert _bitwise(want["T = 0 mid"][2][0], head[2][0])
    assert _bitwise(want["T = 1"][1], full[1][20:])
    assert _bitwise(want["T = 1"][2][1], full[2][1])


# -- the card ----------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    return torch.device("cuda")


def _both(monkeypatch, *args, **kw):
    """``vol_regime_adjust_resume`` on the card through the kernel (one
    launch, counted), then with the loop in the kernel's place."""
    before = C.launch_total()
    got = VR.vol_regime_adjust_resume(*args, **kw)
    assert C.launch_total() == before + 1
    with monkeypatch.context() as m:
        m.setattr(VR, "vol_regime_scan_cuda", VR._scan_loop)
        want = VR.vol_regime_adjust_resume(*args, **kw)
    return got, want


SHAPES = [(1390, 42), (2500, 42), (2500, 73), (61, 5)]


@pytest.mark.card
@pytest.mark.parametrize("T,K", SHAPES, ids=[f"{t}x{k}" for t, k in SHAPES])
@pytest.mark.parametrize("half_life", HALF_LIVES)
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_kernel_is_the_loop_bitwise(card, monkeypatch, T, K, half_life,
                                    dtype):
    """On covariances with invalid dates first and NaN variances: fvm2,
    lamb and the carry from the wrapper, and vr_cov, lamb and the carry
    from the model's function, all bitwise the loop's."""
    args = _inputs(T, K, T + K, dtype, card, n_invalid=min(40, T // 3),
                   nan_dates=(T // 2, T // 2 + 1, T - 3))
    got, want = _both(monkeypatch, *args, half_life)
    _assert_same(got, want, f"{T}x{K} hl={half_life}")
    b2z, okf = VR.scan_inputs(*args)
    lam = torch.tensor(0.5, dtype=dtype, device=card) ** (1.0 / half_life)
    carry = VR.vr_init_carry(dtype, card)
    k_fvm2, k_lamb, k_carry = C.vol_regime_scan_cuda(b2z, okf, None, lam,
                                                     carry)
    l_fvm2, l_lamb, l_carry = VR._scan_loop(b2z, okf, None, lam, carry)
    assert _bitwise(k_fvm2, l_fvm2), "fvm2"
    assert _bitwise(k_lamb, l_lamb) and _bitwise(k_lamb, torch.sqrt(k_fvm2))
    assert all(_bitwise(a, b) for a, b in zip(k_carry, l_carry)), "carry"


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_kernel_resumes_bitwise(card, monkeypatch, dtype):
    """Slabs [0:0], [0:1], [1:1], [1:37], [37:300], [300:599], [599:600]
    from each other's carries: each slab bitwise the loop's from the same
    carry, and together bitwise one uninterrupted kernel run."""
    T, K = 600, 42
    args = _inputs(T, K, 5, dtype, card, n_invalid=20, nan_dates=(100,))
    full, full_loop = _both(monkeypatch, *args, 42.0)
    _assert_same(full, full_loop, "full run")
    cuts = [0, 0, 1, 1, 37, 300, 599, 600]
    carry, adj, lamb = None, [], []
    for a, b in zip(cuts, cuts[1:]):
        got, want = _both(monkeypatch, *(x[a:b] for x in args), 42.0,
                          carry=carry)
        _assert_same(got, want, f"slab [{a}:{b}]")
        adj.append(got[0])
        lamb.append(got[1])
        carry = got[2]
    _assert_same((torch.cat(adj), torch.cat(lamb), carry), full,
                 "resumed vs full")


@pytest.mark.card
@pytest.mark.parametrize("kind", [k for k in MASKS if k != "none"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_kernel_excises_skipped_dates_bitwise(card, monkeypatch, kind,
                                              dtype):
    """A masked date's sums are kept and its frozen ratio written: vr_cov
    (NaN at a NaN date), lamb and the carry bitwise the loop's, with the
    mask on the card and as a host list, in one slab and resumed across
    the masked dates."""
    T, K = 600, 42
    args = _inputs(T, K, 8, dtype, card, nan_dates=(17, 300),
                   n_invalid=_leading_invalid(kind))
    mask = _mask_for(kind, T, card)
    got, want = _both(monkeypatch, *args, 42.0, skip_mask=mask)
    _assert_same(got, want, kind)
    listed, _ = _both(monkeypatch, *args, 42.0, skip_mask=mask.tolist())
    _assert_same(listed, got, f"{kind} as a list")
    first, _ = _both(monkeypatch, *(x[:18] for x in args), 42.0,
                     skip_mask=mask[:18])
    rest, rest_loop = _both(monkeypatch, *(x[18:] for x in args), 42.0,
                            carry=first[2], skip_mask=mask[18:])
    _assert_same(rest, rest_loop, f"{kind} resumed")
    _assert_same((torch.cat([first[0], rest[0]]),
                  torch.cat([first[1], rest[1]]), rest[2]), got,
                 f"{kind} resumed vs one pass")


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_kernel_t0_and_t1_slabs(card, monkeypatch, dtype):
    """A T = 0 slab passes the carry through (the fresh carry and one
    mid-history); a T = 1 slab is one date of the full run."""
    f, c, v = _inputs(50, 42, 3, dtype, card)
    head = VR.vol_regime_adjust_resume(f[:30], c[:30], v[:30])
    for carry in (None, head[2]):
        got, want = _both(monkeypatch, f[:0], c[:0], v[:0], carry=carry)
        assert got[0].shape == (0, 42, 42) and got[1].shape == (0,)
        _assert_same(got, want, "T = 0")
        if carry is not None:
            assert all(_bitwise(a, b) for a, b in zip(got[2], carry))
    one, one_loop = _both(monkeypatch, f[30:31], c[30:31], v[30:31],
                          carry=head[2])
    _assert_same(one, one_loop, "T = 1")
    full = VR.vol_regime_adjust_resume(f[:31], c[:31], v[:31])
    assert _bitwise(one[1], full[1][30:])
    assert all(_bitwise(a, b) for a, b in zip(one[2], full[2]))


@pytest.mark.card
def test_the_kernel_refuses_on_the_card(card):
    f, c, v = _inputs(10, 4, 0, torch.float32, card)
    with pytest.raises(TypeError, match="float32 or float64"):
        VR.vol_regime_adjust_resume(f.half(), c.half(), v)
    with pytest.raises(ValueError, match="skip_mask has 9 dates"):
        VR.vol_regime_adjust_resume(f, c, v, skip_mask=[False] * 9)
    with pytest.raises(ValueError, match="carry"):
        VR.vol_regime_adjust_resume(f, c, v, carry=VR.vr_init_carry(
            torch.float64, card))
    with pytest.raises(ValueError, match="no backward"):
        VR.vol_regime_adjust_resume(f.requires_grad_(True), c, v)


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


def _vr_carry_same(a, b, what):
    assert _bitwise(a.vr_num, b.vr_num), f"{what}: vr_num"
    assert _bitwise(a.vr_den, b.vr_den), f"{what}: vr_den"


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
            vr = [s for s in trace.spans() if s.name == "risk.vol_regime"]
            assert vr[-1].attrs["vr_launches"] == 1, name
            assert C.launch_total() - before == len(vr), name
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
    out, st_slab = _model(panels, slice(T0, TM)).update(st)
    _outputs_same(out, type(full_out)(*(x[T0:] for x in full_out)),
                  f"T0={T0} slab")
    _vr_carry_same(st_slab, full_st, f"T0={T0}")


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_card_clean_guarded_run_is_bitwise_unguarded(card, dtype):
    panels = _panels(dtype, card)
    _, gst = _model(panels, slice(0, 20), cfg=GCFG).init_state()
    _, ust = _model(panels, slice(0, 20)).init_state()
    o_u, ust2 = _model(panels, slice(20, TM)).update(ust)
    o_g, rep, gst2 = _model(panels, slice(20, TM),
                            cfg=GCFG).update_guarded(gst)
    assert not rep.quarantined.any()
    _outputs_same(o_g, o_u, "guarded slab")
    _vr_carry_same(gst2, ust2, "guarded")


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
