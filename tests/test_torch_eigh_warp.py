"""The warp design of the port's Jacobi eigh kernels
(``mfm_tpu_torch/csrc/jacobi_eigh_warp.cu``) rehearsed on the CPU.

A CUDA kernel cannot run here, so this file transcribes its index logic
into PyTorch, lane by lane: lane a holds rows 2a and 2a+1 of the matrix in
the interleaved basis and rows 2a and 2a+1 of V in original coordinates;
the angles come from a select tree over the lane's bits; the basis change
is a shift up and a shift down between lanes (with the kernel's boundary
selects at lanes 0 and h-1) and a static column reorder inside each lane.
The transcription must give the plain version's w and V to the bit, which
is what the kernel is held to on the card by ``chip_smoke.py``.  The
routing of (n, dtype) to a design is checked here too; the wrappers'
refusals, at an n of either design, in ``tests/test_torch_eigh.py``.
Inputs are made with numpy from a seed.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mfm_tpu.ops.eigh_pallas import jacobi_eigh_tpu
from mfm_tpu_torch.ops import eigh as E
from mfm_tpu_torch.ops import eigh_cuda as C

torch.set_num_threads(2)

LANES = 32


def _b0(n, j):
    """Original index held by slot j of the interleaved basis."""
    return n - 1 - j // 2 if j & 1 else j // 2


def _pi(n, j):
    """The basis change: new slot j takes old slot pi(n, j)."""
    if n == 2:
        return j
    if j == 0:
        return 0
    if j == 2:
        return 1
    if j == n - 1:
        return n - 2
    return j + 2 if j & 1 else j - 2


def _pick(x, off, h):
    """The kernel's select tree: x[..., lane, 2 * lane + off] for every
    lane, built from static column indices and the bits of the lane."""
    lane = torch.arange(LANES)
    v = [x[..., 2 * b + off] for b in range(h)]
    bit = 1
    while bit < h:
        for b in range(0, h - bit, 2 * bit):
            v[b] = torch.where((lane & bit) != 0, v[b + bit], v[b])
        bit <<= 1
    return v[0]


def _angle(app, aqq, apq, tiny):
    small = apq.abs() <= tiny
    tau = (aqq - app) / torch.where(small, 1.0, 2.0 * apq)
    t = torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
    t = torch.where(tau == 0, 1.0, t)
    t = torch.where(small, 0.0, t)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    return c, t * c


def _interleave(even, odd):
    return torch.stack([even, odd], dim=-1).flatten(-2)


def warp_decompose(A, sweeps):
    """Transcription of ``decompose`` for a (B, n, n) batch, one warp of 32
    lanes per matrix: returns the lanes' (top, bot, v0, v1), each
    (B, 32, n)."""
    B, n, _ = A.shape
    h = n // 2
    lane = torch.arange(LANES)
    r = torch.where(lane < h, lane, 0)
    cols = [_b0(n, j) for j in range(n)]
    top = A[:, r][:, :, cols]
    bot = A[:, n - 1 - r][:, :, cols]
    b0 = torch.tensor(cols)
    v0 = (2 * r[:, None] == b0[None]).to(A.dtype).expand(B, LANES, n)
    v1 = (2 * r[:, None] + 1 == b0[None]).to(A.dtype).expand(B, LANES, n)
    perm = [_pi(n, j) for j in range(n)]
    tiny = E._skip_threshold(A.dtype)
    for _ in range(sweeps * (n - 1)):
        # (1) each lane's angle; lanes < h publish theirs
        c, s = _angle(_pick(top, 0, h), _pick(bot, 1, h), _pick(top, 1, h),
                      tiny)
        cb, sb = c[:, None, :h], s[:, None, :h]
        # (2) rows with the lane's own angle
        cr, sr = c[..., None], s[..., None]
        t, u = cr * top - sr * bot, sr * top + cr * bot
        # (3) columns 2b, 2b+1 of X and V with pair b's angle
        rot = lambda x: _interleave(cb * x[..., 0::2] - sb * x[..., 1::2],
                                    sb * x[..., 0::2] + cb * x[..., 1::2])
        top, bot, v0, v1 = rot(t), rot(u), rot(v0), rot(v1)
        # (4) the basis change
        if h > 1:
            first = (lane == 0)[:, None]
            last = (lane == h - 1)[:, None]
            send = torch.where(first, bot, top)
            up = torch.cat([send[:, :1], send[:, :-1]], dim=1)  # shfl_up 1
            dn = torch.cat([bot[:, 1:], bot[:, -1:]], dim=1)    # shfl_down 1
            top, bot = torch.where(first, top, up), torch.where(last, top, dn)
            top, bot, v0, v1 = (x[..., perm] for x in (top, bot, v0, v1))
    return top, bot, v0, v1


def warp_eigh(A, sweeps):
    """``warp_eigh_kernel``'s outputs: (w, V) in original slot order."""
    B, n, _ = A.shape
    h = n // 2
    top, bot, v0, v1 = warp_decompose(A, sweeps)
    wt, wb = _pick(top, 0, h), _pick(bot, 1, h)
    w = torch.empty((B, n), dtype=A.dtype)
    V = torch.empty((B, n, n), dtype=A.dtype)
    for a in range(h):
        w[:, a], w[:, n - 1 - a] = wt[:, a], wb[:, a]
        for j in range(n):
            V[:, 2 * a, _b0(n, j)] = v0[:, a, j]
            V[:, 2 * a + 1, _b0(n, j)] = v1[:, a, j]
    return w, V


def warp_weighted(A, d0, sweeps):
    """``warp_weighted_kernel``'s outputs: (w, h), h summed over k in order."""
    n = A.shape[-1]
    w, V = warp_eigh(A, sweeps)
    h = torch.zeros_like(w)
    for k in range(n):
        h = h + V[:, k, :] * V[:, k, :] * d0[:, k, None]
    return w, h


def _psd(rng, B, n):
    X = rng.standard_normal((B, n, n)).astype(np.float32)
    return torch.from_numpy(np.einsum("bik,bjk->bij", X, X) / n)


@pytest.mark.parametrize("n", [2, 4, 6, 8, 42])
def test_warp_transcription_is_bitwise_the_plain_version_f32(n):
    rng = np.random.default_rng(100 + n)
    A = _psd(rng, 3, n)
    sweeps = E._sweeps_for(n, torch.float32)
    w, V = warp_eigh(A, sweeps)
    wp, Vp = E.jacobi_eigh_slots(A, sweeps)
    assert torch.equal(w, wp) and torch.equal(V, Vp)


@pytest.mark.parametrize("n", [8, 42])
def test_warp_weighted_transcription_matches_plain_version_f32(n):
    """w bitwise; h sums its n terms in another order than the plain
    version's reduction."""
    rng = np.random.default_rng(200 + n)
    A = _psd(rng, 3, n)
    d0 = torch.from_numpy(rng.random((3, n)).astype(np.float32))
    w, h = warp_weighted(A, d0, 4)
    wp, hp = E.jacobi_eigh_weighted_diag_slots(A, d0, 4)
    assert torch.equal(w, wp)
    assert float(((h - hp).abs() / hp.abs().amax(-1, keepdim=True)).max()) <= 1e-6


def test_warp_transcription_matches_pallas_kernel_n8():
    """The transcription against the JAX package's kernel in interpret
    mode, to the float32 tolerance of tests/test_torch_eigh.py."""
    rng = np.random.default_rng(8)
    A = _psd(rng, 4, 8)
    w_ref, _ = jacobi_eigh_tpu(jnp.asarray(A.numpy()), sort=False,
                               canonical_signs=False, interpret=True)
    w, _ = warp_eigh(A, E._sweeps_for(8, torch.float32))
    ref = np.asarray(w_ref, np.float64)
    assert np.abs(w.numpy() - ref).max() / np.abs(ref).max() <= 1e-5


@pytest.mark.parametrize("n", list(range(2, 130, 2)))
def test_warp_basis_rules_are_the_schedule(n):
    """The closed forms of the kernel (b0, pi) are the Brent-Luk schedule's
    perms, and pi is the lane shift with its boundary cases."""
    b0, pi = E._brent_luk_perms(n)
    assert [_b0(n, j) for j in range(n)] == b0
    assert [_pi(n, j) for j in range(n)] == pi
    h = n // 2
    for a in range(h):  # rows 2a, 2a+1 of the next round, by source row
        top_src = 2 * a if a == 0 else (1 if a == 1 else 2 * (a - 1))
        bot_src = 2 * a if a == h - 1 else 2 * (a + 1) + 1
        if h == 1:
            top_src, bot_src = 0, 1
        assert (pi[2 * a], pi[2 * a + 1]) == (top_src, bot_src)


@pytest.mark.parametrize("h", [1, 2, 3, 5, 16, 21, 32])
def test_warp_select_tree_picks_each_lanes_block(h):
    x = torch.arange(2 * h, dtype=torch.float32).expand(LANES, 2 * h)
    for off in (0, 1):
        got = _pick(x, off, h)
        assert got[:h].tolist() == [2 * a + off for a in range(h)]


def test_design_routing_by_n_and_dtype():
    """WARP_N is every even n up to the warp source's kMaxN."""
    assert C.WARP_N == tuple(range(2, C._warp_max_n() + 1, 2))
    assert 8 in C.WARP_N and 42 in C.WARP_N
    assert all(n % 2 == 0 and 2 <= n <= E.JACOBI_MAX_N for n in C.WARP_N)
    f32, f64 = torch.float32, torch.float64
    for n in C.WARP_N:
        assert C.design_for(n, f32) == "warp"
        assert C.design_for(n, f64) == "block"
    assert C.design_for(max(C.WARP_N) + 2, f32) == "block"
    assert C.design_for(E.JACOBI_MAX_N, f32) == "block"
    # the main path: K=42 float32 for the F0 eigh, the eigen Monte-Carlo
    # and the regression's 41x41 pseudo-inverse padded to 42
    assert C.design_for(42, f32) == "warp"


def test_design_choice_is_checked_and_cpu_runs_plain_version():
    """The wrappers take no design: a CPU tensor runs the plain version and
    launches nothing, whatever its (n, dtype) would route to.  The private
    launchers refuse the warp design where it does not apply, before any
    library is loaded."""
    A32 = _psd(np.random.default_rng(9), 2, 8)
    d0 = torch.ones((2, 8))
    before = C.launch_counts()
    for A, dd in ((A32, d0), (A32.double(), d0.double())):
        w, V = C.jacobi_eigh_cuda(A, sort=False, canonical_signs=False)
        wp, Vp = E.jacobi_eigh_slots(A)
        assert torch.equal(w, wp) and torch.equal(V, Vp)
        ww, hh = C.jacobi_eigh_weighted_diag_cuda(A, dd)
        assert torch.equal(ww, wp)
    with pytest.raises(TypeError):
        C.jacobi_eigh_cuda(A32, design="warp")
    with pytest.raises(ValueError, match="warp design"):
        C._launch_eigh(A32.double(), 10, "warp")
    with pytest.raises(ValueError, match="warp design"):
        C._launch_weighted(A32.double(), d0.double(), 10, "warp")
    big = torch.eye(max(C.WARP_N) + 2).expand(1, -1, -1).contiguous()
    with pytest.raises(ValueError, match="warp design"):
        C._launch_eigh(big, 10, "warp")
    assert C.launch_counts() == before
