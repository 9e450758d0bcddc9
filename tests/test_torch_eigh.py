"""The port's batched Jacobi eigh (``mfm_tpu_torch.ops.eigh``) against the
JAX package on the CPU.

The plain PyTorch versions of the two Hopper kernels
(``jacobi_eigh_slots``, ``jacobi_eigh_weighted_diag_slots``) are held
against the Pallas kernels run in interpret mode, the way
``tests/test_eigh.py`` runs them; the CUDA kernels themselves are held
against these plain versions on the card by ``chip_smoke.py``.  Inputs are
made with numpy from a seed and handed to both packages.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mfm_tpu.ops.eigh import jacobi_eigh as jax_jacobi_eigh
from mfm_tpu.ops.eigh_pallas import (
    jacobi_eigh_tpu,
    jacobi_eigh_weighted_diag_tpu,
)
from mfm_tpu_torch.ops import eigh as E
from mfm_tpu_torch.ops import eigh_cuda as C
from mfm_tpu_torch.ops.eigh_cuda import (
    jacobi_eigh_cuda,
    jacobi_eigh_weighted_diag_cuda,
    launch_counts,
)

torch.set_num_threads(2)


def _psd(rng, B, n, dtype=np.float32):
    X = rng.standard_normal((B, n, n)).astype(dtype)
    return np.einsum("bik,bjk->bij", X, X) / n


def _scaled_wishart(rng, M, n, L):
    """The eigen Monte-Carlo's G = diag(s) C diag(s) with C the sample
    covariance of L standard-normal draws (tests/test_eigh.py's recipe)."""
    d = rng.standard_normal((M, n, L)).astype(np.float32)
    d -= d.mean(axis=-1, keepdims=True)
    C = np.einsum("mkt,mlt->mkl", d, d) / (L - 1)
    s = np.abs(rng.normal(0.02, 0.01, n)).astype(np.float32)
    return s[None, :, None] * C * s[None, None, :], (s * s)


def _recon_err(w, V, A):
    """max |V diag(w) V' - A| / max |A| and max |V'V - I|, in float64."""
    w, V, A = (np.asarray(x, np.float64) for x in (w, V, A))
    R = np.einsum("bij,bj,bkj->bik", V, w, V)
    n = A.shape[-1]
    orth = np.einsum("bij,bik->bjk", V, V) - np.eye(n)
    return np.abs(R - A).max() / np.abs(A).max(), np.abs(orth).max()


# float32 tolerance against the Pallas kernel: XLA on the CPU contracts the
# rotations into fused multiply-adds and rewrites 1/sqrt as rsqrt, PyTorch
# rounds every product; both sit ~4e-6 * max|w| from the float64 eigenvalues
# at n=42 (measured), so they agree to that level and not to the last bit
F32_TOL = 1e-5


def _max_rel(x, ref):
    return np.abs(np.asarray(x, np.float64) - ref).max() / np.abs(ref).max()


def test_slots_match_pallas_kernel_n42_f32():
    """``jacobi_eigh_slots`` == ``jacobi_eigh_tpu(sort=False,
    canonical_signs=False)`` at the risk model's n=42: same schedule, same
    round count, same slot order."""
    rng = np.random.default_rng(0)
    A = _psd(rng, 12, 42)
    w_ref, V_ref = jacobi_eigh_tpu(jnp.asarray(A), sort=False,
                                   canonical_signs=False, interpret=True)
    w, V = E.jacobi_eigh_slots(torch.from_numpy(A))
    assert _max_rel(w.numpy(), np.asarray(w_ref)) <= F32_TOL
    exact = np.linalg.eigh(A.astype(np.float64))[0]
    assert _max_rel(np.sort(w.numpy(), axis=-1), exact) <= F32_TOL
    rec, orth = _recon_err(w.numpy(), V.numpy(), A)
    assert rec <= 5e-5 and orth <= 2e-5, (rec, orth)


def test_weighted_slots_match_pallas_kernel_on_sim_matrices():
    """``jacobi_eigh_weighted_diag_slots`` == the fused Pallas kernel at the
    eigen Monte-Carlo's 4 sweeps on scaled-Wishart G."""
    rng = np.random.default_rng(1)
    G, d0 = _scaled_wishart(rng, 8, 42, 1390)
    d0 = np.broadcast_to(d0, G.shape[:-1]).copy()
    w_ref, h_ref = jacobi_eigh_weighted_diag_tpu(
        jnp.asarray(G), jnp.asarray(d0), sweeps=4, interpret=True)
    w, h = E.jacobi_eigh_weighted_diag_slots(torch.from_numpy(G),
                                             torch.from_numpy(d0), sweeps=4)
    assert _max_rel(w.numpy(), np.asarray(w_ref)) <= F32_TOL
    assert _max_rel(h.numpy(), np.asarray(h_ref)) <= F32_TOL


def test_slot_order_follows_original_indices_and_rank_deficiency():
    """For near-diagonal input the eigenvalue tracking direction i sits at
    slot i, and exact zero rows/columns at 0 and 1 stay exact zeros at
    slots 0 and 1 (tests/test_eigh.py's contract for the Pallas kernel)."""
    rng = np.random.default_rng(7)
    n = 16
    d = np.linspace(1.0, 16.0, n).astype(np.float32)
    Ep = 0.01 * rng.standard_normal((3, n, n)).astype(np.float32)
    A = np.stack([np.diag(d)] * 3) + (Ep + Ep.transpose(0, 2, 1)) / 2
    w, _ = E.jacobi_eigh_slots(torch.from_numpy(A))
    np.testing.assert_allclose(w.numpy(), np.stack([d] * 3), atol=0.1)

    G = np.diag(np.array([0.0, 0.0] + list(1.0 + np.arange(n - 2)),
                         np.float32))
    E2 = 0.001 * rng.standard_normal((n - 2, n - 2)).astype(np.float32)
    G[2:, 2:] += (E2 + E2.T) / 2
    d0 = np.abs(rng.standard_normal((1, n))).astype(np.float32)
    w0, _ = E.jacobi_eigh_slots(torch.from_numpy(G)[None])
    ww, _ = E.jacobi_eigh_weighted_diag_slots(torch.from_numpy(G)[None],
                                              torch.from_numpy(d0))
    w_ref, _ = jacobi_eigh_tpu(jnp.asarray(G)[None], canonical_signs=False,
                               sort=False, interpret=True)
    for got in (w0[0].numpy(), ww[0].numpy()):
        assert got[0] == 0.0 and got[1] == 0.0
        assert (got[2:] > 0.5).all()
        np.testing.assert_allclose(got, np.asarray(w_ref[0]), rtol=1e-6)


@pytest.mark.parametrize("n", [5, 42, 43])
def test_sorted_jacobi_matches_reference_f64(n):
    rng = np.random.default_rng(n)
    A = rng.standard_normal((6, n, n))
    A = (A + A.transpose(0, 2, 1)) / 2
    w_ref, V_ref = jax_jacobi_eigh(jnp.asarray(A))
    w, V = E.jacobi_eigh(torch.from_numpy(A))
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), rtol=1e-10,
                               atol=1e-10)
    # canonical signs make the eigenvectors comparable elementwise
    np.testing.assert_allclose(V.numpy(), np.asarray(V_ref), atol=1e-10)


@pytest.mark.parametrize("n,rank", [(41, 41), (41, 30), (6, 6), (6, 3)])
def test_pinv_psd_matches_numpy(n, rank):
    rng = np.random.default_rng(21 + n + rank)
    X = rng.standard_normal((5, rank, n))
    G = np.einsum("bri,brj->bij", X, X)
    got = E.pinv_psd(torch.from_numpy(G)).numpy()
    np.testing.assert_allclose(got, np.linalg.pinv(G), rtol=5e-9, atol=1e-10)


def test_pinv_psd_of_zero_is_zero():
    Z = torch.zeros((2, 5, 5), dtype=torch.float64)
    assert torch.equal(E.pinv_psd(Z), Z)


@pytest.mark.parametrize("n", [4, 6, 42, 64, 128])
def test_perm_schedule_covers_all_pairs(n):
    E._check_perm_schedule(n)
    # the kernels' per-round pair tables name every index once a round
    for basis in E._round_bases(n):
        assert sorted(basis) == list(range(n))


def test_weighted_diag_dispatch_odd_n_and_broadcast_d0():
    """``batched_eigh_weighted_diag`` pads odd n with a zero-weight dummy
    and broadcasts a per-date d0 over the sims, against LAPACK."""
    rng = np.random.default_rng(12)
    T, M, n = 3, 4, 7
    X = rng.standard_normal((T, M, 12, n))
    A = np.einsum("tmnk,tmnl->tmkl", X, X) / 12
    d0 = np.abs(rng.standard_normal((T, n)))
    w, h = E.batched_eigh_weighted_diag(torch.from_numpy(A),
                                        torch.from_numpy(d0)[:, None, :])
    wr, Vr = np.linalg.eigh(A)
    hr = np.einsum("tmki,tk->tmi", Vr ** 2, d0)
    order = np.argsort(w.numpy(), axis=-1)
    np.testing.assert_allclose(np.take_along_axis(w.numpy(), order, -1), wr,
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.take_along_axis(h.numpy(), order, -1), hr,
                               rtol=1e-8, atol=1e-10)


def test_large_n_goes_to_library_eigh():
    """n > 128 is off the Jacobi solvers' range: both dispatchers use
    ``torch.linalg.eigh`` there, ascending."""
    rng = np.random.default_rng(3)
    A = _psd(rng, 2, 130, np.float64)
    w, V = E.batched_eigh(torch.from_numpy(A))
    np.testing.assert_allclose(w.numpy(), np.linalg.eigh(A)[0], rtol=1e-10,
                               atol=1e-10)
    d0 = np.ones((2, 130))
    _, h = E.batched_eigh_weighted_diag(torch.from_numpy(A),
                                        torch.from_numpy(d0))
    np.testing.assert_allclose(h.numpy(), 1.0, rtol=1e-10)


def test_cuda_wrappers_run_plain_version_on_cpu_tensors():
    """On a CPU tensor each wrapper runs its kernel's plain version and
    counts no launch."""
    rng = np.random.default_rng(4)
    A = torch.from_numpy(_psd(rng, 3, 8))
    d0 = torch.rand((3, 8), generator=torch.Generator().manual_seed(0))
    before = launch_counts()
    w, V = jacobi_eigh_cuda(A, sort=False, canonical_signs=False)
    ws, Vs = E.jacobi_eigh_slots(A)
    assert torch.equal(w, ws) and torch.equal(V, Vs)
    ww, hh = jacobi_eigh_weighted_diag_cuda(A, d0, sweeps=4)
    wp, hp = E.jacobi_eigh_weighted_diag_slots(A, d0, sweeps=4)
    assert torch.equal(ww, wp) and torch.equal(hh, hp)
    wsorted, _ = jacobi_eigh_cuda(A)
    assert torch.equal(wsorted, torch.sort(ws, dim=-1).values)
    assert launch_counts() == before


@pytest.mark.parametrize("design", ["block", "warp"])
@pytest.mark.parametrize("bad", ["odd", "dtype", "strided", "rank", "d0"])
def test_cuda_wrappers_reject_what_the_kernel_cannot_take(bad, design):
    """At an n that a float32 CUDA tensor would take to either design."""
    n = 8 if design == "warp" else max(C.WARP_N) + 2
    assert C.design_for(n, torch.float32) == design
    A = torch.eye(n).repeat(2, 1, 1)
    d0 = torch.ones((2, n))
    if bad == "odd":
        A, d0 = torch.eye(n - 1).repeat(2, 1, 1), torch.ones((2, n - 1))
    elif bad == "dtype":
        A = A.to(torch.float16)
    elif bad == "strided":
        A = A.transpose(0, 1)
    elif bad == "rank":
        A = A[0]
    else:
        d0 = torch.ones((2, n), dtype=torch.float64)
    err = TypeError if bad == "dtype" else ValueError
    with pytest.raises(err):
        jacobi_eigh_weighted_diag_cuda(A, d0)
    if bad != "d0":
        with pytest.raises(err):
            jacobi_eigh_cuda(A)
