"""The port's differentiable eigh (``mfm_tpu_torch/ops/eigh.py::eigh_diff``)
against ``jax.vjp`` of ``jnp.linalg.eigh``, on the CPU at float64.

The forward is the plain Jacobi (the full kernel's plain version) and the
reference's is LAPACK: eigenvalues agree to ~1e-15 relative, eigenvectors
up to each column's sign.  The backward is the transpose of JAX's eigh
JVP, so with the eigenvector cotangent expressed in each package's own
signs (``V_bar`` times the column signs that map one basis onto the
other) the input cotangents agree within rtol 1e-9: the 1/gap factor
amplifies the ~1e-13 eigenvector agreement of the two solvers, and the
matrices here keep their gaps above 0.05 of the spread.  A repeated
eigenvalue gives the reference's non-finite pattern; ``gradcheck`` holds
the backward against finite differences; a lane's gradient is bitwise
the same alone and beside others.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfm_tpu_torch.ops.eigh import batched_eigh, eigh_diff

torch.set_num_threads(2)

RTOL = 1e-9


def _sym(rng, S, n):
    a = rng.standard_normal((S, n, n))
    return a + np.swapaxes(a, 1, 2)


def _ref_vjp(A, w_bar, V_bar):
    (w, V), pull = jax.vjp(lambda a: tuple(jnp.linalg.eigh(a)),
                           jnp.asarray(A))
    A_bar, = pull((jnp.asarray(w_bar), jnp.asarray(V_bar)))
    return np.asarray(w), np.asarray(V), np.asarray(A_bar)


def _port_vjp(A, w_bar, V_bar, ref_V):
    """The port's input cotangent for the reference's cotangents, V_bar
    carried into the port's own column signs."""
    At = torch.tensor(A, requires_grad=True)
    w, V = eigh_diff(At)
    signs = np.sign(np.einsum("sij,sij->sj", V.detach().numpy(), ref_V))
    A_bar, = torch.autograd.grad(
        (w, V), At,
        (torch.tensor(w_bar), torch.tensor(V_bar * signs[:, None])))
    return w.detach().numpy(), A_bar.numpy()


def _close(got, want, rtol=RTOL):
    scale = np.abs(want).max()
    return np.abs(got - want).max() <= rtol * scale


@pytest.mark.parametrize("n,seed", [(2, 0), (6, 1), (8, 2), (42, 3), (7, 4)])
def test_vjp_is_the_reference(n, seed):
    rng = np.random.default_rng(seed)
    A = _sym(rng, 3, n)
    w_bar = rng.standard_normal((3, n))
    V_bar = rng.standard_normal((3, n, n))
    w_r, V_r, Abar_r = _ref_vjp(A, w_bar, V_bar)
    w_p, Abar_p = _port_vjp(A, w_bar, V_bar, V_r)
    assert _close(w_p, w_r, 1e-12)
    assert _close(Abar_p, Abar_r)
    # symmetrized, as jnp.linalg.eigh's input is
    assert np.array_equal(Abar_p, np.swapaxes(Abar_p, 1, 2))


@pytest.mark.parametrize("which", ["w", "V"])
def test_single_cotangent_is_the_reference(which):
    """Only one output reaches the loss: the other's cotangent is None in
    torch and zeros in JAX."""
    rng = np.random.default_rng(5)
    n = 6
    A = _sym(rng, 2, n)
    w_bar = rng.standard_normal((2, n)) if which == "w" else np.zeros((2, n))
    V_bar = (rng.standard_normal((2, n, n)) if which == "V"
             else np.zeros((2, n, n)))
    _, V_r, Abar_r = _ref_vjp(A, w_bar, V_bar)
    At = torch.tensor(A, requires_grad=True)
    w, V = eigh_diff(At)
    if which == "w":
        A_bar, = torch.autograd.grad(w, At, torch.tensor(w_bar))
    else:
        signs = np.sign(np.einsum("sij,sij->sj", V.detach().numpy(), V_r))
        A_bar, = torch.autograd.grad(V, At,
                                     torch.tensor(V_bar * signs[:, None]))
    assert _close(A_bar.numpy(), Abar_r)


def test_generic_branch_diag_1_to_k_is_the_reference():
    """psd_project's unselected branch differentiates diag(1..K): distinct
    eigenvalues, exact eigenvectors, a finite gradient."""
    K = 6
    A = np.diag(np.arange(1.0, K + 1))[None]
    rng = np.random.default_rng(6)
    w_bar = rng.standard_normal((1, K))
    V_bar = rng.standard_normal((1, K, K))
    w_r, V_r, Abar_r = _ref_vjp(A, w_bar, V_bar)
    w_p, Abar_p = _port_vjp(A, w_bar, V_bar, V_r)
    assert np.array_equal(w_p, w_r)
    assert np.isfinite(Abar_p).all()
    assert _close(Abar_p, Abar_r, 1e-12)


def test_repeated_eigenvalue_gives_the_reference_nonfinite_pattern():
    """A repeated eigenvalue puts inf into Fmat: the eigenvector part of
    the gradient is not finite, in the same places as the reference's."""
    rng = np.random.default_rng(7)
    # exactly repeated in both solvers: a block-diagonal matrix, diag(1, 1)
    # beside a rotated diag(2, 3, 5)
    Q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    A = np.zeros((5, 5))
    A[:2, :2] = np.eye(2)
    A[2:, 2:] = (Q * np.array([2.0, 3.0, 5.0])) @ Q.T
    A = 0.5 * (A + A.T)[None]
    w_bar = rng.standard_normal((1, 5))
    V_bar = rng.standard_normal((1, 5, 5))
    w_r, V_r, Abar_r = _ref_vjp(A, w_bar, V_bar)
    assert w_r[0, 0] == w_r[0, 1]
    At = torch.tensor(A, requires_grad=True)
    w, V = eigh_diff(At)
    assert w[0, 0] == w[0, 1]
    A_bar, = torch.autograd.grad((w, V), At,
                                 (torch.tensor(w_bar), torch.tensor(V_bar)))
    assert not np.isfinite(Abar_r).all()
    assert np.array_equal(np.isfinite(A_bar.numpy()), np.isfinite(Abar_r))
    # an explicit zero eigenvector cotangent still meets Fmat's inf (0 * inf)
    _, _, Abar_z = _ref_vjp(A, w_bar, np.zeros_like(V_bar))
    w, V = eigh_diff(At)
    A_bar_z, = torch.autograd.grad((w, V), At, (torch.tensor(w_bar),
                                                torch.zeros_like(V)))
    assert np.array_equal(np.isfinite(A_bar_z.numpy()), np.isfinite(Abar_z))
    # a loss of the eigenvalues alone leaves the eigenvector cotangent a
    # symbolic zero in JAX and None here: finite in both
    g_r = np.asarray(jax.grad(lambda a: jnp.sum(
        jnp.asarray(w_bar) * jnp.linalg.eigh(a)[0]))(jnp.asarray(A)))
    g_p, = torch.autograd.grad((torch.tensor(w_bar) * eigh_diff(At)[0]).sum(),
                               At)
    assert np.isfinite(g_r).all() and np.isfinite(g_p.numpy()).all()
    assert _close(g_p.numpy(), g_r, 1e-12)


def test_gradcheck():
    """The backward against torch's finite differences, through a function
    of the decomposition that does not depend on the eigenvectors'
    signs."""
    rng = np.random.default_rng(8)
    A = torch.tensor(_sym(rng, 2, 6), requires_grad=True)
    C = torch.tensor(rng.standard_normal((2, 6, 6)))

    def f(X):
        w, V = eigh_diff(0.5 * (X + X.transpose(-1, -2)))
        top = V[..., :, 3:]
        return w, (C * (top @ top.transpose(-1, -2))).sum((-1, -2))

    assert torch.autograd.gradcheck(f, (A,), eps=1e-6, atol=1e-7)


def test_forward_is_batched_eigh_and_lanes_are_batch_invariant():
    rng = np.random.default_rng(9)
    A = torch.tensor(_sym(rng, 9, 8), requires_grad=True)
    w_bar = torch.tensor(rng.standard_normal((9, 8)))
    V_bar = torch.tensor(rng.standard_normal((9, 8, 8)))
    w, V = eigh_diff(A)
    w0, V0 = batched_eigh(A.detach(), canonical_signs=False)
    assert torch.equal(w, w0) and torch.equal(V, V0)
    g_all, = torch.autograd.grad((w, V), A, (w_bar, V_bar))
    for i in (0, 4, 8):
        Ai = A.detach()[i:i + 1].clone().requires_grad_(True)
        wi, Vi = eigh_diff(Ai)
        gi, = torch.autograd.grad((wi, Vi), Ai,
                                  (w_bar[i:i + 1], V_bar[i:i + 1]))
        assert torch.equal(gi[0], g_all[i]), f"lane {i}"


def test_flat_below_changes_only_ties_where_the_loss_is_flat():
    """``flat_below`` is the default rule wherever no two eigenvalues are
    equal; on an exact tie below it, for a loss ``V diag(f(w)) V'`` with f
    constant there, it gives the finite limit: the reference's gradient of
    the same loss on the matrix with its tie split by 1e-12.  A tie above
    it keeps the reference's non-finite rule."""
    rng = np.random.default_rng(10)

    def loss(X, C, floor, flat_below):
        w, V = eigh_diff(X, flat_below=flat_below)
        fw = torch.maximum(w, torch.tensor(floor, dtype=w.dtype))
        return (C * ((V * fw[..., None, :]) @ V.transpose(-1, -2))).sum()

    A = torch.tensor(_sym(rng, 3, 6), requires_grad=True)
    C = torch.tensor(rng.standard_normal((3, 6, 6)))
    g0, = torch.autograd.grad(loss(A, C, -0.5, None), A)
    g1, = torch.autograd.grad(
        loss(A, C, -0.5, torch.full((3,), -0.5, dtype=torch.float64)), A)
    assert torch.equal(g0, g1)

    Q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    T = np.zeros((5, 5))
    T[:2, :2] = np.eye(2)
    T[2:, 2:] = (Q * np.array([2.0, 3.0, 5.0])) @ Q.T
    T = 0.5 * (T + T.T)[None]
    C = torch.tensor(rng.standard_normal((1, 5, 5)))
    At = torch.tensor(T, requires_grad=True)
    below = torch.tensor([1.5], dtype=torch.float64)
    g_nan, = torch.autograd.grad(loss(At, C, 1.5, None), At)
    g_lim, = torch.autograd.grad(loss(At, C, 1.5, below), At)
    assert not torch.isfinite(g_nan).all() and torch.isfinite(g_lim).all()
    split = T.copy()
    split[0, 1, 1] += 1e-12
    Cj = jnp.asarray(C.numpy())

    def ref_loss(a):
        w, V = jnp.linalg.eigh(a)
        fw = jnp.maximum(w, 1.5)
        return jnp.sum(Cj * ((V * fw[..., None, :])
                             @ jnp.swapaxes(V, -1, -2)))

    g_ref = np.asarray(jax.grad(ref_loss)(jnp.asarray(split)))
    assert _close(g_lim.numpy(), g_ref, 1e-9)
    # the tie at 1.0 is above a floor of 0.5: the rule stays the reference's
    g_above, = torch.autograd.grad(
        loss(At, C, 0.5, torch.tensor([0.5], dtype=torch.float64)), At)
    assert not torch.isfinite(g_above).all()
