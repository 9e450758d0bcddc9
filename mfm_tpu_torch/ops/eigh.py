"""Batched symmetric eigendecomposition for small matrices (parallel Jacobi).

Counterpart of ``mfm_tpu/ops/eigh.py``.  The eigenfactor stage decomposes
~T*(M+1) tiny (K x K, K ~ 42) symmetric matrices; this module holds the
**Brent-Luk parallel-ordered cyclic Jacobi** that does it, in plain
PyTorch, and the dispatchers that send each batch to the right solver:

- a CUDA tensor with n <= 128 goes to the hand-written Hopper kernels of
  :mod:`mfm_tpu_torch.ops.eigh_cuda` (odd n padded to even first), which
  raise on what they cannot take — there is no fallback on the card;
- a CPU tensor (or ``kernels=False``, the explicit switch that puts the
  plain versions on the card for comparison) goes to the plain versions
  below, which run the kernels' exact schedule;
- n > 128, off the risk model's path, goes to ``torch.linalg.eigh``, the
  counterpart of the XLA eigh the reference falls back to there.

The schedule: with the circle method, round r pairs (L_r[i], L_r[n-1-i])
where L_{r+1} = g(L_r) for a fixed rotation g.  Writing f for the
interleaving [L[0], L[n-1], L[1], L[n-2], ...] that makes pairs adjacent,
the basis change between consecutive rounds is pi = f^-1 . g . f — the same
permutation every round, and of order n-1, so whole sweeps return the basis
to its start.  The plain versions keep the matrix in that permuted basis
(pair extraction is a strided view), and so does the float32 warp design of
the CUDA kernels (a lane a pair of rows, pi a shift between lanes); the
block design keeps it in original index order and rotates the pairs
:func:`_round_bases` names.  All emit in the matrix's ORIGINAL index order
("slot order").
"""

from __future__ import annotations

import torch

from mfm_tpu_torch.utils.prec import highest_matmul_precision

#: largest n the Jacobi solvers take; bigger batches go to torch.linalg.eigh
JACOBI_MAX_N = 128


def _brent_luk_perms(n: int):
    """(initial basis b0, per-round fixed permutation pi), both length-n
    python int lists."""
    assert n % 2 == 0
    # f: interleave so that circle-method pairs (i, n-1-i) become adjacent
    f = [0] * n
    f[0::2] = range(n // 2)
    f[1::2] = range(n - 1, n // 2 - 1, -1)
    # g: circle-method rotation L' = [L[0], L[-1], L[1], ..., L[-2]]
    g = [0, n - 1] + list(range(1, n - 1))
    f_inv = sorted(range(n), key=f.__getitem__)  # inverse permutation of f
    pi = [f_inv[g[fi]] for fi in f]  # position map of (f^-1 . g . f)
    return f, pi


def _check_perm_schedule(n):
    b0, pi = _brent_luk_perms(n)
    basis = list(b0)
    seen = set()
    for _ in range(n - 1):
        for i in range(n // 2):
            a, b = basis[2 * i], basis[2 * i + 1]
            seen.add((min(a, b), max(a, b)))
        basis = [basis[p] for p in pi]
    assert len(seen) == n * (n - 1) // 2, len(seen)
    # pi has order n-1: whole sweeps return the basis to b0, which the
    # slot-order emission (through inv = argsort(b0)) relies on
    assert basis == b0


def _round_bases(n: int) -> list[list[int]]:
    """The basis of each of the n-1 distinct rounds, in original indices:
    round r rotates the pairs (basis[2i], basis[2i+1]), the first index of
    each pair taking the role of the permuted basis's even slot."""
    b0, pi = _brent_luk_perms(n)
    bases, basis = [], list(b0)
    for _ in range(n - 1):
        bases.append(basis)
        basis = [basis[p] for p in pi]
    return bases


def _sweeps_for(n: int, dtype) -> int:
    base = 7 if dtype == torch.float32 else 10
    return base + max(0, (n - 16) // 32)


def _skip_threshold(dtype) -> float:
    """|a_pq| at or below this skips the pair's rotation (100 * tiny of the
    dtype, the kernels' threshold too)."""
    return float(torch.finfo(dtype).tiny * 100)


def _slots(A: torch.Tensor, sweeps: int | None):
    """Plain Brent-Luk Jacobi over even-n symmetric ``A`` (..., n, n):
    (w (..., n), V (..., n, n)) in original slot order — slot i of w and
    column i of V belong to the eigenvalue that tracks diagonal direction i.
    Fixed ``sweeps * (n-1)`` rounds, no convergence exit."""
    n = A.shape[-1]
    if n % 2:
        raise ValueError(f"Brent-Luk pairing needs even n, got n={n}")
    dtype, dev = A.dtype, A.device
    if sweeps is None:
        sweeps = _sweeps_for(n, dtype)
    b0_list, pi_list = _brent_luk_perms(n)
    b0 = torch.tensor(b0_list, device=dev)
    pi = torch.tensor(pi_list, device=dev)
    inv = torch.tensor(sorted(range(n), key=b0_list.__getitem__), device=dev)
    tiny = _skip_threshold(dtype)
    batch = A.shape[:-2]
    h = n // 2

    # move into the interleaved basis; V tracks basis columns (eigenvectors)
    X = A[..., b0, :][..., :, b0]
    V = torch.eye(n, dtype=dtype, device=dev)[:, b0].expand(A.shape)

    def rot(top, bot, c, s):
        return c * top - s * bot, s * top + c * bot

    for _ in range(sweeps * (n - 1)):
        diag = X.diagonal(dim1=-2, dim2=-1)
        app, aqq = diag[..., 0::2], diag[..., 1::2]
        apq = X[..., 0::2, 1::2].diagonal(dim1=-2, dim2=-1)
        small = apq.abs() <= tiny
        tau = (aqq - app) / torch.where(small, 1.0, 2.0 * apq)
        t = torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
        t = torch.where(tau == 0, 1.0, t)  # 45-degree rotation at a_pp == a_qq
        t = torch.where(small, 0.0, t)
        c = 1.0 / torch.sqrt(1.0 + t * t)
        s = t * c

        # rows: X <- J' X
        Xr = X.reshape(batch + (h, 2, n))
        X = torch.stack(rot(Xr[..., 0, :], Xr[..., 1, :], c[..., None],
                            s[..., None]), dim=-2).reshape(batch + (n, n))
        # cols: X <- X J, and the eigenvector columns V <- V J
        cM, sM = c[..., None, :], s[..., None, :]
        Xc = X.reshape(batch + (n, h, 2))
        X = torch.stack(rot(Xc[..., 0], Xc[..., 1], cM, sM),
                        dim=-1).reshape(batch + (n, n))
        Vc = V.reshape(batch + (n, h, 2))
        V = torch.stack(rot(Vc[..., 0], Vc[..., 1], cM, sM),
                        dim=-1).reshape(batch + (n, n))

        # fixed basis permutation to the next round's pairing
        X = X[..., pi, :][..., :, pi]
        V = V[..., :, pi]

    # sweeps*(n-1) rounds bring the basis back to b0: slot j holds original
    # index b0[j], so emitting through inv restores original order
    return X.diagonal(dim1=-2, dim2=-1)[..., inv], V[..., :, inv]


def _weighted_diag(V, d0):
    """h_i = sum_k V_ki^2 d0_k for V (..., n, n) and d0 (..., n)."""
    return (V * V * d0[..., :, None]).sum(dim=-2)


@highest_matmul_precision
def jacobi_eigh_slots(A: torch.Tensor, sweeps: int | None = None):
    """Plain version of the ``jacobi_eigh`` CUDA kernel (and of the Pallas
    ``jacobi_eigh_tpu(sort=False, canonical_signs=False)``): eigenvalues
    and eigenvectors of even-n symmetric ``A`` (..., n, n) in original slot
    order."""
    return _slots(A, sweeps)


@highest_matmul_precision
def jacobi_eigh_weighted_diag_slots(A: torch.Tensor, d0: torch.Tensor,
                                    sweeps: int | None = None):
    """Plain version of the ``jacobi_eigh_weighted`` CUDA kernel (and of the
    Pallas ``jacobi_eigh_weighted_diag_tpu``): (w, h) with
    ``h_i = sum_k V_ki^2 d0_k``, in original slot order."""
    w, V = _slots(A, sweeps)
    return w, _weighted_diag(V, d0)


def canonicalize_signs(w, V):
    """Flip eigenvector signs so the largest-|.| component is positive."""
    idx = V.abs().argmax(dim=-2, keepdim=True)
    lead = torch.gather(V, -2, idx)
    return w, V * torch.where(lead < 0, -1.0, 1.0)


def sort_and_sign(w, V, sort: bool, canonical_signs: bool):
    """Optionally order slot-order pairs by ascending eigenvalue (stable,
    like ``jnp.argsort``) and canonicalize eigenvector signs."""
    if sort:
        w, order = torch.sort(w, dim=-1, stable=True)
        V = torch.gather(V, -1, order[..., None, :].expand(V.shape))
    if canonical_signs:
        w, V = canonicalize_signs(w, V)
    return w, V


def _pad_odd(A, d0=None):
    """Pad odd-n ``A`` with an isolated dummy eigenvalue strictly below the
    spectrum (Gershgorin bound) at index n: rotations against it are exact
    no-ops since its off-diagonal entries stay zero, so it sits alone in the
    LAST slot.  ``d0`` gets a zero weight there."""
    n0 = A.shape[-1]
    d = A.diagonal(dim1=-2, dim2=-1)
    lb = (d - (A.abs().sum(dim=-1) - d.abs())).amin(dim=-1) - 1.0
    pad = A.new_zeros(A.shape[:-2] + (n0 + 1, n0 + 1))
    pad[..., :n0, :n0] = A
    pad[..., n0, n0] = lb
    if d0 is not None:
        d0 = torch.cat([d0, d0.new_zeros(d0.shape[:-1] + (1,))], dim=-1)
    return pad, d0


def _use_kernel(A, kernels: bool) -> bool:
    return kernels and A.is_cuda


@highest_matmul_precision
def jacobi_eigh(A: torch.Tensor, sweeps: int | None = None,
                canonical_signs: bool = True):
    """Batched eigh of symmetric ``A`` (..., n, n) -> (w (..., n), V (..., n, n))
    in plain PyTorch, any n (odd n padded with a dummy).

    Eigenvalues ascending; ``V[..., :, i]`` is the i-th eigenvector.
    """
    n0 = A.shape[-1]
    if n0 % 2:
        A, _ = _pad_odd(A)
    w, V = _slots(A, sweeps)
    w, V = w[..., :n0], V[..., :n0, :n0]
    return sort_and_sign(w, V, True, canonical_signs)


def _eigh_slots(A, sweeps, kernels):
    """Slot-order (w, V) of ``A`` (..., n, n), n <= JACOBI_MAX_N, through
    the CUDA kernel or the plain version; odd n padded and unpadded."""
    n0 = A.shape[-1]
    if n0 % 2:
        A, _ = _pad_odd(A)
    n = A.shape[-1]
    if _use_kernel(A, kernels):
        from mfm_tpu_torch.ops.eigh_cuda import jacobi_eigh_cuda

        flat = A.reshape(-1, n, n).contiguous()
        w, V = jacobi_eigh_cuda(flat, sweeps=sweeps, canonical_signs=False,
                                sort=False)
        w, V = w.reshape(A.shape[:-1]), V.reshape(A.shape)
    else:
        w, V = _slots(A, sweeps)
    return w[..., :n0], V[..., :n0, :n0]


@highest_matmul_precision
def batched_eigh(A: torch.Tensor, *, canonical_signs: bool = True,
                 sort: bool = True, sweeps: int | None = None,
                 kernels: bool = True):
    """Device-aware batched eigh for (..., n, n) symmetric matrices.

    Eigenvalues ascending and signs canonicalized by default, on every
    route.  ``sort=False`` returns slot order on the Jacobi routes (the
    eigenvalue tracking diagonal direction i at slot i).  ``sweeps`` caps
    the Jacobi sweep count; ``torch.linalg.eigh`` (n > 128) ignores it.
    ``kernels=False`` runs the plain versions even on a CUDA tensor.
    """
    if A.shape[-1] > JACOBI_MAX_N:
        w, V = torch.linalg.eigh(A)
        return sort_and_sign(w, V, False, canonical_signs)
    w, V = _eigh_slots(A, sweeps, kernels)
    return sort_and_sign(w, V, sort, canonical_signs)


@highest_matmul_precision
def batched_eigh_weighted_diag(A: torch.Tensor, d0: torch.Tensor, *,
                               sweeps: int | None = None,
                               kernels: bool = True):
    """Eigenvalues plus D0-weighted squared-eigenvector diagonal, batched.

    Returns ``(w, h)`` with ``h_i = sum_k V_ki^2 d0_k`` for symmetric ``A``
    (..., n, n) and weights ``d0`` broadcastable to (..., n) — the
    eigenfactor Monte-Carlo's consumer shape.  On the card the reduction is
    fused into the kernel, so the eigenvector batch never reaches device
    memory.  Slot order on the Jacobi routes, ascending on
    ``torch.linalg.eigh``; (w_i, h_i) pairing is consistent either way and
    callers rank-pair by sorting the two outputs.
    """
    n0 = A.shape[-1]
    d0b = d0.expand(A.shape[:-1])
    if n0 > JACOBI_MAX_N:
        w, V = torch.linalg.eigh(A)
        return w, _weighted_diag(V, d0b)
    if n0 % 2:
        A, d0b = _pad_odd(A, d0b)
    n = A.shape[-1]
    if _use_kernel(A, kernels):
        from mfm_tpu_torch.ops.eigh_cuda import jacobi_eigh_weighted_diag_cuda

        w, h = jacobi_eigh_weighted_diag_cuda(
            A.reshape(-1, n, n).contiguous(),
            d0b.reshape(-1, n).contiguous(), sweeps=sweeps)
        w, h = w.reshape(A.shape[:-1]), h.reshape(A.shape[:-1])
    else:
        w, V = _slots(A, sweeps)
        h = _weighted_diag(V, d0b)
    return w[..., :n0], h[..., :n0]


@highest_matmul_precision
def pinv_psd(G: torch.Tensor, *, rcond: float | None = None,
             kernels: bool = True) -> torch.Tensor:
    """Moore-Penrose pseudo-inverse of symmetric PSD-up-to-roundoff batches.

    The eigendecomposition form ``V diag(1/w where |w| > cut) V'`` with
    ``cut = rcond * max|w|``, equal to SVD-based ``pinv`` for symmetric
    input; ``rcond`` defaults to ``10 * n * eps``.  Odd n is padded to even
    with an isolated diagonal entry c = trace/n:
    ``pinv(blockdiag(G, c)) = blockdiag(pinv(G), 1/c)`` exactly, and for
    PSD G, ``trace/n`` lies in ``[lambda_max/n, lambda_max]`` so it neither
    raises the cutoff nor gets discarded by it.
    """
    n = G.shape[-1]
    if rcond is None:
        rcond = 10.0 * n * float(torch.finfo(G.dtype).eps)
    pad = n % 2 == 1
    if pad:
        tr = G.diagonal(dim1=-2, dim2=-1).sum(-1) / n
        Gp = G.new_zeros(G.shape[:-2] + (n + 1, n + 1))
        Gp[..., :n, :n] = G
        Gp[..., n, n] = tr
        G = Gp
    w, V = batched_eigh(G, canonical_signs=False, kernels=kernels)
    cut = rcond * w.abs().amax(dim=-1, keepdim=True)
    one, zero = w.new_ones(()), w.new_zeros(())
    inv_w = torch.where(w.abs() > cut, 1.0 / torch.where(w == 0, one, w), zero)
    out = (V * inv_w[..., None, :]) @ V.transpose(-1, -2)
    if pad:
        out = out[..., :n, :n]
    return out


# -- the differentiable eigh (the grad subsystem's) ---------------------------

def _bt(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A @ B^T`` per lane for (S, m, k) and (S, n, k): elementwise
    products and contiguous innermost sums over k, in lane chunks of one
    fixed count under ``serve/query.py``'s ``CHUNK_BYTES``.  A lane's bits
    do not depend on how many lanes share the call (a batched matrix
    product's do, on the card and on the CPU)."""
    # serve/query imports this package's modules, so its helper is taken
    # here, at the call
    from mfm_tpu_torch.serve.query import chunk_rows

    S, m, k = A.shape
    n = B.shape[1]
    step = chunk_rows(m * n * k * A.element_size())
    return torch.cat([(A[s:s + step, :, None, :] * B[s:s + step, None, :, :]
                       ).sum(-1) for s in range(0, max(S, 1), step)])


def _t(A: torch.Tensor) -> torch.Tensor:
    return A.transpose(-1, -2).contiguous()


class _DiffEigh(torch.autograd.Function):
    """:func:`batched_eigh` (ascending, slot signs) with the reverse-mode
    rule of ``jnp.linalg.eigh``: the transpose of JAX's eigh JVP,

        Fmat = 1 / (I + w_j - w_i) - I
        A_bar = V (diag(w_bar) + Fmat o (V' V_bar)) V'

    symmetrized, since ``jnp.linalg.eigh`` symmetrizes its input.  Every
    product is :func:`_bt`'s, so a lane's gradient keeps its bits at any
    batch size.  Repeated eigenvalues give inf in ``Fmat`` and non-finite
    gradients, as in the reference, but where ``flat_below`` (see
    :func:`eigh_diff`) zeroes ``Fmat`` on exactly tied pairs below it."""

    @staticmethod
    def forward(ctx, A, kernels, flat_below):
        w, V = batched_eigh(A, canonical_signs=False, kernels=kernels)
        ctx.flat_below = flat_below
        ctx.save_for_backward(w, V)
        # an output no loss reaches keeps a None cotangent, as JAX's
        # symbolic zero: a loss of w alone never meets Fmat
        ctx.set_materialize_grads(False)
        return w, V

    @staticmethod
    def backward(ctx, w_bar, V_bar):
        w, V = ctx.saved_tensors
        n = w.shape[-1]
        eye = torch.eye(n, dtype=w.dtype, device=w.device)
        Fmat = 1.0 / (eye + w[..., None, :] - w[..., :, None]) - eye
        if ctx.flat_below is not None:
            flat = w < ctx.flat_below[..., None]
            tie = ((w[..., None, :] == w[..., :, None]) & (eye == 0)
                   & flat[..., None, :] & flat[..., :, None])
            Fmat = torch.where(tie, torch.zeros((), dtype=w.dtype,
                                                device=w.device), Fmat)
        C = torch.zeros_like(V)
        if V_bar is None and w_bar is None:
            return None, None, None
        if V_bar is not None:
            C = Fmat * _bt(_t(V), _t(V_bar))
        if w_bar is not None:
            C = C + torch.diag_embed(w_bar)
        A_bar = _bt(_bt(V, _t(C)), V)
        return 0.5 * (A_bar + A_bar.transpose(-1, -2)), None, None


def eigh_diff(A: torch.Tensor, *, kernels: bool = True,
              flat_below: torch.Tensor | None = None):
    """Differentiable batched eigh of symmetric (S, n, n) ``A``: forward
    :func:`batched_eigh` (the full Jacobi kernel on a CUDA tensor, its
    plain version on the CPU; eigenvalues ascending, signs as the solver
    leaves them), backward the rule of ``jnp.linalg.eigh``
    (:class:`_DiffEigh`).  ``kernels=False`` runs the plain Jacobi even
    on a CUDA tensor (``chip_smoke.py`` holds the kernel route to it).

    ``flat_below`` ((S,), optional) is for a caller whose loss depends on
    (w, V) only through a spectral function ``V diag(f(w)) V'`` with f
    constant below ``flat_below`` (the PSD projection's clamp floor).  For
    a pair of eigenvalues tied below it the gradient's limit is the
    divided difference ``(f(w_i) - f(w_j)) / (w_i - w_j)`` -> 0, and
    ``Fmat`` is zeroed there instead of dividing by the zero gap.  The
    Jacobi solver, unlike LAPACK, leaves such ties exact (two zero rows
    of a matrix give two eigenvalues of exactly 0), where ``1 / 0`` would
    poison the whole gradient; LAPACK splits them by rounding (gaps
    ~1e-19) and the reference's gradient reaches the same limit.  Ties
    elsewhere keep the reference's rule."""
    return _DiffEigh.apply(A, kernels, flat_below)
