"""Plain PyTorch linear algebra for the references: a batched cyclic
Jacobi eigensolver, run to convergence, and the matrix product of the
precision a reference runs at.

``torch.linalg.eigh`` on the card solves a batch of 42 x 42 matrices one
matrix at a time (~0.6 ms each), and the rebuild's reference needs up to
250,000 of them.  :func:`eigh` instead rotates every matrix of a batch at
once, one round of n/2 disjoint pairs at a time (a round-robin schedule),
with elementwise operations and gathers only, until the off-diagonal mass
is at the rounding of the dtype.  It shares nothing with the program's
kernels but the textbook: the rotation of Golub and Van Loan's
``sym.schur2``, a convergence test instead of a fixed sweep count.
"""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def _rounds(n: int) -> tuple:
    """The round-robin schedule of an even n: n - 1 rounds of n/2 disjoint
    pairs (p < q), each pair once per sweep."""
    players = list(range(n))
    rounds = []
    for _ in range(n - 1):
        pairs = [(players[i], players[n - 1 - i]) for i in range(n // 2)]
        rounds.append(tuple((min(a, b), max(a, b)) for a, b in pairs))
        players = [players[0], players[-1]] + players[1:-1]
    return tuple(rounds)


def eigh(A: torch.Tensor, max_sweeps: int = 30):
    """Eigenvalues (ascending) and eigenvectors (columns) of a batch of
    symmetric matrices (B, n, n), by cyclic Jacobi to convergence: sweeps
    until every matrix's off-diagonal norm is at most n eps of its norm.
    It reads the symmetric part (A + A') / 2, as a solver that reads one
    triangle reads a symmetric matrix.  Odd n is padded with an isolated
    zero row and column."""
    B, n, _ = A.shape
    dtype, dev = A.dtype, A.device
    if B == 0:
        return A.new_zeros((0, n)), A.new_zeros((0, n, n))
    odd = n % 2 == 1
    if odd:
        A = torch.nn.functional.pad(A, (0, 1, 0, 1))
    m = A.shape[-1]
    A = 0.5 * (A + A.transpose(-1, -2))
    V = torch.eye(m, dtype=dtype, device=dev).expand(B, m, m).clone()
    sched = [(torch.tensor([p for p, _ in r], device=dev),
              torch.tensor([q for _, q in r], device=dev))
             for r in _rounds(m)]
    tol = m * float(torch.finfo(dtype).eps)
    one = torch.ones((), dtype=dtype, device=dev)
    for _ in range(max_sweeps):
        off = A * (1.0 - torch.eye(m, dtype=dtype, device=dev))
        if bool(((off * off).sum(dim=(-2, -1))
                 <= (tol * tol) * (A * A).sum(dim=(-2, -1))).all()):
            break
        for P, Q in sched:
            app = A[:, P, P]
            aqq = A[:, Q, Q]
            apq = A[:, P, Q]
            zero = apq == 0
            tau = (aqq - app) / (2.0 * torch.where(zero, one, apq))
            sgn = torch.where(tau >= 0, one, -one)
            t = sgn / (tau.abs() + torch.sqrt(1.0 + tau * tau))
            t = torch.where(zero, torch.zeros_like(t), t)
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = t * c
            # rows p, q of J' A
            rp, rq = A[:, P, :], A[:, Q, :]
            A[:, P, :] = c[..., None] * rp - s[..., None] * rq
            A[:, Q, :] = s[..., None] * rp + c[..., None] * rq
            # columns p, q of (J' A) J, and of V J
            for X in (A, V):
                cp, cq = X[:, :, P], X[:, :, Q]
                X[:, :, P] = c[:, None, :] * cp - s[:, None, :] * cq
                X[:, :, Q] = s[:, None, :] * cp + c[:, None, :] * cq
    else:
        raise RuntimeError(f"Jacobi did not converge in {max_sweeps} sweeps")
    w = torch.diagonal(A, dim1=-2, dim2=-1)
    if odd:
        w, V = w[:, :n], V[:, :n, :n]
    w, order = torch.sort(w, dim=-1)
    V = torch.gather(V, -1, order[:, None, :].expand(V.shape))
    return w, V


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 explicit mantissa bits, nearest,
    ties away from zero): what a TF32 tensor core reads of an operand."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class Precision:
    """The arithmetic a reference runs at: ``float64`` (the reference),
    ``tf32`` (float32 storage, every matrix product's operands rounded to
    TF32 and accumulated in float32: the control of a float32
    configuration whose matrix products keep TF32 off), ``bfloat16``
    (the control of a float32 path that has no matrix product) or
    ``float32`` (the configuration's own precision: a witness of what
    float32 rounding alone gives, never a control)."""

    DTYPES = {"float64": torch.float64, "tf32": torch.float32,
              "bfloat16": torch.bfloat16, "float32": torch.float32}

    def __init__(self, name: str):
        if name not in self.DTYPES:
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.dtype = self.DTYPES[name]

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "tf32":
            a, b = round_tf32(a), round_tf32(b)
        return a @ b
