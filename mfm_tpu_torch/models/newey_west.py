"""Newey-West factor-return covariance, single-shot and expanding
(counterpart of ``mfm_tpu/models/newey_west.py``).

Contract (``Barra-master/mfm/utils.py:16-50``): for a window of factor
returns x_0..x_{t-1} with exp-decay weights ``w_i ∝ 0.5**((t-1-i)/tau)``
normalized to sum 1, demeaned by the weighted mean:

    Gamma_0  = sum_i w_i d_i d_i'
    Gamma_l  = sum_{i} w_{i+l} d_i d_{i+l}'          (weight of the later obs)
    V        = Gamma_0 + sum_{l=1..q} (1 - l/(1+q)) (Gamma_l + Gamma_l')

and the estimate is *invalid* when t <= q or t <= K.  Every sum is an
exponentially-weighted cumulative sum, so the whole expanding family is one
serial pass of EWMA recursions over the dates — on the card one launch of
a hand-written kernel (``csrc/newey_west_scan.cu``), on the CPU its plain
version, a Python loop of small K x K tensor ops — or, in the
"associative" method, one prefix scan of the same recursions in O(log T)
passes over a packed (T, D) state.
"""

from __future__ import annotations

import torch

from mfm_tpu_torch._device import host_flags
from mfm_tpu_torch.ops.newey_west_cuda import newey_west_scan_cuda
from mfm_tpu_torch.parallel.mesh import replicate_under_mesh
from mfm_tpu_torch.utils.prec import highest_matmul_precision


@highest_matmul_precision
def newey_west(ret: torch.Tensor, q: int = 2,
               half_life: float = 252.0) -> torch.Tensor:
    """Single-window Newey-West covariance of (T, K) factor returns."""
    T, K = ret.shape
    dtype = ret.dtype
    w = 0.5 ** (torch.arange(T - 1, -1, -1, dtype=dtype, device=ret.device)
                / half_life)
    w = w / w.sum()
    mu = w @ ret
    d = ret - mu
    V = torch.einsum("t,ti,tj->ij", w, d, d)
    for lag in range(1, q + 1):
        G = torch.einsum("t,ti,tj->ij", w[lag:], d[: T - lag], d[lag:])
        V = V + (1.0 - lag / (1.0 + q)) * (G + G.T)
    return V


def nw_init_carry(K: int, q: int, dtype, device=None) -> tuple:
    """The recursion state of :func:`newey_west_expanding_resume` before any
    date: ``(t, S, A, Z, Ps, hs, gs, Slags, xlags)`` at t = 0.  Every sum it
    holds is exact, so resuming from it reproduces the uninterrupted pass
    bitwise."""
    def zK():
        return torch.zeros((K,), dtype=dtype, device=device)

    def zKK():
        return torch.zeros((K, K), dtype=dtype, device=device)

    def z():
        return torch.zeros((), dtype=dtype, device=device)

    return (
        torch.zeros((), dtype=torch.int32, device=device),
        zK(), zKK(), z(),
        tuple(zKK() for _ in range(q)),
        tuple(zK() for _ in range(q)),
        tuple(z() for _ in range(q)),
        tuple(zK() for _ in range(q)),
        tuple(zK() for _ in range(q)),
    )


@highest_matmul_precision
def newey_west_expanding(ret: torch.Tensor, q: int = 2,
                         half_life: float = 252.0,
                         min_valid: int | None = None, method: str = "scan"):
    """All expanding-window Newey-West covariances in one pass.

    Returns ``(covs, valid)`` where ``covs[t]`` equals
    ``newey_west(ret[:t+1], q, half_life)`` and ``valid[t]`` is False when
    t+1 <= q or t+1 <= min_valid (default K).  See the reference for the
    EWMA derivation.  ``method``: "scan" runs the serial recursion (the
    default, resumable through :func:`newey_west_expanding_resume`);
    "associative" the same recursions as a prefix scan,
    :func:`newey_west_expanding_associative`.
    """
    if method == "associative":
        return newey_west_expanding_associative(ret, q, half_life, min_valid)
    if method != "scan":
        raise ValueError(f"method must be 'scan' or 'associative', got {method!r}")
    covs, valid, _ = newey_west_expanding_resume(ret, q, half_life, min_valid)
    return covs, valid


@highest_matmul_precision
def newey_west_expanding_resume(
    ret: torch.Tensor, q: int = 2, half_life: float = 252.0,
    min_valid: int | None = None, carry: tuple | None = None,
    skip_mask=None,
):
    """The "scan" method of :func:`newey_west_expanding`, checkpointable.

    Returns ``(covs, valid, carry_out)``.  ``carry`` resumes the recursion
    from a previous call's ``carry_out`` (default: the t = 0 state,
    :func:`nw_init_carry`); dates ``[0:T0]`` then ``[T0:T]`` from the
    returned carry give bitwise the covariances of one uninterrupted pass.
    ``q``, ``half_life`` and ``min_valid`` must match across resumed calls.

    ``skip_mask`` ((T,) bool tensor or sequence, the quarantine verdicts of
    serve/guard.py) excises dates: at a masked date the whole carry passes
    through unchanged — no decay, no ``t`` increment — so the carry after
    (good, BAD, good) equals the carry after (good, good) bitwise.  The
    mask is read to the host once (``t`` is a host integer here), and a
    masked date's candidate carry is dropped, never blended in, so a NaN
    in the date cannot reach the sums.  The masked date's stacked output V
    is the discarded candidate and its ``valid`` is False.

    A CUDA tensor runs the recursion in one launch of the Hopper kernel
    (:func:`mfm_tpu_torch.ops.newey_west_cuda.newey_west_scan_cuda`),
    bitwise the plain loop :func:`_scan_loop`, which a CPU tensor runs.
    Under a mesh the tiny (T, K) series runs replicated: a date-sharded
    input is gathered first.
    """
    ret = replicate_under_mesh(ret)
    T, K = ret.shape
    dtype, dev = ret.dtype, ret.device
    lam = torch.tensor(0.5, dtype=dtype, device=dev) ** (1.0 / half_life)
    kmin = K if min_valid is None else min_valid
    state = nw_init_carry(K, q, dtype, dev) if carry is None else carry
    skip = host_flags(skip_mask, T)
    t = int(state[0])
    scan = newey_west_scan_cuda if dev.type == "cuda" else _scan_loop
    covs, sums = scan(ret, lam, q, t, state[1:], skip)
    valid = []
    for skipped in skip:
        if not skipped:
            t += 1
        valid.append(not skipped and t > q and t > kmin)
    carry_out = (torch.tensor(t, dtype=torch.int32, device=dev), *sums)
    return covs, torch.tensor(valid, dtype=torch.bool, device=dev), carry_out


def _scan_loop(ret: torch.Tensor, lam: torch.Tensor, q: int, t: int,
               sums: tuple, skip: list[bool]):
    """The recursion of :func:`newey_west_expanding_resume` as a Python
    loop of small tensor ops, a date at a time from the carry's sums
    ``(S, A, Z, Ps, hs, gs, Slags, xlags)`` at window length ``t``: the
    plain version of the CUDA kernel.  Returns ``(covs, sums_out)``."""
    T, K = ret.shape
    S, A, Z, Ps, hs, gs, Slags, xlags = sums
    covs = torch.empty((T, K, K), dtype=ret.dtype, device=ret.device)

    for i in range(T):
        xt = ret[i]
        t1 = t + 1  # window length after including xt
        Snew = lam * S + xt
        Anew = lam * A + torch.outer(xt, xt)
        Znew = lam * Z + 1.0
        Ps_new, hs_new, gs_new = [], [], []
        for li, lag in enumerate(range(1, q + 1)):
            head = 1.0 if t1 <= lag else 0.0
            Ps_new.append(lam * Ps[li] + torch.outer(xlags[lag - 1], xt))
            hs_new.append(lam * hs[li] + head * xt)
            gs_new.append(lam * gs[li] + head)

        mu = Snew / Znew
        mumu = torch.outer(mu, mu)
        V = Anew / Znew - mumu
        for li, lag in enumerate(range(1, q + 1)):
            a_l = Snew - hs_new[li]
            b_l = Slags[lag - 1]
            z_l = Znew - gs_new[li]
            G = (Ps_new[li] - torch.outer(b_l, mu) - torch.outer(mu, a_l)
                 + z_l * mumu) / Znew
            V = V + (1.0 - lag / (1.0 + q)) * (G + G.T)
        covs[i] = V
        if skip[i]:
            continue
        t = t1
        S, A, Z = Snew, Anew, Znew
        Ps, hs, gs = tuple(Ps_new), tuple(hs_new), tuple(gs_new)
        if q > 0:
            Slags = (Snew,) + Slags[:-1]
            xlags = (xt,) + xlags[:-1]

    return covs, (S, A, Z, Ps, hs, gs, Slags, xlags)


def linear_prefix_scan(a: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Every prefix of the recurrence ``s_t = a_t * s_{t-1} + u_t`` from
    ``s_{-1} = 0``, along dim 0: a (T, 1) coefficient column ``a`` and a
    (T, D) inject ``u`` give the (T, D) states.

    Doubling (Hillis-Steele) scan of the combine ``(a1, b1) . (a2, b2) =
    (a1*a2, a2*b1 + b2)``: after the pass at offset d each row holds the
    composition of the last 2d elements, so ceil(log2 T) passes of whole-
    tensor ops finish it.  Each pass writes new tensors (two copies of the
    state at a time).  No power of ``a`` is ever inverted, so a short half
    life underflows to 0 and never overflows, as ``a^t * cumsum(a^-i u_i)``
    would.
    """
    T = u.shape[0]
    d = 1
    while d < T:
        b = torch.cat([u[:d], torch.addcmul(u[d:], a[d:], u[:-d])])
        a = torch.cat([a[:d], a[d:] * a[:-d]])
        u = b
        d *= 2
    return u


@highest_matmul_precision
def newey_west_expanding_associative(
    ret: torch.Tensor, q: int = 2, half_life: float = 252.0,
    min_valid: int | None = None,
):
    """Expanding Newey-West as one prefix scan (the reference's
    ``lax.associative_scan`` form).

    Every sum of the derivation is a first-order linear recurrence
    ``s_t = lam * s_{t-1} + u_t``: Z, S, A, the q lag products P^l and the
    heads (h^l, g^l) pack into one (T, D) inject, D = 1 + K + (1+q) K^2 +
    q (K+1), and :func:`linear_prefix_scan` evaluates them all in O(log T)
    passes.  The lag-shifted first moments b^l = S_{t-l} come from shifting
    the scanned S rows.  No carry comes out: the serving step resumes the
    serial "scan" method only.  Under a mesh it runs replicated, as the
    serial scan does.
    """
    ret = replicate_under_mesh(ret)
    T, K = ret.shape
    dtype, dev = ret.dtype, ret.device
    lam = torch.tensor(0.5, dtype=dtype, device=dev) ** (1.0 / half_life)
    kmin = K if min_valid is None else min_valid
    tgrid = torch.arange(1, T + 1, device=dev)

    def shift_rows(x, lag):
        n = min(lag, T)
        return torch.cat([x.new_zeros((n,) + x.shape[1:]), x[:T - n]])

    def outer_rows(x, y):
        return (x[:, :, None] * y[:, None, :]).reshape(T, K * K)

    injects = [torch.ones((T, 1), dtype=dtype, device=dev), ret,
               outer_rows(ret, ret)]
    for lag in range(1, q + 1):
        injects.append(outer_rows(shift_rows(ret, lag), ret))    # x_{t-1-l} x_t'
    for lag in range(1, q + 1):
        head_on = (tgrid <= lag).to(dtype)[:, None]
        injects.append(head_on * ret)                             # h^l
        injects.append(head_on)                                   # g^l
    U = torch.cat(injects, dim=1)                                 # (T, D)
    states = linear_prefix_scan(lam.expand(T, 1), U)

    sizes = [1, K, K * K] + [K * K] * q + [K, 1] * q
    parts = list(torch.split(states, sizes, dim=1))
    Z, S, A = parts[0][:, 0], parts[1], parts[2].reshape(T, K, K)
    Ps = [p.reshape(T, K, K) for p in parts[3:3 + q]]
    heads = parts[3 + q:]

    Zc = Z[:, None, None]
    mu = S / Z[:, None]
    mumu = mu[:, :, None] * mu[:, None, :]
    V = A / Zc - mumu
    for li, lag in enumerate(range(1, q + 1)):
        h_l, g_l = heads[2 * li], heads[2 * li + 1][:, 0]
        a_l = S - h_l
        b_l = shift_rows(S, lag)                                  # S_{t-l}
        z_l = Z - g_l
        G = (Ps[li] - b_l[:, :, None] * mu[:, None, :]
             - mu[:, :, None] * a_l[:, None, :]
             + z_l[:, None, None] * mumu) / Zc
        V = V + (1.0 - lag / (1.0 + q)) * (G + G.transpose(-1, -2))
    valid = (tgrid > q) & (tgrid > kmin)
    return V, valid
