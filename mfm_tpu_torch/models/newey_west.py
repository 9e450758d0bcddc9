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
serial pass of EWMA recursions over the dates — here a Python loop of small
K x K tensor ops on the device (about three dozen launches a date).
"""

from __future__ import annotations

import torch

from mfm_tpu_torch._device import host_flags
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
    EWMA derivation.  Only the serial "scan" method is ported.
    """
    if method == "associative":
        raise NotImplementedError(
            "the associative Newey-West is not ported yet (ROADMAP.md §A 16)")
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
    """
    T, K = ret.shape
    dtype, dev = ret.dtype, ret.device
    lam = torch.tensor(0.5, dtype=dtype, device=dev) ** (1.0 / half_life)
    kmin = K if min_valid is None else min_valid
    state = nw_init_carry(K, q, dtype, dev) if carry is None else carry
    skip = host_flags(skip_mask, T)
    t = int(state[0])
    S, A, Z, Ps, hs, gs, Slags, xlags = state[1:]
    covs = torch.empty((T, K, K), dtype=dtype, device=dev)
    valid = []

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
            valid.append(False)
            continue
        valid.append(t1 > q and t1 > kmin)
        t = t1
        S, A, Z = Snew, Anew, Znew
        Ps, hs, gs = tuple(Ps_new), tuple(hs_new), tuple(gs_new)
        if q > 0:
            Slags = (Snew,) + Slags[:-1]
            xlags = (xt,) + xlags[:-1]

    carry_out = (torch.tensor(t, dtype=torch.int32, device=dev),
                 S, A, Z, Ps, hs, gs, Slags, xlags)
    return covs, torch.tensor(valid, dtype=torch.bool, device=dev), carry_out
