"""The batched scenario kernel and the streaming sweep's fold (counterpart
of ``mfm_tpu/scenario/kernel.py``).

Every scenario kind :mod:`mfm_tpu_torch.scenario.spec` can express reduces,
by the time it reaches the device, to the same lane shape: a base
covariance (today's served matrix, a historical replay, a quarantine
counterfactual) plus four dense shock operands.  The reference vmaps one
lane function over the S axis; here the S axis is a leading dimension of
plain tensor ops, and a batch of S scenarios is still S independent
single runs:

- every per-lane op is elementwise, the per-lane eigendecomposition, or a
  contiguous innermost sum of K terms within the lane
  (``ops/xreg.py::_rowdot``) — never a matrix product, whose row bits move
  with the batch size on the card — so lane i's bytes cannot depend on its
  batchmates or on the bucket it was padded to;
- the identity lane is a ``torch.where`` passthrough of the UNTOUCHED base
  covariance, not an algebraic no-op, so the identity scenario is
  bitwise-equal to the unshocked baseline by construction.

Lane math, in order (PAPER.md's USE4 vocabulary):

1. split the base covariance into vols and correlations,
2. per-factor vol shocks ``sigma' = max(sigma * scale + shift, 0)``,
3. the vol-regime multiplier override ``sigma' *= vol_mult``,
4. correlation stress: off-diagonals scaled by ``1 + corr_beta`` and
   clipped to [-1, 1],
5. gated PSD projection: eigendecompose, clamp eigenvalues to a small
   relative floor, reconstruct — only where the stressed matrix went
   indefinite.  The eigendecomposition is
   :func:`~mfm_tpu_torch.ops.eigh.batched_eigh`: the Jacobi eigh kernel
   on a CUDA tensor (it never falls back), its plain version on the CPU.
   :func:`psd_project` is the gate's grad-safe twin, which the grad
   subsystem differentiates; every product on that path has a backward
   of innermost sums too, so a lane's gradient is also batch-invariant.

The streaming sweep's fold (:func:`sweep_chunk`, :func:`sweep_merge`)
keeps a fixed-size carry — per-book top-k worst table, fixed-bin vol
histogram, counters — and never materializes the (S, K, K) stack.  The
hot chunk path does no eigendecomposition: the host certifies each
(base, corr_beta level) pair PSD (``scenario/sweep.py``) and routes the
lanes it cannot vouch for through :func:`scenario_batch`.

The reference's donated jits have no counterpart and need none: every
operand is built fresh for each call, and the carry is replaced, never
written in place.
"""

from __future__ import annotations

import torch

from mfm_tpu_torch.models.risk_model import portfolio_vol
from mfm_tpu_torch.ops.eigh import _bt, batched_eigh, eigh_diff
from mfm_tpu_torch.ops.xreg import _rowdot
from mfm_tpu_torch.serve.query import chunk_rows


class _Outer(torch.autograd.Function):
    """(..., K) -> (..., K, K) outer product of each row with itself; the
    backward sums ``g v + g' v`` innermost (autograd's own would reduce
    over the second factor's broadcast rows, an outer dimension)."""

    @staticmethod
    def forward(ctx, v):
        ctx.save_for_backward(v)
        return v[..., :, None] * v[..., None, :]

    @staticmethod
    def backward(ctx, g):
        v, = ctx.saved_tensors
        vr = v[..., None, :]
        return (_rowdot(g, vr)
                + _rowdot(g.transpose(-1, -2).contiguous(), vr))


_outer = _Outer.apply


def stress_cov(cov, shift, scale, vol_mult, corr_beta):
    """Steps 1-4 of the lane math: the stressed covariance BEFORE the PSD
    gate, for ``cov`` (..., K, K), ``shift``/``scale`` (..., K) and
    ``vol_mult``/``corr_beta`` (...).  Shared by the serving kernel below,
    the sweep's hot path and the grad subsystem, which differentiates it
    with respect to the four shocks (``cov`` stays a constant).

    The clips are ``torch.maximum`` / ``torch.minimum``, as ``jnp.clip``
    and ``jnp.maximum`` are: the same values as ``torch.clamp``, and a
    gradient split in halves at a tie, as the reference's.  ``corr_beta``
    scales the rows through a (..., K) factor, so its gradient is two
    innermost sums of K terms, never one long one."""
    dtype, dev = cov.dtype, cov.device
    K = cov.shape[-1]
    eye = torch.eye(K, dtype=dtype, device=dev)
    off = 1.0 - eye
    zero = torch.zeros((), dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)

    var = torch.diagonal(cov, dim1=-2, dim2=-1)
    sigma = torch.sqrt(torch.maximum(var, zero))
    denom = _outer(sigma)
    corr = torch.where(denom > 0, cov / denom, zero)
    corr = corr * off + eye
    beta = (1.0 + corr_beta)[..., None].expand(corr_beta.shape + (K,))
    corr_s = torch.minimum(torch.maximum(corr * beta[..., :, None], -one),
                           one)
    corr_s = corr_s * off + eye
    sigma_s = torch.maximum(sigma * scale + shift, zero) * vol_mult[..., None]
    return corr_s * _outer(sigma_s)


class _Reconstruct(torch.autograd.Function):
    """``(V * w) @ V.T`` per lane as a row-local product (``ops/eigh.py::
    _bt``: (S, K, K, K) elementwise products summed over the innermost K,
    in lane chunks; bit-neutral, every sum stays inside its lane), with a
    backward of innermost sums too: ``V_bar = (P_bar + P_bar') V diag(w)``
    and ``w_bar_k = sum_i V_ik (P_bar V)_ik``."""

    @staticmethod
    def forward(ctx, V, w):
        ctx.save_for_backward(V, w)
        return _bt(V * w[..., None, :], V)

    @staticmethod
    def backward(ctx, P_bar):
        V, w = ctx.saved_tensors
        Vt = V.transpose(-1, -2).contiguous()
        V_bar = w_bar = None
        if ctx.needs_input_grad[0]:
            sym = P_bar + P_bar.transpose(-1, -2)
            V_bar = _bt(sym, Vt) * w[..., None, :]
        if ctx.needs_input_grad[1]:
            PV = _bt(P_bar, Vt)
            w_bar = _rowdot(Vt, PV.transpose(-1, -2).contiguous())
        return V_bar, w_bar


_reconstruct = _Reconstruct.apply


def psd_project(cov_s):
    """Step 5, the gated PSD projection, in its GRAD-SAFE form
    (``mfm_tpu/scenario/kernel.py::psd_project``) for (S, K, K) stressed
    covariances.

    Forward outputs are bitwise the serving gate of :func:`scenario_batch`
    on the same device — the same eigh, clamp floor and reconstruction;
    when the gate fires the projection eigh's input is bitwise ``cov_s``,
    when it does not the output IS ``cov_s`` — but the gating is
    restructured so reverse-mode AD through it stays finite:

    - the gate value comes from the eigenvalues of ``cov_s.detach()``: the
      gate is a DECISION, not a differentiable quantity;
    - the eigh whose vectors rebuild the projection
      (:func:`~mfm_tpu_torch.ops.eigh.eigh_diff`) runs on
      ``where(needs, cov_s, diag(1..K))``, so an unselected lane
      differentiates a matrix with well-separated eigenvalues instead of
      the inf/NaN a degenerate ``cov_s`` would produce;
    - the reconstruction ``V diag(max(w, floor)) V'`` is flat in w below
      the floor, so a pair of eigenvalues tied exactly there (stressed
      vols driven to 0 zero rows and columns: eigenvalues of exactly 0)
      contributes its limit, 0, to the gradient
      (``eigh_diff(flat_below=floor)``), as LAPACK's rounding-split tie
      does in the reference.

    The serving kernel keeps its single-eigh gate (this form costs a
    second eigendecomposition); the grad subsystem composes this one.
    Returns ``(cov_psd, needs, min_eig)`` like the inline gate.
    """
    dtype, dev = cov_s.dtype, cov_s.device
    K = cov_s.shape[-1]
    zero = torch.zeros((), dtype=dtype, device=dev)
    eps = torch.finfo(dtype).eps
    w_gate, _ = batched_eigh(cov_s.detach(), canonical_signs=False)
    min_eig = w_gate[:, 0]
    needs = min_eig < 0
    generic = torch.diag(torch.arange(1, K + 1, device=dev).to(dtype))
    # a fired lane's projection eigh is the gate's own (same input, same
    # bits), so the gate's eigenvalues give its clamp floor beforehand
    w, V = eigh_diff(torch.where(needs[:, None, None], cov_s, generic),
                     flat_below=torch.maximum(w_gate[:, -1], zero) * (K * eps))
    floor = torch.maximum(w[:, -1], zero) * (K * eps)
    w_cl = torch.maximum(w, floor[:, None])
    proj = _reconstruct(V, w_cl)
    proj = 0.5 * (proj + proj.transpose(-1, -2))
    return torch.where(needs[:, None, None], proj, cov_s), needs, min_eig


def scenario_batch(base_cov, shift, scale, vol_mult, corr_beta, passthrough,
                   kernels: bool = True):
    """Shock S covariance lanes: ``base_cov`` (S, K, K), ``shift``/``scale``
    (S, K), ``vol_mult``/``corr_beta`` (S,), ``passthrough`` (S,) bool —
    True serves the base back bitwise-untouched (identity scenarios,
    rejected specs, pad lanes).  ``kernels=False`` runs the plain Jacobi
    even on a CUDA tensor (comparison only).

    Returns ``(covs (S, K, K), psd_projected (S,), min_eig_stressed (S,))``
    where ``min_eig_stressed`` is the smallest eigenvalue of the stressed
    matrix BEFORE projection (0 on passthrough lanes).
    """
    dtype = base_cov.dtype
    K = base_cov.shape[-1]
    cov_s = stress_cov(base_cov, shift, scale, vol_mult, corr_beta)

    # the eigh runs unconditionally (the gate needs min_eig and K is
    # small); the clamp floor is RELATIVE — eigenvalues of the
    # reconstruction differ from the clamped ones by O(eps * ||cov||), so
    # K * eps * lambda_max keeps min-eig >= 0 at compute dtype
    w, V = batched_eigh(cov_s, canonical_signs=False, kernels=kernels)
    min_eig = w[:, 0]
    floor = torch.clamp_min(w[:, -1], 0) * (K * torch.finfo(dtype).eps)
    w_cl = torch.maximum(w, floor[:, None])
    proj = _reconstruct(V, w_cl)
    proj = 0.5 * (proj + proj.transpose(-1, -2))
    needs = min_eig < 0
    cov_out = torch.where(needs[:, None, None], proj, cov_s)
    cov_out = torch.where(passthrough[:, None, None], base_cov, cov_out)
    return (cov_out, needs & ~passthrough,
            torch.where(passthrough, torch.zeros((), dtype=dtype,
                                                 device=min_eig.device),
                        min_eig))


# -- streaming sweep kernels (scenario/sweep.py) ------------------------------

def book_vols(covs, xs):
    """(B, C) portfolio vols of every book ``xs`` (B, K) against every lane
    covariance ``covs`` (C, K, K): :func:`portfolio_vol` broadcast over
    both, in lane chunks of one fixed count whose (B, c, K, K) product
    fits ``serve/query.py``'s ``CHUNK_BYTES``.  Row-local, so a book's
    vol against a lane has the same bits whatever else shares the call —
    the streaming top-k is bitwise the materializing engine's."""
    B, K = xs.shape
    step = chunk_rows(B * K * K * covs.element_size())
    x = xs[:, None, :]
    return torch.cat([portfolio_vol(covs[None, s:s + step], x)
                      for s in range(0, covs.shape[0], step)], dim=1)


def _init_sweep_carry(n_books: int, top_k: int, n_theta: int, bins: int,
                      dtype, device):
    """Fresh aggregate carry for one sweep, a flat tuple:

    - ``top_vol (B, k)``: per-book worst vols, descending; finfo.min = empty.
    - ``top_theta (B, k, TH)``: the dense theta behind each entry
      (``[shift(K) | scale(K) | vol_mult | corr_beta]``).
    - ``top_src (B, k) i32``: global scenario index (replayable identity).
    - ``top_base (B, k) i32``: base-library row the lane stressed.
    - ``hist (B, bins) i32``: fixed-bin vol histogram (the quantile
      sketch; bin edges live host-side, deterministic per sweep).
    - ``counts (3,) i32``: [n_ok, n_rejected, n_projected].
    """
    neg = torch.finfo(dtype).min
    i32 = dict(dtype=torch.int32, device=device)
    return (torch.full((n_books, top_k), neg, dtype=dtype, device=device),
            torch.zeros((n_books, top_k, n_theta), dtype=dtype,
                        device=device),
            torch.full((n_books, top_k), -1, **i32),
            torch.full((n_books, top_k), -1, **i32),
            torch.zeros((n_books, bins), **i32),
            torch.zeros((3,), **i32))


def _merge_into_carry(carry, vols, thetas, src, base_idx, take, reject,
                      projected, lo, width):
    """Fold one chunk's lane vols ``(B, C)`` into the carry; lane masks are
    (C,) — a lane is merged for every book or none.

    The top-k merge keeps the reference's ``lax.top_k`` tie rule — the
    LOWER index wins, so carried (older) entries win over chunk lanes and
    earlier lanes win within a chunk — through a stable descending sort of
    the [carried k | C chunk lanes] concatenation, cut to k
    (``torch.topk`` promises no order among ties on the card).
    """
    top_vol, top_theta, top_src, top_base, hist, counts = carry
    k = top_vol.shape[1]
    C = vols.shape[1]
    neg = torch.finfo(top_vol.dtype).min
    masked = torch.where(take[None, :], vols,
                         torch.full((), neg, dtype=vols.dtype,
                                    device=vols.device))

    allv = torch.cat([top_vol, masked], dim=1)                  # (B, k + C)
    new_vol, sel = torch.sort(allv, dim=1, descending=True, stable=True)
    new_vol, sel = new_vol[:, :k], sel[:, :k]
    from_chunk = sel >= k
    chunk_i = torch.clamp(sel - k, 0, C - 1)                    # (B, k)
    old_i = torch.clamp(sel, 0, k - 1)

    new_theta = torch.where(
        from_chunk[:, :, None], thetas[chunk_i],
        torch.gather(top_theta, 1,
                     old_i[:, :, None].expand(-1, -1, top_theta.shape[2])))
    new_src = torch.where(from_chunk, src[chunk_i],
                          torch.gather(top_src, 1, old_i))
    new_base = torch.where(from_chunk, base_idx[chunk_i],
                           torch.gather(top_base, 1, old_i))

    # quantile sketch: per-book fixed bins [lo, lo + bins * width); the
    # open top edge clips into the last bin.  The cast comes before the
    # clamp, as in the reference; rejected lanes (possibly NaN) weigh 0
    bins = hist.shape[1]
    bi = torch.clamp(((vols - lo[:, None]) / width[:, None]).to(torch.int32),
                     0, bins - 1)
    hist = hist.scatter_add(1, bi.long(),
                            take[None, :].to(torch.int32).expand_as(bi))

    counts = counts + torch.stack([
        take.sum(dtype=torch.int32),
        reject.sum(dtype=torch.int32),
        (projected & take).sum(dtype=torch.int32)])
    return (new_vol, new_theta, new_src, new_base, hist, counts)


#: sub-chunk length: sweep_chunk folds a C-lane chunk as C / SWEEP_SUBCHUNK
#: slices in order, which bounds the (B, sub, K, K) product and the width
#: of each merge's sort while the host still pays one transfer per C
#: lanes.  Folding slices in order is bitwise C / sub sequential small
#: chunks — the merge sees the same lanes in the same order.
SWEEP_SUBCHUNK = 2048


def sweep_chunk(carry, base_lib, xs, thetas, base_idx, src,
                take, reject, passthrough, lo, width):
    """Fold one chunk of C HOST-CERTIFIED lanes into the carry.

    Every ``take`` lane is pre-certified PSD by the host inertia gate
    (sweep.py), so the lane math is stress + quadratic form only — no
    eigh anywhere on this path.  Lane vols reuse the serving building
    blocks (:func:`stress_cov` + :func:`book_vols`), so streaming results
    are bitwise the materializing engine's; passthrough (identity-theta)
    lanes take the per-base vols instead, mirroring the serving kernel's
    untouched-base passthrough.  It is :func:`sweep_fold` of
    :func:`sweep_lane_vols`.

    Args:
      carry: the tuple of :func:`_init_sweep_carry`.
      base_lib: (L, K, K) resolved base covariances (row 0 = served cov,
        rows 1.. = replay library).
      xs: (B, K) book exposure vectors.
      thetas: (C, 2K + 2) dense shock lanes.
      base_idx: (C,) base-library row per lane.
      src: (C,) i32 global scenario index per lane.
      take / reject / passthrough: (C,) bool lane masks (pad lanes are
        neither taken nor rejected).
      lo / width: (B,) histogram bin origin / width at compute dtype.
    """
    vols = sweep_lane_vols(base_lib, xs, thetas, base_idx, passthrough)
    return sweep_fold(carry, vols, thetas, base_idx, src, take, reject, lo,
                      width)


def _subchunk(C: int) -> int:
    return SWEEP_SUBCHUNK if C % SWEEP_SUBCHUNK == 0 else C


def sweep_lane_vols(base_lib, xs, thetas, base_idx, passthrough):
    """(B, C) vols of every book under each of C certified lanes, in
    ``SWEEP_SUBCHUNK`` slices; a lane's vols keep their bits whatever
    lanes share the call (the sharded sweep computes each shard's lanes
    alone)."""
    K = base_lib.shape[-1]
    C = thetas.shape[0]
    base_vols = book_vols(base_lib, xs)                         # (B, L)
    sub = _subchunk(C)
    base_idx = base_idx.long()
    out = []
    for s in range(0, C, sub):
        th, bi = thetas[s:s + sub], base_idx[s:s + sub]
        covs = stress_cov(base_lib[bi], th[:, :K], th[:, K:2 * K],
                          th[:, 2 * K], th[:, 2 * K + 1])
        vols = book_vols(covs, xs)                              # (B, sub)
        out.append(torch.where(passthrough[None, s:s + sub],
                               base_vols[:, bi], vols))
    return out[0] if len(out) == 1 else torch.cat(out, dim=1)


def sweep_fold(carry, vols, thetas, base_idx, src, take, reject, lo, width):
    """Fold a chunk's (B, C) certified lane vols (:func:`sweep_lane_vols`)
    into the carry, one ``SWEEP_SUBCHUNK`` slice at a time."""
    C = thetas.shape[0]
    sub = _subchunk(C)
    bi = base_idx.to(torch.int32)
    projected = torch.zeros(C, dtype=torch.bool, device=thetas.device)
    for s in range(0, C, sub):
        part = slice(s, s + sub)
        carry = _merge_into_carry(carry, vols[:, part], thetas[part],
                                  src[part], bi[part], take[part],
                                  reject[part], projected[part], lo, width)
    return carry


def sweep_merge(carry, covs, xs, thetas, src, base_idx, take, projected,
                lo, width):
    """Fold M OFFENDER lanes (already shocked + PSD-gated by
    :func:`scenario_batch`) into the carry: the quadratic forms and the
    identical merge, so offender lanes land in the same top-k, histogram
    and counters as certified ones, with their true post-projection vols
    and their ``projected`` flags counted."""
    vols = book_vols(covs, xs)                                  # (B, M)
    reject = torch.zeros(thetas.shape[0], dtype=torch.bool,
                         device=thetas.device)
    return _merge_into_carry(carry, vols, thetas, src, base_idx, take,
                             reject, projected, lo, width)
