"""Eigenfactor risk adjustment (USE4), batched over dates (counterpart of
``mfm_tpu/models/eigen.py``).

Contract (``Barra-master/mfm/utils.py:55-92``): eigendecompose the factor
covariance F0 = U0 D0 U0'; simulate M sets of factor returns with the
eigen-variances, re-estimate and re-decompose each simulated covariance,
measure the per-eigenvalue bias v, scale ``v <- scale_coef*(v-1)+1``, and
rebuild ``F0_hat = U0 diag(v^2 * D0) U0'``.

The structure is the reference's: the M standard-normal draw matrices are
the same for every date, so their sample covariances C_m are computed once;
the whole Monte-Carlo runs in F0's eigenbasis, where date t's simulated
covariance is G_m = diag(s) C_m diag(s) with s = sqrt(D0), its eigenvalues
are the simulated eigenvalues and ``D_hat_i = sum_k W_ki^2 D0_k``; and all
(T, M) decompositions run as ONE flat batch — the weighted Jacobi kernel
on the card, which never writes the eigenvectors out.

The incremental (causal) mode, :func:`eigen_risk_adjust_incremental`,
re-estimates the simulated covariances at each date from the draw columns
consumed so far, carried as exact raw prefix moments, so a daily update
is the suffix of the full-history run.

With ``mc_dtype="bfloat16"`` (``RiskModelConfig.eigen_mc_dtype``) the
draws are bfloat16, the Gram and moment sums accumulate in the compute
dtype, and G is assembled from the bfloat16-rounded scale factors and
simulated covariances, then cast up for the full-precision eighs: a
different realization, gated statistically on the eigenfactor bias stat
(``tools/parity_budget.json``, entry ``eigen_mc_bf16``), not bitwise.

Under an ambient ``('date', 'stock')`` mesh (``parallel/mesh.py``) the
Monte-Carlo runs date-parallel over the whole mesh: each shard runs the
per-date body on its contiguous date block, so every eigh stays
shard-local and the result is bitwise the single-device batch.  The F0
eigh and the rebuild stay whole on the mesh's first device.

Draws come from explicit ``torch.Generator``s; they cannot match
``jax.random``'s, so parity with the reference injects ``sim_covs`` (or
the incremental mode's draw tensor).
"""

from __future__ import annotations

import torch

from mfm_tpu_torch._device import host_flags
from mfm_tpu_torch.ops.eigh import (
    _sweeps_for,
    batched_eigh,
    batched_eigh_weighted_diag,
)
from mfm_tpu_torch.parallel.mesh import (
    P,
    NamedSharding,
    _ambient_mesh,
    device_put,
    gather,
    map_shards,
    replicate,
)
from mfm_tpu_torch.utils.prec import highest_matmul_precision


def _near_diagonal_sims(n_factors: int, sim_length: int | None) -> bool:
    """Whether G = diag(s) C_m diag(s) is near-diagonal: C_m = I +
    O(1/sqrt(sim_length)), so the premise needs sim_length >> K (4*K is the
    conservative cutoff).  ``sim_length=None`` counts as not-near."""
    return sim_length is not None and sim_length >= 4 * n_factors


def sim_sweeps_for(n_factors: int, dtype, sim_length: int) -> int:
    """Jacobi sweep cap for the simulated eighs, derived from K: the
    solver default when the near-diagonal premise fails, default-2 (at
    least 5) above 4*K draws, default-3 (at least 4) from 32*K draws on —
    the reference's measured accuracy tiers (``mfm_tpu/models/eigen.py``)."""
    full = _sweeps_for(n_factors, dtype)
    if not _near_diagonal_sims(n_factors, sim_length):
        return full
    if sim_length >= 32 * n_factors:
        return max(4, full - 3)
    return max(5, full - 2)


def _mc(mc_dtype) -> torch.dtype | None:
    """The Monte-Carlo dtype named by ``eigen_mc_dtype`` (None: the
    compute dtype)."""
    return None if mc_dtype is None else getattr(torch, mc_dtype)


@highest_matmul_precision
def simulated_eigen_covs(generator: torch.Generator, n_factors: int,
                         sim_length: int, n_sims: int,
                         dtype=torch.float32, mc_dtype=None) -> torch.Tensor:
    """Sample covariances C_m of M standard-normal (K, sim_length) draws,
    drawn on ``generator``'s device.

    ``np.cov`` semantics: demean each row over the samples, normalize by
    (sim_length - 1).  Shape (M, K, K), always ``dtype``.

    ``mc_dtype`` (``"bfloat16"``): the draws are generated in that dtype;
    the mean is accumulated in ``dtype`` and rounded back for the
    subtraction, so the demeaned samples stay in ``mc_dtype``; the Gram
    products are exact in ``dtype`` and accumulate there, never in a
    bfloat16 running sum.
    """
    md = _mc(mc_dtype) or dtype
    draws = torch.randn((n_sims, n_factors, sim_length), generator=generator,
                        dtype=md, device=generator.device)
    if md == dtype:
        d = draws - draws.mean(dim=-1, keepdim=True)
    else:
        d = (draws - draws.to(dtype).mean(dim=-1, keepdim=True).to(md)
             ).to(dtype)
    return (d @ d.transpose(-1, -2)) / (sim_length - 1)


def draw_bucket(T: int) -> int:
    """Power-of-two draw-bucket capacity >= T (floor 64): the incremental
    mode's draw tensor is regenerated only when the history crosses a
    power of two."""
    b = 64
    while b < T:
        b *= 2
    return b


def _fmix32(h: int) -> int:
    """MurmurHash3's 32-bit finalizer, a bijection on [0, 2**32)."""
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    return h ^ (h >> 16)


def _column_seed(seed: int, t: int) -> int:
    """The CPU generator seed of draw column ``t``.  The CPU generator
    keeps only 32 bits of a seed, so (seed, t) is mixed into 32 bits, one
    to one in t for a given seed: no two columns of a tensor repeat."""
    key = _fmix32((seed ^ (seed >> 32)) & 0xFFFFFFFF)
    return _fmix32(key ^ (t & 0xFFFFFFFF))


def simulated_eigen_draws(seed: int, n_factors: int, bucket: int,
                          n_sims: int, dtype=torch.float32,
                          device=None, mc_dtype=None) -> torch.Tensor:
    """The frozen (M, K, bucket) standard-normal draw tensor behind the
    incremental mode, generated **per column**: column t is
    ``torch.randn((M, K))`` from a CPU generator seeded with (seed, t), in
    ``mc_dtype`` when given (else ``dtype``), then the tensor moves to
    ``device``.

    Per-column generation makes a bigger bucket a strict prefix-extension
    of a smaller one, bitwise, so a bucket rollover rewrites no column
    already consumed.  One ``torch.randn((M, K, bucket))`` would not: its
    values depend on the total count (and on CUDA, Philox's offsets do).
    Drawing on the CPU gives the same tensor on every device, so the CPU
    tests pin what the card uses.  The values cannot match the reference's
    ``jax.random.fold_in`` draws; parity tests inject the draw tensor.
    """
    md = _mc(mc_dtype) or dtype
    cols = [torch.randn((n_sims, n_factors), dtype=md,
                        generator=torch.Generator().manual_seed(
                            _column_seed(seed, t)))
            for t in range(bucket)]
    return torch.stack(cols, dim=-1).to(device)


def eigen_carry_init(n_sims: int, n_factors: int, dtype=torch.float32,
                     device=None) -> tuple:
    """The ``(R, p, n)`` raw prefix moments of the incremental mode before
    any date: R (M, K, K) sum of per-column outer products, p (M, K)
    column sum, n (int32) columns consumed."""
    return (torch.zeros((n_sims, n_factors, n_factors), dtype=dtype,
                        device=device),
            torch.zeros((n_sims, n_factors), dtype=dtype, device=device),
            torch.zeros((), dtype=torch.int32, device=device))


# working-set accounting for the chunked Monte-Carlo: the G tensor itself
# plus solver scratch (a few copies of the batch)
_CHUNK_WORKSPACE_FACTOR = 4
# the host gets a hard transient cap, so huge histories stream through a
# bounded working set instead of thrashing the page cache
_CHUNK_HOST_BUDGET_BYTES = 256 * 1024 * 1024


def _memory_headroom_bytes(device: torch.device) -> int | None:
    """Free memory on the CUDA device, or the host's MemAvailable."""
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[0])
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


def auto_eigen_chunk(T: int, n_sims: int, n_factors: int, itemsize: int = 4,
                     device: torch.device | str = "cuda") -> int | None:
    """Resolve ``eigen_chunk="auto"``: a date-chunk size for the eigen
    Monte-Carlo, or None to run the full (T, M) batch in one shot — the
    reference's formula, with the device's free memory from
    ``torch.cuda.mem_get_info`` (half of it is the budget) and the host's
    MemAvailable (a quarter, at most 256 MiB) on the CPU."""
    device = torch.device(device)
    per_date = n_sims * n_factors * n_factors * itemsize * _CHUNK_WORKSPACE_FACTOR
    head = _memory_headroom_bytes(device)
    if device.type == "cuda":
        budget = head // 2 if head else 4 * 1024 ** 3
    else:
        budget = (min(head // 4, _CHUNK_HOST_BUDGET_BYTES) if head
                  else _CHUNK_HOST_BUDGET_BYTES)
    if T * per_date <= budget:
        return None
    return int(max(1, min(T, budget // per_date)))


def _bias_ratios(G, d0_c, sim_sweeps, kernels):
    """(c, M, K, K) scaled-Gram batch + (c, K) F0 eigenvalues -> (c, K) mean
    bias ratios v^2."""
    Dm, Dm_hat = batched_eigh_weighted_diag(
        G, d0_c[:, None, :], sweeps=sim_sweeps, kernels=kernels)
    # rank pairing, order-invariant across solvers: the i-th smallest sim
    # eigenvalue pairs with the i-th smallest D0 (D0 is already ascending);
    # a stable sort keeps tied slots in slot order, like the reference
    Dm, order = torch.sort(Dm, dim=-1, stable=True)
    Dm_hat = torch.gather(Dm_hat, -1, order)
    # a numerically-zero sim eigenvalue (rank-deficient covariance) would
    # make the ratio 0/0 or a huge spurious value: ratio 1 wherever |Dm| is
    # below eps * lambda_max
    eps = torch.finfo(G.dtype).eps
    thr = eps * Dm.abs().amax(dim=-1, keepdim=True)
    degenerate = Dm.abs() <= thr
    one = torch.ones((), dtype=G.dtype, device=G.device)
    ratio = torch.where(degenerate, one,
                        Dm_hat / torch.where(degenerate, one, Dm))
    # clamp: tiny-negative Dm just above thr could still push the mean
    # negative, and sqrt of a negative poisons the whole date with NaN
    return torch.clamp_min(ratio.mean(dim=1), 0.0)  # (c, K)


@highest_matmul_precision
def eigen_risk_adjust_by_time(
    covs: torch.Tensor,
    valid: torch.Tensor,
    sim_covs: torch.Tensor,
    scale_coef: float = 1.4,
    sim_sweeps: int | None = None,
    sim_length: int | None = None,
    chunk: int | None = None,
    kernels: bool = True,
    mc_dtype=None,
):
    """Batched adjustment over the date axis.

    ``covs``: (T, K, K); ``valid``: (T,) — dates whose Newey-West estimate
    was invalid stay invalid, and dates with a negative eigenvalue are
    marked invalid.  Returns (adjusted covs (T, K, K) with NaN at invalid
    dates, valid (T,)).

    ``sim_sweeps`` caps the Jacobi sweeps of the (T, M) simulated
    decompositions only; ``sim_length`` (the draw count behind
    ``sim_covs``) sizes the automatic cap (:func:`sim_sweeps_for`).  The
    bias pairing is rank-based: the scalar (Dm, Dm_hat) pairs are sorted by
    Dm, so ascending sim eigenvalues always pair with ascending D0.

    ``chunk`` streams the Monte-Carlo over the date axis in slabs of that
    many dates, so the (T, M, K, K) G transient is never whole; the per-date
    op sequence is the same, so chunked == unchunked.  ``kernels=False``
    runs the plain eigh versions on the card.

    ``mc_dtype`` (``"bfloat16"``): G is assembled in that dtype from the
    rounded scale factors and simulated covariances (:func:`_assemble_g`)
    and cast to ``covs.dtype`` for the full-precision eighs.
    """
    T, K = covs.shape[0], covs.shape[-1]
    if sim_sweeps is None and sim_length is not None:
        sim_sweeps = sim_sweeps_for(K, covs.dtype, sim_length)
    eye = torch.eye(K, dtype=covs.dtype, device=covs.device)
    safe = torch.where(valid[:, None, None], covs, eye)

    # canonical_signs=False: s and psd read D0 only, and the rebuild below
    # carries U0 quadratically, so eigenvector signs square away
    D0, U0 = batched_eigh(safe, canonical_signs=False, kernels=kernels)
    psd = D0[..., 0] >= 0  # ascending order -> min eigenvalue first
    s = torch.sqrt(torch.clamp_min(D0, 0.0))

    md = _mc(mc_dtype)
    sim = sim_covs if md is None else sim_covs.to(md)

    def v2_slab(s_c, d0_c, sc):
        """v2 over a (t, K) slab of dates, streamed by ``chunk`` when it
        bites: the per-shard body under a mesh."""
        t = s_c.shape[0]
        step = t if chunk is None or chunk >= t else chunk
        return torch.cat([
            _bias_ratios(_assemble_g(s_c[a:a + step], sc[None], md),
                         d0_c[a:a + step], sim_sweeps, kernels)
            for a in range(0, t, step)]) if t else s_c

    mesh = _ambient_mesh()
    if mesh is None:
        v2 = v2_slab(s, D0, sim)
    else:
        # the date axis over the WHOLE mesh: each shard's contiguous block
        # (dates padded to a multiple of the mesh's size carry s = 0, so G
        # is all zero, every ratio is degenerate and v2 = 1; cropped); the
        # draws are made once and copied to every shard, one shard's G
        # freed before the next shard's is made
        pad = (-T) % mesh.size
        z = torch.zeros((pad, K), dtype=s.dtype, device=s.device)
        spread = NamedSharding(mesh, P(("date", "stock")))
        v2 = gather(map_shards(
            v2_slab, device_put(torch.cat([s, z]), spread),
            device_put(torch.cat([D0, z]), spread), replicate(sim, mesh),
            out_specs=P(("date", "stock"))))[:T]

    return _rebuild(U0, D0, v2, scale_coef, valid & psd)


def eigen_risk_adjust(cov: torch.Tensor, sim_covs: torch.Tensor,
                      scale_coef: float = 1.4) -> torch.Tensor:
    """Adjust one KxK covariance (the reference's ``eigen_risk_adj``,
    ``utils.py:55-92``): :func:`eigen_risk_adjust_by_time` over one date."""
    one = torch.ones((1,), dtype=torch.bool, device=cov.device)
    out, _ = eigen_risk_adjust_by_time(cov[None], one, sim_covs, scale_coef)
    return out[0]


def _assemble_g(s_c, C, md):
    """The simulated covariances in F0's eigenbasis, G = diag(s) C_m
    diag(s), for a (c, K) slab of sqrt-eigenvalues ``s_c`` and C (c or 1,
    M, K, K).  Under a Monte-Carlo dtype ``md`` (C already in it) there
    are two roundings, in this order: the (c, K, K) outer product
    ``S = s_lo s_lo'`` of the rounded scale factors, then the one multiply
    ``S C``; only the product is cast up to the compute dtype of ``s_c``.
    """
    if md is None:
        return s_c[:, None, :, None] * C * s_c[:, None, None, :]
    s_lo = s_c.to(md)
    S = s_lo[:, :, None] * s_lo[:, None, :]
    return (S[:, None] * C).to(s_c.dtype)


def _rebuild(U0, D0, v2, scale_coef, ok):
    """F0_hat = U0 diag(v^2 D0) U0' with v scaled from the bias ratios v2;
    NaN where ``ok`` is False."""
    v = scale_coef * (torch.sqrt(v2) - 1.0) + 1.0
    out = (U0 * (v * v * D0)[:, None, :]) @ U0.transpose(-1, -2)
    out = torch.where(ok[:, None, None], out,
                      torch.full_like(out, float("nan")))
    return out, ok


@highest_matmul_precision
def eigen_risk_adjust_incremental(
    covs: torch.Tensor,
    valid: torch.Tensor,
    draws: torch.Tensor,
    carry: tuple,
    scale_coef: float = 1.4,
    *,
    sim_sweeps: int | None = None,
    chunk: int | None = None,
    skip_mask=None,
    kernels: bool = True,
    mc_dtype=None,
):
    """Causal (expanding-draw) eigen adjustment, the incremental mode.

    Each date that is not skipped consumes the next column of the frozen
    per-column ``draws`` (M, K, bucket) (:func:`simulated_eigen_draws`) and
    folds it into the raw prefix moments ``carry = (R, p, n)``
    (:func:`eigen_carry_init`) BEFORE its own bias is measured, so date t's
    simulated covariances ``C_m(t) = (R - p p'/n) / (n - 1)`` estimate
    from exactly the draws available at date t.  The moment recursion runs
    date by date in order and the carry is exact, so a slab resumed from a
    carry is bitwise the suffix of the full-history run, for any chunk or
    slab boundary.  Each product is rounded before its sum (``o = x x'``
    before ``R + o``, ``mu p'`` before ``R - mu p'``), as in the
    reference; PyTorch rounds every op, so no fused multiply-add can
    change that between runs.  Dates with n < 2 get the identity (they
    are Newey-West-invalid anyway).

    ``skip_mask`` ((T,) bool, read to the host once) excises dates: a
    skipped date consumes no column and leaves (R, p, n) untouched.
    ``sim_sweeps`` is resolved by the caller from the running count
    (:func:`sim_sweeps_for`).  ``chunk`` bounds the (chunk, M, K, K) G
    transient; chunked == unchunked.  ``mc_dtype``: bfloat16 draws cast up
    exactly (the moments always accumulate in the compute dtype) and G
    assembled as in :func:`eigen_risk_adjust_by_time`, from the simulated
    covariances rounded to ``mc_dtype``.  Returns ``(out, ok, carry_out)``.
    """
    T, K = covs.shape[0], covs.shape[-1]
    M = draws.shape[0]
    eye = torch.eye(K, dtype=covs.dtype, device=covs.device)
    safe = torch.where(valid[:, None, None], covs, eye)
    # sign-invariant F0 basis, as in eigen_risk_adjust_by_time
    D0, U0 = batched_eigh(safe, canonical_signs=False, kernels=kernels)
    psd = D0[..., 0] >= 0
    s = torch.sqrt(torch.clamp_min(D0, 0.0))
    skip = host_flags(skip_mask, T)
    md = _mc(mc_dtype)

    R, p, n = carry
    n = int(n)
    step = T if chunk is None or chunk >= T else chunk
    v2 = []
    for a in range(0, T, step):
        c = min(step, T - a)
        Cs = torch.empty((c, M, K, K), dtype=covs.dtype, device=covs.device)
        for i in range(c):
            if not skip[a + i]:
                # column n: the next unconsumed draw
                x = draws[:, :, n].to(covs.dtype)
                o = x[:, :, None] * x[:, None, :]
                R = R + o
                p = p + x
                n += 1
            if n >= 2:
                mu = p / float(n)
                pp = mu[:, :, None] * p[:, None, :]
                Cs[i] = (R - pp) / float(n - 1)
            else:
                Cs[i] = eye
        G = _assemble_g(s[a:a + c], Cs if md is None else Cs.to(md), md)
        v2.append(_bias_ratios(G, D0[a:a + c], sim_sweeps, kernels))
    v2 = (torch.cat(v2) if v2
          else torch.zeros((0, K), dtype=covs.dtype, device=covs.device))
    out, ok = _rebuild(U0, D0, v2, scale_coef, valid & psd)
    return out, ok, (R, p, torch.tensor(n, dtype=torch.int32,
                                        device=covs.device))
