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

Draws come from an explicit ``torch.Generator``; they cannot match
``jax.random``'s, so parity with the reference injects ``sim_covs``.
Not ported in this slice: the bfloat16 Monte-Carlo, the incremental
(causal) mode and the device-mesh branch (ROADMAP.md §A 7, §A 16).
"""

from __future__ import annotations

import torch

from mfm_tpu_torch.ops.eigh import (
    _sweeps_for,
    batched_eigh,
    batched_eigh_weighted_diag,
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


@highest_matmul_precision
def simulated_eigen_covs(generator: torch.Generator, n_factors: int,
                         sim_length: int, n_sims: int,
                         dtype=torch.float32) -> torch.Tensor:
    """Sample covariances C_m of M standard-normal (K, sim_length) draws,
    drawn on ``generator``'s device.

    ``np.cov`` semantics: demean each row over the samples, normalize by
    (sim_length - 1).  Shape (M, K, K).
    """
    draws = torch.randn((n_sims, n_factors, sim_length), generator=generator,
                        dtype=dtype, device=generator.device)
    d = draws - draws.mean(dim=-1, keepdim=True)
    return (d @ d.transpose(-1, -2)) / (sim_length - 1)


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

    def v2_of(s_c, d0_c):
        # simulated covariances in F0's eigenbasis: G = diag(s) C_m diag(s)
        G = s_c[:, None, :, None] * sim_covs[None] * s_c[:, None, None, :]
        return _bias_ratios(G, d0_c, sim_sweeps, kernels)

    if chunk is None or chunk >= T:
        v2 = v2_of(s, D0)
    else:
        v2 = torch.cat([v2_of(s[a:a + chunk], D0[a:a + chunk])
                        for a in range(0, T, chunk)])

    v = scale_coef * (torch.sqrt(v2) - 1.0) + 1.0
    out = (U0 * (v * v * D0)[:, None, :]) @ U0.transpose(-1, -2)
    ok = valid & psd
    out = torch.where(ok[:, None, None], out,
                      torch.full_like(out, float("nan")))
    return out, ok
