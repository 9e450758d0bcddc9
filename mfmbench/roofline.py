"""The yardstick of the kernels: published peaks of the card and the
operations and bytes of the eigen stage's work, counted from shapes alone,
so that any implementation of the stage is read against the same work.

The Jacobi count is ``mfm_tpu_torch/obs/profile.kernel_flops``'s, copied:
9 n^2 flop a matrix a round, n - 1 rounds a sweep, plus 3 n^2 a matrix for
the weighted decomposition's h = sum_k V_ki^2 d0_k.
"""

#: one NVIDIA H100 SXM (data sheet, dense): FP32 outside the tensor cores
#: and HBM3 bandwidth, at the full 700 W power limit
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def jacobi_flops(B: int, n: int, sweeps: int, weighted: bool) -> float:
    """Operations of B cyclic Jacobi eighs of n x n over ``sweeps``."""
    ops = sweeps * (n - 1) * 9 * n * n * B
    if weighted:
        ops += 3 * n * n * B
    return float(ops)


def eigen_stage_bound(T: int, M: int, K: int, sweeps: int,
                      itemsize: int = 4) -> dict:
    """The least time of the eigen stage's Monte-Carlo: T*M weighted eighs
    of K x K at ``sweeps`` sweeps at the FP32 peak, against its bytes at
    the memory rate (G written once and read once, the M simulated
    covariances, d0 read as the decomposition reads it, w and h written).
    ``least_s`` is the larger, ``bound_by`` says which."""
    B = T * M
    ops = jacobi_flops(B, K, sweeps, weighted=True)
    nbytes = itemsize * (2 * B * K * K + M * K * K + B * K + 2 * B * K)
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return {"least_s": max(t_ops, t_bytes), "flops": ops, "bytes": nbytes,
            "ops_s": t_ops, "bytes_s": t_bytes,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
