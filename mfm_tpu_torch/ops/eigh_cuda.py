"""Hopper kernels for the batched Jacobi eigh (counterpart of
``mfm_tpu/ops/eigh_pallas.py``).

Two wrappers, each with two CUDA designs of its kernel:

- :func:`jacobi_eigh_cuda` replaces ``jacobi_eigh_tpu`` (eigenvalues and
  eigenvectors; the F0 eigh and the regression's pseudo-inverse);
- :func:`jacobi_eigh_weighted_diag_cuda` replaces
  ``jacobi_eigh_weighted_diag_tpu`` (eigenvalues and the D0-weighted
  squared-eigenvector diagonal, the eigen Monte-Carlo's 139,000 matrices
  at CSI300 shape).

The designs: ``"warp"`` (``csrc/jacobi_eigh_warp.cu``, one warp per
matrix, the matrix in registers) takes float32 at the even n of
:data:`WARP_N`; ``"block"`` (``csrc/jacobi_eigh.cu``, one thread block per
matrix in shared memory) takes everything else, float64 included.
:func:`design_for` routes by (n, dtype) alone.

Each wrapper checks what it is given and raises on what its kernel does
not take (dtype other than float32/float64, odd n, n > 128, a shape whose
matrices do not fit one block's shared memory, a non-contiguous tensor).
On a CPU tensor it runs the kernel's plain version from
:mod:`mfm_tpu_torch.ops.eigh`; on a CUDA tensor it launches the kernel on
the current stream or raises — it never falls back to the other design or
the plain version.  :data:`LAUNCHES` counts the launches of each kernel
and design, and nothing else.
"""

from __future__ import annotations

import ctypes
import functools
import re

import torch

from mfm_tpu_torch.ops import _build
from mfm_tpu_torch.ops.eigh import (
    JACOBI_MAX_N,
    _round_bases,
    _skip_threshold,
    _sweeps_for,
    jacobi_eigh_slots,
    jacobi_eigh_weighted_diag_slots,
    sort_and_sign,
)

SOURCE = "jacobi_eigh"
WARP_SOURCE = "jacobi_eigh_warp"


def _warp_max_n() -> int:
    """``kMaxN`` of ``csrc/jacobi_eigh_warp.cu``: the source instantiates
    the warp kernels at every even n up to it, and owns that choice."""
    text = (_build.CSRC / f"{WARP_SOURCE}.cu").read_text()
    return int(re.search(r"constexpr int kMaxN = (\d+);", text).group(1))


#: the n the warp design takes, all float32
WARP_N = tuple(range(2, _warp_max_n() + 1, 2))
#: dynamic shared memory one block may use on Hopper (227 KB)
SMEM_LIMIT = 232448
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

#: kernel launches by kernel and design; a launcher adds one where it
#: launches, and nowhere else
LAUNCHES = {kernel: {"warp": 0, "block": 0}
            for kernel in ("jacobi_eigh", "jacobi_eigh_weighted")}
#: the same launches by kernel and ``(B, n, sweeps)``, the figures a
#: launch's operation count needs (``obs/profile.kernel_flops``)
LAUNCH_SHAPES = {kernel: {} for kernel in LAUNCHES}


def reset_launches():
    for kernel, counts in LAUNCHES.items():
        for design in counts:
            counts[design] = 0
        LAUNCH_SHAPES[kernel].clear()


def _count_launch(kernel: str, design: str, B: int, n: int, sweeps: int):
    LAUNCHES[kernel][design] += 1
    shapes = LAUNCH_SHAPES[kernel]
    shapes[(B, n, sweeps)] = shapes.get((B, n, sweeps), 0) + 1


def launch_shapes() -> dict:
    """A copy of :data:`LAUNCH_SHAPES`: ``{kernel: {(B, n, sweeps):
    launches}}``."""
    return {kernel: dict(shapes) for kernel, shapes in LAUNCH_SHAPES.items()}


def launch_counts() -> dict[str, int]:
    """A copy of :data:`LAUNCHES` as ``{"<kernel>/<design>": count}``."""
    return {f"{kernel}/{design}": count
            for kernel, counts in LAUNCHES.items()
            for design, count in counts.items()}


def design_for(n: int, dtype) -> str:
    """The design a CUDA tensor of (n, dtype) goes to."""
    return "warp" if dtype == torch.float32 and n in WARP_N else "block"


@functools.lru_cache(maxsize=None)
def _warp_lib() -> ctypes.CDLL:
    lib = _build.load(WARP_SOURCE)
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.mfm_jacobi_warp_eigh_f32.argtypes = [vp, vp, vp, ll, i32, i32,
                                             ctypes.c_double, vp]
    lib.mfm_jacobi_warp_eigh_f32.restype = i32
    lib.mfm_jacobi_warp_weighted_f32.argtypes = [vp, vp, vp, vp, ll, i32, i32,
                                                 ctypes.c_double, vp]
    lib.mfm_jacobi_warp_weighted_f32.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for sfx in _SUFFIX.values():
        fn = getattr(lib, f"mfm_jacobi_eigh_{sfx}")
        fn.argtypes = [vp, vp, vp, vp, ll, i32, i32, ctypes.c_double, vp]
        fn.restype = i32
        fn = getattr(lib, f"mfm_jacobi_eigh_weighted_{sfx}")
        fn.argtypes = [vp, vp, vp, vp, vp, ll, i32, i32, ctypes.c_double, vp]
        fn.restype = i32
    lib.mfm_jacobi_smem_bytes.argtypes = [i32, i32]
    lib.mfm_jacobi_smem_bytes.restype = ctypes.c_size_t
    lib.mfm_cuda_error_string.argtypes = [i32]
    lib.mfm_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _pair_table(n: int, device: torch.device) -> torch.Tensor:
    """(n-1) x n uint8 round bases (:func:`mfm_tpu_torch.ops.eigh._round_bases`)
    on ``device``: round r of the kernel rotates (row[2i], row[2i+1])."""
    return torch.tensor(_round_bases(n), dtype=torch.uint8, device=device)


def _check(A: torch.Tensor, what: str) -> int:
    if A.dtype not in _SUFFIX:
        raise TypeError(f"{what}: dtype must be float32 or float64, got {A.dtype}")
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"{what}: A must be (B, n, n), got {tuple(A.shape)}")
    n = A.shape[-1]
    if n % 2 or not 2 <= n <= JACOBI_MAX_N:
        raise ValueError(
            f"{what}: n must be even and in [2, {JACOBI_MAX_N}], got n={n} "
            "(odd-n callers pad through mfm_tpu_torch.ops.eigh)")
    if not A.is_contiguous():
        raise ValueError(f"{what}: A must be contiguous")
    return n


def _check_design(A: torch.Tensor, design: str, what: str):
    """Raise unless ``design`` can take the checked tensor ``A``."""
    n = A.shape[-1]
    if design == "warp":
        if design_for(n, A.dtype) != "warp":
            raise ValueError(
                f"{what}: the warp design takes float32 at n in {WARP_N}, "
                f"got n={n} {A.dtype}")
    elif (smem := _lib().mfm_jacobi_smem_bytes(n, A.element_size())) > SMEM_LIMIT:
        raise ValueError(
            f"{what}: n={n} in {A.dtype} needs {smem} B of shared memory "
            f"a block, more than the {SMEM_LIMIT} B one block may use")


def _raise_on(rc: int, what: str):
    if rc:
        # the error strings come from the CUDA runtime either library links
        msg = _lib().mfm_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} "
                           f"({msg})")


def _launch_eigh(A: torch.Tensor, sweeps: int, design: str):
    """The full kernel's ``design`` on a checked CUDA tensor ``A``: (w, V)
    in original slot order.  The wrapper launches the design
    :func:`design_for` names; ``chip_smoke.py`` launches both, to check and
    time one against the other."""
    _check_design(A, design, "jacobi_eigh")
    B, n = A.shape[0], A.shape[-1]
    w = torch.empty(A.shape[:-1], dtype=A.dtype, device=A.device)
    V = torch.empty_like(A)
    if not B:
        return w, V
    tiny = _skip_threshold(A.dtype)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        if design == "warp":
            rc = _warp_lib().mfm_jacobi_warp_eigh_f32(
                A.data_ptr(), w.data_ptr(), V.data_ptr(), B, n, sweeps, tiny,
                stream)
        else:
            fn = getattr(_lib(), f"mfm_jacobi_eigh_{_SUFFIX[A.dtype]}")
            rc = fn(A.data_ptr(), w.data_ptr(), V.data_ptr(),
                    _pair_table(n, A.device).data_ptr(), B, n, sweeps, tiny,
                    stream)
    _raise_on(rc, f"jacobi_eigh ({design})")
    _count_launch("jacobi_eigh", design, B, n, sweeps)
    return w, V


def _launch_weighted(A: torch.Tensor, d0: torch.Tensor, sweeps: int,
                     design: str):
    """The weighted kernel's ``design`` on checked CUDA tensors: (w, h), as
    :func:`_launch_eigh`."""
    _check_design(A, design, "jacobi_eigh_weighted")
    B, n = A.shape[0], A.shape[-1]
    w = torch.empty(A.shape[:-1], dtype=A.dtype, device=A.device)
    h = torch.empty_like(w)
    if not B:
        return w, h
    tiny = _skip_threshold(A.dtype)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        if design == "warp":
            rc = _warp_lib().mfm_jacobi_warp_weighted_f32(
                A.data_ptr(), d0.data_ptr(), w.data_ptr(), h.data_ptr(), B, n,
                sweeps, tiny, stream)
        else:
            fn = getattr(_lib(), f"mfm_jacobi_eigh_weighted_{_SUFFIX[A.dtype]}")
            rc = fn(A.data_ptr(), d0.data_ptr(), w.data_ptr(), h.data_ptr(),
                    _pair_table(n, A.device).data_ptr(), B, n, sweeps, tiny,
                    stream)
    _raise_on(rc, f"jacobi_eigh_weighted ({design})")
    _count_launch("jacobi_eigh_weighted", design, B, n, sweeps)
    return w, h


def jacobi_eigh_cuda(A: torch.Tensor, sweeps: int | None = None,
                     canonical_signs: bool = True, sort: bool = True):
    """Batched eigh of symmetric (B, n, n) ``A`` with the Hopper kernel.

    Returns (w (B, n), V (B, n, n)), ``V[:, :, i]`` the eigenvector of
    ``w[:, i]``.  The kernel emits original slot order; ``sort`` orders by
    ascending eigenvalue and ``canonical_signs`` makes each eigenvector's
    largest-|.| component positive, both as the Pallas wrapper does.
    """
    n = _check(A, "jacobi_eigh_cuda")
    if sweeps is None:
        sweeps = _sweeps_for(n, A.dtype)
    if A.is_cuda:
        w, V = _launch_eigh(A, sweeps, design_for(n, A.dtype))
    else:
        w, V = jacobi_eigh_slots(A, sweeps)
    return sort_and_sign(w, V, sort, canonical_signs)


def jacobi_eigh_weighted_diag_cuda(A: torch.Tensor, d0: torch.Tensor,
                                   sweeps: int | None = None):
    """Fused eigenvalues + weighted eigenvector diagonal with the Hopper
    kernel: (w, h) with ``h_i = sum_k V_ki^2 d0_k`` for symmetric (B, n, n)
    ``A`` and per-matrix weights ``d0`` (B, n), in original slot order.  The
    eigenvectors never reach device memory."""
    n = _check(A, "jacobi_eigh_weighted_diag_cuda")
    if d0.shape != A.shape[:-1] or d0.dtype != A.dtype \
            or d0.device != A.device or not d0.is_contiguous():
        raise ValueError(
            "jacobi_eigh_weighted_diag_cuda: d0 must be a contiguous "
            f"{tuple(A.shape[:-1])} {A.dtype} tensor on {A.device}, got "
            f"{tuple(d0.shape)} {d0.dtype} on {d0.device}")
    if sweeps is None:
        sweeps = _sweeps_for(n, A.dtype)
    if A.is_cuda:
        return _launch_weighted(A, d0, sweeps, design_for(n, A.dtype))
    return jacobi_eigh_weighted_diag_slots(A, d0, sweeps)
