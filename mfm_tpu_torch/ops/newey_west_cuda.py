"""Hopper kernel for the serial expanding Newey-West scan
(``csrc/newey_west_scan.cu``).

:func:`newey_west_scan_cuda` runs the whole recursion of
:func:`mfm_tpu_torch.models.newey_west.newey_west_expanding_resume` in one
launch: every date's covariance and the carry out, from the carry in,
bitwise the plain loop (``models/newey_west._scan_loop``) on the card.
It replaces no TPU kernel (the JAX package's recursion is a ``lax.scan``).
``newey_west_expanding_resume`` sends it every CUDA tensor and the loop
every CPU one.

The wrapper takes a float32 or float64 CUDA series with ``q`` in
``[0, MAX_Q]`` and a carry of the series' dtype, device and shapes, none
requiring grad, and raises on anything else; it never falls back to the
loop.  :func:`launch_total` counts its launches, and nothing else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mfm_tpu_torch.ops import _build

SOURCE = "newey_west_scan"


#: the largest lag count the kernel takes: ``kMaxQ`` of
#: ``csrc/newey_west_scan.cu``, which instantiates the kernel at every q
#: up to it (a CPU test holds the two equal)
MAX_Q = 8
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
#: kernel launches; the launcher adds one where it launches, nowhere else
LAUNCHES = {"newey_west_scan": 0}


def launch_total() -> int:
    """Every launch :data:`LAUNCHES` has counted."""
    return LAUNCHES["newey_west_scan"]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for sfx in _SUFFIX.values():
        fn = getattr(lib, f"mfm_newey_west_scan_{sfx}")
        fn.argtypes = [vp, ll, ll, vp, vp, ll, i32, i32, i32,
                       ctypes.POINTER(vp), ctypes.POINTER(vp), vp, vp]
        fn.restype = i32
    lib.mfm_newey_west_error_string.argtypes = [i32]
    lib.mfm_newey_west_error_string.restype = ctypes.c_char_p
    return lib


def _flat(sums: tuple, q: int) -> list:
    """The carry's sums ``(S, A, Z, Ps, hs, gs, Slags, xlags)`` as the
    kernel's flat list: S, A, Z, then each per-lag group of ``q``."""
    S, A, Z, *groups = sums
    if len(groups) != 5 or any(len(grp) != q for grp in groups):
        raise ValueError(
            f"newey_west_scan_cuda: the carry must hold (S, A, Z, Ps, hs, "
            f"gs, Slags, xlags) with q = {q} tensors in each per-lag group")
    return [S, A, Z, *(x for grp in groups for x in grp)]


def require_lags(q: int) -> None:
    """Raise unless the kernel takes ``q`` lags: on the card the serial
    scan runs only through it, so a model refuses more when it is built
    (``models/risk_model.py``), before any stage runs."""
    if not 0 <= q <= MAX_Q:
        raise ValueError(
            f"nw_lags: the card's Newey-West kernel takes q in [0, {MAX_Q}] "
            f"(csrc/newey_west_scan.cu), got {q}; more lags run with "
            f"nw_method='associative' or on the CPU")


def check(ret: torch.Tensor, q: int, sums: tuple) -> list:
    """Raise unless the kernel takes this (T, K) series, ``q`` and carry
    sums; return the sums as :func:`_flat` lists them."""
    what = "newey_west_scan_cuda"
    if ret.dtype not in _SUFFIX:
        raise TypeError(f"{what}: dtype must be float32 or float64, got "
                        f"{ret.dtype}")
    if ret.dim() != 2 or ret.shape[1] < 1:
        raise ValueError(f"{what}: the series must be (T, K) with K >= 1, "
                         f"got {tuple(ret.shape)}")
    require_lags(q)
    K = ret.shape[1]
    flat = _flat(sums, q)
    shapes = ([(K,), (K, K), ()] + [(K, K)] * q + [(K,)] * q + [()] * q
              + [(K,)] * (2 * q))
    for x, shape in zip(flat, shapes):
        if (x.dtype != ret.dtype or x.device != ret.device
                or tuple(x.shape) != shape or not x.is_contiguous()):
            raise ValueError(
                f"{what}: each carry tensor must be contiguous, of the "
                f"series' dtype and device and of its shape; got "
                f"{tuple(x.shape)} {x.dtype} on {x.device} where "
                f"{shape} {ret.dtype} on {ret.device} is due")
    if any(x.requires_grad for x in (ret, *flat)):
        raise ValueError(f"{what}: the kernel has no backward; got an "
                         f"input that requires grad")
    return flat


def newey_west_scan_cuda(ret: torch.Tensor, lam: torch.Tensor, q: int,
                         t: int, sums: tuple, skip: list[bool]):
    """Every expanding Newey-West covariance of the CUDA series ``ret``
    (T, K) in one launch, resumed from the carry's ``sums`` ``(S, A, Z,
    Ps, hs, gs, Slags, xlags)`` at window length ``t``; ``lam`` is the
    decay as a one-element tensor on the device, ``skip`` the host flags
    of the dates to excise.  Returns ``(covs, sums_out)`` as
    ``models/newey_west._scan_loop`` does, bitwise."""
    flat = check(ret, q, sums)
    if ret.device.type != "cuda":
        raise ValueError("newey_west_scan_cuda takes CUDA tensors; the CPU "
                         "runs models/newey_west._scan_loop")
    if lam.dtype != ret.dtype or lam.device != ret.device or lam.numel() != 1:
        raise ValueError("newey_west_scan_cuda: lam must be one element of "
                         "the series' dtype on its device")
    T, K = ret.shape
    covs = torch.empty((T, K, K), dtype=ret.dtype, device=ret.device)
    out = [torch.empty_like(x) for x in flat]
    # no flag set, no copy: the kernel reads a null mask as no skipped date
    mask = (torch.tensor(skip, dtype=torch.uint8, device=ret.device)
            if any(skip) else None)
    ptrs = ctypes.c_void_p * len(flat)
    fn = getattr(_lib(), f"mfm_newey_west_scan_{_SUFFIX[ret.dtype]}")
    with torch.cuda.device(ret.device):
        rc = fn(ret.data_ptr(), ret.stride(0), ret.stride(1), lam.data_ptr(),
                None if mask is None else mask.data_ptr(), T, K, q, t,
                ptrs(*(x.data_ptr() for x in flat)),
                ptrs(*(x.data_ptr() for x in out)), covs.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
    if rc:
        msg = _lib().mfm_newey_west_error_string(rc).decode()
        raise RuntimeError(f"newey_west_scan kernel launch failed: CUDA error "
                           f"{rc} ({msg})")
    LAUNCHES["newey_west_scan"] += 1
    S, A, Z, *rest = out
    groups = tuple(tuple(rest[k * q:(k + 1) * q]) for k in range(5))
    return covs, (S, A, Z, *groups)
