"""Hopper kernel for the vol-regime recursion (``csrc/vol_regime_scan.cu``).

:func:`vol_regime_scan_cuda` runs the serial part of
:func:`mfm_tpu_torch.models.vol_regime.vol_regime_adjust_resume` in one
launch: from each date's ``okf`` and ``B2z`` (computed by torch), the
skip mask and the ``(num, den)`` carry in, every date's multiplier
``fvm2``, its square root ``lamb`` and the carry out, bitwise the plain
loop (``models/vol_regime._scan_loop``) on the card.  It replaces no TPU
kernel (the JAX package's recursion is a ``fori_loop``).
``vol_regime_adjust_resume`` sends it every CUDA series and the loop every
CPU one.

The wrapper takes a float32 or float64 CUDA series, a bool mask of the
series' length on its device (or None), and a carry of the series' dtype
and device, none requiring grad, and raises on anything else; it never
falls back to the loop.  :func:`launch_total` counts its launches, and
nothing else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mfm_tpu_torch.ops import _build

SOURCE = "vol_regime_scan"

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
#: kernel launches; the launcher adds one where it launches, nowhere else
LAUNCHES = {"vol_regime_scan": 0}


def launch_total() -> int:
    """Every launch :data:`LAUNCHES` has counted."""
    return LAUNCHES["vol_regime_scan"]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    for sfx in _SUFFIX.values():
        fn = getattr(lib, f"mfm_vol_regime_scan_{sfx}")
        fn.argtypes = [vp, vp, vp, vp, vp, vp, ll, vp, vp, vp, vp, vp]
        fn.restype = ctypes.c_int
    lib.mfm_vol_regime_error_string.argtypes = [ctypes.c_int]
    lib.mfm_vol_regime_error_string.restype = ctypes.c_char_p
    return lib


def check(b2z: torch.Tensor, okf: torch.Tensor, skip, lam: torch.Tensor,
          carry: tuple) -> None:
    """Raise unless the kernel takes these (T,) series, mask, ``lam`` and
    ``(num, den)`` carry."""
    what = "vol_regime_scan_cuda"
    if b2z.dtype not in _SUFFIX:
        raise TypeError(f"{what}: dtype must be float32 or float64, got "
                        f"{b2z.dtype}")
    for name, x in (("okf", okf), ("B2z", b2z)):
        if (x.dim() != 1 or x.dtype != b2z.dtype or x.device != b2z.device
                or x.shape != b2z.shape or not x.is_contiguous()):
            raise ValueError(
                f"{what}: {name} must be a contiguous (T,) series of B2z's "
                f"dtype and device; got {tuple(x.shape)} {x.dtype} on "
                f"{x.device}")
    T = b2z.shape[0]
    if skip is not None:
        if skip.dim() != 1 or skip.shape[0] != T:
            raise ValueError(f"skip_mask has {skip.numel()} dates, the slab "
                             f"{T}")
        if (skip.dtype != torch.bool or skip.device != b2z.device
                or not skip.is_contiguous()):
            raise ValueError(f"{what}: skip_mask must be a contiguous bool "
                             f"tensor on {b2z.device}; got {skip.dtype} on "
                             f"{skip.device}")
    if lam.dtype != b2z.dtype or lam.device != b2z.device or lam.numel() != 1:
        raise ValueError(f"{what}: lam must be one element of the series' "
                         f"dtype on its device")
    if len(carry) != 2:
        raise ValueError(f"{what}: the carry must be (num, den)")
    for x in carry:
        if x.dtype != b2z.dtype or x.device != b2z.device or x.shape != ():
            raise ValueError(
                f"{what}: each carry tensor must be a scalar of the series' "
                f"dtype and device; got {tuple(x.shape)} {x.dtype} on "
                f"{x.device} where () {b2z.dtype} on {b2z.device} is due")
    if any(x.requires_grad for x in (b2z, okf, lam, *carry)):
        raise ValueError(f"{what}: the kernel has no backward; got an input "
                         f"that requires grad")


def vol_regime_scan_cuda(b2z: torch.Tensor, okf: torch.Tensor, skip,
                         lam: torch.Tensor, carry: tuple):
    """The vol-regime recursion over the CUDA series ``b2z`` and ``okf``
    (T,) in one launch, resumed from ``carry`` ``(num, den)``; ``skip`` is
    the (T,) bool mask of the dates to excise on the device, or None;
    ``lam`` the decay as a one-element tensor on the device.  Returns
    ``(fvm2, lamb, (num, den))`` as ``models/vol_regime._scan_loop`` does,
    bitwise."""
    check(b2z, okf, skip, lam, carry)
    if b2z.device.type != "cuda":
        raise ValueError("vol_regime_scan_cuda takes CUDA tensors; the CPU "
                         "runs models/vol_regime._scan_loop")
    num, den = carry
    fvm2, lamb = torch.empty_like(b2z), torch.empty_like(b2z)
    num_out, den_out = torch.empty_like(num), torch.empty_like(den)
    fn = getattr(_lib(), f"mfm_vol_regime_scan_{_SUFFIX[b2z.dtype]}")
    with torch.cuda.device(b2z.device):
        rc = fn(b2z.data_ptr(), okf.data_ptr(),
                None if skip is None else skip.data_ptr(), lam.data_ptr(),
                num.data_ptr(), den.data_ptr(), b2z.shape[0],
                fvm2.data_ptr(), lamb.data_ptr(), num_out.data_ptr(),
                den_out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc:
        msg = _lib().mfm_vol_regime_error_string(rc).decode()
        raise RuntimeError(f"vol_regime_scan kernel launch failed: CUDA error "
                           f"{rc} ({msg})")
    LAUNCHES["vol_regime_scan"] += 1
    return fvm2, lamb, (num_out, den_out)
