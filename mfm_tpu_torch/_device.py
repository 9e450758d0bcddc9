"""Device resolution for the port's entry points, the move of their inputs
onto the device, and the one host read of a per-date mask."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means the CUDA card; the CPU only when asked for by name.

    Raises when CUDA is requested (explicitly or by default) and no CUDA
    device is present, so a run meant for the card never quietly lands on
    the host.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mfm_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path on "
            "the host")
    return dev


def on_device(x, device, dtype=None) -> torch.Tensor:
    """A tensor or numpy array as a tensor on ``device`` (in ``dtype``
    when given, else its own)."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=device, dtype=dtype)


def host_flags(mask, T: int) -> list[bool]:
    """A (T,) per-date bool mask (tensor or sequence; None means no date)
    as a host list — one device read for a mask that lives on the card."""
    if mask is None:
        return [False] * T
    flags = [bool(x) for x in torch.as_tensor(mask).reshape(-1).tolist()]
    if len(flags) != T:
        raise ValueError(f"skip_mask has {len(flags)} dates, the slab {T}")
    return flags
