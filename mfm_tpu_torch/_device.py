"""Device resolution for the port's entry points, the move of their inputs
onto the device, the one host read of a per-date mask, and the devices a
mesh may draw on."""

from __future__ import annotations

import os

import numpy as np
import torch

#: the port's counterpart of XLA's ``--xla_force_host_platform_device_count``:
#: ``N`` makes a mesh see the process's one device N times over (a virtual
#: mesh: its shards are separate tensors, all on that device).  Read only
#: when a mesh is built (:func:`mesh_devices`), never by a single-device run.
VIRTUAL_DEVICES_ENV = "MFM_TORCH_VIRTUAL_DEVICES"


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


def mesh_devices(device: str | torch.device | None = None) -> list:
    """The devices a mesh may draw on, in order.

    ``device`` resolves as for every entry point (None: the card).  With
    :data:`VIRTUAL_DEVICES_ENV` set to N, the process's one device
    (``cuda:0`` on the card, the CPU in the tests) repeated N times;
    otherwise every visible CUDA device, or the one CPU.
    """
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    raw = os.environ.get(VIRTUAL_DEVICES_ENV)
    if raw:
        try:
            n = int(raw)
        except ValueError:
            n = 0
        if n < 1:
            raise ValueError(f"{VIRTUAL_DEVICES_ENV} must be a positive "
                             f"int, got {raw!r}")
        return [dev] * n
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]
