"""Multi-process execution helpers (counterpart of
``mfm_tpu/parallel/distributed.py``), over ``torch.distributed``.

Across processes only the date axis is partitioned: every cross-date
dependency of the pipeline is parallel over dates (regression, eigen
adjustment) or a tiny K x K recursion that runs replicated (Newey-West,
vol-regime), so the one cross-process collective is the gather of date
shards (``parallel/mesh.py`` ``gather``).

Topology doctrine for an (n_processes x devices) fleet:

  mesh axes     ('date', 'stock')
  date axis     outer, spans processes
  stock axis    inner, within one process's devices (its gather is a
                ``torch.cat`` in the process)

Usage in each process of a job:

    from mfm_tpu_torch.parallel.distributed import (
        initialize, make_global_mesh)
    initialize()                        # MFM_COORDINATOR_ADDRESS, rank
    mesh = make_global_mesh(n_stock=4)  # every rank's devices, date x stock

``torch.distributed`` is imported only when a coordinator is set or a
function needs the process group, never at import: process start is the
CLI's first cost.
"""

from __future__ import annotations

import datetime
import os
import sys

import numpy as np

from mfm_tpu_torch._device import mesh_devices, resolve_device


def _dist():
    import torch.distributed as dist

    return dist


def _world() -> tuple:
    """(world size, rank): (1, 0) without an initialized process group."""
    if "torch.distributed" not in sys.modules:
        return 1, 0
    dist = _dist()
    if not (dist.is_available() and dist.is_initialized()):
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *, device=None,
               timeout_s: float | None = None) -> bool:
    """Initialize ``torch.distributed`` from the arguments or the
    environment; True when the world holds more than one process.

    Returns False, doing nothing, when no coordinator is configured
    (``coordinator_address`` or ``MFM_COORDINATOR_ADDRESS``) and no
    process count is given, so code paths are shared between one process
    and a fleet.  The address is ``host:port`` (TCP) or a ``file://``
    store; the process count and rank come from the arguments, else
    ``WORLD_SIZE`` and ``RANK``.  The backend is NCCL for a CUDA device
    (the card unless ``device="cpu"``) and gloo for the CPU; a CUDA
    process takes the card of its rank.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "MFM_COORDINATOR_ADDRESS")
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None:
        raise ValueError("num_processes without a coordinator address: set "
                         "MFM_COORDINATOR_ADDRESS or pass one")
    world = int(num_processes if num_processes is not None
                else os.environ.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None
               else os.environ.get("RANK", 0))
    dev = resolve_device(device)
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist = _dist()
    if dev.type == "cuda":
        import torch

        torch.cuda.set_device(rank % torch.cuda.device_count())
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=url, world_size=world, rank=rank,
                            **kw)
    return dist.get_world_size() > 1


def make_global_mesh(n_stock: int = 1, device=None):
    """('date', 'stock') mesh over every process's devices.

    Each process contributes its :func:`mfm_tpu_torch._device.mesh_devices`
    (every process the same count), numbered contiguously by rank, so the
    stock axis stays within one process by construction: n_stock must
    divide the global device count and fit in one process's devices.
    """
    from mfm_tpu_torch.parallel.mesh import Mesh

    local = mesh_devices(device)
    world, rank = _world()
    total = world * len(local)
    if total % n_stock:
        raise ValueError(f"{n_stock=} must divide device count {total}")
    if n_stock > len(local):
        raise ValueError(
            f"stock axis ({n_stock}) must fit within one host's "
            f"{len(local)} devices so its collectives stay in one process")
    devs = np.empty(total, dtype=object)
    devs[:] = [d for _ in range(world) for d in local]
    ranks = np.repeat(np.arange(world), len(local))
    shape = (total // n_stock, n_stock)
    return Mesh(devs.reshape(shape), ("date", "stock"),
                ranks=ranks.reshape(shape), rank=rank)


def process_date_slice(T: int) -> slice:
    """The dates this process should load (data-parallel ingestion): the
    contiguous block partition of [0, T) over the processes."""
    n, p = _world()
    chunk = -(-T // n)
    return slice(p * chunk, min(T, (p + 1) * chunk))
