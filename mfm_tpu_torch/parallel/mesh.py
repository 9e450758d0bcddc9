"""Mesh and sharding layout for the risk pipeline (counterpart of
``mfm_tpu/parallel/mesh.py``).

Layout doctrine, the reference's:

- mesh axes ``('date', 'stock')``;
- (T, N) panels shard as ``P('date', 'stock')``;
- the cross-sectional regression is parallel over dates, and its
  stock-axis reductions (normal equations, per-industry cap sums, masked
  means and stds, guard coverage counts) run shard-local after ONE gather
  of the stock axis at stage entry (:func:`constrain_cross_section`), in
  the unsharded summation order, so a sharded run is bitwise the
  single-device one;
- factor-return series and K x K covariances are tiny: replicated;
- rolling kernels are parallel along 'stock' and windowed along time:
  ``P(None, ('date', 'stock'))`` (``shard_panel(..., rolling=True)``).

Eager PyTorch has no partitioner, so the layout is explicit.  A
:class:`ShardedPanel` is a global shape, a :class:`NamedSharding` (mesh
and :class:`PartitionSpec`) and one tensor per mesh position of this
process, on that position's device.  Work runs on the shards through
:func:`map_shards`, and data moves between shards only through the three
collectives of this module, each of which keeps bits:

- :func:`all_gather_stock`: the stock-axis gather at stage entry
  (``torch.cat`` of a date row's blocks; the stock axis never leaves a
  process, :func:`mfm_tpu_torch.parallel.distributed.make_global_mesh`);
- :func:`gather`: every block to the mesh's first device (``torch.cat`` /
  ``.to`` in one process; across processes
  ``torch.distributed.all_gather_into_tensor``);
- :func:`replicate`: one tensor to every shard (``.to``; across processes
  a ``broadcast`` from the first position's rank first).

Each of the three tells the IR audit's probes (:data:`_PROBES`,
``analysis/collectives.py``) the bytes it moved, when one listens.

In one process a replicated value is computed once, on the mesh's first
device; across processes each rank holds its own copy.  A mesh whose
devices repeat (:data:`mfm_tpu_torch._device.VIRTUAL_DEVICES_ENV`) is
*virtual*: its shards are separate tensors on one device, computed one
after another.  It proves the sharded path and its bits, not a speed-up.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Sequence

import numpy as np
import torch

from mfm_tpu_torch._device import VIRTUAL_DEVICES_ENV, mesh_devices

AXES = ("date", "stock")


class PartitionSpec(tuple):
    """One entry per array dimension: None (not sharded), a mesh axis name,
    or a tuple of axis names (the dimension split over their product,
    the first axis outermost).  Missing trailing entries are None."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class Mesh:
    """A ('date', 'stock') grid of devices.

    ``devices`` is an (n_date, n_stock) object array of ``torch.device``;
    ``ranks`` the process rank owning each position (all this process's
    ``rank`` when None).  A position is *local* when this process owns it.
    """

    def __init__(self, devices, axis_names: Sequence[str], *, ranks=None,
                 rank: int = 0):
        src = np.asarray(devices, dtype=object)
        devs = np.empty(src.shape, dtype=object)
        for idx in np.ndindex(src.shape):
            devs[idx] = torch.device(src[idx])
        if devs.ndim != 2 or tuple(axis_names) != AXES:
            raise ValueError(f"a mesh is a 2-D grid over {AXES}, got shape "
                             f"{devs.shape} and axes {tuple(axis_names)}")
        self.devices = devs
        self.axis_names = tuple(axis_names)
        self.rank = int(rank)
        self.ranks = (np.full(devs.shape, self.rank, dtype=int)
                      if ranks is None else np.asarray(ranks, dtype=int))
        if self.ranks.shape != devs.shape:
            raise ValueError("ranks must have the devices' shape")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def positions(self) -> list:
        """Every (date, stock) position, row-major."""
        return list(np.ndindex(self.devices.shape))

    @property
    def local_positions(self) -> list:
        return [p for p in self.positions if self.ranks[p] == self.rank]

    @property
    def process_count(self) -> int:
        return len(set(self.ranks.flat))

    @property
    def first_device(self) -> torch.device:
        """Where replicated values live in this process: the device of its
        first position."""
        return self.devices[self.local_positions[0]]

    @property
    def virtual(self) -> bool:
        """True when two positions share one device of one process."""
        seen = {(int(r), str(d)) for r, d in zip(self.ranks.flat,
                                                  self.devices.flat)}
        return len(seen) < self.size

    def describe(self) -> dict:
        """What a record of this mesh states: its shape, whether it is
        virtual, its devices and processes."""
        nd, ns = self.devices.shape
        return {"mesh": f"{nd}x{ns}", "virtual": self.virtual,
                "devices": [str(d) for d in self.devices.flat],
                "processes": self.process_count}

    def __repr__(self):
        return (f"Mesh({dict(self.shape)}, virtual={self.virtual}, "
                f"devices={[str(d) for d in self.devices.flat]})")


class NamedSharding:
    """A mesh and a :class:`PartitionSpec`."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        for entry in spec:
            for a in _axes(entry):
                if a not in mesh.axis_names:
                    raise ValueError(f"{spec} names axis {a!r}, not one of "
                                     f"the mesh's {mesh.axis_names}")
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


_AMBIENT: contextvars.ContextVar = contextvars.ContextVar(
    "mfm_tpu_torch_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """The ambient mesh for the block: a context-local setting, so threads
    and tasks each see their own."""
    token = _AMBIENT.set(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.reset(token)


def _ambient_mesh() -> Mesh | None:
    """The mesh set by :func:`use_mesh`, if any."""
    return _AMBIENT.get()


def make_mesh(n_date: int | None = None, n_stock: int = 1,
              devices: Sequence | None = None, device=None) -> Mesh:
    """Build a ('date', 'stock') mesh over the first n_date * n_stock of
    ``devices`` (default :func:`mfm_tpu_torch._device.mesh_devices` of
    ``device``: the card unless the caller asks for the CPU).

    Default: all devices on the 'date' axis (the cross-sectional stage is
    the dominant cost and is parallel over dates).  Too few devices
    raise, naming the virtual-device variable.
    """
    devs = list(devices) if devices is not None else mesh_devices(device)
    if n_date is None:
        n_date = len(devs) // n_stock
    need = n_date * n_stock
    if n_date < 1 or n_stock < 1:
        raise ValueError(f"a mesh needs at least one shard per axis, got "
                         f"{n_date}x{n_stock}")
    if need > len(devs):
        raise ValueError(
            f"a {n_date}x{n_stock} mesh needs {need} devices but only "
            f"{len(devs)} are up — set {VIRTUAL_DEVICES_ENV}={need} for a "
            "virtual mesh")
    grid = np.empty(need, dtype=object)
    grid[:] = devs[:need]
    return Mesh(grid.reshape(n_date, n_stock), ("date", "stock"))


def panel_sharding(mesh: Mesh, *, rolling: bool = False) -> NamedSharding:
    """Sharding for a (T, N, ...) panel: date axis over 'date' and stock
    axis over 'stock'; ``rolling``: time local, stocks over the whole
    mesh."""
    if rolling:
        return NamedSharding(mesh, P(None, ("date", "stock")))
    return NamedSharding(mesh, P("date", "stock"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


# -- block geometry ------------------------------------------------------------

def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _full_spec(spec, ndim: int) -> tuple:
    if len(spec) > ndim:
        raise ValueError(f"{spec} has more entries than {ndim} dimensions")
    return tuple(spec) + (None,) * (ndim - len(spec))


def _n_blocks(mesh: Mesh, spec, ndim: int) -> tuple:
    return tuple(int(np.prod([mesh.shape[a] for a in _axes(e)]))
                 for e in _full_spec(spec, ndim))


def _block_of(mesh: Mesh, spec, ndim: int, pos) -> tuple:
    """The block index, per dimension, that position ``pos`` holds."""
    coord = dict(zip(mesh.axis_names, pos))
    key = []
    for e in _full_spec(spec, ndim):
        i = 0
        for a in _axes(e):
            i = i * mesh.shape[a] + coord[a]
        key.append(i)
    return tuple(key)


def shard_region(shape, sharding: NamedSharding, pos) -> tuple:
    """The slices of a global array of ``shape`` that mesh position
    ``pos`` holds under ``sharding``."""
    return _region(shape, sharding.mesh, sharding.spec, pos)


def _region(shape, mesh: Mesh, spec, pos) -> tuple:
    """The slices of the global array that position ``pos`` holds; every
    sharded dimension must divide its axes' product (as ``device_put``
    requires)."""
    nb = _n_blocks(mesh, spec, len(shape))
    for d, (n, b) in enumerate(zip(shape, nb)):
        if n % b:
            raise ValueError(
                f"dimension {d} of size {n} does not divide the {b} shards "
                f"of {spec} — pad it first (pad_to_mesh)")
    key = _block_of(mesh, spec, len(shape), pos)
    return tuple(slice(k * (n // b), (k + 1) * (n // b))
                 for k, n, b in zip(key, shape, nb))


class ShardedPanel:
    """A global (T, N, ...) array laid out over a mesh: its ``shape``, its
    ``sharding`` and ``shards``, one tensor per local mesh position on
    that position's device (positions holding the same block on one
    device share one tensor)."""

    def __init__(self, shape, sharding: NamedSharding, shards: dict,
                 dtype: torch.dtype):
        self.shape = torch.Size(shape)
        self.sharding = sharding
        self.shards = shards
        self.dtype = dtype

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    @property
    def spec(self) -> PartitionSpec:
        return self.sharding.spec

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def device(self) -> torch.device:
        return self.mesh.first_device

    def __repr__(self):
        return (f"ShardedPanel(shape={tuple(self.shape)}, dtype={self.dtype}"
                f", spec={self.spec!r}, mesh={dict(self.mesh.shape)})")


def _tree_map(fn, x):
    if isinstance(x, tuple) and not hasattr(x, "_fields"):
        return tuple(_tree_map(fn, v) for v in x)
    if isinstance(x, list):
        return [_tree_map(fn, v) for v in x]
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    return None if x is None else fn(x)


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x))
    return torch.as_tensor(x)


def device_put(x, sharding: NamedSharding):
    """Lay a tensor or numpy array (or a tuple/list/dict of them) out over
    ``sharding``: each local position gets its block, contiguous, on its
    device.  A :class:`ShardedPanel` under another sharding is gathered and
    laid out again."""
    def lay_out(a):
        if isinstance(a, ShardedPanel):
            if a.mesh is sharding.mesh and a.spec == sharding.spec:
                return a
            a = gather(a)
        a = _as_tensor(a)
        return make_sharded(a.shape, sharding, lambda region: a[region])

    return _tree_map(lay_out, x)


def make_sharded(shape, sharding: NamedSharding, callback,
                 dtype: torch.dtype | None = None) -> ShardedPanel:
    """``jax.make_array_from_callback``: ``callback(index)`` (a tuple of
    slices of the global shape) gives each local position's block, which
    goes straight to that position's device, contiguous; positions holding
    the same block on one device share one tensor, and no global array is
    built."""
    mesh = sharding.mesh
    shards, made = {}, {}
    for pos in mesh.local_positions:
        region = _region(shape, mesh, sharding.spec, pos)
        key = (tuple((s.start, s.stop) for s in region),
               str(mesh.devices[pos]))
        if key not in made:
            blk = _as_tensor(callback(region))
            made[key] = blk.to(mesh.devices[pos], dtype).contiguous()
        shards[pos] = made[key]
    first = next(iter(shards.values()))
    return ShardedPanel(shape, sharding, shards, first.dtype)


def pad_to_mesh(x, mesh: Mesh, *, fill=0, rolling: bool = False):
    """Pad a (T, N, ...) array's sharded axes up to mesh-divisible sizes
    (a torch tensor or a numpy array; the result is of the same kind).

    The framework's masked design makes padding inert: pad ``valid`` /
    observed masks with False and data with ``fill`` (0 for risk-stage
    arrays, NaN for FactorEngine fields).  Time padding appends AFTER the
    last date, so every causal stage leaves the real dates' outputs
    unchanged; crop with ``[:T]`` / ``[:, :N]``.  Bool arrays always pad
    False whatever ``fill`` is.
    """
    n_date, n_stock = mesh.shape["date"], mesh.shape["stock"]
    if rolling:
        pads = {1: n_date * n_stock} if x.ndim > 1 else {}
    else:
        pads = {0: n_date}
        if x.ndim > 1:
            pads[1] = n_stock
    widths = [(0, 0)] * x.ndim
    for ax, div in pads.items():
        widths[ax] = (0, (-x.shape[ax]) % div)
    if not any(w[1] for w in widths):
        return x
    is_bool = x.dtype == (torch.bool if isinstance(x, torch.Tensor)
                          else np.bool_)
    v = False if is_bool else fill
    if isinstance(x, np.ndarray):
        return np.pad(x, widths, constant_values=v)
    out = torch.full([n + w[1] for n, w in zip(x.shape, widths)], v,
                     dtype=x.dtype, device=x.device)
    out[tuple(slice(0, n) for n in x.shape)] = x
    return out


def shard_panel(x, mesh: Mesh, *, rolling: bool = False):
    """:func:`device_put` a (T, N, ...) array (or a tuple/list/dict of
    them) onto the mesh in the panel layout."""
    return device_put(x, panel_sharding(mesh, rolling=rolling))


# -- the collectives -----------------------------------------------------------

#: the IR audit's collective probes (``analysis/collectives.py``): each is
#: called with ``(kind, nbytes, result)`` by every collective below that
#: moves data, while it is registered.  ``kind`` is the name of the XLA
#: collective that does the same (all three are ``"all-gather"``: every
#: position that receives data ends holding a whole axis or array),
#: ``nbytes`` the bytes of the result one position holds.
_PROBES: list = []


def _note_collective(result, nbytes: int) -> None:
    for fn in list(_PROBES):
        fn("all-gather", int(nbytes), result)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _distributed():
    import torch.distributed as dist

    return dist


def all_gather_stock(x: ShardedPanel) -> ShardedPanel:
    """The stock-axis gather at stage entry: the dimension sharded over
    'stock' alone becomes whole on every position of its date row, by
    ``torch.cat`` of the row's blocks in stock order.  The stock axis
    never spans processes, so this stays in the process."""
    spec = _full_spec(x.spec, x.ndim)
    dims = [d for d, e in enumerate(spec) if "stock" in _axes(e)]
    if not dims:
        return x
    d = dims[0]
    if spec[d] != "stock":
        raise ValueError(f"all_gather_stock gathers a dimension sharded over "
                         f"'stock' alone, got {x.spec}")
    mesh = x.mesh
    ns = mesh.shape["stock"]
    new = NamedSharding(mesh, P(*(None if i == d else e
                                  for i, e in enumerate(spec))))
    out, rows = {}, {}
    for pos in mesh.local_positions:
        i = pos[0]
        if any(mesh.ranks[i, j] != mesh.rank for j in range(ns)):
            raise ValueError("the stock axis spans processes; build the mesh "
                             "with make_global_mesh")
        dev = mesh.devices[pos]
        key = (i, str(dev))
        if key not in rows:
            blocks = [x.shards[(i, j)].to(dev) for j in range(ns)]
            rows[key] = blocks[0] if ns == 1 else torch.cat(blocks, dim=d)
        out[pos] = rows[key]
    res = ShardedPanel(x.shape, new, out, x.dtype)
    if _PROBES and ns > 1:
        _note_collective(res, max(_nbytes(t) for t in out.values()))
    return res


def _assemble(blocks: dict, nb: tuple, d: int = 0) -> torch.Tensor:
    if d == len(nb):
        return blocks[()]
    parts = [_assemble({k[1:]: v for k, v in blocks.items() if k[0] == b},
                       nb, d + 1) for b in range(nb[d])]
    return parts[0] if nb[d] == 1 else torch.cat(parts, dim=d)


def _gather_across(x: ShardedPanel, have: dict, nb: tuple) -> dict:
    """Every block of ``x`` from every process: each block's owner (the
    rank of the first position holding it) sends it through one
    ``all_gather_into_tensor`` of the owners' stacked blocks."""
    dist = _distributed()
    mesh = x.mesh
    owner = {}
    for pos in mesh.positions:
        owner.setdefault(_block_of(mesh, x.spec, x.ndim, pos),
                         int(mesh.ranks[pos]))
    world = sorted(set(owner.values()) | {int(r) for r in mesh.ranks.flat})
    owned = {r: sorted(k for k, o in owner.items() if o == r) for r in world}
    n = len(owned[mesh.rank])
    if any(len(v) != n for v in owned.values()):
        raise ValueError(f"{x.spec} gives the processes unequal numbers of "
                         "blocks; the gather needs equal ones")
    mine = torch.stack([have[k] for k in owned[mesh.rank]])
    wire = mine.to(torch.uint8) if mine.dtype == torch.bool else mine
    out = torch.empty((len(world) * n,) + tuple(wire.shape[1:]),
                      dtype=wire.dtype, device=wire.device)
    fn = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    fn(out, wire.contiguous())
    if mine.dtype == torch.bool:
        out = out.to(torch.bool)
    blocks = {}
    for ri, r in enumerate(world):
        for bi, k in enumerate(owned[r]):
            blocks[k] = out[ri * n + bi]
    return blocks


def gather(x: ShardedPanel) -> torch.Tensor:
    """Every block of ``x`` to the mesh's first device, assembled into the
    global array (``torch.cat`` in one process; across processes each
    block comes through ``all_gather_into_tensor``)."""
    mesh = x.mesh
    nb = _n_blocks(mesh, x.spec, x.ndim)
    have = {}
    for pos in mesh.local_positions:
        have.setdefault(_block_of(mesh, x.spec, x.ndim, pos), x.shards[pos])
    if len(have) < int(np.prod(nb)):
        have = _gather_across(x, have, nb)
    dev = mesh.first_device
    res = _assemble({k: v.to(dev) for k, v in have.items()}, nb)
    if _PROBES and int(np.prod(nb)) > 1:
        _note_collective(res, _nbytes(res))
    return res


def replicate(x, mesh: Mesh) -> ShardedPanel:
    """One tensor on every position (``P()``): copied to each local
    device; across processes the first position's rank broadcasts it
    first, so every process holds its bits."""
    x = _as_tensor(x)
    if mesh.process_count > 1:
        dist = _distributed()
        x = x.to(mesh.first_device).contiguous().clone()
        wire = x.to(torch.uint8) if x.dtype == torch.bool else x
        dist.broadcast(wire, src=int(mesh.ranks[0, 0]))
        x = wire.to(torch.bool) if x.dtype == torch.bool else wire
    res = device_put(x, replicated(mesh))
    if _PROBES and mesh.size > 1:
        _note_collective(res, _nbytes(x))
    return res


# -- computing on the shards -----------------------------------------------------

def map_shards(fn, *args, out_specs):
    """``fn`` on every local position, on that position's shards of the
    :class:`ShardedPanel` arguments (other arguments pass as they are),
    one position after another.  Positions whose sharded inputs are the
    same tensors on the same device (a date row of stock-local panels on
    a virtual mesh) compute once and share the result.  ``out_specs``:
    the :class:`PartitionSpec` of ``fn``'s tensor result, or a tuple of
    them for a tuple result (one spec for a tuple result is every
    element's); global shapes follow from the blocks."""
    mesh = next(a.mesh for a in args if isinstance(a, ShardedPanel))
    multi = isinstance(out_specs, tuple) and not isinstance(
        out_specs, PartitionSpec)
    results, done = {}, {}
    for pos in mesh.local_positions:
        key = (str(mesh.devices[pos]),) + tuple(
            id(a.shards[pos]) for a in args if isinstance(a, ShardedPanel))
        if key not in done:
            r = fn(*(a.shards[pos] if isinstance(a, ShardedPanel) else a
                     for a in args))
            done[key] = tuple(r) if isinstance(r, (tuple, list)) else (r,)
        results[pos] = done[key]
    n_out = len(next(iter(results.values())))
    specs = out_specs if multi else (out_specs,) * n_out
    multi = multi or n_out > 1
    out = []
    pos0 = mesh.local_positions[0]
    for i, spec in enumerate(specs):
        blk = results[pos0][i]
        nb = _n_blocks(mesh, spec, blk.ndim)
        shape = [b * n for b, n in zip(nb, blk.shape)]
        out.append(ShardedPanel(shape, NamedSharding(mesh, spec),
                                {p: r[i] for p, r in results.items()},
                                blk.dtype))
    return tuple(out) if multi else out[0]


def constrain_cross_section(*panels):
    """Pin (T, N, ...) panels to the date-parallel, stock-LOCAL layout
    ``P('date', None, ...)`` of the ambient mesh; no-op when no mesh is
    ambient.

    This is the bitwise doctrine: a reduction over a sharded axis becomes
    partial sums and a combine, which reorders the floating-point
    accumulation.  Gathering the stock axis once at stage entry
    (:func:`all_gather_stock`) keeps every cross-sectional reduction
    shard-local and in the unsharded summation order, while the date axis
    still spreads the per-date work over the mesh.  A tensor or a panel
    in another layout is laid out afresh (its dates must divide the
    mesh's date axis).
    """
    m = _ambient_mesh()
    if m is None:
        return panels
    out = []
    for x in panels:
        if x is None:
            out.append(None)
            continue
        spec = P("date", *([None] * (x.ndim - 1)))
        if isinstance(x, ShardedPanel) and x.mesh is m:
            full = _full_spec(x.spec, x.ndim)
            if full[0] == "date" and full[1] == "stock" \
                    and not any(full[2:]):
                x = all_gather_stock(x)
            if _full_spec(x.spec, x.ndim) == _full_spec(spec, x.ndim):
                out.append(x)
                continue
        out.append(device_put(x, NamedSharding(m, spec)))
    return tuple(out)


def replicate_under_mesh(x):
    """A tuple/list/dict of small arrays in the replicated layout: each
    :class:`ShardedPanel` gathered to the mesh's first device, tensors
    as they are (where this process computes replicated stages)."""
    return _tree_map(lambda a: gather(a) if isinstance(a, ShardedPanel)
                     else a, x)


# canonical layouts of the risk-model stages' inputs, by argument name
PIPELINE_SPECS = {
    "ret": P("date", "stock"),
    "cap": P("date", "stock"),
    "styles": P("date", "stock", None),
    "industry": P("date", "stock"),
    "valid": P("date", "stock"),
    "factor_ret": P("date", None),
    "covs": P("date", None, None),
    "sim_covs": P(),
}
