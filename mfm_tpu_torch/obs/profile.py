"""Device profiling: measured cost, memory and compile walls of one run
(counterpart of ``mfm_tpu/obs/profile.py``).

The reference asks XLA what a compiled program does without running it.
Eager torch compiles no program, so each probe here runs the call once
and counts:

- :func:`compiled_cost` — ``{"flops": ...}``: the total of
  ``torch.utils.flop_counter.FlopCounterMode`` over the run (aten matmuls,
  convolutions, attention) plus each hand-written kernel launch's own
  operation count, :func:`kernel_flops` over the ``(B, n, sweeps)`` of
  every launch ``ops/eigh_cuda`` recorded (the kernels are ctypes calls,
  which ``FlopCounterMode`` never sees).  No figure of bytes accessed
  exists, so that key is left out, as the reference leaves out a key its
  cost analysis has no figure for.
- :func:`compiled_memory_of` — :func:`mfm_tpu_torch.utils.obs.
  compiled_memory`'s fields, off the same run.
- :func:`capture_compile_walls` — a scoped listener on the compile-contract
  events (:mod:`mfm_tpu_torch.utils.contracts`) collecting the wall of
  each kernel build and load into ``mfm_jit_compile_seconds``.  An empty
  capture means every kernel was already loaded: ``compile_wall_s`` None,
  not 0.

:func:`executable_profile` bundles the three, and ``source`` says whether
the cost was counted ("flop_counter") or is missing ("static_model").
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

from mfm_tpu_torch.obs.instrument import JIT_COMPILE_SECONDS
from mfm_tpu_torch.utils import contracts

#: the events whose wall is a build or load (a signature event has none)
_WALL_EVENTS = (contracts.KERNEL_BUILD_EVENT, contracts.KERNEL_LOAD_EVENT)


def kernel_flops(kernel: str, B: int, n: int, sweeps: int) -> float:
    """Operations of one launch of a Jacobi eigh kernel on ``B`` n x n
    matrices over ``sweeps`` sweeps of n - 1 rounds: 9 n^2 a matrix a
    round, plus 3 n^2 a matrix for the weighted kernel's h (the count of
    ``chip_smoke.py``'s bound)."""
    ops = sweeps * (n - 1) * 9 * n * n * B
    if kernel == "jacobi_eigh_weighted":
        ops += 3 * n * n * B
    return float(ops)


def _launch_flops(before: dict, after: dict) -> float:
    total = 0.0
    for kernel, shapes in after.items():
        for (B, n, sweeps), count in shapes.items():
            new = count - before.get(kernel, {}).get((B, n, sweeps), 0)
            total += new * kernel_flops(kernel, B, n, sweeps)
    return total


@dataclasses.dataclass
class CompiledRun:
    """One measured run of a call: what :func:`compile_fn` returns in the
    place of the reference's compiled executable."""

    out: object
    flops: float
    kernel_flops: float
    memory: dict
    events: list


def compile_fn(fn: Callable, *args) -> CompiledRun:
    """Run ``fn(*args)`` once under :func:`contracts.count_compiles`,
    counting its operations and measuring its memory — the one run every
    probe below reads."""
    from torch.utils.flop_counter import FlopCounterMode

    from mfm_tpu_torch.ops.eigh_cuda import launch_shapes
    from mfm_tpu_torch.utils.obs import measured_call

    before = launch_shapes()
    with contracts.count_compiles() as counter, \
            FlopCounterMode(display=False) as flop_mode:
        out, memory = measured_call(fn, *args)
    kflops = _launch_flops(before, launch_shapes())
    return CompiledRun(out, float(flop_mode.get_total_flops()) + kflops,
                       kflops, memory, list(counter.events))


def cost_of(compiled: CompiledRun) -> dict | None:
    """:func:`compiled_cost` off a :func:`compile_fn` run."""
    flops = compiled.flops
    if flops != flops or flops < 0:
        return None
    return {"flops": float(flops)}


def compiled_cost(fn: Callable, *args) -> dict | None:
    """Counted flops of one run of ``fn(*args)``."""
    return cost_of(compile_fn(fn, *args))


def compiled_memory_of(compiled: CompiledRun) -> dict:
    """The memory fields of a :func:`compile_fn` run (field-compatible with
    ``utils.obs.compiled_memory``)."""
    return dict(compiled.memory)


@contextlib.contextmanager
def capture_compile_walls():
    """Scoped compile-wall capture: registers a listener on the
    compile-contract events, yields a list that accumulates each kernel
    build's and load's wall seconds (also observed into
    ``mfm_jit_compile_seconds``), and unregisters on exit.

    An empty list after the block means every kernel library was already
    loaded — record ``compile_wall_s: None``, not 0.
    """
    walls: list[float] = []

    def _listener(event: str, detail: str = "", seconds=None) -> None:
        if event in _WALL_EVENTS and seconds is not None:
            walls.append(float(seconds))
            JIT_COMPILE_SECONDS.observe(float(seconds))

    contracts._LISTENERS.append(_listener)
    try:
        yield walls
    finally:
        contracts._LISTENERS.remove(_listener)


def executable_profile(fn: Callable, *args) -> dict:
    """One run, every probe: counted cost + measured memory + compile
    wall, with ``source`` tagging whether the cost was counted.

    ``compile_wall_s`` is the summed build and load wall of this call;
    None when every kernel it launched was already loaded.
    """
    with capture_compile_walls() as walls:
        compiled = compile_fn(fn, *args)
    cost = cost_of(compiled)
    return {
        "cost": cost,
        "memory": compiled_memory_of(compiled),
        "compile_wall_s": (round(sum(walls), 4) if walls else None),
        "source": ("flop_counter" if cost else "static_model"),
    }
