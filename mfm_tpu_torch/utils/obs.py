"""Observability helpers: structured logging, stage timing, determinism
checks and memory measurement (counterpart of ``mfm_tpu/utils/obs.py``).

- :func:`log` — structured JSON-lines logging with levels, a shim over
  the :mod:`mfm_tpu_torch.obs.exporters` event stream.
- :func:`force` — wait for the card's work on a tree of tensors (PyTorch
  returns before the device finishes, so a host clock without it measures
  the enqueue).
- :func:`determinism_check` — runs a function twice and compares the
  results bitwise; the batch job's stand-in for a race detector (same
  seed => bitwise-equal outputs).
- :func:`compiled_memory` — the memory one call of a function needs: its
  arguments, outputs, the outputs that alias an argument and, on the card,
  the transient peak above them.
"""

from __future__ import annotations

from typing import Callable

import torch

_BITS = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def set_log_level(level: str) -> None:
    from mfm_tpu_torch.obs.exporters import default_event_log

    default_event_log().set_level(level)


def log(level: str, event: str, **fields) -> None:
    """Structured JSONL event (stderr by default; a CLI run with
    ``--metrics-dir`` routes the same stream to ``events.jsonl``)."""
    from mfm_tpu_torch.obs.exporters import emit_event

    emit_event(level, event, **fields)


def _leaves(tree) -> list:
    """The tensors of a tree of tuples (NamedTuples too), lists and
    dicts, in order; other leaves are dropped."""
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [x for sub in tree for x in _leaves(sub)]
    return []


def force(tree) -> float:
    """Wait for every tensor of ``tree`` on its device; return the summed
    checksum of the finite entries of its floating tensors (useful for
    timing and smoke assertions)."""
    leaves = _leaves(tree)
    for dev in {x.device for x in leaves if x.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    floats = [x for x in leaves if x.is_floating_point()]
    total = sum(float(torch.where(torch.isfinite(x), x,
                                  torch.zeros((), dtype=x.dtype,
                                              device=x.device)).sum())
                for x in floats)
    return float(total)


def _same(x: torch.Tensor, y: torch.Tensor, atol: float) -> bool:
    if x.shape != y.shape or x.dtype != y.dtype:
        return False
    if atol == 0.0:
        if x.is_floating_point() or x.is_complex():
            # bitwise: the bit patterns, so NaN equals the same NaN
            bits = _BITS[x.element_size()]
            return torch.equal(x.contiguous().view(bits),
                               y.contiguous().view(bits))
        return torch.equal(x, y)
    return torch.allclose(x, y, rtol=0.0, atol=atol, equal_nan=True)


def determinism_check(fn: Callable, *args, atol: float = 0.0) -> bool:
    """Run ``fn`` twice; True iff its tensors agree within ``atol`` (0 =
    bitwise, ``torch.equal`` of the bit patterns).

    With seeded ``torch.Generator`` draws and no data races there is no
    legitimate source of run-to-run divergence — this is the framework's
    sanitizer.
    """
    a = _leaves(fn(*args))
    b = _leaves(fn(*args))
    return len(a) == len(b) and all(_same(x, y, atol) for x, y in zip(a, b))


def _unique_bytes(tensors) -> tuple[int, set]:
    """Summed bytes of ``tensors`` (each tensor once) and the data
    pointers of their storages."""
    seen, total, ptrs = set(), 0, set()
    for t in tensors:
        if id(t) in seen:
            continue
        seen.add(id(t))
        total += t.numel() * t.element_size()
        ptrs.add(t.untyped_storage().data_ptr())
    return total, ptrs


def measured_call(fn: Callable, *args) -> tuple:
    """``(fn(*args), memory fields)`` of one call: :func:`compiled_memory`
    with the call's output kept."""
    leaves_in = _leaves(args)
    arg_bytes, arg_ptrs = _unique_bytes(leaves_in)
    devices = {x.device for x in leaves_in if x.device.type == "cuda"}
    on_card = bool(devices)
    if on_card:
        for dev in devices:
            torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    out = fn(*args)
    leaves_out = _leaves(out)
    out_bytes, _ = _unique_bytes(leaves_out)
    alias, _ = _unique_bytes(
        [t for t in leaves_out
         if t.untyped_storage().data_ptr() in arg_ptrs])
    mem = {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
           "alias_bytes": alias, "generated_code_bytes": 0}
    if on_card:
        for dev in devices:
            torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated()
        temp = max(0, peak - base - (out_bytes - alias))
        mem["temp_bytes"] = temp
        # aliased bytes live in the argument total; don't double-count them
        mem["peak_bytes"] = temp + arg_bytes + out_bytes - alias
    return out, mem


def compiled_memory(fn: Callable, *args) -> dict:
    """Memory breakdown of one call of ``fn`` on ``args``, in bytes, with
    the reference's field names.

    The reference reads XLA's buffer-assignment totals without running
    anything.  Eager torch has no compiled program, so this runs ``fn``
    once and measures: ``argument_bytes`` and ``output_bytes`` are the
    tensor leaves' bytes, ``alias_bytes`` the outputs that share storage
    with an argument, and ``generated_code_bytes`` 0 (no code is
    generated).  On the card (a CUDA tensor among the arguments)
    ``temp_bytes`` is the peak of
    ``torch.cuda.max_memory_allocated`` over the call above what was
    allocated before it, less the outputs — the transient high-water mark
    — and ``peak_bytes`` adds the argument and output residency, by the
    reference's formula.  The CPU keeps no allocation peak, so there the
    two are left out, as the reference returns no field where no analysis
    exists.
    """
    return measured_call(fn, *args)[1]
