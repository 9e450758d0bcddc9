"""Observability helpers: structured logging, stage timing, determinism
checks and profiler spans (counterpart of ``mfm_tpu/utils/obs.py``).

- :func:`log` — structured JSON-lines logging with levels, a shim over
  the :mod:`mfm_tpu_torch.obs.exporters` event stream.
- :func:`force` — wait for the card's work on a tree of tensors (PyTorch
  returns before the device finishes, so a host clock without it measures
  the enqueue).
- :func:`determinism_check` — runs a function twice and compares the
  results bitwise; the batch job's stand-in for a race detector (same
  seed => bitwise-equal outputs).
- :func:`trace_annotation` — a named ``torch.profiler`` range.

The reference's ``compiled_memory`` reads XLA's buffer assignment, which
the port does not have (ROADMAP.md §A 16).
"""

from __future__ import annotations

import contextlib
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


@contextlib.contextmanager
def trace_annotation(name: str):
    """Named range visible in ``torch.profiler`` traces."""
    with torch.profiler.record_function(name):
        yield
