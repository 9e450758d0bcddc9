"""Device traces of one call, read from ``torch.profiler``'s events as
recorded (``kineto_results``), never through ``key_averages``' event tree
(about 25 s at a rebuild's ~84,000 kernels).

:func:`device_trace` traces the device alone, the lightest tracer: the
device's operations (kernels, copies, fills), their count, the union of
their intervals (busy time) and the call's wall (the traced window).
:func:`idle_by_host` traces the host's operators too and splits each idle
gap of the device by the top-level host operator that ran during it
(``python`` where none did).
"""

from __future__ import annotations

import bisect
import time


def _profile(fn, device, host: bool):
    import torch
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CUDA] if on_card else []
    if host or not on_card:
        acts.append(ProfilerActivity.CPU)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, wall, list(prof.profiler.kineto_results.events())


def _span(e) -> tuple:
    start = e.start_ns()
    end = getattr(e, "end_ns", None)
    return start, (end() if end is not None else start + e.duration_ns())


def _device_ops(events) -> list:
    from torch.autograd import DeviceType

    return [e for e in events if e.device_type() == DeviceType.CUDA
            and not e.is_async()]


def _is_kernel(name: str) -> bool:
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


def _union(spans: list) -> list:
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1] = b
        else:
            merged.append([a, b])
    return merged


def device_trace(fn, device, top: int = 10) -> tuple:
    """``fn()`` traced on the device: ``(fn's result, record)`` with the
    record's ``window_s`` (the call's wall, synchronised), ``busy_s`` (the
    union of the device operations' intervals), ``kernels`` (kernel
    launches, copies and fills left out), ``device_s`` (the operations'
    summed durations) and ``device_ops`` (the ``top`` names by summed
    time, ``[name, seconds]``)."""
    out, wall, events = _profile(fn, device, host=False)
    ops = _device_ops(events)
    spans = [_span(e) for e in ops]
    by_name: dict = {}
    for e, (a, b) in zip(ops, spans):
        by_name[e.name()] = by_name.get(e.name(), 0) + (b - a)
    rows = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)
    busy = sum(b - a for a, b in _union(spans)) / 1e9
    return out, {
        "window_s": wall,
        "busy_s": busy,
        "kernels": sum(1 for e in ops if _is_kernel(e.name())),
        "device_ops_n": len(ops),
        "device_s": sum(b - a for a, b in spans) / 1e9,
        "device_ops": [[name[:120], ns / 1e9] for name, ns in rows[:top]],
    }


def _top_level(host: list) -> list:
    """The outermost host operators of one thread, as (start, end, name),
    sorted and disjoint."""
    out = []
    for a, b, name in sorted(host):
        if out and a < out[-1][1]:
            continue
        out.append((a, b, name))
    return out


def idle_by_host(fn, device, top: int = 10) -> tuple:
    """``fn()`` traced on the device and the host: ``(fn's result,
    [[label, seconds], ...])``, the device's idle time inside its first to
    last operation split by the top-level host operator running meanwhile
    (``python`` where the host ran none), the ``top`` labels by time."""
    from torch.autograd import DeviceType

    out, _, events = _profile(fn, device, host=True)
    dev = _union([_span(e) for e in _device_ops(events)])
    threads: dict = {}
    for e in events:
        if e.device_type() == DeviceType.CPU and not e.is_async() \
                and e.name().startswith("aten::"):
            a, b = _span(e)
            threads.setdefault(e.start_thread_id(), []).append(
                (a, b, e.name()))
    host = _top_level(max(threads.values(), key=len)) if threads else []
    starts = [a for a, _, _ in host]
    idle: dict = {}
    for (_, g0), (g1, _) in zip(dev, dev[1:]):
        covered = 0
        i = max(0, bisect.bisect_right(starts, g0) - 1)
        while i < len(host) and host[i][0] < g1:
            a, b, name = host[i]
            part = min(b, g1) - max(a, g0)
            if part > 0:
                idle[name] = idle.get(name, 0) + part
                covered += part
            i += 1
        idle["python"] = idle.get("python", 0) + (g1 - g0 - covered)
    rows = sorted(idle.items(), key=lambda kv: kv[1], reverse=True)
    return out, [[name, ns / 1e9] for name, ns in rows[:top]]
