"""The device trace of one call split by the program's own stage spans
(``mfm_tpu_torch.obs.trace.stage``), on one clock.

The program's spans are timed on the host's ``perf_counter``;
``torch.profiler`` stamps host and device events on a clock of its own.
:func:`by_span` brackets a few host probe ops (``torch.empty(0)``) between
two ``perf_counter`` reads inside the profiled window, and takes the
offset from the narrowest bracket (``obs.trace.clock_offset_from_probe``:
the midpoint, half the bracket its uncertainty); the two clocks drift
apart by under 6e-7 over a call on the H100's host.  On that clock
:func:`assign` gives each device operation to the innermost span open
where the host launched it (the runtime call with the operation's
correlation id), so a kernel that runs after its span closed on the host
still counts to it, and each idle gap of the device to the span that
launched the operation ending it (``outside`` where none was open).  The
program puts nothing into the profiler's trace.
"""

from __future__ import annotations

import time

from mfmbench.tracing import _device_ops, _is_kernel, _span, _union

OUTSIDE = "outside"

#: host probe ops bracketed in each traced window (the narrowest sets the
#: offset; the others check it)
PROBES = 5


def probe_offset(brackets: list, probe_ns: list) -> tuple:
    """``(offset_ns, uncertainty_ns, misfit_ns)`` from probes, each
    ``(t0_s, t1_s)`` of ``perf_counter`` around one probe op and that op's
    start ``probe_ns`` on the profiler's clock: adding ``offset_ns`` to a
    ``perf_counter`` time in ns gives the profiler's, from the narrowest
    probe; ``misfit_ns`` is how far the farthest probe's offset lies from
    it beyond both uncertainties (0 where all agree; a probe matched to
    the wrong event reads far off)."""
    from mfm_tpu_torch.obs.trace import clock_offset_from_probe

    each = [clock_offset_from_probe(t0, t1, ns / 1e3)
            for (t0, t1), ns in zip(brackets, probe_ns)]
    offset, unc = min(each, key=lambda ou: ou[1])
    misfit = max(max(0.0, abs(o - offset) - u - unc) for o, u in each)
    return offset * 1e3, unc * 1e3, misfit * 1e3


def _is_runtime_call(name: str) -> bool:
    """A call of the CUDA runtime (``cudaLaunchKernel``,
    ``cudaMemcpyAsync``) or of its lower API (``cuLaunchKernel``): what a
    device operation's correlation id names.  The profiler's host operators carry
    correlation ids of another numbering, which collide with these."""
    return name.startswith("cuda") or (name.startswith("cu")
                                        and name[2:3].isupper())


def _innermost(spans: list, t: int) -> str:
    """The name of the innermost of ``spans`` (``(name, start, end)``,
    nested as one thread opens them) open at ``t``, else ``outside``."""
    open_ = [(a, -b, name) for name, a, b in spans if a <= t < b]
    return max(open_)[2] if open_ else OUTSIDE


def assign(ops: list, launches: dict, spans: list) -> dict:
    """Device work and idle time by program span (ns in, seconds out).

    ``ops``: the device's operations, ``(start, end, name,
    correlation_id)`` on the device's clock; ``launches``: correlation id
    -> the host's launch time; ``spans``: ``(name, start, end)`` on the
    host's clock.  Returns ``{label: {"ops", "kernels", "busy_s",
    "idle_s"}}`` over the spans' names and ``outside``: an operation counts
    to the innermost span open at its launch (``outside`` where none was,
    or no launch is known), ``busy_s`` is the union of its operations'
    intervals, and ``idle_s`` the device's idle time, first operation to
    last, before the operations it launched: the device waited on that
    launch.  Only launches are placed against the spans, host time
    against host time: the profiler's device stamps drift from its host
    stamps (0.5-0.7% of a rebuild's window on an H100), which would move
    a gap placed by the host's clock across a stage boundary."""
    labels = [name for name, _, _ in spans] + [OUTSIDE]
    rows = {name: {"ops": 0, "kernels": 0, "busy_s": 0.0, "idle_s": 0.0}
            for name in labels}
    intervals: dict = {name: [] for name in labels}
    end = None
    for a, b, name, corr in sorted(ops):
        t = launches.get(corr)
        label = OUTSIDE if t is None else _innermost(spans, t)
        rows[label]["ops"] += 1
        rows[label]["kernels"] += _is_kernel(name)
        intervals[label].append((a, b))
        if end is not None and a > end:
            rows[label]["idle_s"] += (a - end) / 1e9
        end = b if end is None else max(end, b)
    for label, spans_ in intervals.items():
        rows[label]["busy_s"] = sum(b - a for a, b in _union(spans_)) / 1e9
    return rows


def by_span(fn, device) -> tuple:
    """``fn()`` traced on the device and the host, its device work split
    by the program spans it opened: ``(fn's result, record)``.

    The record: ``by_span`` (:func:`assign`'s rows; with each span name's
    ``count``, summed ``host_s`` and ``device_s`` from its CUDA events),
    ``kernels`` and ``busy_s`` of the whole call, ``window_s`` (its wall,
    synchronised), ``trace_ids`` (the traces its spans belong to),
    ``unmatched`` (device operations with no launch in the trace), and
    the clock join's ``offset_uncertainty_s`` and ``offset_misfit_s``.
    The caller has tracing and stage tracing on
    (``obs.trace.set_stage_tracing``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mfm_tpu_torch.obs import trace

    on_card = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU]
    if on_card:
        acts.append(ProfilerActivity.CUDA)
    brackets = []
    with profile(activities=acts) as prof:
        for _ in range(PROBES):
            t0 = time.perf_counter()
            torch.empty(0)
            brackets.append((t0, time.perf_counter()))
        h0 = time.perf_counter()
        out = fn()
        if on_card:
            torch.cuda.synchronize()
        h1 = time.perf_counter()
    events = list(prof.profiler.kineto_results.events())
    host = [e for e in events if e.device_type() == DeviceType.CPU]
    probe_ns = sorted(e.start_ns() for e in host
                      if e.name() == "aten::empty")[:PROBES]
    offset, unc, misfit = probe_offset(brackets, probe_ns)
    mine = [s for s in trace.spans() if s.dur_us is not None
            and h0 * 1e6 <= s.start_us and s.start_us + s.dur_us <= h1 * 1e6]
    spans = [(s.name, round(s.start_us * 1e3 + offset),
              round((s.start_us + s.dur_us) * 1e3 + offset)) for s in mine]
    launches = {e.correlation_id(): e.start_ns() for e in host
                if e.correlation_id() and _is_runtime_call(e.name())}
    dev = _device_ops(events)
    ops = [(*_span(e), e.name(), e.correlation_id()) for e in dev]
    rows = assign(ops, launches, spans)
    for name, row in rows.items():
        named = [s for s in mine if s.name == name]
        device_s = [trace.device_seconds(s) for s in named]
        row.update(count=len(named),
                   host_s=sum(s.dur_us for s in named) / 1e6,
                   device_s=(sum(device_s) if named and None not in device_s
                             else None))
    return out, {
        "by_span": rows,
        "kernels": sum(1 for e in dev if _is_kernel(e.name())),
        "busy_s": sum(b - a for a, b in _union([o[:2] for o in ops])) / 1e9,
        "window_s": h1 - h0,
        "trace_ids": sorted({s.trace_id for s in mine}),
        "unmatched": sum(1 for o in ops if o[3] not in launches),
        "offset_uncertainty_s": unc / 1e9,
        "offset_misfit_s": misfit / 1e9,
    }
