"""Request-scoped tracing: spans, a bounded ring buffer, the fleet-wire
span merge and Chrome-trace export (counterpart of ``mfm_tpu/obs/trace.py``).

Zero-dependency (stdlib only; :func:`stage` reaches torch only for a
stage on a CUDA device), thread-safe and host-side: spans open and close
around the device work, never inside it, and add nothing to it.

- :func:`span` — context-manager span with monotonic-clock timing and
  trace/span/parent ids; nesting uses a thread-local stack, so a child
  opened on the same thread inherits its parent's trace.
- :func:`start_span` / :func:`end_span` — the explicit pair for async
  boundaries (a serve request's span opens at admission and closes at
  response, batches apart); :func:`push_span` / :func:`pop_span` put such
  a span on the nesting stack, so that spans opened under it join its
  trace (a CLI run's root span).
- :func:`stage` — a span around one stage of the device work, with the
  stage's interval on the device from two CUDA events
  (:func:`device_seconds`); off unless :func:`set_stage_tracing` turned
  stages on, and then a shared null context that costs a flag check.
- A bounded ring holds finished spans; overflow drops the OLDEST and
  tallies ``mfm_trace_dropped_total``.
- :func:`drain_spans`, :func:`clock_offset_from_probe` and
  :func:`ingest_foreign_spans` move a fleet worker's spans over the
  ``__fleet__`` wire into the front end's ring, shifted onto its clock.
- Exporters: :func:`render_chrome_trace` (Perfetto-loadable
  ``{"traceEvents": [...]}``, complete "X" events),
  :func:`parse_chrome_trace` (the schema validator), the atomic
  :func:`write_chrome_trace` (tmp -> fsync -> chaos point -> rename -> dir
  fsync), and :func:`export_spans_to_events`, the mirror of spans onto
  the JSONL event stream (:mod:`mfm_tpu_torch.obs.exporters`).

Ids follow W3C trace-context sizing: ``trace_id`` 16 random bytes hex,
``span_id`` 8.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time

from mfm_tpu_torch.obs.instrument import (
    TRACE_DROPPED_TOTAL,
    TRACE_SPANS_TOTAL,
    record_foreign_spans,
)
from mfm_tpu_torch.utils.chaos import chaos_point

#: default ring capacity — ~1 MB of spans; a serve storm overflows it by
#: design (drop-oldest + counted) rather than growing without bound
DEFAULT_RING_CAPACITY = 4096

#: Chrome trace-event phases the validator accepts (we emit only "X" and
#: "M", but a hand-edited or foreign trace may carry the rest)
_CHROME_PHASES = frozenset("XBEiIMCbens")

_enabled = True
_stages = False
_lock = threading.Lock()
_ring: collections.deque = collections.deque()
_capacity = DEFAULT_RING_CAPACITY
_tls = threading.local()


def set_tracing(on: bool) -> None:
    """Process-wide tracing switch; disabled spans record nothing."""
    global _enabled
    _enabled = bool(on)


def tracing_enabled() -> bool:
    return _enabled


def set_stage_tracing(on: bool) -> None:
    """Switch :func:`stage` spans on (off by default; they record only
    while tracing is on too).  A stage span costs host time on the
    program's hot path, so it is recorded only where a reader asks for
    it, as the CLI's ``--metrics-dir`` does."""
    global _stages
    _stages = bool(on)


def stage_tracing_enabled() -> bool:
    return _stages


def set_ring_capacity(n: int) -> None:
    """Resize the span ring (existing overflow drops oldest, counted)."""
    global _capacity
    if int(n) < 1:
        raise ValueError(f"ring capacity must be >= 1, got {n}")
    with _lock:
        _capacity = int(n)
        _evict_locked()


def new_trace_id() -> str:
    """16 random bytes, hex — W3C trace-context sized."""
    return os.urandom(16).hex()


def new_span_id() -> str:
    """8 random bytes, hex."""
    return os.urandom(8).hex()


class Span:
    """One finished-or-open span.  ``start_us``/``dur_us`` are on the
    monotonic ``perf_counter`` clock (microseconds) — a consistent
    process-local timeline, which is all the Chrome trace format needs;
    ``wall_ts`` is the wall-clock open time for joining to JSONL events;
    ``events`` the (open, close) CUDA timing events of a :func:`stage` on
    the card, else None."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start_us",
                 "dur_us", "wall_ts", "tid", "attrs", "events")

    def __init__(self, name, trace_id, span_id, parent_id, start_us,
                 wall_ts, tid, attrs):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start_us = start_us
        self.dur_us = None          # None until end_span
        self.wall_ts = wall_ts
        self.tid = tid
        self.attrs = attrs
        self.events = None


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def _evict_locked() -> None:
    dropped = 0
    while len(_ring) > _capacity:
        _ring.popleft()
        dropped += 1
    if dropped:
        TRACE_DROPPED_TOTAL.inc(dropped)


def start_span(name: str, *, trace_id: str | None = None,
               parent_id: str | None = None, **attrs) -> Span:
    """Open a span WITHOUT touching the thread-local nesting stack — the
    async half of the API (a serve request opens here at admission and
    :func:`end_span` closes it at response, possibly batches later).

    ``trace_id``/``parent_id`` default to the calling thread's current
    span when one is open (so an explicit span started under ``span()``
    still joins its trace), else a fresh trace begins.
    """
    st = _stack()
    cur = st[-1] if st else None
    if trace_id is None:
        trace_id = cur.trace_id if cur is not None else new_trace_id()
    if parent_id is None and cur is not None and cur.trace_id == trace_id:
        parent_id = cur.span_id
    return Span(str(name), str(trace_id), new_span_id(), parent_id,
                time.perf_counter() * 1e6, round(time.time(), 3),
                threading.get_ident(), dict(attrs))


def end_span(sp: Span, **attrs) -> Span:
    """Close a span: stamp its duration, merge late attrs, push it onto
    the ring (oldest dropped + counted past capacity).  Idempotence is
    the caller's job — ending twice records twice."""
    sp.dur_us = max(0.0, time.perf_counter() * 1e6 - sp.start_us)
    if attrs:
        sp.attrs |= attrs
    if not _enabled:
        return sp
    TRACE_SPANS_TOTAL.inc()
    with _lock:
        _ring.append(sp)
        _evict_locked()
    return sp


@contextlib.contextmanager
def span(name: str, *, trace_id: str | None = None,
         parent_id: str | None = None, **attrs):
    """Context-manager span: nests via the thread-local stack, so children
    opened inside inherit this trace; an exception ends the span with an
    ``error`` attr and propagates."""
    sp = start_span(name, trace_id=trace_id, parent_id=parent_id, **attrs)
    st = _stack()
    st.append(sp)
    try:
        yield sp
    except BaseException as e:
        end_span(sp, error=f"{type(e).__name__}: {e}"[:500])
        raise
    finally:
        st.pop()
    end_span(sp)


def push_span(sp: Span) -> None:
    """Make ``sp`` (opened by :func:`start_span`) the calling thread's
    current span: spans opened under it join its trace until
    :func:`pop_span`."""
    _stack().append(sp)


def pop_span(sp: Span) -> None:
    """Take ``sp`` off the calling thread's nesting stack, where it is."""
    st = _stack()
    if sp in st:
        st.remove(sp)


#: what :func:`stage` returns with stage spans off
_OFF = contextlib.nullcontext()


def stage(name: str, device=None, **attrs):
    """A :func:`span` around one stage of the device work; ``with`` gives
    the open span, whose ``attrs`` the stage may add counts to.

    With stage spans off (the default; :func:`set_stage_tracing`) or
    tracing off it is a shared null context (``with`` gives None): no
    span, no id, no event, a flag check.  On a CUDA ``device`` the span
    also records a timing event on the device's current stream at open
    and at close (``Span.events``), so that :func:`device_seconds` reads
    the stage's interval on the device once the caller has synchronized;
    no synchronize and no operation of the device's own is added."""
    if not (_stages and _enabled):
        return _OFF
    return _Stage(name, device, attrs)


class _Stage:
    """:func:`stage` with stage spans on: :func:`span`'s open, nest and
    close, without a generator's frame."""

    __slots__ = ("name", "device", "attrs", "sp", "events")

    def __init__(self, name, device, attrs):
        self.name, self.device, self.attrs = name, device, attrs

    def __enter__(self) -> Span:
        sp = self.sp = start_span(self.name, **self.attrs)
        _stack().append(sp)
        self.events = None
        if self.device is not None and self.device.type == "cuda":
            import torch

            stream = torch.cuda.current_stream(self.device)
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True), stream)
            self.events[0].record(stream)
        return sp

    def __exit__(self, kind, err, tb) -> None:
        sp = self.sp
        _stack().pop()
        if kind is not None:
            end_span(sp, error=f"{kind.__name__}: {err}"[:500])
            return
        if self.events is not None:
            opened, closed, stream = self.events
            closed.record(stream)
            sp.events = (opened, closed)
        end_span(sp)


def device_seconds(sp: Span) -> float | None:
    """Seconds between a stage's two CUDA events, once the close event
    has completed; None for a span without events or before then."""
    if sp.events is None or not sp.events[1].query():
        return None
    return sp.events[0].elapsed_time(sp.events[1]) / 1e3


def current_trace_id() -> str | None:
    """The calling thread's open trace id, if any span is open."""
    st = _stack()
    return st[-1].trace_id if st else None


def spans() -> list:
    """Snapshot of the ring's finished spans, oldest first."""
    with _lock:
        return list(_ring)


def reset_tracing() -> None:
    """Drop every recorded span and this thread's nesting stack (tests)."""
    global _capacity
    with _lock:
        _ring.clear()
        _capacity = DEFAULT_RING_CAPACITY
    _tls.stack = []


# -- fleet-wire span merge ----------------------------------------------------
#
# A fleet worker's spans live in ITS process ring; these helpers move them
# across the ``__fleet__`` wire and into the frontend's ring so one Chrome
# trace shows the whole request timeline.  Worker clocks are perf_counter
# clocks with arbitrary epochs, so every merged span is shifted by a
# per-worker offset estimated from heartbeat RTT midpoints; the offset and
# its uncertainty (half the RTT) are stamped on the span, and a span whose
# corrected timeline still falls outside the frontend's observed dispatch
# window beyond that uncertainty is flagged ``clock_skew="uncorrectable"``
# — flagged, never reordered or clamped.

#: wire-form span fields (the JSONL payload piggybacked on flushed/pong
#: replies); ``tid`` rides along so per-thread lanes survive the merge
_WIRE_FIELDS = ("name", "trace_id", "span_id", "parent_id", "start_us",
                "dur_us", "wall_ts", "tid")


def wire_span(sp: Span) -> dict:
    """One finished span as a JSON-safe wire dict."""
    d = {k: getattr(sp, k) for k in _WIRE_FIELDS}
    d["attrs"] = dict(sp.attrs)
    return d


def drain_spans() -> list:
    """Destructively pop every finished span off the ring, in order, as
    wire dicts — the worker side of the piggyback (spans ship once, on
    the next flushed/pong reply, and stop occupying worker memory)."""
    with _lock:
        out = list(_ring)
        _ring.clear()
    return [wire_span(s) for s in out]


def clock_offset_from_probe(t0_s: float, t1_s: float,
                            peer_clock_us: float) -> tuple:
    """``(offset_us, uncertainty_us)`` from one probe round trip: the
    peer stamped ``peer_clock_us`` (its perf_counter, µs) somewhere
    between our send (``t0_s``) and receive (``t1_s``) perf_counter
    stamps.  The midpoint is the minimum-error estimate; half the RTT
    bounds the error.  Adding ``offset_us`` to a LOCAL timestamp maps it
    onto the peer's clock — so subtract it from peer timestamps (which
    is what :func:`ingest_foreign_spans` expects as its ``offset_us``,
    negated by the caller)."""
    mid_us = (float(t0_s) + float(t1_s)) / 2.0 * 1e6
    rtt_us = max(0.0, (float(t1_s) - float(t0_s)) * 1e6)
    return float(peer_clock_us) - mid_us, rtt_us / 2.0


def ingest_foreign_spans(span_dicts, *, offset_us: float = 0.0,
                         uncertainty_us: float = 0.0, window_us=None,
                         worker=None) -> list:
    """Merge wire-form spans from another process into this ring.

    ``offset_us`` is ADDED to each span's ``start_us`` to map it onto
    this process's perf_counter clock (callers that estimated
    ``peer - local`` via :func:`clock_offset_from_probe` pass the
    NEGATED estimate).  Every merged span is stamped with the correction
    (``clock_offset_us``/``clock_uncertainty_us`` and ``worker``), and a
    span whose corrected extent lies outside ``window_us`` (a local
    ``(lo_us, hi_us)`` bracket around the exchange that produced it) by
    more than the uncertainty is flagged ``clock_skew="uncorrectable"``
    — the timeline is preserved as corrected, never reordered.  Returns
    the ingested spans (empty when tracing is disabled)."""
    if not _enabled:
        return []
    out = []
    n_skew = 0
    for d in span_dicts or ():
        if not isinstance(d, dict) or not d.get("name"):
            continue
        try:
            start = float(d["start_us"]) + float(offset_us)
            dur = float(d.get("dur_us") or 0.0)
        except (KeyError, TypeError, ValueError):
            continue
        attrs = dict(d.get("attrs") or {})
        attrs["clock_offset_us"] = round(float(offset_us), 3)
        attrs["clock_uncertainty_us"] = round(float(uncertainty_us), 3)
        if worker is not None:
            attrs["worker"] = worker
        if window_us is not None:
            lo, hi = float(window_us[0]), float(window_us[1])
            slack = max(0.0, float(uncertainty_us))
            if start < lo - slack or start + dur > hi + slack:
                attrs["clock_skew"] = "uncorrectable"
                n_skew += 1
        sp = Span(str(d["name"]), str(d.get("trace_id")),
                  str(d.get("span_id") or new_span_id()),
                  d.get("parent_id"), start,
                  d.get("wall_ts"), int(d.get("tid") or 0), attrs)
        sp.dur_us = dur
        out.append(sp)
    if out:
        TRACE_SPANS_TOTAL.inc(len(out))
        record_foreign_spans(len(out), n_skew)
        with _lock:
            _ring.extend(out)
            _evict_locked()
    return out


# -- Chrome trace-event export ------------------------------------------------

def chrome_trace_events(span_list=None) -> list:
    """The ring (or an explicit span list) as Chrome trace-event dicts:
    complete ("X") events, µs timestamps, ids and attrs under ``args``,
    with a stage's seconds on the device as ``device_s`` once known."""
    pid = os.getpid()
    out = []
    for s in (spans() if span_list is None else span_list):
        args = {"trace_id": s.trace_id, "span_id": s.span_id}
        if s.parent_id:
            args["parent_id"] = s.parent_id
        for k in sorted(s.attrs):
            if k not in args:
                args[k] = s.attrs[k]
        dev = device_seconds(s)
        if dev is not None:
            args["device_s"] = dev
        out.append({"name": s.name, "cat": "mfm", "ph": "X",
                    "ts": round(s.start_us, 3),
                    "dur": round(s.dur_us or 0.0, 3),
                    "pid": pid, "tid": int(s.tid), "args": args})
    return out


def render_chrome_trace(span_list=None) -> str:
    """Perfetto-loadable JSON text: ``{"traceEvents": [...]}``."""
    return json.dumps({"traceEvents": chrome_trace_events(span_list),
                       "displayTimeUnit": "ms"},
                      sort_keys=True, default=str)


def parse_chrome_trace(text: str) -> list:
    """Schema-validate Chrome trace-event JSON; returns the event list.

    Accepts both the object form (``{"traceEvents": [...]}``) we emit and
    the bare-array form Perfetto also loads.  Raises ValueError on
    anything either consumer would choke on — which is the point: the
    trace we ship must load.
    """
    try:
        obj = json.loads(text)
    except ValueError as e:
        raise ValueError(f"not valid JSON ({e}) — torn trace file?") from e
    if isinstance(obj, dict):
        events = obj.get("traceEvents")
        if not isinstance(events, list):
            raise ValueError("object form lacks a traceEvents list")
    elif isinstance(obj, list):
        events = obj
    else:
        raise ValueError(f"trace must be an object or array, got "
                         f"{type(obj).__name__}")
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            raise ValueError(f"{where}: event is not an object")
        ph = ev.get("ph")
        if not isinstance(ph, str) or ph not in _CHROME_PHASES:
            raise ValueError(f"{where}: bad phase {ph!r}")
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            raise ValueError(f"{where}: missing/empty name")
        if ph != "M":        # metadata events carry no timestamp
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                raise ValueError(f"{where}: bad ts {ts!r}")
        for key in ("pid", "tid"):
            if not isinstance(ev.get(key), int):
                raise ValueError(f"{where}: {key} must be an int, got "
                                 f"{ev.get(key)!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"{where}: complete event needs dur >= 0, "
                                 f"got {dur!r}")
        if "args" in ev and not isinstance(ev["args"], dict):
            raise ValueError(f"{where}: args must be an object")
    return events


def write_chrome_trace(path: str, span_list=None) -> str:
    """Atomic trace flush (tmp -> fsync -> chaos point -> rename -> dir
    fsync), same discipline as the manifests — a SIGKILL mid-flush must
    never leave a torn trace file.  Returns the final path."""
    text = render_chrome_trace(span_list)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    try:
        with open(tmp, "w", encoding="utf-8") as fh:
            fh.write(text)
            fh.write("\n")
            fh.flush()
            os.fsync(fh.fileno())
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    chaos_point("trace.after_tmp", path)
    os.replace(tmp, path)
    try:
        fd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:  # pragma: no cover - exotic filesystems
        pass
    return path


def export_spans_to_events(span_list=None, level: str = "info") -> int:
    """Mirror spans onto the JSONL event stream (one ``span`` event each,
    routed wherever ``route_events_to`` points).  Returns the count."""
    from mfm_tpu_torch.obs.exporters import emit_event

    sl = spans() if span_list is None else span_list
    for s in sl:
        emit_event(level, "span", name=s.name, trace_id=s.trace_id,
                   span_id=s.span_id, parent_id=s.parent_id,
                   dur_s=round((s.dur_us or 0.0) / 1e6, 6),
                   **{f"attr_{k}": v for k, v in sorted(s.attrs.items())})
    return len(sl)
