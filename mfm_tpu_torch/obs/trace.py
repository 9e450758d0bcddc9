"""Request-scoped tracing: spans in a bounded ring buffer (counterpart of
the span half of ``mfm_tpu/obs/trace.py``).

Zero-dependency (stdlib only), thread-safe and host-side: spans open and
close around the device work, never inside it.

- :func:`span` — context-manager span with monotonic-clock timing and
  trace/span/parent ids; nesting uses a thread-local stack, so a child
  opened on the same thread inherits its parent's trace.
- :func:`start_span` / :func:`end_span` — the explicit pair for async
  boundaries (a serve request's span opens at admission and closes at
  response, batches apart).
- A bounded ring holds finished spans; overflow drops the OLDEST and
  tallies ``mfm_trace_dropped_total``.

Ids follow W3C trace-context sizing: ``trace_id`` 16 random bytes hex,
``span_id`` 8.  The Chrome-trace export and the fleet-wire span merge wait
for ROADMAP.md §A 15; :func:`wire_span` is here for the flight recorder.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time

from mfm_tpu_torch.obs.instrument import TRACE_DROPPED_TOTAL, TRACE_SPANS_TOTAL

#: default ring capacity — ~1 MB of spans; a serve storm overflows it by
#: design (drop-oldest + counted) rather than growing without bound
DEFAULT_RING_CAPACITY = 4096

_enabled = True
_lock = threading.Lock()
_ring: collections.deque = collections.deque()
_tls = threading.local()


def set_tracing(on: bool) -> None:
    """Process-wide tracing switch; disabled spans record nothing."""
    global _enabled
    _enabled = bool(on)


def tracing_enabled() -> bool:
    return _enabled


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
    ``wall_ts`` is the wall-clock open time for joining to JSONL events."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start_us",
                 "dur_us", "wall_ts", "tid", "attrs")

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


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def _evict_locked() -> None:
    dropped = 0
    while len(_ring) > DEFAULT_RING_CAPACITY:
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
    with _lock:
        _ring.clear()
    _tls.stack = []


#: wire-form span fields (the reference's); ``tid`` rides along so
#: per-thread lanes survive a merge
_WIRE_FIELDS = ("name", "trace_id", "span_id", "parent_id", "start_us",
                "dur_us", "wall_ts", "tid")


def wire_span(sp: Span) -> dict:
    """One finished span as a JSON-safe wire dict."""
    d = {k: getattr(sp, k) for k in _WIRE_FIELDS}
    d["attrs"] = dict(sp.attrs)
    return d
