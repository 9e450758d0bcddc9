"""Request coalescing: merge in-flight requests across callers into the
geometric bucket ladder (counterpart of ``mfm_tpu/serve/coalesce.py``).

The single-stream loop (``QueryServer.run``) already amortizes one device
batch over a whole drained queue — but only when one client pipes many
lines.  Real small-request traffic arrives one line per connection, and a
per-line drain pays the full batch latency every time.  The
:class:`Coalescer` closes that gap: frontend threads :meth:`submit` lines
concurrently, admitted requests pool in the wrapped server's queue, and
ONE flush drains them through the unchanged ``drain_routed`` path — which
already groups by scenario tag and pads each group to its ladder
bucket.  Because batch-of-B is bitwise-equal to B singles
(``serve/query.py``), coalesced responses are bitwise-identical per
request id to the sequential single-connection run.

Flush policy — the linger budget:

- **full**: a submit that fills the queue to ``policy.batch_max`` flushes
  immediately (high load: batches fill, no waiting).
- **linger**: the background flusher (or an explicit :meth:`poll`) flushes
  once the OLDEST queued request has waited ``linger_s`` (low load: p99 is
  bounded by the linger plus one batch wall, never an unbounded wait for a
  bucket to fill).
- **eof**: :meth:`stop` / :meth:`flush` drain whatever remains.

Thread model: ONE lock serializes every touch of the wrapped server
(admission, drain, reload polling).  Coalescing does not try to overlap
device batches; the win is amortizing the batch dispatch, not pipelining
it.  Responses route back to their submitting caller via the
``(origin, resp)`` pairs the routed server API returns.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

from mfm_tpu_torch.obs import instrument as _obs
from mfm_tpu_torch.obs import trace as _trace
from mfm_tpu_torch.serve.cache import CacheFill
from mfm_tpu_torch.serve.query import bucket_for


class Coalescer:
    """Thread-safe coalescing front of a :class:`~mfm_tpu_torch.serve.server.
    QueryServer`.

    Args:
      server: the wrapped :class:`QueryServer`.  The coalescer owns it —
        nothing else may call its submit/drain once coalescing starts.
      linger_s: max time the oldest admitted request may wait before a
        flush (the p99 budget at low load).
      clock: monotonic clock, injectable for deterministic tests.
      deliver: optional callback ``deliver(pairs)`` receiving every list
        of ``(origin, resp)`` pairs as it is produced.  When set, submit/
        flush deliver through it and return ``[]``; when None, they return
        the pairs to the caller (the single-threaded test mode).
      cache: optional :class:`~mfm_tpu_torch.serve.cache.ResponseCache` sitting
        between admission and the queue.  A hit answers from the cached
        body (re-stamped with the caller's id/trace id) without touching
        admission; a miss rides the unchanged path with its origin
        wrapped in a ``CacheFill`` so delivery populates the entry.  The
        cache is bypassed whenever the breaker is not closed — reject-
        with-retry-after is the documented degraded behavior, and a
        cache must never argue with the breaker.
    """

    def __init__(self, server, *, linger_s: float = 0.01,
                 clock: Callable[[], float] = time.monotonic,
                 deliver=None, cache=None):
        if linger_s < 0:
            raise ValueError(f"linger_s must be >= 0, got {linger_s}")
        self.server = server
        self.linger_s = float(linger_s)
        self._clock = clock
        self._deliver = deliver
        self.cache = cache
        self._lock = threading.RLock()
        self._wake = threading.Condition(self._lock)
        self._oldest_t: float | None = None   # enqueue time of queue head
        self._last_poll = -float("inf")       # hit-path reload-poll stamp
        self._flusher: threading.Thread | None = None
        self._stopping = False

    # -- internals (callers hold self._lock) ---------------------------------
    def _emit(self, pairs):
        if not pairs:
            return []
        if self.cache is not None:
            # unwrap CacheFill origins (populating the cache from
            # cacheable responses) and count every delivered response
            pairs = self.cache.absorb(pairs)
        if self._deliver is not None:
            self._deliver(pairs)
            return []
        return pairs

    def _flush_locked(self, trigger: str) -> list:
        """Drain the whole queue (possibly several batch_max rounds) and
        tally the fill/linger metrics per drained round."""
        out = []
        now = self._clock()
        lingered = (now - self._oldest_t) if self._oldest_t is not None else 0.0
        while self.server._queue:
            n = min(len(self.server._queue), self.server.policy.batch_max)
            self.server.poll_reload()
            pairs = self.server.drain_routed()
            _obs.record_coalesce_flush(n, bucket_for(n), trigger, lingered)
            lingered = 0.0   # later rounds of one flush did not linger
            out.extend(pairs)
        self._oldest_t = None
        return out

    def _poll_reload_locked(self) -> None:
        """The reload point the hit-path throttle uses.  FleetServer
        overrides this so a rollout fleet never moves the admission
        engine (or the cache fence) ahead of its workers."""
        self.server.poll_reload()

    # -- the public API ------------------------------------------------------
    def submit(self, line: str, origin=None) -> list:
        """Admit one request line from any thread.  Immediate responses
        (rejections, dead-letter acks, shed notices) come back right away;
        admitted requests answer at the next flush.  Returns/delivers
        ``(origin, resp)`` pairs."""
        if self.cache is not None:
            # drains poll the checkpoint watch, but an all-hits streak
            # never drains — without this throttled poll a pure repeat
            # stream would keep answering from a retired generation
            # forever.  The linger budget bounds hit-path fence
            # staleness exactly as it bounds response latency.
            now = self._clock()
            if now - self._last_poll >= self.linger_s:
                self._last_poll = now
                with self._lock:
                    self._poll_reload_locked()
            if self.server.breaker.state == "closed":
                resp, token = self.cache.lookup(line)
                if resp is not None:
                    if _trace.tracing_enabled():
                        # a hit never opens a serve.request span — this
                        # child marks the short-circuit on the timeline
                        _trace.end_span(_trace.start_span(
                            "cache.hit", trace_id=resp.get("trace_id"),
                            request_id=resp.get("id")))
                    with self._lock:
                        return self._emit([(origin, resp)])
                if token is not None:
                    origin = CacheFill(origin, token)
        with self._lock:
            was_empty = not self.server._queue
            pairs = list(self.server.submit_line_routed(line, origin))
            if self.server._queue and was_empty:
                self._oldest_t = self._clock()
                self._wake.notify()   # flusher re-arms its linger deadline
            if len(self.server._queue) >= self.server.policy.batch_max:
                pairs.extend(self._flush_locked("full"))
            return self._emit(pairs)

    def poll(self) -> list:
        """Flush if the oldest queued request's linger budget expired
        (call this from a dispatcher loop when not using :meth:`start`)."""
        with self._lock:
            if (self._oldest_t is not None
                    and self._clock() - self._oldest_t >= self.linger_s):
                return self._emit(self._flush_locked("linger"))
            return []

    def flush(self, trigger: str = "eof") -> list:
        """Drain everything queued, regardless of linger state."""
        with self._lock:
            return self._emit(self._flush_locked(trigger))

    def queued(self) -> int:
        with self._lock:
            return len(self.server._queue)

    def next_deadline(self) -> float | None:
        """Clock time the current oldest request must flush by (None when
        the queue is empty)."""
        with self._lock:
            if self._oldest_t is None:
                return None
            return self._oldest_t + self.linger_s

    # -- background flusher --------------------------------------------------
    def start(self) -> None:
        """Run the linger flusher in a daemon thread (requires ``deliver``
        — there is no caller to hand pairs back to)."""
        if self._deliver is None:
            raise ValueError("Coalescer.start() needs a deliver callback")
        if self._flusher is not None:
            return
        # _stopping is read by the flusher under _lock; a bare write here
        # could race a concurrent stop() and strand the new thread in an
        # immediate-exit or never-exit state.
        with self._lock:
            self._stopping = False
        self._flusher = threading.Thread(target=self._flush_loop,
                                         name="mfm-coalesce-flusher",
                                         daemon=True)
        self._flusher.start()

    def _flush_loop(self) -> None:
        with self._lock:
            while not self._stopping:
                if self._oldest_t is None:
                    self._wake.wait(timeout=0.5)
                    continue
                budget = self._oldest_t + self.linger_s - self._clock()
                if budget > 0:
                    self._wake.wait(timeout=budget)
                    continue
                self._emit(self._flush_locked("linger"))

    def stop(self) -> list:
        """Stop the flusher (if running) and drain the tail.  Returns the
        final pairs in no-deliver mode."""
        with self._lock:
            self._stopping = True
            self._wake.notify_all()
        if self._flusher is not None:
            self._flusher.join(timeout=5.0)
            self._flusher = None
        with self._lock:
            return self._emit(self._flush_locked("eof"))
