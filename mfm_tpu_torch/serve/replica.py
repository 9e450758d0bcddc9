"""Worker replicas: N serving processes behind one coalescing front end,
sharing the generation-fenced checkpoint store — on one host or many
(counterpart of ``mfm_tpu/serve/replica.py``; the wire protocol is the
reference's byte for byte, so the two packages' front ends and workers
interoperate).

Process model
-------------
The front end (the :class:`FleetServer` below, usually wrapped by
``serve/frontend.py``) runs ADMISSION only: request guards, dead-letter
quarantine, shed-oldest backpressure and deadline stamping through its own
:class:`~mfm_tpu_torch.serve.server.QueryServer` — which it never drains.
Admitted raw lines pool under the coalescer's linger budget, then each
flush routes one batch to the healthy worker with the lowest EWMA batch
wall (with a starvation guard so no healthy worker goes unfed; see
:meth:`FleetServer._next_replica`).

Workers are ``python -m mfm_tpu_torch.cli serve --worker`` subprocesses
(spawned over pipes with ``--replicas N``, each with its own CUDA context
on the front end's device) or ``serve --worker --listen HOST:PORT``
processes on ANY host (attached with ``--workers host:port,...``).  Both speak the
same wire protocol over a deadline-bearing transport
(:mod:`mfm_tpu_torch.serve.transport`), load the SAME fenced checkpoint (so
re-parsing an admitted line is deterministic), and answer with the
unchanged batched drain path — which is why fleet responses stay
bitwise-identical per request id to the single-process loop on the same
device (batch == singles holds for queries and construct solves, so a
worker's batch composition does not move a response's bits).

Wire protocol (JSONL both ways, ``__fleet__`` is the control key —
reserved at ADMISSION: ``parse_request`` dead-letters any request
carrying it, and a worker accepts a control frame only when the parsed
object is exactly ``{"__fleet__": ...}``, so a client can never spoof a
flush or shift response ordinals):

- frontend -> worker: admitted request lines verbatim, then
  ``{"__fleet__": "flush"}`` to drain the batch.  A tracing frontend
  precedes the lines with ONE structured prologue frame
  ``{"__fleet__": {"op": "batch", "trace": {...}}}`` carrying the
  dispatch span and each line's parent span id; the prologue consumes no
  seq ordinal and an unknown ``op`` is ignored, so the frame is invisible
  to response routing and to older workers alike.
- worker -> frontend: one envelope ``{"seq": i, "resp": {...}}`` per line
  (``seq`` = the line's ordinal within the current batch — request ids
  need not be unique, ordinals are), then
  ``{"__fleet__": "flushed", "n": k}``.
- between batches the frontend may send single-frame probes, each
  answered with exactly one line: ``"ping"`` -> ``"pong"`` (the
  heartbeat), ``"metrics"`` -> a live summary + registry snapshot (the
  scrape-time observability shard ``/metrics`` and ``/healthz`` merge),
  and ``"reload"`` -> re-fence now and report
  ``{"ok": ..., "generation": ...}`` (the rolling-rollout step).
- piggyback: ``flushed``, ``pong`` and ``reloaded`` replies also carry
  ``clock_us`` (the worker's perf_counter stamp, for RTT-midpoint
  clock-offset estimation) and, when tracing is on, ``spans`` — the
  worker's finished spans in wire form, drained once and merged into the
  frontend ring shifted onto its clock
  (:func:`mfm_tpu_torch.obs.trace.ingest_foreign_spans`), so ONE Chrome trace
  shows the whole request timeline across processes.  Response bodies
  are untouched: the extra keys ride only on control replies, so fleet
  responses stay bitwise-identical per request id.

Failure semantics
-----------------
- A worker that DIES mid-batch (crash, SIGKILL — detected as EOF or a
  broken pipe/reset) loses nothing but its in-flight batch: the batch is
  re-dispatched to the next healthy replica, the death and re-dispatch
  are counted, and the checkpoint bytes are untouched (workers only ever
  read the store).
- A worker that WEDGES (SIGSTOP, a hung device call — detected as a
  per-I/O deadline expiry or a missed heartbeat pong) is quarantined and
  its batch re-dispatched exactly like a death: a frozen worker holding
  a batch hostage is indistinguishable from a dead one to the client.
  The difference is bookkeeping (``wedged`` in the manifest, the
  ``mfm_fleet_transport_*`` counters) and shutdown (a wedged subprocess
  is killed, not drained).
- A worker that fails its FENCE AUDIT on reload force-opens its own
  breaker, so the whole batch comes back ``rejected`` with
  ``breaker == "fence_audit"``.  The front end does NOT deliver those: the
  replica is quarantined — drained out, never killed mid-batch — and the
  batch re-dispatches to a replica that still passes its audit.
- With NO healthy replica left, queued work answers ``error`` locally
  (clients see a well-formed response, the merged manifest shows the
  outage).

Rolling rollout (``--rollout``): workers run with ``--hold-fence`` (no
self-polling), and when the checkpoint pointer's generation moves the
front end re-fences ONE worker at a time with the ``reload`` frame —
never mid-batch, because the roll happens between dispatches under the
coalescer lock.  The admission engine and the response-cache fence
move LAST, only once every surviving worker reports the new
generation, so no response ever crosses a generation boundary mid-batch
and the cache can never answer ahead of the fleet.

At shutdown each worker writes its own serve manifest shard
(``serve_manifest.r{i}.json`` beside the checkpoint); the front end merges
them with its own summary into ``fleet_manifest.json``, whose audit
invariant — per-replica delivered outcome counts plus the front end's
locally-answered ledger sum to the accepted count — is what
``doctor --serve`` checks, alongside the per-replica transport
counters (reconnects, heartbeat misses, redispatches).
"""

from __future__ import annotations

import json
import os
import subprocess
import time

from mfm_tpu_torch.obs import flightrec as _frec
from mfm_tpu_torch.obs import instrument as _obs
from mfm_tpu_torch.obs import trace as _trace
from mfm_tpu_torch.serve.coalesce import Coalescer
from mfm_tpu_torch.serve.query import bucket_for
from mfm_tpu_torch.serve.server import FLEET_CONTROL_KEY as CONTROL_KEY
from mfm_tpu_torch.serve.transport import (
    DEFAULT_IO_TIMEOUT_S,
    PipeTransport,
    TcpTransport,
    TransportError,
    TransportTimeout,
)

#: per-replica manifest shard name beside the checkpoint
WORKER_MANIFEST_FMT = "serve_manifest.r{idx}.json"
FLEET_MANIFEST_NAME = "fleet_manifest.json"

#: EWMA smoothing for the per-replica batch-wall estimate the router keys on
EWMA_ALPHA = 0.3


class ReplicaDeadError(RuntimeError):
    """The worker is gone mid-batch (crash/SIGKILL/broken pipe)."""


class ReplicaWedgedError(ReplicaDeadError):
    """The worker is alive but frozen (deadline expiry / missed pong).

    Subclasses :class:`ReplicaDeadError` on purpose: every dispatch-side
    recovery path (quarantine + re-dispatch) treats the two identically;
    only bookkeeping and shutdown differ."""


def _control_frame(line: str) -> dict | None:
    """Parse ``line`` as a control frame, or None if it is a request.

    Only an object that is EXACTLY ``{"__fleet__": ...}`` counts:
    admission already dead-letters any request carrying the reserved key
    (``parse_request``), and the strict shape here is the second wall —
    a line that somehow reaches a worker with ``__fleet__`` among other
    keys falls through to normal admission (consuming its seq ordinal)
    instead of flushing mid-batch or silently shifting ordinals, either
    of which would desync the pipe and route responses to the wrong
    clients."""
    if CONTROL_KEY not in line[:16]:
        return None
    try:
        obj = json.loads(line)
    except ValueError:
        return None
    if isinstance(obj, dict) and set(obj) == {CONTROL_KEY}:
        return obj
    return None


# -- worker side --------------------------------------------------------------

def run_worker(server, in_fp, out_fp, *, poll_on_flush: bool = True) -> dict:
    """The worker-side loop: admitted lines in, seq envelopes out.

    ``server`` is a fully-wired :class:`QueryServer` (engine off the
    fenced checkpoint, ``reload_fn`` polling the pointer).  With
    ``poll_on_flush=False`` (the ``--hold-fence`` worker of a rolling
    rollout) the pointer is polled ONLY on the frontend's ``reload``
    frame, so generations move one worker at a time on the frontend's
    schedule.  Returns the worker's serve summary for its manifest
    shard."""

    def emit(pairs):
        for origin, resp in pairs:
            out_fp.write(json.dumps({"seq": origin, "resp": resp},
                                    sort_keys=True) + "\n")

    def flush_out():
        out_fp.flush()
        if server.policy.fsync_emits:
            try:
                os.fsync(out_fp.fileno())
            except (OSError, ValueError):
                pass

    def reply(obj):
        out_fp.write(json.dumps(obj, sort_keys=True) + "\n")
        flush_out()

    def piggyback(frame):
        # completed spans ride back on control replies so the frontend
        # can merge them into one timeline; clock_us lets it estimate
        # this process's perf_counter offset from the probe RTT
        frame["clock_us"] = time.perf_counter() * 1e6
        if _trace.tracing_enabled():
            shipped = _trace.drain_spans()
            if shipped:
                frame["spans"] = shipped
        return frame

    # Immediate responses (worker-side rejections, shed notices) BUFFER
    # until the flush control: the front end writes its whole batch before
    # it starts reading, so a worker that wrote envelopes mid-batch could
    # fill the stdout pipe while the front end fills stdin — a deadlock.
    # Holding writes until flush makes the pipe strictly half-duplex.
    # Probe frames (ping/metrics/reload) only ever arrive between batches
    # and are answered with exactly one line, which keeps the half-duplex
    # discipline: one frame in, one frame out, frontend reads immediately.
    seq = 0
    held: list = []
    trace_ctx: dict | None = None
    for line in in_fp:
        line = line.strip()
        if not line:
            continue
        ctl = _control_frame(line)
        if ctl is not None:
            kind = ctl[CONTROL_KEY]
            if isinstance(kind, dict):
                # structured control frame: op dispatch.  Today's only op
                # is the trace-context prologue a tracing frontend sends
                # before its batch lines; unknown ops are ignored, not
                # fatal, so an older worker survives a newer frontend.
                if kind.get("op") == "batch":
                    tr = kind.get("trace")
                    trace_ctx = tr if isinstance(tr, dict) else {}
                continue
            if kind == "flush":
                n_batch = seq
                bsp = None
                if _trace.tracing_enabled():
                    ref = (trace_ctx or {}).get("dispatch") or []
                    bsp = _trace.start_span(
                        "worker.batch",
                        trace_id=(ref[0] if len(ref) > 0 else None),
                        parent_id=(ref[1] if len(ref) > 1 else None),
                        n=n_batch)
                emit(held)
                held = []
                if poll_on_flush:
                    server.poll_reload()
                while server._queue:
                    emit(server.drain_routed())
                if bsp is not None:
                    _trace.end_span(bsp)
                trace_ctx = None
                reply(piggyback({CONTROL_KEY: "flushed", "n": n_batch}))
                seq = 0   # seq is an ordinal WITHIN a batch
            elif kind == "ping":
                reply(piggyback({CONTROL_KEY: "pong"}))
            elif kind == "metrics":
                from mfm_tpu_torch.obs.metrics import REGISTRY
                reply({CONTROL_KEY: "metrics",
                       "summary": _obs.serve_summary_from_registry(),
                       "metrics": REGISTRY.snapshot()})
            elif kind == "reload":
                rsp = (_trace.start_span("worker.reload_fence")
                       if _trace.tracing_enabled() else None)
                server.poll_reload()
                # a reload that failed its fence audit force-opened the
                # breaker; report it so the frontend quarantines us
                # instead of shipping batches that would all reject
                ok = not (server.breaker.state == "open"
                          and server.breaker.open_reason == "fence_audit")
                if rsp is not None:
                    _trace.end_span(rsp, ok=ok,
                                    generation=server.generation)
                reply(piggyback({CONTROL_KEY: "reloaded", "ok": ok,
                                 "generation": server.generation}))
            continue
        rsp = None
        if _trace.tracing_enabled() and trace_ctx is not None:
            parents = trace_ctx.get("parents") or []
            par = parents[seq] if seq < len(parents) else None
            if par:
                # the frontend's serve.request span for this ordinal is
                # the parent; the trace id matches its sha-derived one,
                # so the two processes' spans join in one timeline
                rsp = _trace.start_span(
                    "worker.recv", trace_id=par[0], parent_id=par[1],
                    seq=seq)
        held.extend(server.submit_line_routed(line, origin=seq))
        if rsp is not None:
            _trace.end_span(rsp)
        seq += 1
    # EOF: drain the tail (a frontend that closes our stdin without a
    # final flush still gets every admitted request answered)
    emit(held)
    if poll_on_flush:
        server.poll_reload()
    while server._queue:
        emit(server.drain_routed())
    flush_out()
    server.close()
    return _obs.serve_summary_from_registry()


# -- frontend side ------------------------------------------------------------

class Replica:
    """One worker (spawned subprocess or remote TCP peer) + its ledger."""

    #: capability flag the dispatcher checks before prepending a trace
    #: prologue frame to a batch (test stubs lack it -> plain batches)
    accepts_trace_frames = True

    def __init__(self, idx: int, cmd: list, env: dict | None = None, *,
                 io_timeout_s: float = DEFAULT_IO_TIMEOUT_S):
        self.idx = int(idx)
        self.cmd = list(cmd)
        self.host = "local"
        self.proc = subprocess.Popen(
            self.cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            text=True, env=env)
        self.transport = PipeTransport(self.proc, io_timeout_s=io_timeout_s)
        self._init_ledger()

    @classmethod
    def connect(cls, idx: int, addr, *,
                io_timeout_s: float = DEFAULT_IO_TIMEOUT_S,
                attempts: int = 5, backoff_s: float = 0.05,
                sleep=None) -> "Replica":
        """Attach to a ``serve --worker --listen`` process on any host.
        ``addr`` is a ``(host, port)`` pair; dialing retries with
        exponential backoff (the worker may still be loading its
        checkpoint), and exhaustion raises the last ``OSError`` stamped
        ``phase="connect"``."""
        self = cls.__new__(cls)
        self.idx = int(idx)
        self.cmd = None
        self.host = f"{addr[0]}:{int(addr[1])}"
        self.proc = None
        kw = {} if sleep is None else {"sleep": sleep}
        self.transport = TcpTransport.connect(
            (addr[0], int(addr[1])), io_timeout_s=io_timeout_s,
            attempts=attempts, backoff_s=backoff_s, **kw)
        self._init_ledger()
        _obs.record_transport_reconnects(
            self.idx, self.transport.counters["reconnects"])
        return self

    def _init_ledger(self) -> None:
        self.quarantined = False
        self.dead = False      # transport saw EOF/broken pipe/reset
        self.wedged = False    # transport deadline or heartbeat expired
        #: outcome -> responses DELIVERED to clients off this replica
        #: (a quarantined fence-audit batch is not delivered, by design)
        self.delivered: dict[str, int] = {}
        #: router state: smoothed batch wall (None until the first batch
        #: lands — fresh workers outrank everyone so each gets fed early)
        self.ewma_wall: float | None = None
        self.idle_rounds = 0
        #: monotonic stamp of the last successful exchange; None until
        #: first contact (a worker still importing/loading its checkpoint
        #: must not be heartbeat-probed into a false quarantine)
        self.last_io_t: float | None = None
        self.heartbeat_misses = 0
        #: requests re-dispatched AWAY from this replica after it failed
        self.redispatches = 0
        #: perf_counter offset estimate (peer - local, µs) and half-RTT
        #: uncertainty, refreshed whenever a tighter probe lands; spans
        #: the worker ships are corrected by the negated offset
        self.clock_offset_us: float | None = None
        self.clock_uncertainty_us: float = 0.0

    @property
    def alive(self) -> bool:
        if self.quarantined or self.dead or self.wedged:
            return False
        return self.proc is None or self.proc.poll() is None

    # -- transport-failure bookkeeping ---------------------------------------
    def _transport_failed(self, e: TransportError) -> ReplicaDeadError:
        if isinstance(e, TransportTimeout):
            self.wedged = True
            _obs.record_transport_timeout(self.idx, e.phase)
            return ReplicaWedgedError(
                f"replica {self.idx} ({self.host}): {e}")
        self.dead = True
        return ReplicaDeadError(f"replica {self.idx} ({self.host}): {e}")

    def _gone(self, what: str) -> ReplicaDeadError:
        self.dead = True
        rc = self.proc.poll() if self.proc is not None else None
        return ReplicaDeadError(
            f"replica {self.idx} ({self.host}): {what} (rc {rc})")

    def _recv_obj(self, timeout_s: float | None, what: str) -> dict:
        """One parsed frame off the transport; failures mark this replica
        dead/wedged and raise the matching error."""
        try:
            raw = self.transport.recv_line(timeout_s)
        except TransportError as e:
            raise self._transport_failed(e) from e
        if raw is None:
            raise self._gone(f"EOF {what}")
        try:
            obj = json.loads(raw)
        except ValueError as e:
            raise self._gone(f"torn output line {what}") from e
        return obj

    # -- the wire calls (all I/O deadline-bearing; these run under the
    # coalescer lock, two levels above the raw fd waits) ---------------------
    def _absorb_reply_telemetry(self, obj: dict, t0: float,
                                t1: float) -> None:
        """Fold a control reply's piggyback into local state: refresh the
        clock-offset estimate when this probe bounds it at least as tight
        as the current one (ping RTTs beat batch walls), then merge any
        shipped spans into the local ring shifted by the NEGATED offset
        (the probe measures peer - local) with the exchange bracket
        ``(t0, t1)`` as the skew-sanity window."""
        clock = obj.get("clock_us")
        if isinstance(clock, (int, float)):
            off, unc = _trace.clock_offset_from_probe(t0, t1, float(clock))
            if (self.clock_offset_us is None
                    or unc <= self.clock_uncertainty_us):
                self.clock_offset_us = off
                self.clock_uncertainty_us = unc
        shipped = obj.get("spans")
        if shipped:
            _trace.ingest_foreign_spans(
                shipped, offset_us=-(self.clock_offset_us or 0.0),
                uncertainty_us=self.clock_uncertainty_us,
                window_us=(t0 * 1e6, t1 * 1e6), worker=self.idx)

    def run_batch(self, lines: list) -> dict:
        """Send one batch + flush, collect the envelopes.  Returns
        ``{seq: resp}``; raises :class:`ReplicaDeadError` /
        :class:`ReplicaWedgedError` on a broken or silent worker."""
        t0 = time.monotonic()
        try:
            self.transport.send_lines(
                list(lines) + [json.dumps({CONTROL_KEY: "flush"})])
        except TransportError as e:
            raise self._transport_failed(e) from e
        resps: dict = {}
        while True:
            obj = self._recv_obj(None, "mid-batch")
            if obj.get(CONTROL_KEY) == "flushed":
                flushed = obj
                break
            resps[int(obj["seq"])] = obj["resp"]
        t1 = time.monotonic()
        wall = t1 - t0
        self.ewma_wall = (wall if self.ewma_wall is None
                          else EWMA_ALPHA * wall
                          + (1.0 - EWMA_ALPHA) * self.ewma_wall)
        self.last_io_t = t1
        self._absorb_reply_telemetry(flushed, t0, t1)
        return resps

    def ping(self, timeout_s: float | None = None) -> None:
        """One heartbeat round trip; a miss marks this replica wedged.
        Doubling as the clock probe: the pong's ``clock_us`` against the
        tight ping RTT is the best offset estimate this replica gets."""
        t0 = time.monotonic()
        try:
            self.transport.send_frame({CONTROL_KEY: "ping"})
            raw = self.transport.recv_line(timeout_s)
        except TransportTimeout as e:
            self.heartbeat_misses += 1
            _obs.record_heartbeat_miss(self.idx)
            raise self._transport_failed(e) from e
        except TransportError as e:
            raise self._transport_failed(e) from e
        if raw is None:
            raise self._gone("EOF on heartbeat")
        try:
            obj = json.loads(raw)
        except ValueError as e:
            raise self._gone("torn heartbeat reply") from e
        if obj.get(CONTROL_KEY) != "pong":
            raise self._gone(f"bad heartbeat reply {raw[:64]!r}")
        t1 = time.monotonic()
        self.last_io_t = t1
        self._absorb_reply_telemetry(obj, t0, t1)

    def scrape(self, timeout_s: float | None = None) -> dict:
        """Live observability shard: the worker's serve summary + metrics
        snapshot, for the frontend's mid-run ``/metrics`` merge."""
        try:
            self.transport.send_frame({CONTROL_KEY: "metrics"})
        except TransportError as e:
            raise self._transport_failed(e) from e
        obj = self._recv_obj(timeout_s, "on metrics scrape")
        self.last_io_t = time.monotonic()
        return obj

    def reload_worker(self, timeout_s: float | None = None) -> dict:
        """One rolling-rollout step: tell the worker to re-fence NOW and
        report ``{"ok": ..., "generation": ...}``."""
        t0 = time.monotonic()
        try:
            self.transport.send_frame({CONTROL_KEY: "reload"})
        except TransportError as e:
            raise self._transport_failed(e) from e
        obj = self._recv_obj(timeout_s, "on reload")
        t1 = time.monotonic()
        self.last_io_t = t1
        self._absorb_reply_telemetry(obj, t0, t1)
        return obj

    def transport_counters(self) -> dict:
        """The manifest's per-replica transport block."""
        c = dict(self.transport.counters)
        c["failure_phases"] = dict(c["failure_phases"])
        c["heartbeat_misses"] = self.heartbeat_misses
        c["redispatches"] = self.redispatches
        return c

    def close(self, timeout: float = 30.0) -> int | None:
        """Graceful drain-out: half-closing the write side lets the
        worker answer its tail and write its manifest shard.  A wedged
        worker cannot drain — its process is killed outright.  Returns
        the exit code (None for a TCP replica, whose process belongs to
        another host)."""
        self.transport.close()
        if self.proc is None:
            # TCP: drain the tail so the remote worker's final writes
            # never block, then drop the socket; it writes its own shard
            try:
                while self.transport.recv_line(min(timeout, 5.0)) is not None:
                    pass
            except TransportError:
                pass
            self.transport.abort()
            return None
        if self.wedged:
            self.proc.kill()
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        return self.proc.poll()


def worker_cmd(state_path: str, *, worker_id: int, policy_args=(),
               python=None, device: str = "cuda") -> list:
    """The ``python -m mfm_tpu_torch.cli serve --worker`` argv for one
    replica, on ``device`` (the front end's)."""
    import sys
    py = python or sys.executable
    return ([py, "-m", "mfm_tpu_torch.cli", "serve", str(state_path),
             "--worker", "--worker-id", str(worker_id),
             "--device", str(device)]
            + list(policy_args))


def replica_env(idx: int, base_env=None) -> dict:
    """Worker environment with chaos-kill targeting: when
    ``MFM_CHAOS_KILL_REPLICA`` names this replica's index, the
    ``MFM_CHAOS_KILL``/``MFM_CHAOS_KILL_MATCH`` pair passes through;
    every other worker (and the front end, which never drains) runs
    clean — the drill kills exactly one replica."""
    env = dict(base_env if base_env is not None else os.environ)
    target = env.pop("MFM_CHAOS_KILL_REPLICA", None)
    if target is not None and int(target) != int(idx):
        env.pop("MFM_CHAOS_KILL", None)
        env.pop("MFM_CHAOS_KILL_MATCH", None)
    return env


class FleetServer(Coalescer):
    """The fleet dispatcher: a :class:`Coalescer` whose flush sends each
    batch to a worker replica instead of draining locally.

    ``server`` is the ADMISSION QueryServer (same engine/policy as the
    workers, but it never drains — its queue is the coalescing pool and
    its guards/shed/dead-letter run in-process so rejects never cost a
    pipe round trip).

    Args (beyond :class:`Coalescer`):
      heartbeat_s: a healthy replica idle this long is pinged before it
        gets another batch; a missed pong quarantines it (0 = off).
      heartbeat_timeout_s: how long a pong (or a live scrape) may take.
      rollout_check: optional zero-cost pointer probe returning the
        current checkpoint generation.  When set, the fleet is in
        ROLLING ROLLOUT mode: a generation move re-fences one worker at
        a time (see :meth:`_roll_fleet`) instead of letting everything
        self-poll.
    """

    #: dispatches a healthy replica may sit unpicked before the router
    #: must feed it regardless of EWMA rank (starvation guard — also
    #: what keeps slow-but-correct workers exercising their fence)
    starve_rounds = 4

    def __init__(self, server, replicas: list, *, linger_s: float = 0.01,
                 clock=None, deliver=None, cache=None,
                 heartbeat_s: float = 5.0,
                 heartbeat_timeout_s: float = 2.0,
                 rollout_check=None):
        super().__init__(server, linger_s=linger_s,
                         clock=clock or time.monotonic, deliver=deliver,
                         cache=cache)
        self.replicas = list(replicas)
        self.accepted_total = 0   # requests popped for dispatch
        #: outcome -> responses the FRONT END answered locally (deadline
        #: expiry in its queue, no-healthy-replica outage, dropped seq);
        #: merged into the fleet manifest so the delivery audit still
        #: balances — every accepted request's response is in exactly one
        #: ledger, a replica's or this one
        self.local_delivered: dict[str, int] = {}
        self.heartbeat_s = float(heartbeat_s)
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self._rollout_check = rollout_check
        # the generation the whole fleet last agreed on (rollout mode);
        # at construction every worker just loaded the pointed-at state
        self._fleet_generation = (rollout_check()
                                  if rollout_check is not None else None)

    # -- reload discipline ---------------------------------------------------
    # (callers hold self._lock, via Coalescer.submit/poll/flush/stop)
    def _poll_reload_locked(self) -> None:
        self._poll_generation()

    def _poll_generation(self) -> None:
        """The fleet's per-flush reload point.  Plain ``--watch`` fleets
        poll the admission server directly (workers self-poll too, and
        the response-cache fence rides the admission reload); a rollout
        fleet peeks the pointer and rolls workers one at a time."""
        if self._rollout_check is None:
            self.server.poll_reload()
            return
        gen = self._rollout_check()
        if gen is None or gen == self._fleet_generation:
            return
        self._roll_fleet(gen)

    def _roll_fleet(self, gen) -> None:
        """Rolling zero-downtime rollout: re-fence ONE worker at a time
        behind the generation fence.  Runs between batches (under the
        coalescer lock), so no batch ever straddles a generation.  The
        admission engine and the response-cache fence move LAST, only
        when every surviving worker reports ``gen`` — the fence the
        cache keys on can never run ahead of the fleet."""
        agreed = True
        for w in self.replicas:
            if not w.alive:
                continue
            reload_worker = getattr(w, "reload_worker", None)
            if reload_worker is None:
                continue
            try:
                rep = reload_worker()
            except ReplicaWedgedError:
                _obs.record_replica_quarantine()
                continue
            except ReplicaDeadError:
                _obs.record_replica_death()
                continue
            _obs.record_rollout_step()
            if not rep.get("ok", False):
                # its new generation failed the fence audit: the worker
                # is already rejecting (breaker open) — drain it out
                w.quarantined = True
                _obs.record_replica_quarantine()
                _frec.record_event("fence_audit_quarantine",
                                   replica=w.idx, generation=gen,
                                   during="rollout")
                _frec.trigger_dump("fence_audit",
                                   state=self._flightrec_state())
                continue
            if rep.get("generation") not in (None, gen):
                # pointer moved again mid-roll; re-roll next flush
                agreed = False
        if agreed:
            self.server.poll_reload()
            self._fleet_generation = gen

    # -- routing -------------------------------------------------------------
    def _next_replica(self):
        """Lowest-EWMA healthy worker, with two overrides: a FRESH worker
        (no batch yet) outranks everyone — each replica gets fed early,
        which is also what keeps deterministic drills deterministic for
        the first full cycle — and a worker starved past
        ``starve_rounds`` dispatches is fed regardless of rank."""
        healthy = [w for w in self.replicas if w.alive]
        if not healthy:
            return None
        starved = [w for w in healthy
                   if getattr(w, "idle_rounds", 0) >= self.starve_rounds]
        if starved:
            pick = max(starved,
                       key=lambda w: (getattr(w, "idle_rounds", 0), -w.idx))
        else:
            fresh = [w for w in healthy
                     if getattr(w, "ewma_wall", None) is None]
            pick = min(fresh or healthy,
                       key=lambda w: (getattr(w, "ewma_wall", None) or 0.0,
                                      w.idx))
        for w in healthy:
            w.idle_rounds = (0 if w is pick
                             else getattr(w, "idle_rounds", 0) + 1)
        return pick

    def _heartbeat_ok(self, w) -> bool:
        """Probe a long-idle replica before trusting it with a batch.
        Never probes a worker that has not answered ANYTHING yet (it may
        legitimately still be loading its checkpoint)."""
        ping = getattr(w, "ping", None)
        if ping is None or self.heartbeat_s <= 0:
            return True
        last = getattr(w, "last_io_t", None)
        if last is None or time.monotonic() - last < self.heartbeat_s:
            return True
        try:
            ping(self.heartbeat_timeout_s)
        except ReplicaWedgedError:
            _obs.record_replica_quarantine()
            return False
        except ReplicaDeadError:
            _obs.record_replica_death()
            return False
        return True

    # callers hold self._lock (Coalescer.submit/poll/flush/stop take it)
    def _flush_locked(self, trigger: str) -> list:
        out = []
        now = self._clock()
        lingered = (now - self._oldest_t) if self._oldest_t is not None else 0.0
        while self.server._queue:
            # move the fence HERE too (workers reload on their own, or
            # one at a time under --rollout): the admission engine,
            # health stamp, and the response-cache fence must track the
            # fleet, or the front-end cache would keep answering from a
            # retired generation after a hot reload
            self._poll_generation()
            batch = []
            while (self.server._queue
                   and len(batch) < self.server.policy.batch_max):
                batch.append(self.server._queue.popleft())
            _obs.record_queue_depth(len(self.server._queue))
            _obs.record_coalesce_flush(len(batch), bucket_for(len(batch)),
                                       trigger, lingered)
            lingered = 0.0
            self.accepted_total += len(batch)
            # enforce deadlines HERE, not just in the worker: workers
            # re-stamp deadlines at their own enqueue time, so time spent
            # lingering or queued at the front end would otherwise never
            # count against a request's budget — same check drain() runs
            live = []
            for r in batch:
                if now > r.deadline_t:
                    out.append(self._local_deadline(r))
                else:
                    live.append(r)
            if live:
                out.extend(self._dispatch(live))
        self._oldest_t = None
        return out

    def _count_local(self, outcome: str) -> None:
        self.local_delivered[outcome] = \
            self.local_delivered.get(outcome, 0) + 1

    def _local_error(self, r, detail: str) -> tuple:
        _obs.record_query_outcome("error")
        self._count_local("error")
        if r.span is not None:
            _trace.end_span(r.span, outcome="error")
        return (r.origin, self.server._stamp(
            {"id": r.rid, "ok": False, "outcome": "error",
             "detail": detail},
            scenario_id=r.scenario, trace_id=r.trace_id))

    def _local_deadline(self, r) -> tuple:
        _obs.record_query_outcome("deadline")
        self._count_local("deadline")
        if r.span is not None:
            _trace.end_span(r.span, outcome="deadline")
        return (r.origin, self.server._stamp(
            {"id": r.rid, "ok": False, "outcome": "deadline"},
            scenario_id=r.scenario, trace_id=r.trace_id))

    def _flightrec_state(self) -> dict:
        """The live-context block a triggered flight-recorder dump
        bundles: breaker, rollout generation, per-replica ledgers."""
        b = self.server.breaker
        return {
            "breaker": {"state": b.state, "open_reason": b.open_reason},
            "fleet_generation": self._fleet_generation,
            "accepted_total": self.accepted_total,
            "replicas": [
                {"replica": w.idx, "host": getattr(w, "host", "local"),
                 "alive": bool(getattr(w, "alive", True)),
                 "quarantined": bool(getattr(w, "quarantined", False)),
                 "wedged": bool(getattr(w, "wedged", False)),
                 "dead": bool(getattr(w, "dead", False)),
                 "delivered_total": sum(getattr(w, "delivered",
                                                {}).values())}
                for w in self.replicas],
        }

    def _dispatch(self, batch: list) -> list:
        lines = [r.line for r in batch]
        head = batch[0]
        while True:
            w = self._next_replica()
            if w is None:
                _frec.record_event("fleet_outage", trace_id=head.trace_id,
                                   n=len(lines))
                return [self._local_error(r, "no healthy replicas")
                        for r in batch]
            if not self._heartbeat_ok(w):
                continue   # quarantined before the batch left — no loss
            _obs.record_fleet_dispatch(w.idx, len(lines))
            _frec.record_event("dispatch", trace_id=head.trace_id,
                               replica=w.idx, n=len(lines))
            dsp = None
            wire = lines
            if _trace.tracing_enabled():
                # the dispatch span is the worker.batch span's parent;
                # each request's admission span parents its worker.recv
                dsp = _trace.start_span(
                    "fleet.dispatch", trace_id=head.trace_id,
                    parent_id=(head.span.span_id
                               if head.span is not None else None),
                    replica=w.idx, n=len(lines))
                if getattr(w, "accepts_trace_frames", False):
                    payload = {"op": "batch", "trace": {
                        "dispatch": [dsp.trace_id, dsp.span_id],
                        "parents": [
                            [r.trace_id,
                             (r.span.span_id if r.span is not None
                              else None)]
                            for r in batch]}}
                    wire = [json.dumps({CONTROL_KEY: payload},
                                       sort_keys=True)] + lines
            try:
                resps = w.run_batch(wire)
            except ReplicaWedgedError:
                # alive-but-frozen mid-batch: quarantine exactly like a
                # death and re-dispatch; close() kills it at shutdown
                w.redispatches = getattr(w, "redispatches", 0) + len(lines)
                _obs.record_replica_quarantine()
                _obs.record_fleet_redispatch(len(lines))
                if dsp is not None:
                    _trace.end_span(dsp, outcome="wedged")
                _frec.record_event("wedge_quarantine",
                                   trace_id=head.trace_id, replica=w.idx,
                                   n=len(lines))
                _frec.trigger_dump("wedge_quarantine",
                                   trace_id=head.trace_id,
                                   state=self._flightrec_state())
                continue
            except ReplicaDeadError:
                w.redispatches = getattr(w, "redispatches", 0) + len(lines)
                _obs.record_replica_death()
                _obs.record_fleet_redispatch(len(lines))
                if dsp is not None:
                    _trace.end_span(dsp, outcome="dead")
                _frec.record_event("replica_death",
                                   trace_id=head.trace_id, replica=w.idx,
                                   n=len(lines))
                continue
            if (len(resps) == len(lines) and resps and
                    all(isinstance(v, dict)
                        and v.get("breaker") == "fence_audit"
                        for v in resps.values())):
                # the replica's own reload failed its fence audit: drain
                # it out (no more batches; graceful close at shutdown so
                # it still writes its manifest shard) and re-dispatch
                w.quarantined = True
                w.redispatches = getattr(w, "redispatches", 0) + len(lines)
                _obs.record_replica_quarantine()
                _obs.record_fleet_redispatch(len(lines))
                if dsp is not None:
                    _trace.end_span(dsp, outcome="fence_audit")
                _frec.record_event("fence_audit_quarantine",
                                   trace_id=head.trace_id, replica=w.idx,
                                   n=len(lines))
                _frec.trigger_dump("fence_audit", trace_id=head.trace_id,
                                   state=self._flightrec_state())
                continue
            if dsp is not None:
                _trace.end_span(dsp, outcome="ok")
            pairs = []
            for i, r in enumerate(batch):
                resp = resps.get(i)
                if resp is None:
                    pairs.append(self._local_error(
                        r, f"replica {w.idx} dropped seq {i}"))
                    continue
                outcome = str(resp.get("outcome", "error"))
                _obs.record_query_outcome(outcome)
                w.delivered[outcome] = w.delivered.get(outcome, 0) + 1
                if r.span is not None:
                    _trace.end_span(r.span, outcome=outcome)
                pairs.append((r.origin, resp))
            return pairs

    # -- live observability ---------------------------------------------------
    def scrape_fleet(self) -> list:
        """Live per-worker shards for the frontend's mid-run ``/metrics``
        and ``/healthz`` merge — each marked by replica ordinal.  Runs
        the probes under the coalescer lock (never mid-batch); a worker
        that fails its scrape is quarantined like any transport failure."""
        shards = []
        with self._lock:
            for w in self.replicas:
                entry = {"replica": w.idx,
                         "host": getattr(w, "host", "local"),
                         "alive": bool(w.alive),
                         "quarantined": bool(getattr(w, "quarantined",
                                                     False)),
                         "wedged": bool(getattr(w, "wedged", False))}
                tc = getattr(w, "transport_counters", None)
                if callable(tc):
                    entry["transport"] = tc()
                scrape = getattr(w, "scrape", None)
                if entry["alive"] and callable(scrape):
                    try:
                        obj = scrape(self.heartbeat_timeout_s)
                    except ReplicaDeadError:
                        obj = None
                        entry["alive"] = bool(w.alive)
                    if isinstance(obj, dict):
                        entry["summary"] = obj.get("summary")
                        entry["metrics"] = obj.get("metrics")
                shards.append(entry)
        return shards

    def close_replicas(self) -> None:
        for w in self.replicas:
            w.close()


# -- merged manifest ----------------------------------------------------------

def build_fleet_manifest(frontend_summary: dict, fleet,
                         manifest_dir: str) -> dict:
    """Merge the front end's summary with every replica's ledger + its
    manifest shard (a SIGKILLed worker has no shard — that IS the loss
    the manifest counts).  The ``audit`` block is the doctor invariant:
    per-replica delivered outcome counts plus the front end's own
    locally-answered ledger (deadline expiry at the front end, outage
    errors, dropped seqs — all well-formed responses clients DID receive)
    must sum to the accepted count.  Each replica also carries its
    transport counters (reconnects, heartbeat misses, redispatches, I/O
    timeouts by phase), totalled in the top-level ``transport`` block."""
    from mfm_tpu_torch.obs.manifest import ManifestError, read_run_manifest
    reps = []
    outcomes_sum = 0
    totals = {"reconnects": 0, "heartbeat_misses": 0, "redispatches": 0,
              "io_timeouts": 0}
    for w in fleet.replicas:
        proc = getattr(w, "proc", None)
        rc = proc.poll() if proc is not None else None
        shard_path = os.path.join(manifest_dir,
                                  WORKER_MANIFEST_FMT.format(idx=w.idx))
        shard = None
        try:
            shard = read_run_manifest(shard_path).get("serve")
        except (ManifestError, OSError):
            pass
        total = sum(w.delivered.values())
        outcomes_sum += total
        tcfn = getattr(w, "transport_counters", None)
        tc = tcfn() if callable(tcfn) else None
        if isinstance(tc, dict):
            totals["reconnects"] += int(tc.get("reconnects", 0))
            totals["heartbeat_misses"] += int(tc.get("heartbeat_misses", 0))
            totals["redispatches"] += int(tc.get("redispatches", 0))
            totals["io_timeouts"] += (int(tc.get("send_timeouts", 0))
                                      + int(tc.get("recv_timeouts", 0)))
        reps.append({
            "replica": w.idx,
            "host": getattr(w, "host", "local"),
            "exit_code": rc,
            "lost": bool(getattr(w, "dead", False)
                         or (rc is not None and rc != 0)),
            "wedged": bool(getattr(w, "wedged", False)),
            "quarantined": bool(w.quarantined),
            "outcomes": dict(sorted(w.delivered.items())),
            "outcomes_total": total,
            "transport": tc,
            "manifest_shard": (WORKER_MANIFEST_FMT.format(idx=w.idx)
                               if shard is not None else None),
            "worker_summary": shard,
        })
    accepted = int(fleet.accepted_total)
    local = dict(sorted(getattr(fleet, "local_delivered", {}).items()))
    local_total = sum(local.values())
    slo = (frontend_summary.get("slo")
           if isinstance(frontend_summary, dict) else None)
    return {
        "schema": 1,
        "frontend": frontend_summary,
        "slo": slo,
        "flightrec": {"armed": _frec.armed_path() is not None,
                      "events": len(_frec.events())},
        "accepted_total": accepted,
        "replicas": reps,
        "transport": totals,
        "frontend_local": {
            "outcomes": local,
            "outcomes_total": local_total,
        },
        "audit": {
            "replica_outcomes_sum": outcomes_sum,
            "frontend_local_total": local_total,
            "delivered_total": outcomes_sum + local_total,
            "accepted_total": accepted,
            "consistent": outcomes_sum + local_total == accepted,
        },
    }
