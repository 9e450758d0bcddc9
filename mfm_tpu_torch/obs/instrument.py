"""Instrumentation of the serving stack: the metric catalog and the
host-side recording helpers (counterpart of the serving part of
``mfm_tpu/obs/instrument.py``; metric names and summary keys are the
reference's).

Everything records host values — clocks around a device batch, counts,
outcomes — never device tensors.  The catalog here covers what the query
loop, the response cache, the coalescer, the serving fleet (front end,
replicas, transport), the SLO engine, the span ring and its fleet-wire
merge, the flight recorder, retries, the scenario engine and the
streaming sweep record, the guard tallies of a guarded step, the update
latency, the per-stage walls the manifests' guard block and the CLI
read, the fenced checkpoint's saves, loads and refusals
(data/artifacts.py), and the compile counters and compiled-memory gauges.
Eager torch compiles no program, so the compile counter counts the events
that stand in a lowering's place (:mod:`mfm_tpu_torch.utils.contracts`:
a kernel library's build or load, a new eigh or serving-bucket
signature), and the memory gauges export :func:`mfm_tpu_torch.utils.obs.
compiled_memory`'s measurement of one run.
"""

from __future__ import annotations

import contextlib
import time

from mfm_tpu_torch.obs.metrics import REGISTRY

# -- guard verdicts (read by the manifests' guard block and the SLO engine) --

GUARD_REASON_TOTAL = REGISTRY.counter(
    "mfm_guard_reason_total",
    "guard trips by reason bit (one date may tally several reasons)",
    labelnames=("reason",))
QUARANTINED_DATES_TOTAL = REGISTRY.counter(
    "mfm_quarantined_dates_total", "dates excised by the quarantine policy")
SERVED_DATES_TOTAL = REGISTRY.counter(
    "mfm_served_dates_total", "dates served (healthy + degraded-mode)")
SERVED_COV_STALENESS = REGISTRY.gauge(
    "mfm_served_cov_staleness",
    "dates since the most recently served covariance was fit (0 = fresh)")
QUARANTINE_COUNT = REGISTRY.gauge(
    "mfm_quarantine_count", "quarantined dates in the last guarded step")
UPDATE_LATENCY = REGISTRY.histogram(
    "mfm_update_latency_seconds", "guarded/unguarded update step wall time")

STAGE_SECONDS = REGISTRY.gauge(
    "mfm_stage_seconds", "last wall time of a pipeline/risk stage",
    labelnames=("stage",))
COMPILED_BYTES = REGISTRY.gauge(
    "mfm_compiled_bytes",
    "compiled-program memory analysis (utils.obs.compiled_memory)",
    labelnames=("stage", "kind"))

# -- fenced checkpoints (data/artifacts.py) -----------------------------------

CHECKPOINT_SAVES_TOTAL = REGISTRY.counter(
    "mfm_checkpoint_saves_total", "fenced artifact saves")
CHECKPOINT_LOADS_TOTAL = REGISTRY.counter(
    "mfm_checkpoint_loads_total", "fenced artifact loads")
CHECKPOINT_CORRUPT_TOTAL = REGISTRY.counter(
    "mfm_checkpoint_corrupt_total",
    "checksum/fence verification failures on load")
CHECKPOINT_STALE_TOTAL = REGISTRY.counter(
    "mfm_checkpoint_stale_total", "generation-fence rejections on load")
CHECKPOINT_HEAL_FORWARD_TOTAL = REGISTRY.counter(
    "mfm_checkpoint_heal_forward_total",
    "pointer heal-forwards after a crash between rename and pointer swap")
CHECKPOINT_GENERATION = REGISTRY.gauge(
    "mfm_checkpoint_generation", "generation fence of the last save/load")
CHECKPOINT_SAVE_SECONDS = REGISTRY.histogram(
    "mfm_checkpoint_save_seconds", "artifact save wall time")
CHECKPOINT_LOAD_SECONDS = REGISTRY.histogram(
    "mfm_checkpoint_load_seconds", "artifact load wall time")

# -- compile-standing events (utils/contracts.py) ------------------------------

JIT_COMPILES_TOTAL = REGISTRY.counter(
    "mfm_jit_compiles_total",
    "jit lowerings observed since watch_compiles() (steady state: flat)")
JIT_COMPILE_SECONDS = REGISTRY.histogram(
    "mfm_jit_compile_seconds",
    "per-executable lowering/compile wall (obs.profile.capture_compile_walls)",
    buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 15.0, 60.0))

# -- retries (data/etl.py with_retry) -----------------------------------------

RETRY_ATTEMPTS_TOTAL = REGISTRY.counter(
    "mfm_retry_attempts_total", "with_retry attempts by outcome",
    labelnames=("outcome",))   # outcome: ok | retried | exhausted
RETRY_BACKOFF_SECONDS = REGISTRY.histogram(
    "mfm_retry_backoff_seconds", "with_retry sleep durations",
    buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0))

# -- tracing (obs/trace.py span ring) -----------------------------------------

TRACE_SPANS_TOTAL = REGISTRY.counter(
    "mfm_trace_spans_total", "spans finished and recorded to the trace ring")
TRACE_DROPPED_TOTAL = REGISTRY.counter(
    "mfm_trace_dropped_total",
    "oldest spans evicted by ring-buffer overflow (trace is lossy past "
    "capacity, but counted)")
TRACE_FOREIGN_SPANS_TOTAL = REGISTRY.counter(
    "mfm_trace_foreign_spans_total",
    "worker spans merged into this process's ring off the fleet wire "
    "(clock-offset corrected before insertion)")
TRACE_SKEW_UNCORRECTABLE_TOTAL = REGISTRY.counter(
    "mfm_trace_skew_uncorrectable_total",
    "merged foreign spans whose corrected timeline still fell outside "
    "the dispatch window beyond the offset uncertainty (flagged "
    "clock_skew=uncorrectable on the span, never reordered)")

# -- flight recorder (obs/flightrec.py postmortem ring) -----------------------

FLIGHTREC_EVENTS_TOTAL = REGISTRY.counter(
    "mfm_flightrec_events_total",
    "events recorded to the flight-recorder ring")
FLIGHTREC_DROPPED_TOTAL = REGISTRY.counter(
    "mfm_flightrec_dropped_total",
    "oldest flight-recorder events evicted by ring overflow")
FLIGHTREC_DUMPS_TOTAL = REGISTRY.counter(
    "mfm_flightrec_dumps_total",
    "atomic flightrec.json dumps by trigger",
    labelnames=("trigger",))   # breaker_open | wedge_quarantine |
#                                fence_audit | sigterm | manual

# -- SLO burn-rate engine (obs/slo.py) ----------------------------------------

SLO_BURN_RATE = REGISTRY.gauge(
    "mfm_slo_burn_rate",
    "error-budget burn rate per SLO and window (1.0 = burning exactly "
    "the budget; fast window trips paging, slow window trips tickets)",
    labelnames=("slo", "window"))   # window: fast | slow
SLO_STATE = REGISTRY.gauge(
    "mfm_slo_state",
    "SLO alert state (0 ok, 1 slow_burn, 2 fast_burn)",
    labelnames=("slo",))
SLO_BREACHES_TOTAL = REGISTRY.counter(
    "mfm_slo_breaches_total",
    "evaluations that found an SLO in a burning state",
    labelnames=("slo", "state"))

# -- query service (serve/server.py request loop) -----------------------------

QUERY_REQUESTS_TOTAL = REGISTRY.counter(
    "mfm_query_requests_total", "portfolio-query requests by final outcome",
    labelnames=("outcome",))   # ok | dead_letter | shed | rejected |
#                                deadline | error
QUERY_PORTFOLIOS_TOTAL = REGISTRY.counter(
    "mfm_query_portfolios_total", "portfolios answered (ok outcomes)")
QUERY_BATCH_SECONDS = REGISTRY.histogram(
    "mfm_query_batch_seconds", "device step wall time per drained batch")
QUERY_BATCH_SIZE = REGISTRY.histogram(
    "mfm_query_batch_size", "true (unpadded) portfolios per drained batch",
    buckets=(1, 2, 8, 32, 128, 512, 2048, 8192, 32768, 131072, 524288))
QUERY_LATENCY_SECONDS = REGISTRY.histogram(
    "mfm_query_latency_seconds",
    "enqueue-to-response wall time per answered request")
QUERY_QUEUE_DEPTH = REGISTRY.gauge(
    "mfm_query_queue_depth", "admission queue depth after the last event")
QUERY_SHED_TOTAL = REGISTRY.counter(
    "mfm_query_shed_total",
    "requests dropped (oldest-first) by queue-overflow load shedding")
BREAKER_OPEN_TOTAL = REGISTRY.counter(
    "mfm_breaker_open_total",
    "circuit-breaker transitions into the open state")
BREAKER_STATE = REGISTRY.gauge(
    "mfm_breaker_state", "circuit breaker state (0 closed, 1 half_open, "
    "2 open)")

_BREAKER_STATE_CODE = {"closed": 0, "half_open": 1, "open": 2}
_BREAKER_CODE_STATE = {v: k for k, v in _BREAKER_STATE_CODE.items()}

# -- coalescer (serve/coalesce.py) --------------------------------------------

COALESCE_FLUSHES_TOTAL = REGISTRY.counter(
    "mfm_coalesce_flushes_total", "coalescer flushes by trigger",
    labelnames=("trigger",))   # full | linger | eof
COALESCE_BATCH_FILL = REGISTRY.histogram(
    "mfm_coalesce_batch_fill",
    "true queued requests / geometric bucket capacity per coalesced flush "
    "(1.0 = the batch dispatch was fully amortized)",
    buckets=(0.05, 0.1, 0.25, 0.5, 0.625, 0.75, 0.875, 1.0))
COALESCE_LINGER_SECONDS = REGISTRY.histogram(
    "mfm_coalesce_linger_seconds",
    "oldest-request wait inside the coalescer at flush time",
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
             0.5, 1.0))

# -- serving fleet (serve/frontend.py, serve/replica.py, serve/transport.py) --

FRONTEND_CONNECTIONS_TOTAL = REGISTRY.counter(
    "mfm_frontend_connections_total", "client connections accepted")
FLEET_DISPATCH_TOTAL = REGISTRY.counter(
    "mfm_fleet_dispatch_total",
    "admitted request lines dispatched to worker replicas",
    labelnames=("replica",))
FLEET_REPLICA_DEATHS_TOTAL = REGISTRY.counter(
    "mfm_fleet_replica_deaths_total",
    "worker replicas lost mid-serve (crash/SIGKILL — their in-flight "
    "batch is re-dispatched to survivors)")
FLEET_REPLICA_QUARANTINED_TOTAL = REGISTRY.counter(
    "mfm_fleet_replica_quarantined_total",
    "worker replicas drained out after failing their fence audit")
FLEET_REDISPATCH_TOTAL = REGISTRY.counter(
    "mfm_fleet_redispatch_total",
    "request lines re-dispatched after a replica death or quarantine")
FLEET_TRANSPORT_RECONNECTS_TOTAL = REGISTRY.counter(
    "mfm_fleet_transport_reconnects_total",
    "extra worker connect attempts beyond the first (with_retry backoff "
    "while the worker was still loading its checkpoint)",
    labelnames=("replica",))
FLEET_TRANSPORT_HEARTBEAT_MISSES_TOTAL = REGISTRY.counter(
    "mfm_fleet_transport_heartbeat_misses_total",
    "heartbeat pings a worker failed to answer within the deadline "
    "(wedged worker: quarantined, its batch re-dispatched)",
    labelnames=("replica",))
FLEET_TRANSPORT_IO_TIMEOUTS_TOTAL = REGISTRY.counter(
    "mfm_fleet_transport_io_timeouts_total",
    "per-I/O deadline expiries on worker reads/writes by failure phase "
    "(connect = never attached, batch = lost mid-batch)",
    labelnames=("replica", "phase"))
FLEET_ROLLOUT_STEPS_TOTAL = REGISTRY.counter(
    "mfm_fleet_rollout_steps_total",
    "single-worker re-fence steps completed by rolling checkpoint "
    "rollouts (one per worker per generation crossed)")

# -- response cache (serve/cache.py content-addressed reuse) ------------------

CACHE_HITS_TOTAL = REGISTRY.counter(
    "mfm_cache_hits_total",
    "response-cache hits (cached body re-stamped with the caller's "
    "id/trace_id)")
CACHE_MISSES_TOTAL = REGISTRY.counter(
    "mfm_cache_misses_total",
    "response-cache misses (request rode the cold path)")
CACHE_EVICTIONS_TOTAL = REGISTRY.counter(
    "mfm_cache_evictions_total",
    "entries evicted (LRU) by the entry/byte bounds — includes entries "
    "stranded behind an old generation fence")
CACHE_BYTES_TOTAL = REGISTRY.counter(
    "mfm_cache_bytes_total",
    "cumulative response-body bytes inserted into the cache")
CACHE_ENTRIES = REGISTRY.gauge(
    "mfm_cache_entries", "resident response-cache entries")
CACHE_RESIDENT_BYTES = REGISTRY.gauge(
    "mfm_cache_resident_bytes", "resident response-cache body bytes")
CACHE_HIT_LATENCY_SECONDS = REGISTRY.histogram(
    "mfm_cache_hit_latency_seconds",
    "lookup-to-restamped-response wall time on a cache hit",
    buckets=(0.000005, 0.00001, 0.000025, 0.00005, 0.0001, 0.00025,
             0.0005, 0.001, 0.0025, 0.01))
RESPONSES_DELIVERED_TOTAL = REGISTRY.counter(
    "mfm_responses_delivered_total",
    "responses delivered through the caching layer (hits + computed); "
    "delivered == computed + hits is the delivery audit")
CONSTRUCT_WARM_STARTS_TOTAL = REGISTRY.counter(
    "mfm_construct_warm_starts_total",
    "construction solves seeded from a near-miss cached solution")
CONSTRUCT_WARM_STEPS_SAVED_TOTAL = REGISTRY.counter(
    "mfm_construct_warm_steps_saved_total",
    "solver iterations saved by warm-started construction solves")


# -- scenario engine (scenario/engine.py batched stress tests) ----------------

SCENARIOS_RUN_TOTAL = REGISTRY.counter(
    "mfm_scenarios_run_total", "scenarios answered by admission outcome",
    labelnames=("status",))   # ok | rejected
SCENARIO_BATCH_SECONDS = REGISTRY.histogram(
    "mfm_scenario_batch_seconds",
    "device wall time per batched scenario run (all S lanes, one call)")
SCENARIO_BATCH_SIZE = REGISTRY.histogram(
    "mfm_scenario_batch_size", "true (unpadded) scenarios per batch",
    buckets=(1, 2, 8, 32, 128, 512, 2048, 8192, 32768))
SCENARIO_PSD_PROJECTIONS_TOTAL = REGISTRY.counter(
    "mfm_scenario_psd_projections_total",
    "lanes whose stressed covariance went indefinite and was projected "
    "back to PSD (corr stress past the feasible cone)")

# -- streaming sweeps (scenario/sweep.py) -------------------------------------

SWEEP_SCENARIOS_TOTAL = REGISTRY.counter(
    "mfm_sweep_scenarios_total",
    "sweep lanes streamed by admission outcome",
    labelnames=("status",))   # ok | rejected
SWEEP_CHUNKS_TOTAL = REGISTRY.counter(
    "mfm_sweep_chunks_total",
    "chunk folds dispatched by sweeps (hot path + offender flushes)")
SWEEP_SECONDS = REGISTRY.histogram(
    "mfm_sweep_seconds",
    "host wall time per full sweep (carry pull included)")
SWEEP_OFFENDER_LANES_TOTAL = REGISTRY.counter(
    "mfm_sweep_offender_lanes_total",
    "lanes the host inertia certificate could not vouch for, routed "
    "through the exact per-lane eigh path")
SWEEP_PSD_PROJECTIONS_TOTAL = REGISTRY.counter(
    "mfm_sweep_psd_projections_total",
    "offender lanes whose stressed covariance was projected back to PSD "
    "before merging")


# -- recording helpers ----------------------------------------------------------

def record_guard_report(report) -> None:
    """Tally one guarded step's verdicts (host-side, off the report the
    update returned; one host copy of each per-date field)."""
    from mfm_tpu_torch.data.artifacts import _numpy
    from mfm_tpu_torch.serve import guard

    q = _numpy(report.quarantined).astype(bool)
    reasons = _numpy(report.reasons)
    staleness = _numpy(report.staleness)
    n_q = int(q.sum())
    if n_q:
        QUARANTINED_DATES_TOTAL.inc(n_q)
    SERVED_DATES_TOTAL.inc(int(q.shape[0]))
    QUARANTINE_COUNT.set_value(n_q)
    if staleness.size:
        SERVED_COV_STALENESS.set_value(int(staleness[-1]))
    for bit, name in guard._REASON_NAMES:
        n = int(((reasons & bit) != 0).sum())
        if n:
            GUARD_REASON_TOTAL.inc(n, reason=name)


def record_update_latency(seconds: float) -> None:
    UPDATE_LATENCY.observe(float(seconds))


def record_stage_seconds(stage: str, seconds: float) -> None:
    STAGE_SECONDS.set_value(float(seconds), stage=stage)


def record_compiled_memory(stage: str, mem: dict) -> None:
    """Export a ``utils.obs.compiled_memory`` analysis as labeled gauges."""
    for kind, v in mem.items():
        if isinstance(v, (int, float)):
            COMPILED_BYTES.set_value(float(v), stage=stage, kind=kind)


_COMPILE_WATCHER = None


def watch_compiles() -> None:
    """Install a process-lifetime watcher on the compile-contract events
    (:mod:`mfm_tpu_torch.utils.contracts`: a kernel build or load, a new
    eigh or bucket signature) feeding ``mfm_jit_compiles_total``
    (idempotent)."""
    global _COMPILE_WATCHER
    if _COMPILE_WATCHER is not None:
        return
    from mfm_tpu_torch.utils import contracts

    def _watcher(event: str, detail: str = "", seconds=None) -> None:
        JIT_COMPILES_TOTAL.inc()

    contracts._WATCHERS.append(_watcher)
    _COMPILE_WATCHER = _watcher


def unwatch_compiles() -> None:
    """Remove the watcher installed by :func:`watch_compiles` (tests)."""
    global _COMPILE_WATCHER
    if _COMPILE_WATCHER is None:
        return
    from mfm_tpu_torch.utils import contracts

    if _COMPILE_WATCHER in contracts._WATCHERS:
        contracts._WATCHERS.remove(_COMPILE_WATCHER)
    _COMPILE_WATCHER = None


@contextlib.contextmanager
def time_stage(stage: str):
    """Span a host-side stage; sets ``mfm_stage_seconds{stage=...}``.

    The body must synchronize its device work before exiting
    (:func:`mfm_tpu_torch.utils.obs.force`); this span only reads the
    clock, it never waits for the card itself.
    """
    t0 = time.perf_counter()
    try:
        yield
    finally:
        record_stage_seconds(stage, time.perf_counter() - t0)


def record_foreign_spans(n: int, uncorrectable: int = 0) -> None:
    """Tally one fleet-wire span merge: spans ingested + how many were
    flagged with uncorrectable clock skew."""
    if n:
        TRACE_FOREIGN_SPANS_TOTAL.inc(int(n))
    if uncorrectable:
        TRACE_SKEW_UNCORRECTABLE_TOTAL.inc(int(uncorrectable))


def record_flightrec_event(n: int = 1, dropped: int = 0) -> None:
    FLIGHTREC_EVENTS_TOTAL.inc(int(n))
    if dropped:
        FLIGHTREC_DROPPED_TOTAL.inc(int(dropped))


def record_flightrec_dump(trigger: str) -> None:
    FLIGHTREC_DUMPS_TOTAL.inc(1, trigger=str(trigger))


def record_slo_state(slo: str, state: str, burn_fast: float,
                     burn_slow: float) -> None:
    """Mirror one SLO evaluation onto the gauges; a burning state also
    tallies ``mfm_slo_breaches_total``."""
    SLO_BURN_RATE.set_value(float(burn_fast), slo=slo, window="fast")
    SLO_BURN_RATE.set_value(float(burn_slow), slo=slo, window="slow")
    SLO_STATE.set_value(
        {"ok": 0, "slow_burn": 1, "fast_burn": 2}.get(state, 0), slo=slo)
    if state != "ok":
        SLO_BREACHES_TOTAL.inc(1, slo=slo, state=state)


def record_query_outcome(outcome: str, n: int = 1) -> None:
    QUERY_REQUESTS_TOTAL.inc(n, outcome=outcome)


def record_query_batch(n_true: int, seconds: float) -> None:
    """Tally one drained batch: true (unpadded) size + device wall."""
    QUERY_BATCH_SIZE.observe(int(n_true))
    QUERY_BATCH_SECONDS.observe(float(seconds))
    QUERY_PORTFOLIOS_TOTAL.inc(int(n_true))


def record_query_latency(seconds: float) -> None:
    QUERY_LATENCY_SECONDS.observe(float(seconds))


def record_queue_depth(depth: int) -> None:
    QUERY_QUEUE_DEPTH.set_value(int(depth))


def record_shed(n: int = 1) -> None:
    QUERY_SHED_TOTAL.inc(int(n))


def record_breaker_state(state: str) -> None:
    """Mirror a breaker transition onto the gauge; entering ``open`` also
    tallies ``mfm_breaker_open_total``."""
    BREAKER_STATE.set_value(_BREAKER_STATE_CODE[state])
    if state == "open":
        BREAKER_OPEN_TOTAL.inc()


def serve_summary_from_registry() -> dict:
    """The manifest's query-service block, off the live counters (the
    reference's keys).  A breaker left open at shutdown
    (``breaker_state`` = "open") marks a failed serve run even if every
    request got a well-formed response."""
    outcomes = {k[0]: int(v) for k, v in QUERY_REQUESTS_TOTAL.series().items()}
    total = sum(outcomes.values())
    shed = int(QUERY_SHED_TOTAL.value())
    state_code = int(BREAKER_STATE.value())
    p50 = QUERY_LATENCY_SECONDS.quantile_est(0.5)
    p99 = QUERY_LATENCY_SECONDS.quantile_est(0.99)
    out = {
        "requests": outcomes,
        "requests_total": total,
        "portfolios_total": int(QUERY_PORTFOLIOS_TOTAL.value()),
        "shed_total": shed,
        "shed_rate": (round(shed / total, 6) if total else 0.0),
        "breaker_open_total": int(BREAKER_OPEN_TOTAL.value()),
        "breaker_state": _BREAKER_CODE_STATE.get(state_code, "closed"),
        "query_p50_latency_s": (None if p50 != p50 else round(p50, 6)),
        "query_p99_latency_s": (None if p99 != p99 else round(p99, 6)),
        "cache": cache_summary_from_registry(),
    }
    # the SLO block rides along whenever an engine is installed (the
    # serve CLI installs one): /healthz, the serve/fleet manifests and
    # doctor --serve all read the same evaluation.  Deferred import —
    # obs/slo.py reads this module's catalog.
    from mfm_tpu_torch.obs import slo as _slo
    slo_block = _slo.installed_summary()
    if slo_block is not None:
        out["slo"] = slo_block
    return out


def record_coalesce_flush(n_true: int, capacity: int, trigger: str,
                          lingered_s: float) -> None:
    """Tally one coalesced flush: fill fraction vs the geometric bucket
    the batch padded to, what triggered it, and how long the oldest
    queued request lingered."""
    COALESCE_FLUSHES_TOTAL.inc(1, trigger=trigger)
    if capacity > 0:
        COALESCE_BATCH_FILL.observe(min(1.0, n_true / capacity))
    COALESCE_LINGER_SECONDS.observe(max(0.0, float(lingered_s)))


def record_frontend_connection(n: int = 1) -> None:
    FRONTEND_CONNECTIONS_TOTAL.inc(int(n))


def record_cache_hit(latency_s: float) -> None:
    CACHE_HITS_TOTAL.inc()
    CACHE_HIT_LATENCY_SECONDS.observe(max(0.0, float(latency_s)))


def record_cache_miss() -> None:
    CACHE_MISSES_TOTAL.inc()


def record_cache_store(size_bytes: int, evicted: int,
                       entries_now: int, resident_now: int) -> None:
    """Tally one cache insertion: bytes added, entries it displaced, and
    the resulting occupancy gauges."""
    CACHE_BYTES_TOTAL.inc(int(size_bytes))
    if evicted:
        CACHE_EVICTIONS_TOTAL.inc(int(evicted))
    CACHE_ENTRIES.set_value(int(entries_now))
    CACHE_RESIDENT_BYTES.set_value(int(resident_now))


def record_responses_delivered(n: int = 1) -> None:
    RESPONSES_DELIVERED_TOTAL.inc(int(n))


def record_warm_start(steps_saved: int) -> None:
    CONSTRUCT_WARM_STARTS_TOTAL.inc()
    CONSTRUCT_WARM_STEPS_SAVED_TOTAL.inc(int(steps_saved))


def cache_summary_from_registry() -> dict:
    """The response-cache summary block, off the live counters.

    ``delivered_total`` counts every response that left through the
    caching layer; with a cache active, every delivered response is
    exactly one of: computed with a recorded outcome, or served from
    cache (``delivered_total == requests_total + hits_total``)."""
    hits = int(CACHE_HITS_TOTAL.value())
    misses = int(CACHE_MISSES_TOTAL.value())
    looked = hits + misses
    p99 = CACHE_HIT_LATENCY_SECONDS.quantile_est(0.99)
    return {
        "hits_total": hits,
        "misses_total": misses,
        "hit_rate": (round(hits / looked, 6) if looked else 0.0),
        "evictions_total": int(CACHE_EVICTIONS_TOTAL.value()),
        "entries": int(CACHE_ENTRIES.value()),
        "resident_bytes": int(CACHE_RESIDENT_BYTES.value()),
        "inserted_bytes_total": int(CACHE_BYTES_TOTAL.value()),
        "delivered_total": int(RESPONSES_DELIVERED_TOTAL.value()),
        "hit_p99_latency_s": (None if p99 != p99 else round(p99, 9)),
        "warm_starts_total": int(CONSTRUCT_WARM_STARTS_TOTAL.value()),
        "warm_steps_saved_total": int(
            CONSTRUCT_WARM_STEPS_SAVED_TOTAL.value()),
    }


def record_fleet_dispatch(replica: int, n: int = 1) -> None:
    FLEET_DISPATCH_TOTAL.inc(int(n), replica=str(replica))


def record_replica_death(n: int = 1) -> None:
    FLEET_REPLICA_DEATHS_TOTAL.inc(int(n))


def record_replica_quarantine(n: int = 1) -> None:
    FLEET_REPLICA_QUARANTINED_TOTAL.inc(int(n))


def record_fleet_redispatch(n: int = 1) -> None:
    FLEET_REDISPATCH_TOTAL.inc(int(n))


def record_transport_reconnects(replica: int, n: int) -> None:
    if n:
        FLEET_TRANSPORT_RECONNECTS_TOTAL.inc(int(n), replica=str(replica))


def record_heartbeat_miss(replica: int, n: int = 1) -> None:
    FLEET_TRANSPORT_HEARTBEAT_MISSES_TOTAL.inc(int(n),
                                               replica=str(replica))


def record_transport_timeout(replica: int, phase: str,
                             n: int = 1) -> None:
    FLEET_TRANSPORT_IO_TIMEOUTS_TOTAL.inc(int(n), replica=str(replica),
                                          phase=str(phase))


def record_rollout_step(n: int = 1) -> None:
    FLEET_ROLLOUT_STEPS_TOTAL.inc(int(n))


def fleet_summary_from_registry() -> dict:
    """The fleet manifest's front-end block, off the live counters.

    Extends :func:`serve_summary_from_registry` with the coalescer and
    replica-dispatch counters; ``doctor --serve`` audits the per-replica
    outcome counts in the merged manifest against this block's dispatch
    totals."""
    out = serve_summary_from_registry()
    flushes = {k[0]: int(v)
               for k, v in COALESCE_FLUSHES_TOTAL.series().items()}
    dispatch = {k[0]: int(v)
                for k, v in FLEET_DISPATCH_TOTAL.series().items()}
    fill_series = COALESCE_BATCH_FILL.series()
    fill_mean = None
    if fill_series:
        st = next(iter(fill_series.values()))
        if st.count:
            fill_mean = round(st.total / st.count, 6)
    linger_p99 = COALESCE_LINGER_SECONDS.quantile_est(0.99)
    out.update({
        "coalesce_flushes": flushes,
        "coalesce_flushes_total": sum(flushes.values()),
        "coalesce_batch_fill_frac": fill_mean,
        "coalesce_linger_p99_s": (None if linger_p99 != linger_p99
                                  else round(linger_p99, 6)),
        "connections_total": int(FRONTEND_CONNECTIONS_TOTAL.value()),
        "dispatch_by_replica": dispatch,
        "dispatch_total": sum(dispatch.values()),
        "replica_deaths_total": int(FLEET_REPLICA_DEATHS_TOTAL.value()),
        "replica_quarantined_total": int(
            FLEET_REPLICA_QUARANTINED_TOTAL.value()),
        "redispatch_total": int(FLEET_REDISPATCH_TOTAL.value()),
        "transport": {
            "reconnects_total": int(sum(
                FLEET_TRANSPORT_RECONNECTS_TOTAL.series().values())),
            "heartbeat_misses_total": int(sum(
                FLEET_TRANSPORT_HEARTBEAT_MISSES_TOTAL.series()
                .values())),
            "io_timeouts_total": int(sum(
                FLEET_TRANSPORT_IO_TIMEOUTS_TOTAL.series().values())),
        },
        "rollout_steps_total": int(FLEET_ROLLOUT_STEPS_TOTAL.value()),
    })
    return out


def record_scenario_batch(n_true: int, seconds: float) -> None:
    """Tally one batched scenario run: true (unpadded) S + device wall."""
    SCENARIO_BATCH_SIZE.observe(int(n_true))
    SCENARIO_BATCH_SECONDS.observe(float(seconds))


def record_scenario_outcome(status: str, n: int = 1) -> None:
    SCENARIOS_RUN_TOTAL.inc(int(n), status=status)


def record_psd_projections(n: int = 1) -> None:
    SCENARIO_PSD_PROJECTIONS_TOTAL.inc(int(n))


def record_sweep(n_ok: int, n_rejected: int, n_chunks: int,
                 seconds: float) -> None:
    """Tally one full sweep: admitted/rejected lanes, chunk folds and host
    wall."""
    if n_ok:
        SWEEP_SCENARIOS_TOTAL.inc(int(n_ok), status="ok")
    if n_rejected:
        SWEEP_SCENARIOS_TOTAL.inc(int(n_rejected), status="rejected")
    SWEEP_CHUNKS_TOTAL.inc(int(n_chunks))
    SWEEP_SECONDS.observe(float(seconds))


def record_sweep_offenders(n: int = 1) -> None:
    SWEEP_OFFENDER_LANES_TOTAL.inc(int(n))


def record_sweep_projections(n: int = 1) -> None:
    SWEEP_PSD_PROJECTIONS_TOTAL.inc(int(n))


def sweep_summary_from_registry() -> dict:
    """The sweep manifest's ``summary`` block, off the live counters (the
    one VOLATILE manifest field — wall quantiles don't replay)."""
    statuses = {k[0]: int(v) for k, v in SWEEP_SCENARIOS_TOTAL.series().items()}
    p50 = SWEEP_SECONDS.quantile_est(0.5)
    return {
        "sweep_lanes": statuses,
        "sweep_lanes_total": sum(statuses.values()),
        "chunks_total": int(SWEEP_CHUNKS_TOTAL.value()),
        "offender_lanes_total": int(SWEEP_OFFENDER_LANES_TOTAL.value()),
        "psd_projections_total": int(SWEEP_PSD_PROJECTIONS_TOTAL.value()),
        "sweep_p50_wall_s": (None if p50 != p50 else round(p50, 6)),
    }


def scenario_summary_from_registry() -> dict:
    """The scenario manifest's ``summary`` block, off the live counters
    (the one VOLATILE manifest field — latency quantiles don't replay)."""
    statuses = {k[0]: int(v) for k, v in SCENARIOS_RUN_TOTAL.series().items()}
    p50 = SCENARIO_BATCH_SECONDS.quantile_est(0.5)
    p99 = SCENARIO_BATCH_SECONDS.quantile_est(0.99)
    return {
        "scenarios": statuses,
        "scenarios_total": sum(statuses.values()),
        "psd_projections_total": int(
            SCENARIO_PSD_PROJECTIONS_TOTAL.value()),
        "batch_p50_latency_s": (None if p50 != p50 else round(p50, 6)),
        "batch_p99_latency_s": (None if p99 != p99 else round(p99, 6)),
    }


def guard_summary_from_registry() -> dict:
    """The manifest's guard verdict summary, off the live counters."""
    served = SERVED_DATES_TOTAL.value()
    quarantined = QUARANTINED_DATES_TOTAL.value()
    reasons = {}
    for key, n in GUARD_REASON_TOTAL.series().items():
        reasons[key[0]] = int(n)
    return {
        "served_dates": int(served),
        "quarantined_dates": int(quarantined),
        "quarantine_rate": (round(quarantined / served, 6) if served else 0.0),
        "reasons": reasons,
        "last_staleness": int(SERVED_COV_STALENESS.value()),
    }
