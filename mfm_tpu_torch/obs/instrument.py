"""Instrumentation of the serving stack: the metric catalog and the
host-side recording helpers (counterpart of the serving part of
``mfm_tpu/obs/instrument.py``; metric names and summary keys are the
reference's).

Everything records host values — clocks around a device batch, counts,
outcomes — never device tensors.  The catalog here covers what the query
loop, the response cache, the coalescer, the span ring and the flight
recorder record; the reference's model-side metrics (guard tallies,
update latency, checkpoint and compile counters), the fleet and the SLO
engine wait for ROADMAP.md §A 15.
"""

from __future__ import annotations

from mfm_tpu_torch.obs.metrics import REGISTRY

# -- tracing (obs/trace.py span ring) -----------------------------------------

TRACE_SPANS_TOTAL = REGISTRY.counter(
    "mfm_trace_spans_total", "spans finished and recorded to the trace ring")
TRACE_DROPPED_TOTAL = REGISTRY.counter(
    "mfm_trace_dropped_total",
    "oldest spans evicted by ring-buffer overflow (trace is lossy past "
    "capacity, but counted)")

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
    labelnames=("trigger",))

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


# -- recording helpers ----------------------------------------------------------

def record_flightrec_event(n: int = 1, dropped: int = 0) -> None:
    FLIGHTREC_EVENTS_TOTAL.inc(int(n))
    if dropped:
        FLIGHTREC_DROPPED_TOTAL.inc(int(dropped))


def record_flightrec_dump(trigger: str) -> None:
    FLIGHTREC_DUMPS_TOTAL.inc(1, trigger=str(trigger))


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
    """The query service's summary block, off the live counters (the
    reference's keys; its SLO block waits for ``obs/slo.py``, ROADMAP.md
    §A 10).  A breaker left open at shutdown (``breaker_state`` = "open")
    marks a failed serve run even if every request got a well-formed
    response."""
    outcomes = {k[0]: int(v) for k, v in QUERY_REQUESTS_TOTAL.series().items()}
    total = sum(outcomes.values())
    shed = int(QUERY_SHED_TOTAL.value())
    state_code = int(BREAKER_STATE.value())
    p50 = QUERY_LATENCY_SECONDS.quantile_est(0.5)
    p99 = QUERY_LATENCY_SECONDS.quantile_est(0.99)
    return {
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


def record_coalesce_flush(n_true: int, capacity: int, trigger: str,
                          lingered_s: float) -> None:
    """Tally one coalesced flush: fill fraction vs the geometric bucket
    the batch padded to, what triggered it, and how long the oldest
    queued request lingered."""
    COALESCE_FLUSHES_TOTAL.inc(1, trigger=trigger)
    if capacity > 0:
        COALESCE_BATCH_FILL.observe(min(1.0, n_true / capacity))
    COALESCE_LINGER_SECONDS.observe(max(0.0, float(lingered_s)))


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
