"""The request loop around :class:`~mfm_tpu_torch.serve.query.QueryEngine`
(counterpart of ``mfm_tpu/serve/server.py``; the same request and response
formats, outcomes, reason bits and dead-letter records).

Everything here is host-side — JSON decoding, deques, clocks.  The only
device work is the one batched :meth:`QueryEngine.query` call per drained
batch (and scenario group), with its inputs copied to the card once and its
seven outputs brought back once each.

Four layers:

1. **Request guards** — schema/dtype validation, NaN/short-weight
   rejection, unknown-factor mapping, all folded into a per-request reason
   bitmask (``REQ_REASON_*``, decoded by the shared
   :func:`mfm_tpu_torch.serve._checks.names_of_mask`).  Malformed requests
   are quarantined to a dead-letter JSONL instead of killing the batch.
   The optional MAD weight check runs the slab guards' formula on a CPU
   tensor: no request makes a trip to the card.
2. **Admission control + deadlines** — a bounded queue with explicit
   backpressure: overflow sheds the OLDEST queued work with a counted
   ``shed`` outcome.  Every request carries a deadline budget; work that
   expires in the queue is answered ``deadline``, never computed.
3. **Degraded serving** — every response is stamped with the served
   covariance's staleness and the health verdict; a
   :class:`CircuitBreaker` flips the loop to reject-with-retry-after when
   health degrades, the checkpoint fails its fence audit on reload, or
   batches keep failing.
4. **Chaos hooks** — ``chaos_point("serve.after_batch", ...)`` fires after
   every drained batch.

A ``sweep`` request streams a bounded shock sweep of its book through
:class:`~mfm_tpu_torch.scenario.sweep.SweepEngine` against the engine's
covariance.  A ``construct`` request asks for a portfolio-construction
solve (:class:`~mfm_tpu_torch.grad.engine.GradEngine`) instead of a risk
query: each drained batch answers its construct lines in one batched
solve per (solver, hmax), against the same engine's covariance.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import json
import math
import os
import threading
import time
from typing import Callable

import numpy as np

from mfm_tpu_torch.obs import flightrec as _frec
from mfm_tpu_torch.obs import instrument as _obs
from mfm_tpu_torch.obs import trace as _trace
from mfm_tpu_torch.serve._checks import names_of_mask
from mfm_tpu_torch.utils.chaos import chaos_point

# request-guard reason bitmask — its own namespace, deliberately disjoint
# from serve/guard.py's per-date bits (a dead-letter record and a
# quarantined date are different animals; sharing decode machinery via
# serve/_checks.py is what keeps the two layers from drifting)
REQ_REASON_SCHEMA = 1            # not a JSON object / missing required keys
REQ_REASON_DTYPE = 2             # weights not coercible to finite floats
REQ_REASON_NAN_WEIGHT = 4        # NaN/Inf weight entries
REQ_REASON_SHORT_WEIGHTS = 8     # wrong length / empty weight vector
REQ_REASON_UNKNOWN_FACTOR = 16   # dict weight key not in the engine's space
REQ_REASON_UNKNOWN_BENCHMARK = 32
REQ_REASON_WEIGHT_OUTLIER = 64   # |w - med| > mad_k * MAD (policy-gated)
REQ_REASON_UNKNOWN_SCENARIO = 128  # scenario tag not in the served table
REQ_REASON_BAD_CONSTRUCT = 256   # construct solver unknown / unsupported
                                 # space / bad hedge factors or hmax
REQ_REASON_BAD_SWEEP = 512       # sweep spec unknown sampler / out-of-bound
                                 # n, chunk, top_k or bins

_REQ_REASON_NAMES = (
    (REQ_REASON_SCHEMA, "schema"),
    (REQ_REASON_DTYPE, "dtype"),
    (REQ_REASON_NAN_WEIGHT, "nan_weight"),
    (REQ_REASON_SHORT_WEIGHTS, "short_weights"),
    (REQ_REASON_UNKNOWN_FACTOR, "unknown_factor"),
    (REQ_REASON_UNKNOWN_BENCHMARK, "unknown_benchmark"),
    (REQ_REASON_WEIGHT_OUTLIER, "weight_outlier"),
    (REQ_REASON_UNKNOWN_SCENARIO, "unknown_scenario"),
    (REQ_REASON_BAD_CONSTRUCT, "bad_construct"),
    (REQ_REASON_BAD_SWEEP, "bad_sweep"),
)

#: sweep request bounds — a sweep is a whole streaming batch job riding
#: one request, so admission caps every size knob (serving answers bounded
#: exploratory sweeps; million-scenario runs call SweepEngine directly)
SWEEP_SAMPLERS = ("uniform", "sobol", "grid")
SWEEP_MAX_N = 262144
SWEEP_MAX_CHUNK = 16384
SWEEP_MAX_TOP_K = 64
SWEEP_MAX_BINS = 256

#: construct request vocabulary (mfm_tpu_torch/grad/construct.py solvers)
CONSTRUCT_SOLVERS = ("min_vol", "risk_parity", "hedge")

#: JSONL key reserved for the fleet wire protocol (serve/replica.py).
#: Admission REJECTS any request carrying it, so admitted lines can be
#: forwarded to a worker replica verbatim without frame escaping — a
#: client can never smuggle a control frame past the front end.
FLEET_CONTROL_KEY = "__fleet__"


def req_reason_names(mask: int) -> list[str]:
    """Human-readable names of the bits set in a request-reason mask."""
    return names_of_mask(mask, _REQ_REASON_NAMES)


@dataclasses.dataclass(frozen=True)
class ServePolicy:
    """Admission/deadline/breaker knobs of the query loop.

    Frozen + hashable like :class:`mfm_tpu_torch.config.QuarantinePolicy`:
    the policy is part of a serve run's identity, and a mutable policy
    mid-run would make shed/deadline outcomes unreplayable.

    Attributes:
      queue_max: admission bound; an arriving request beyond it sheds the
        OLDEST queued request (counted ``shed`` outcome).
      batch_max: most requests drained into one device batch (the padded
        bucket is ``bucket_for`` of the true size).
      default_deadline_s: per-request deadline budget when the request
        doesn't carry its own ``deadline_s``.
      breaker_failures: consecutive batch failures that open the breaker.
      breaker_cooldown_s: open -> half-open cooldown; also the
        ``retry_after_s`` stamped on rejected responses.
      weight_mad_k: MAD multiple beyond which a weight entry is an outlier
        (shared formula with the slab guards); 0 disables the check.
      breaker_on_degraded: force the breaker open while the model health
        verdict is "degraded".
      fsync_emits: fsync the response stream after every emitted event
        batch.  The per-emit ``flush()`` already makes responses durable
        against the PYTHON buffer (a SIGKILLed loop loses nothing it
        wrote); fsync extends that through the OS page cache, so emitted
        responses also survive a power cut.  Off by default — an fsync per
        drain is an I/O wall the pipe-to-consumer deployment doesn't need.
    """

    queue_max: int = 4096
    batch_max: int = 1024
    default_deadline_s: float = 1.0
    breaker_failures: int = 3
    breaker_cooldown_s: float = 5.0
    weight_mad_k: float = 0.0
    breaker_on_degraded: bool = True
    fsync_emits: bool = False

    def __post_init__(self):
        if self.queue_max < 1:
            raise ValueError(f"queue_max must be >= 1, got {self.queue_max}")
        if self.batch_max < 1:
            raise ValueError(f"batch_max must be >= 1, got {self.batch_max}")
        if self.default_deadline_s <= 0:
            raise ValueError("default_deadline_s must be > 0, got "
                             f"{self.default_deadline_s}")
        if self.breaker_failures < 1:
            raise ValueError("breaker_failures must be >= 1, got "
                             f"{self.breaker_failures}")
        if self.breaker_cooldown_s < 0:
            raise ValueError("breaker_cooldown_s must be >= 0, got "
                             f"{self.breaker_cooldown_s}")
        if self.weight_mad_k < 0:
            raise ValueError(f"weight_mad_k must be >= 0, got "
                             f"{self.weight_mad_k}")

    def identity(self) -> tuple:
        return tuple(getattr(self, f.name)
                     for f in dataclasses.fields(self))


class CircuitBreaker:
    """closed -> open -> half_open -> closed breaker with injectable clock.

    ``closed``: all traffic admitted; ``failures`` consecutive
    :meth:`record_failure` calls open it.  ``open``: everything rejected
    with a retry-after until ``cooldown_s`` elapses, then the next
    :meth:`allow` admits ONE probe (half_open).  ``half_open``: probe
    success closes, probe failure re-opens (cooldown restarts).
    :meth:`force_open` is the degraded-health / fence-audit path — it
    records why, and the reason rides on rejected responses.

    Thread-safe: every state transition and counter bump happens under one
    internal lock.  Admission may run on other threads than the drain that
    records batch outcomes (the coalescer), and an unlocked
    ``_consecutive += 1`` under that interleaving can lose failures and
    never open the breaker.
    """

    def __init__(self, failures: int = 3, cooldown_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic):
        self._threshold = int(failures)
        self._cooldown = float(cooldown_s)
        self._clock = clock
        self._lock = threading.RLock()
        self._state = "closed"
        self._consecutive = 0
        self._opened_at = 0.0
        self.open_reason: str | None = None
        _obs.record_breaker_state(self._state)

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def _to(self, state: str) -> None:
        # callers hold self._lock
        if state != self._state:
            self._state = state
            _obs.record_breaker_state(state)

    def allow(self) -> bool:
        """Admit a request?  May transition open -> half_open."""
        with self._lock:
            if self._state == "open":
                if self._clock() - self._opened_at >= self._cooldown:
                    self._to("half_open")
                    return True
                return False
            return True

    def record_success(self) -> None:
        with self._lock:
            self._consecutive = 0
            if self._state == "half_open":
                self.open_reason = None
                self._to("closed")

    def record_failure(self) -> None:
        with self._lock:
            self._consecutive += 1
            trip = (self._state == "half_open"
                    or self._consecutive >= self._threshold)
        if trip:
            # force_open runs OUTSIDE this frame's lock hold so its
            # flight-recorder dump (file I/O, registry/ring locks) never
            # happens under the breaker lock
            self.force_open("failures")

    def force_open(self, reason: str) -> None:
        with self._lock:
            was_open = self._state == "open"
            self._consecutive = 0
            self._opened_at = self._clock()
            self.open_reason = reason
            # re-arm the cooldown even if already open (repeated force_open
            # keeps rejecting); only a transition tallies breaker_open_total
            self._to("open")
        if not was_open:
            # postmortem on the TRANSITION only (a breaker that stays
            # open re-arms without re-dumping): the ring's newest
            # trace-stamped event — the batch_error that tripped us —
            # becomes the dump's triggering trace id
            _frec.record_event("breaker_open", reason=reason)
            _frec.trigger_dump("breaker_open", state={
                "breaker": {"state": "open", "open_reason": reason}})

    def retry_after(self) -> float:
        with self._lock:
            if self._state != "open":
                return 0.0
            return max(0.0,
                       self._cooldown - (self._clock() - self._opened_at))


class _Request:
    __slots__ = ("rid", "weights", "bidx", "enq_t", "deadline_t", "scenario",
                 "trace_id", "span", "construct", "sweep", "origin", "line")

    def __init__(self, rid, weights, bidx, enq_t, deadline_t, scenario=None,
                 trace_id=None, span=None, construct=None, sweep=None,
                 origin=None, line=None):
        self.rid = rid
        self.weights = weights
        self.bidx = bidx
        self.enq_t = enq_t
        self.deadline_t = deadline_t
        self.scenario = scenario
        self.trace_id = trace_id
        self.span = span
        self.construct = construct
        self.sweep = sweep
        # origin: an opaque routing token (a connection handle, a cache
        # fill, a replica dispatch ordinal) stamped by the layer above; None
        # on the plain single-stream loop.  line: the raw admitted request
        # text — the fleet dispatcher forwards it verbatim to a worker
        self.origin = origin
        self.line = line


def _line_trace_id(line: str) -> str:
    """Host-generated trace id for a request that didn't bring one:
    derived from the request BYTES, not os.urandom, so a replayed stream
    reuses the same ids and the chaos plans' bitwise-prefix contract on
    the response stream survives tracing."""
    return hashlib.sha256(line.encode("utf-8", "replace")).hexdigest()[:32]


def _parse_construct(raw, engine):
    """Decode + guard a request's ``construct`` block.  Accepts the string
    shorthand (``"min_vol"``) or an object (``{"solver": "hedge",
    "hedge_factors": [...], "hmax": 0.5}``).  Returns
    ``(spec_dict_or_None, reason_bits, detail)`` — the spec dict is what
    rides on the queued request into the drain-side solver dispatch."""
    if isinstance(raw, str):
        raw = {"solver": raw}
    if not isinstance(raw, dict):
        return None, REQ_REASON_BAD_CONSTRUCT, \
            "construct must be a solver name or an object"
    solver = raw.get("solver")
    if solver not in CONSTRUCT_SOLVERS:
        return None, REQ_REASON_BAD_CONSTRUCT, \
            f"unknown construct solver {solver!r}; have " \
            f"{list(CONSTRUCT_SOLVERS)}"
    if engine.space != "factor":
        return None, REQ_REASON_BAD_CONSTRUCT, \
            "construction runs in factor space (engine serves " \
            f"{engine.space!r})"
    spec = {"solver": str(solver), "hedge_mask": None, "hmax": 1.0}
    if solver == "hedge":
        factors = raw.get("hedge_factors")
        if factors is not None:
            if not isinstance(factors, (list, tuple)) or not factors:
                return None, REQ_REASON_BAD_CONSTRUCT, \
                    "hedge_factors must be a non-empty list"
            unknown = [str(f) for f in factors
                       if str(f) not in engine.factor_index]
            if unknown:
                return None, REQ_REASON_BAD_CONSTRUCT, \
                    f"hedge_factors outside the engine's space: " \
                    f"{sorted(unknown)[:5]}"
            mask_vec = np.zeros(engine.N, np.float64)
            for f in factors:
                mask_vec[engine.factor_index[str(f)]] = 1.0
            spec["hedge_mask"] = mask_vec
        try:
            hmax = float(raw.get("hmax", 1.0))
            if not (np.isfinite(hmax) and hmax > 0):
                raise ValueError(hmax)
        except (TypeError, ValueError):
            return None, REQ_REASON_BAD_CONSTRUCT, \
                f"bad hmax {raw.get('hmax')!r} (need finite > 0)"
        spec["hmax"] = hmax
    return spec, 0, ""


def _parse_sweep(raw, engine):
    """Decode + guard a request's ``sweep`` block.  Accepts ``true`` (all
    defaults) or an object with ``sampler`` / ``n`` / ``seed`` / ``chunk``
    / ``top_k`` / ``bins``.  Every size knob is bounded at admission — a
    sweep is a streaming batch job riding one request line, and the
    drain must stay O(bounded) per request.  Returns ``(spec_dict_or_None,
    reason_bits, detail)``."""
    if raw is True:
        raw = {}
    if not isinstance(raw, dict):
        return None, REQ_REASON_BAD_SWEEP, \
            "sweep must be true or an object"
    if engine.space != "factor":
        return None, REQ_REASON_BAD_SWEEP, \
            f"sweeps run in factor space (engine serves {engine.space!r})"
    sampler = str(raw.get("sampler", "uniform"))
    if sampler not in SWEEP_SAMPLERS:
        return None, REQ_REASON_BAD_SWEEP, \
            f"unknown sweep sampler {sampler!r}; have {list(SWEEP_SAMPLERS)}"
    spec = {"sampler": sampler}
    for key, default, lo, hi in (("n", 4096, 1, SWEEP_MAX_N),
                                 ("chunk", 1024, 1, SWEEP_MAX_CHUNK),
                                 ("top_k", 8, 1, SWEEP_MAX_TOP_K),
                                 ("bins", 64, 8, SWEEP_MAX_BINS),
                                 ("seed", 0, 0, 2 ** 31 - 1)):
        v = raw.get(key, default)
        try:
            iv = int(v)
            if isinstance(v, float) and v != iv:
                raise ValueError(v)
            if not (lo <= iv <= hi):
                raise ValueError(iv)
        except (TypeError, ValueError):
            return None, REQ_REASON_BAD_SWEEP, \
                f"bad sweep {key} {v!r} (need int in [{lo}, {hi}])"
        spec[key] = iv
    return spec, 0, ""


def parse_request(line: str, engine, policy: ServePolicy, scenarios=None):
    """Decode + guard one JSONL request.

    Returns ``(fields_or_None, reason_mask, detail)``: a zero mask means
    the request is admissible and ``fields`` is ``(rid, weights (D,)
    float, bidx int, deadline_s float, scenario str|None, trace_id
    str|None, construct dict|None, sweep dict|None)``; a nonzero mask
    means dead-letter
    (``detail`` says what tripped, ``rid`` may still be recoverable and
    is returned inside ``detail``-bearing fields as None).  ``trace_id``
    is the caller's own when the request JSON carries one, else None (the
    server derives a deterministic one at admission).  ``scenarios``: the
    served scenario table (names only are consulted); a ``scenario`` tag
    outside it — including ANY tag when no table is served — is
    ``unknown_scenario``.  ``sweep`` asks for a streaming shock sweep of
    the request's book instead of a risk query; :func:`_parse_sweep`
    guards its knobs.  ``construct`` asks for a portfolio-construction
    solve instead of a risk query (the weights become the warm start /
    base book); :func:`_parse_construct` guards its vocabulary.
    """
    mask = 0
    rid = None
    try:
        obj = json.loads(line)
    except (ValueError, TypeError) as e:
        return None, REQ_REASON_SCHEMA, f"bad json: {e}"
    if not isinstance(obj, dict):
        return None, REQ_REASON_SCHEMA, "request must be a JSON object"
    rid = obj.get("id")
    scenario = obj.get("scenario")
    if scenario is not None:
        scenario = str(scenario)
    trace_id = obj.get("trace_id")
    if trace_id is not None:
        trace_id = str(trace_id)
    if FLEET_CONTROL_KEY in obj:
        return (rid, None, 0, 0.0, scenario, trace_id, None, None), \
            REQ_REASON_SCHEMA, \
            f"reserved key {FLEET_CONTROL_KEY!r} (fleet control namespace)"
    raw_w = obj.get("weights")
    if raw_w is None:
        return (rid, None, 0, 0.0, scenario, trace_id, None, None), \
            REQ_REASON_SCHEMA, "missing 'weights'"

    detail = ""
    if scenario is not None and scenario not in (scenarios or {}):
        mask |= REQ_REASON_UNKNOWN_SCENARIO
        have = sorted(scenarios) if scenarios else []
        detail = f"unknown scenario {scenario!r} (serving " \
            f"{have[:5] if have else 'no scenario table'})"
    construct = None
    raw_c = obj.get("construct")
    if raw_c is not None:
        construct, c_bits, c_detail = _parse_construct(raw_c, engine)
        if c_bits:
            mask |= c_bits
            detail = detail or c_detail
    sweep = None
    raw_s = obj.get("sweep")
    if raw_s is not None and raw_s is not False:
        sweep, s_bits, s_detail = _parse_sweep(raw_s, engine)
        if s_bits:
            mask |= s_bits
            detail = detail or s_detail
        elif construct is not None:
            sweep = None
            mask |= REQ_REASON_BAD_SWEEP
            detail = detail or \
                "a request is a sweep OR a construct solve, not both"
    if isinstance(raw_w, dict):
        # name-keyed weights: map onto the engine's own axis order.  In
        # factor space the keys are factor names; in stock space stock ids.
        names = (engine.stocks if engine.space == "stock" and engine.stocks
                 else engine.factor_names if engine.space == "factor"
                 else None)
        if names is None:
            return (rid, None, 0, 0.0, scenario, trace_id, None, None), \
                REQ_REASON_SCHEMA, \
                "dict weights need a named axis (engine has no stock ids)"
        index = (engine.factor_index if engine.space == "factor"
                 else {n: i for i, n in enumerate(names)})
        w = np.zeros(engine.N, np.float64)
        unknown = [k for k in raw_w if k not in index]
        if unknown:
            mask |= REQ_REASON_UNKNOWN_FACTOR
            detail = f"unknown names: {sorted(unknown)[:5]}"
        else:
            try:
                for k, v in raw_w.items():
                    w[index[k]] = float(v)
            except (TypeError, ValueError) as e:
                mask |= REQ_REASON_DTYPE
                detail = f"non-numeric weight: {e}"
    else:
        try:
            w = np.asarray(raw_w, np.float64)
        except (TypeError, ValueError) as e:
            w = None
            mask |= REQ_REASON_DTYPE
            detail = f"weights not coercible: {e}"
        if w is not None and (w.ndim != 1 or
                              not np.issubdtype(w.dtype, np.number)):
            mask |= REQ_REASON_DTYPE if w.ndim == 1 else \
                REQ_REASON_SHORT_WEIGHTS
            detail = detail or f"weights must be a flat numeric list, got " \
                f"ndim={w.ndim} dtype={w.dtype}"
            w = None

    if w is not None and not (mask & (REQ_REASON_DTYPE |
                                      REQ_REASON_UNKNOWN_FACTOR)):
        if w.shape != (engine.N,):
            mask |= REQ_REASON_SHORT_WEIGHTS
            detail = f"expected {engine.N} weights, got {w.shape[0]}"
        elif not np.isfinite(w).all():
            mask |= REQ_REASON_NAN_WEIGHT
            detail = f"{int((~np.isfinite(w)).sum())} non-finite weights"
        elif policy.weight_mad_k > 0 and w.shape[0] >= 4:
            # the slab guards' MAD formula (serve/_checks.py) in numpy, as
            # the reference's request guard runs it: a request never
            # reaches torch, so the coalescer's admission lock never waits
            # on device work
            x = w.astype(np.float64)
            dev = np.abs(x - np.nanmedian(x))
            mad = np.nanmedian(dev)
            out = dev > (policy.weight_mad_k * mad if mad > 0 else np.inf)
            if bool(out.any()):
                mask |= REQ_REASON_WEIGHT_OUTLIER
                detail = f"{int(out.sum())} weight outliers beyond " \
                    f"{policy.weight_mad_k} MAD"

    bidx = 0
    bench = obj.get("benchmark")
    if bench is not None:
        bidx = engine.benchmark_index.get(str(bench), -1)
        if bidx < 0:
            mask |= REQ_REASON_UNKNOWN_BENCHMARK
            detail = detail or f"unknown benchmark {bench!r} (have " \
                f"{sorted(engine.benchmark_index)})"
            bidx = 0
    try:
        deadline_s = float(obj.get("deadline_s", policy.default_deadline_s))
        if not (deadline_s > 0):
            raise ValueError(deadline_s)
    except (TypeError, ValueError):
        mask |= REQ_REASON_SCHEMA
        detail = detail or f"bad deadline_s {obj.get('deadline_s')!r}"
        deadline_s = policy.default_deadline_s
    return (rid, w, bidx, deadline_s, scenario, trace_id, construct,
            sweep), int(mask), detail


class QueryServer:
    """The batched request loop: admit -> queue -> drain -> respond.

    Args:
      engine: the :class:`QueryEngine` to answer with (swappable under
        load via :meth:`swap` / ``reload_fn``).
      policy: :class:`ServePolicy` (admission, deadlines, breaker).
      health: the model-health verdict string stamped on every response
        ("ok" | "degraded" | "unknown" — ``obs/health.py``'s vocabulary);
        "degraded" force-opens the breaker when the policy says so.
      dead_letter_path: JSONL file collecting guarded-out requests.
      clock: monotonic clock (injectable for deterministic tests).
      reload_fn: optional zero-arg callable polled between batches; it
        returns None (no change) or ``{"engine": ..., "health": ...}``; a
        fence-audit failure (ArtifactCorrupt/Stale) force-opens the
        breaker instead of serving a checkpoint that failed its audit.
      scenarios: optional ``{name: QueryEngine}`` table of stressed
        engines (e.g. :meth:`QueryEngine.with_cov` siblings).  A request
        carrying ``"scenario": name`` is answered from that engine;
        requests with no tag run the exact baseline path, and tags outside
        the table dead-letter with ``unknown_scenario``.
      warm_index: optional :class:`~mfm_tpu_torch.serve.cache.
        WarmStartIndex`.  When set, a construct request whose book is a
        near miss of a previously solved one seeds the solver's
        warm-start blend with the cached solution at a reduced step
        budget; the response records the parity contract
        (``warm_start``).  Cold solves are byte-for-byte unchanged (no
        extra field), so every bitwise contract holds whenever the index
        finds nothing.
    """

    def __init__(self, engine, policy: ServePolicy | None = None, *,
                 health: str = "unknown", dead_letter_path=None,
                 clock: Callable[[], float] = time.monotonic,
                 reload_fn=None, scenarios=None, warm_index=None):
        self.engine = engine
        self.scenarios: dict = dict(scenarios or {})
        self.policy = policy or ServePolicy()
        self.health = str(health)
        self.breaker = CircuitBreaker(self.policy.breaker_failures,
                                      self.policy.breaker_cooldown_s,
                                      clock=clock)
        self._clock = clock
        self._queue: collections.deque[_Request] = collections.deque()
        self._batch_i = 0
        self._dead_path = dead_letter_path
        self._dead_fp = None
        self._reload_fn = reload_fn
        self.warm_index = warm_index
        #: checkpoint generation currently served (None = untracked),
        #: moved by swap()
        self.generation: int | None = None
        if self.health == "degraded" and self.policy.breaker_on_degraded:
            self.breaker.force_open("health_degraded")

    # -- degraded serving ----------------------------------------------------
    def _stamp(self, resp: dict, scenario_id: str | None = None,
               engine=None, trace_id: str | None = None) -> dict:
        eng = engine if engine is not None else self.engine
        resp["scenario_id"] = scenario_id
        resp["staleness"] = int(eng.staleness)
        resp["health"] = self.health
        resp["degraded"] = bool(eng.staleness > 0
                                or self.health != "ok")
        resp["trace_id"] = trace_id
        return resp

    def swap(self, engine=None, health: str | None = None,
             generation: int | None = None) -> None:
        """Hot-swap the served engine / health verdict (checkpoint reload
        under load).  Degraded health force-opens the breaker; a recovery
        to "ok" lets the normal cooldown -> half-open -> closed path run
        (no instant flap back to closed)."""
        if engine is not None:
            self.engine = engine
        if generation is not None:
            self.generation = int(generation)
        if health is not None:
            self.health = str(health)
            if self.health == "degraded" and self.policy.breaker_on_degraded:
                self.breaker.force_open("health_degraded")

    def poll_reload(self) -> None:
        """Between-batch checkpoint watch: apply ``reload_fn``'s swap, or
        force the breaker open if the new checkpoint fails its fence
        audit."""
        if self._reload_fn is None:
            return
        from mfm_tpu_torch.data.artifacts import ArtifactCorruptError, \
            ArtifactStaleError
        try:
            upd = self._reload_fn()
        except (ArtifactCorruptError, ArtifactStaleError):
            self.breaker.force_open("fence_audit")
            return
        if upd:
            self.swap(engine=upd.get("engine"), health=upd.get("health"),
                      generation=upd.get("generation"))

    # -- dead letter ---------------------------------------------------------
    def _dead_letter(self, rid, mask: int, detail: str, line: str,
                     extra: dict | None = None) -> None:
        if self._dead_path is None:
            return
        rec = {"id": rid, "reasons": req_reason_names(mask), "mask": int(mask),
               "detail": detail, "line": line[:2048]}
        if extra:
            rec.update(extra)
        if self._dead_fp is None:
            self._dead_fp = open(self._dead_path, "a", encoding="utf-8")
        self._dead_fp.write(json.dumps(rec, sort_keys=True) + "\n")
        self._dead_fp.flush()

    # -- admission -----------------------------------------------------------
    def submit_line(self, line: str) -> list[dict]:
        """Admit one JSONL request.  Returns the IMMEDIATE responses this
        event produced (rejection, dead-letter ack, shed notices for
        displaced older work); an admitted request answers later, at
        drain."""
        return [resp for _, resp in self.submit_line_routed(line)]

    def submit_line_routed(self, line: str, origin=None) -> list[tuple]:
        """:meth:`submit_line` with response routing: every immediate
        response comes back as ``(origin, resp)``, where the origin is the
        one the RESPONSE's request was admitted with — a shed notice
        carries the DISPLACED (older) request's origin, which may belong
        to a different caller than the line that triggered it.  The
        coalescer routes each response to its caller off this pairing;
        the single-stream loop passes ``origin=None`` and ignores it."""
        out = []
        if not self.breaker.allow():
            _obs.record_query_outcome("rejected")
            return [(origin, self._stamp({
                "id": _peek_id(line), "ok": False, "outcome": "rejected",
                "retry_after_s": round(self.breaker.retry_after(), 3),
                "breaker": self.breaker.open_reason or "open"},
                trace_id=_peek_trace_id(line) or _line_trace_id(line)))]
        fields, mask, detail = parse_request(line, self.engine, self.policy,
                                             scenarios=self.scenarios)
        if mask:
            rid = fields[0] if fields else None
            scen = fields[4] if fields else None
            tid = (fields[5] if fields else None) or _line_trace_id(line)
            self._dead_letter(rid, mask, detail, line,
                              extra={"scenario_id": scen, "trace_id": tid})
            _obs.record_query_outcome("dead_letter")
            return [(origin, self._stamp({"id": rid, "ok": False,
                                          "outcome": "dead_letter",
                                          "reasons": req_reason_names(mask),
                                          "detail": detail}, scenario_id=scen,
                                         trace_id=tid))]
        rid, w, bidx, deadline_s, scen, tid, construct, sweep = fields
        if tid is None:
            tid = _line_trace_id(line)
        now = self._clock()
        # request span opens at admission and ends with the final outcome
        # (possibly batches later) — the explicit start/end half of the API
        sp = _trace.start_span("serve.request", trace_id=tid, parent_id=None,
                               request_id=rid, scenario=scen)
        self._queue.append(_Request(rid, w, bidx, now, now + deadline_s,
                                    scenario=scen, trace_id=tid, span=sp,
                                    construct=construct, sweep=sweep,
                                    origin=origin, line=line))
        # bounded queue: shedding drops the OLDEST queued work first —
        # under overload the head of the queue is the request whose
        # deadline is nearest death; the freshest work is the most useful
        while len(self._queue) > self.policy.queue_max:
            old = self._queue.popleft()
            _obs.record_shed()
            _obs.record_query_outcome("shed")
            if old.span is not None:
                _trace.end_span(old.span, outcome="shed")
            out.append((old.origin, self._stamp({"id": old.rid, "ok": False,
                                                 "outcome": "shed"},
                                                scenario_id=old.scenario,
                                                trace_id=old.trace_id)))
        _obs.record_queue_depth(len(self._queue))
        return out

    # -- drain ---------------------------------------------------------------
    def drain(self) -> list[dict]:
        """Answer up to ``batch_max`` queued requests in ONE device batch.

        Deadline-expired requests are answered ``deadline`` without
        touching the device.  A batch failure tallies the breaker; the
        chaos point fires after every drained batch (crash-recovery plans
        key on its deterministic ``batch{i}`` path)."""
        return [resp for _, resp in self.drain_routed()]

    def drain_routed(self) -> list[tuple]:
        """:meth:`drain` with response routing: ``(origin, resp)`` pairs,
        each response paired with the origin its request was admitted
        with (see :meth:`submit_line_routed`)."""
        taken = []
        while self._queue and len(taken) < self.policy.batch_max:
            taken.append(self._queue.popleft())
        _obs.record_queue_depth(len(self._queue))
        if not taken:
            return []
        now = self._clock()
        live, out = [], []
        for r in taken:
            if now > r.deadline_t:
                _obs.record_query_outcome("deadline")
                if r.span is not None:
                    _trace.end_span(r.span, outcome="deadline")
                out.append((r.origin,
                            self._stamp({"id": r.rid, "ok": False,
                                         "outcome": "deadline"},
                                        scenario_id=r.scenario,
                                        trace_id=r.trace_id)))
            else:
                live.append(r)
        if not live:
            return out
        if not self.breaker.allow():
            # breaker opened between admission and drain (forced open by a
            # failed reload / degraded health): reject the queued work
            for r in live:
                _obs.record_query_outcome("rejected")
                if r.span is not None:
                    _trace.end_span(r.span, outcome="rejected")
                out.append((r.origin, self._stamp({
                    "id": r.rid, "ok": False, "outcome": "rejected",
                    "retry_after_s": round(self.breaker.retry_after(), 3),
                    "breaker": self.breaker.open_reason or "open"},
                    scenario_id=r.scenario, trace_id=r.trace_id)))
            return out
        # group by scenario tag, first-appearance order: the None group is
        # the plain path (one stack, one engine.query); each tagged group
        # runs the same batched path against its stressed engine, and its
        # sweep requests stream against that engine's covariance
        groups: dict = {}
        for r in live:
            groups.setdefault(r.scenario, []).append(r)
        for scen, grp in groups.items():
            engine = self.engine if scen is None else self.scenarios.get(scen)
            if engine is None:
                # table swapped between admission and drain
                for r in grp:
                    _obs.record_query_outcome("error")
                    if r.span is not None:
                        _trace.end_span(r.span, outcome="error")
                    out.append((r.origin, self._stamp(
                        {"id": r.rid, "ok": False, "outcome": "error",
                         "detail": f"scenario {scen!r} no longer served"},
                        scenario_id=scen, trace_id=r.trace_id)))
                continue
            # split risk queries from construction solves: the query
            # sub-batch runs the exact pre-construct path (one stack, one
            # engine.query — untagged risk traffic stays bitwise the same),
            # each (solver, hmax) construct sub-batch runs its own batched
            # solve against the SAME engine's covariance (so scenario-tagged
            # construction solves against the stressed world)
            qgrp = [r for r in grp
                    if r.construct is None and r.sweep is None]
            sgrp = [r for r in grp if r.sweep is not None]
            cgrps: dict = {}
            for r in grp:
                if r.construct is not None:
                    key = (r.construct["solver"], r.construct["hmax"])
                    cgrps.setdefault(key, []).append(r)
            if qgrp:
                out.extend(self._drain_query(engine, scen, qgrp))
            for (solver, hmax), cg in cgrps.items():
                out.extend(self._drain_construct(engine, scen, solver,
                                                 hmax, cg))
            if sgrp:
                out.extend(self._drain_sweep(engine, scen, sgrp))
        chaos_point("serve.after_batch", f"batch{self._batch_i}")
        self._batch_i += 1
        return out

    def _drain_query(self, engine, scen, grp) -> list[tuple]:
        """Answer one scenario group's risk queries in ONE device batch.
        Returns routed ``(origin, resp)`` pairs."""
        out = []
        W = np.stack([r.weights for r in grp]).astype(engine.dtype)
        bench = [r.bidx for r in grp]
        # batch-execution child span: joins the first member's trace as
        # a child of its request span; every member's trace_id rides in
        # args (capped) so any slow request can be joined to its batch
        head = grp[0]
        bsp = _trace.start_span(
            "serve.batch", trace_id=head.trace_id,
            parent_id=(head.span.span_id if head.span else None),
            batch=self._batch_i, scenario=scen, n=len(grp),
            trace_ids=[r.trace_id for r in grp[:32]])
        t0 = time.perf_counter()
        try:
            res = engine.query(W, bench=bench)
        except Exception as e:   # noqa: BLE001 — any batch failure trips
            _trace.end_span(bsp, outcome="error")
            # event BEFORE record_failure: if this failure trips the
            # breaker, the dump's triggering trace id is this batch's
            _frec.record_event("batch_error", trace_id=head.trace_id,
                               kind_of="query", scenario=scen, n=len(grp),
                               detail=str(e)[:200])
            self.breaker.record_failure()
            for r in grp:
                _obs.record_query_outcome("error")
                if r.span is not None:
                    _trace.end_span(r.span, outcome="error")
                out.append((r.origin,
                            self._stamp({"id": r.rid, "ok": False,
                                         "outcome": "error",
                                         "detail": str(e)[:500]},
                                        scenario_id=scen, engine=engine,
                                        trace_id=r.trace_id)))
            return out
        dt = time.perf_counter() - t0
        _trace.end_span(bsp, outcome="ok")
        self.breaker.record_success()
        _obs.record_query_batch(len(grp), dt)
        done = self._clock()
        for i, r in enumerate(grp):
            _obs.record_query_outcome("ok")
            _obs.record_query_latency(max(0.0, done - r.enq_t))
            if r.span is not None:
                _trace.end_span(r.span, outcome="ok",
                                batch=self._batch_i)
            resp = {"id": r.rid, "ok": True, "outcome": "ok",
                    "total_vol": float(res.total_vol[i]),
                    "factor_var": float(res.factor_var[i]),
                    "specific_var": float(res.specific_var[i]),
                    "contribution": np.asarray(
                        res.contribution[i]).tolist(),
                    "marginal": np.asarray(res.marginal[i]).tolist()}
            if r.bidx > 0:
                resp["active_risk"] = float(res.active_risk[i])
                resp["beta"] = float(res.beta[i])
            out.append((r.origin, self._stamp(resp, scenario_id=scen,
                                              engine=engine,
                                              trace_id=r.trace_id)))
        return out

    def _drain_construct(self, engine, scen, solver, hmax, grp) -> list[tuple]:
        """Answer one (solver, hmax) construct sub-batch in ONE batched
        solve (:meth:`GradEngine.construct_solve`, padded to the portfolio
        bucket, on the engine's device), with the query path's breaker /
        outcome / span semantics.

        With a :attr:`warm_index`, requests whose books are near misses
        of previously solved ones split into a second solve seeded from
        the cached solutions at a reduced step budget.  Cold results feed
        the index; warm results never do (no warm-from-warm chaining).
        Returns routed ``(origin, resp)`` pairs."""
        from mfm_tpu_torch.grad.engine import (
            MINVOL_STEPS,
            RISKPARITY_STEPS,
            GradEngine,
        )
        out = []
        head = grp[0]
        bsp = _trace.start_span(
            "serve.construct", trace_id=head.trace_id,
            parent_id=(head.span.span_id if head.span else None),
            batch=self._batch_i, scenario=scen, solver=solver, n=len(grp),
            trace_ids=[r.trace_id for r in grp[:32]])
        full_steps = {"min_vol": MINVOL_STEPS,
                      "risk_parity": RISKPARITY_STEPS}.get(solver)
        seeds = [None] * len(grp)
        if self.warm_index is not None and full_steps is not None:
            for j, r in enumerate(grp):
                seeds[j] = self.warm_index.nearest(solver, hmax, r.weights)
        cold = [j for j in range(len(grp)) if seeds[j] is None]
        warm = [j for j in range(len(grp)) if seeds[j] is not None]
        warm_steps = (max(1, full_steps // self.warm_index.STEPS_DIVISOR)
                      if warm else None)
        t0 = time.perf_counter()
        try:
            ge = GradEngine(engine._cov, factor_names=engine.factor_names,
                            staleness=engine.staleness, dtype=engine.dtype,
                            device=engine.device)
            results: dict = {}
            if cold:
                W = np.stack([grp[j].weights
                              for j in cold]).astype(engine.dtype)
                hmask = None
                if solver == "hedge":
                    hmask = np.stack([
                        grp[j].construct["hedge_mask"]
                        if grp[j].construct["hedge_mask"] is not None
                        else np.ones(ge.K) for j in cold]).astype(engine.dtype)
                res = ge.construct_solve(solver, W, hedge_mask=hmask,
                                         hmax=hmax)
                for i, j in enumerate(cold):
                    results[j] = (res["weights"][i], res["vols"][i],
                                  res["diag"][i], False)
            if warm:
                Wseed = np.stack([seeds[j]
                                  for j in warm]).astype(engine.dtype)
                res = ge.construct_solve(solver, Wseed, hmax=hmax,
                                         steps=warm_steps)
                for i, j in enumerate(warm):
                    results[j] = (res["weights"][i], res["vols"][i],
                                  res["diag"][i], True)
        except Exception as e:   # noqa: BLE001 — any batch failure trips
            _trace.end_span(bsp, outcome="error")
            _frec.record_event("batch_error", trace_id=head.trace_id,
                               kind_of="construct", scenario=scen,
                               n=len(grp), detail=str(e)[:200])
            self.breaker.record_failure()
            for r in grp:
                _obs.record_query_outcome("error")
                if r.span is not None:
                    _trace.end_span(r.span, outcome="error")
                out.append((r.origin,
                            self._stamp({"id": r.rid, "ok": False,
                                         "outcome": "error",
                                         "kind": "construct",
                                         "detail": str(e)[:500]},
                                        scenario_id=scen, engine=engine,
                                        trace_id=r.trace_id)))
            return out
        dt = time.perf_counter() - t0
        _trace.end_span(bsp, outcome="ok")
        self.breaker.record_success()
        _obs.record_query_batch(len(grp), dt)
        done = self._clock()
        for i, r in enumerate(grp):
            _obs.record_query_outcome("ok")
            _obs.record_query_latency(max(0.0, done - r.enq_t))
            if r.span is not None:
                _trace.end_span(r.span, outcome="ok", batch=self._batch_i)
            w_i, vol_i, diag_i, warmed = results[i]
            resp = {"id": r.rid, "ok": True, "outcome": "ok",
                    "kind": "construct", "solver": solver,
                    "weights": np.asarray(w_i).tolist(),
                    "total_vol": float(vol_i)}
            diag = np.asarray(diag_i)
            resp["diag"] = diag.tolist() if diag.ndim else float(diag)
            if warmed:
                # the parity contract: a seeded solve converged to the
                # same optimum statistically, not bitwise — recorded,
                # never silently passed off as an exact computation
                resp["warm_start"] = {"used": True, "steps": warm_steps,
                                      "steps_saved": full_steps - warm_steps,
                                      "parity": "seeded"}
                self.warm_index.record_use(warm_steps,
                                           full_steps - warm_steps)
            elif self.warm_index is not None and full_steps is not None:
                self.warm_index.add(solver, hmax, r.weights,
                                    np.asarray(w_i))
            out.append((r.origin,
                        self._stamp(resp, scenario_id=scen, engine=engine,
                                    trace_id=r.trace_id)))
        return out

    def _drain_sweep(self, engine, scen, grp) -> list[tuple]:
        """Answer one scenario group's sweep requests.  Requests sharing
        an identical (admission-bounded) sweep spec batch their books
        into ONE streaming sweep — the fold already carries B books per
        lane, so co-sweeping is free; distinct specs run sequentially.
        Scenario-tagged sweeps stream against the stressed engine's
        covariance (the same world their queries answer from), on the
        engine's device.  No refinement in the serving path.  Returns
        routed ``(origin, resp)`` pairs."""
        from mfm_tpu_torch.grad.engine import ShockBall
        from mfm_tpu_torch.scenario.sweep import (
            GridSampler, SobolSampler, SweepEngine, UniformSampler,
        )
        out = []
        head = grp[0]
        bsp = _trace.start_span(
            "serve.sweep", trace_id=head.trace_id,
            parent_id=(head.span.span_id if head.span else None),
            batch=self._batch_i, scenario=scen, n=len(grp),
            trace_ids=[r.trace_id for r in grp[:32]])
        by_spec: dict = {}
        for r in grp:
            by_spec.setdefault(tuple(sorted(r.sweep.items())), []).append(r)
        t0 = time.perf_counter()
        try:
            se = SweepEngine(engine._cov, factor_names=engine.factor_names,
                             staleness=engine.staleness, dtype=engine.dtype,
                             device=engine.device)
            results: dict = {}
            for key, rs in by_spec.items():
                spec = dict(key)
                ball = ShockBall()
                if spec["sampler"] == "grid":
                    side = max(2, int(math.isqrt(spec["n"])))
                    sampler = GridSampler(ball, se.K, n_vol=side,
                                          n_corr=side)
                elif spec["sampler"] == "sobol":
                    sampler = SobolSampler(ball, se.K, spec["n"],
                                           seed=spec["seed"])
                else:
                    sampler = UniformSampler(ball, se.K, spec["n"],
                                             seed=spec["seed"])
                W = np.stack([r.weights for r in rs])
                res = se.sweep(W, sampler, chunk=spec["chunk"],
                               top_k=spec["top_k"], bins=spec["bins"])
                for i, r in enumerate(rs):
                    results[id(r)] = (res.books[i], res.counts, res.sampler)
        except Exception as e:   # noqa: BLE001 — any batch failure trips
            _trace.end_span(bsp, outcome="error")
            _frec.record_event("batch_error", trace_id=head.trace_id,
                               kind_of="sweep", scenario=scen,
                               n=len(grp), detail=str(e)[:200])
            self.breaker.record_failure()
            for r in grp:
                _obs.record_query_outcome("error")
                if r.span is not None:
                    _trace.end_span(r.span, outcome="error")
                out.append((r.origin,
                            self._stamp({"id": r.rid, "ok": False,
                                         "outcome": "error",
                                         "kind": "sweep",
                                         "detail": str(e)[:500]},
                                        scenario_id=scen, engine=engine,
                                        trace_id=r.trace_id)))
            return out
        dt = time.perf_counter() - t0
        _trace.end_span(bsp, outcome="ok")
        self.breaker.record_success()
        _obs.record_query_batch(len(grp), dt)
        done = self._clock()
        for r in grp:
            book, counts, sampler_d = results[id(r)]
            _obs.record_query_outcome("ok")
            _obs.record_query_latency(max(0.0, done - r.enq_t))
            if r.span is not None:
                _trace.end_span(r.span, outcome="ok", batch=self._batch_i)
            resp = {"id": r.rid, "ok": True, "outcome": "ok",
                    "kind": "sweep", "book": book, "counts": counts,
                    "sampler": sampler_d}
            out.append((r.origin,
                        self._stamp(resp, scenario_id=scen, engine=engine,
                                    trace_id=r.trace_id)))
        return out

    # -- the loop ------------------------------------------------------------
    def run(self, lines, out_fp, *, gulp: bool = False, cache=None) -> dict:
        """Serve a JSONL stream: one request per line in, one response per
        event out.  ``gulp`` reads ALL input before the first drain — the
        deterministic overload mode (shedding then depends only on the
        input, not on drain timing).
        ``cache`` (a :class:`~mfm_tpu_torch.serve.cache.ResponseCache`) answers
        repeat bodies from the cached response re-stamped with the
        caller's id/trace id, skipping admission — same semantics as the
        coalescer's cache seat, bypassed whenever the breaker is not
        closed.  Returns the final serve summary."""
        if cache is not None:
            # deferred: serve/cache.py imports this module (no cycle)
            from mfm_tpu_torch.serve.cache import CacheFill

        def emit(pairs):
            # flush per event batch: an emitted response is durable even if
            # the process is SIGKILLed before the next drain.  fsync_emits
            # extends that durability through the OS page cache — flush
            # alone only empties the Python-level buffer.
            if cache is not None:
                pairs = cache.absorb(pairs)
            for _, r in pairs:
                out_fp.write(json.dumps(r, sort_keys=True) + "\n")
            if pairs:
                out_fp.flush()
                if self.policy.fsync_emits:
                    try:
                        os.fsync(out_fp.fileno())
                    except (OSError, ValueError):
                        pass  # not a real file (StringIO, closed pipe)

        last_poll = -float("inf")
        for line in lines:
            line = line.strip()
            if not line:
                continue
            origin = None
            if cache is not None:
                # drains poll the watch, but an all-hits streak never
                # drains — bound the hit path's fence staleness too
                # (0.05 s: the coalescer's default linger scale)
                now = self._clock()
                if now - last_poll >= 0.05:
                    last_poll = now
                    self.poll_reload()
            if cache is not None and self.breaker.state == "closed":
                resp, token = cache.lookup(line)
                if resp is not None:
                    if _trace.tracing_enabled():
                        # a hit never opens a serve.request span — this
                        # child marks the short-circuit on the timeline
                        _trace.end_span(_trace.start_span(
                            "cache.hit", trace_id=resp.get("trace_id"),
                            request_id=resp.get("id")))
                    emit([(None, resp)])
                    continue
                if token is not None:
                    origin = CacheFill(None, token)
            emit(self.submit_line_routed(line, origin))
            if not gulp and len(self._queue) >= self.policy.batch_max:
                self.poll_reload()
                emit(self.drain_routed())
        while self._queue:
            self.poll_reload()
            emit(self.drain_routed())
        out_fp.flush()
        self.close()
        return _obs.serve_summary_from_registry()

    def close(self) -> None:
        if self._dead_fp is not None:
            self._dead_fp.close()
            self._dead_fp = None


def _peek_id(line: str):
    """Best-effort request id off a line we're rejecting unparsed."""
    try:
        obj = json.loads(line)
        return obj.get("id") if isinstance(obj, dict) else None
    except (ValueError, TypeError):
        return None


def _peek_trace_id(line: str):
    """Best-effort caller trace id off a line we're rejecting unparsed."""
    try:
        obj = json.loads(line)
    except (ValueError, TypeError):
        return None
    tid = obj.get("trace_id") if isinstance(obj, dict) else None
    return str(tid) if tid is not None else None
