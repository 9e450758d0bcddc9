"""Content-addressed response cache + construct warm-start index
(counterpart of ``mfm_tpu/serve/cache.py``; the same keys and bytes).

At millions of users most traffic is repeated traffic, and the serving
stack already computes every key a response cache needs: trace ids are
content hashes of the request line, checkpoints carry a monotonic
``generation`` fence, and scenarios carry a canonical ``spec_hash``.
This module turns those into exact response reuse in front of the
coalescer (``serve/coalesce.py``):

- **Key**: the canonical request body — the parsed JSON object with the
  two per-caller identity keys (``id``, ``trace_id``) removed,
  re-serialized with sorted keys — plus the checkpoint generation and
  the spec hash of the request's scenario tag.  Two users asking the
  same question hit the same entry; a hot reload (``--watch``, replica
  fence audit) bumps the generation and every old entry becomes
  unreachable WITHOUT a scan (LRU eviction collects the corpses).
- **Hit**: the cached response bytes, re-stamped with the caller's own
  ``id``/``trace_id``.  Everything else is byte-identical to a cold
  computation — asserted by the tests, not approximated — because the
  stored body IS a cold response with only the identity keys stripped,
  and canonical-JSON round-trips are exact (Python float repr is
  shortest-round-trip).
- **Miss**: rides today's path verbatim.  The miss's origin token is
  wrapped in a :class:`CacheFill` so the response can be matched back to
  its key at delivery with no id/trace-id ambiguity (client-supplied
  trace ids need not be unique; the wrapped origin is).
- **Population**: only terminal healthy responses enter the cache —
  ``outcome == "ok"`` and not degraded/stale-stamped.  Dead-letter,
  shed, deadline, breaker-reject and error responses never do.

The warm-start tier extends reuse to construction solves: an exact body
match is a plain cache hit (bitwise), while a NEAR miss — same solver
and hmax, exposure vector within a tolerance of a cached solve's key —
seeds the solver's strictly-positive warm-start blend with the cached
solution instead of the request book, at a reduced step budget.  A
warm-started solve is NOT bitwise-equal to a cold one; it records the
parity contract on the response (``warm_start: {used, steps,
steps_saved, parity: "seeded"}``) and tests hold it to a convergence
tolerance instead.  Cold solves carry no ``warm_start`` field, which is
what keeps every existing bitwise contract (batch-of-B == B singles,
coalesced == sequential) intact when the index is idle.  The served
construction solves (``serve/server.py``) consult the index.

Host-only module: JSON, dicts, locks.
"""

from __future__ import annotations

import collections
import json
import threading
import time

import numpy as np

from mfm_tpu_torch.obs import instrument as _obs
from mfm_tpu_torch.serve.server import _line_trace_id

#: response keys carrying per-caller identity — stripped from stored
#: bodies, re-stamped on every hit
IDENTITY_KEYS = ("id", "trace_id")


class CacheFill:
    """Origin wrapper riding a cache miss through the serving path.

    Admission stamps the request's origin token onto the queued request;
    wrapping it here lets :meth:`ResponseCache.absorb` match the
    response back to the exact cache key its line hashed to — no
    pending-map keyed on (possibly client-duplicated) trace ids, no
    ambiguity.  ``absorb`` unwraps before responses reach a frontend, so
    nothing downstream ever sees the wrapper."""

    __slots__ = ("origin", "token")

    def __init__(self, origin, token):
        self.origin = origin
        self.token = token


def cacheable_response(resp) -> bool:
    """Only terminal healthy responses may enter the cache: ``ok``
    outcome, not degraded (staleness > 0 or health != ok stamps
    ``degraded`` — serving those from a cache would freeze a transient
    condition into a permanent answer)."""
    return (isinstance(resp, dict) and resp.get("ok") is True
            and resp.get("outcome") == "ok"
            and not resp.get("degraded"))


class ResponseCache:
    """Bounded, thread-safe, content-addressed response cache.

    Args:
      max_entries: LRU bound on entry count.
      max_bytes: LRU bound on resident stored-body bytes.
      generation: initial checkpoint generation fence (see
        :meth:`set_fence`).
      scenario_hashes: ``{scenario name: spec_hash}`` for the served
        scenario table.  A tagged request's key includes its scenario's
        spec hash, so swapping one scenario's spec invalidates exactly
        that scenario's entries.  Names absent from the map fence on the
        name itself (coarser: only a generation bump invalidates them).
      clock: monotonic clock for the hit-latency histogram.
    """

    def __init__(self, max_entries: int = 4096,
                 max_bytes: int = 64 << 20, *, generation: int = 0,
                 scenario_hashes=None,
                 clock=time.perf_counter):
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        if max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1, got {max_bytes}")
        self.max_entries = int(max_entries)
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self._resident = 0
        self._generation = int(generation)
        self._scenario_hashes = dict(scenario_hashes or {})
        self._clock = clock
        # per-instance tallies (the obs counters are process-global;
        # tests and manifests want THIS cache's numbers)
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # -- fence ----------------------------------------------------------------
    @property
    def generation(self) -> int:
        with self._lock:
            return self._generation

    def set_fence(self, generation=None, scenario_hashes=None) -> None:
        """Move the fence: entries keyed under the old (generation,
        scenario hash) become unreachable immediately — no sweep, the
        LRU bound evicts them as fresh entries arrive."""
        with self._lock:
            if generation is not None:
                self._generation = int(generation)
            if scenario_hashes is not None:
                self._scenario_hashes = dict(scenario_hashes)

    # -- key derivation -------------------------------------------------------
    def key_for(self, line: str):
        """``(key, rid, tid)`` for one request line, or None when the
        line is not a JSON object (those dead-letter — uncacheable by
        construction).  ``tid`` is the caller's own trace id when the
        request carries one, else the deterministic line hash — exactly
        the id the cold path would stamp."""
        try:
            obj = json.loads(line)
        except (ValueError, TypeError):
            return None
        if not isinstance(obj, dict):
            return None
        rid = obj.pop("id", None)
        raw_tid = obj.pop("trace_id", None)
        tid = str(raw_tid) if raw_tid is not None else _line_trace_id(line)
        if obj.get("sweep"):
            # sweep responses summarize a whole streaming batch run —
            # cache-exempt by contract: every sweep streams against the
            # live fenced checkpoint, never a stored answer
            return None
        scen = obj.get("scenario")
        with self._lock:
            gen = self._generation
            scen_hash = ("" if scen is None
                         else self._scenario_hashes.get(str(scen),
                                                        f"name:{scen}"))
        try:
            # compact separators: the canonical form never leaves the
            # cache, and the tight spelling is ~30% less encoder work on
            # the per-request hot path
            body = json.dumps(obj, sort_keys=True, separators=(",", ":"))
        except (TypeError, ValueError):
            return None
        return (body, gen, scen_hash), rid, tid

    # -- lookup / populate ----------------------------------------------------
    def lookup(self, line: str):
        """``(response_or_None, token_or_None)``.  A hit returns the
        cached body re-stamped with THIS caller's id/trace id; a miss
        returns a token for :class:`CacheFill` so delivery can populate
        the entry.  Uncacheable lines return ``(None, None)``."""
        t0 = self._clock()
        keyed = self.key_for(line)
        if keyed is None:
            return None, None
        key, rid, tid = keyed
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self.hits += 1
            else:
                self.misses += 1
        if entry is None:
            _obs.record_cache_miss()
            return None, key
        # shallow-copy the parsed template instead of re-decoding the
        # stored bytes: the floats in it are the exact objects the stored
        # body serialized from, so the re-stamped response still encodes
        # byte-identically — and the hot path skips a json.loads.  The
        # template is immutable by contract: nothing in the serving stack
        # mutates a response body after it is stamped.
        resp = dict(entry[1])
        resp["id"] = rid
        resp["trace_id"] = tid
        _obs.record_cache_hit(self._clock() - t0)
        return resp, key

    def put(self, key, resp: dict) -> bool:
        """Store one response under ``key`` (identity keys stripped).
        Returns False — and stores nothing — for uncacheable outcomes."""
        if not cacheable_response(resp):
            return False
        template = {k: v for k, v in resp.items()
                    if k not in IDENTITY_KEYS}
        # the stored bytes (size accounting + the byte-identity contract)
        # and the parsed template the hot path re-stamps; json.dumps
        # defaults to ensure_ascii, so len(str) IS the byte length
        body = json.dumps(template, sort_keys=True)
        size = len(body)
        evicted = 0
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._resident -= len(old[0])
            self._entries[key] = (body, template)
            self._resident += size
            while self._entries and (len(self._entries) > self.max_entries
                                     or self._resident > self.max_bytes):
                _, dropped = self._entries.popitem(last=False)
                self._resident -= len(dropped[0])
                evicted += 1
            self.evictions += evicted
            entries_now, resident_now = len(self._entries), self._resident
        _obs.record_cache_store(size, evicted, entries_now, resident_now)
        return True

    def absorb(self, pairs: list) -> list:
        """Delivery-side hook: unwrap every :class:`CacheFill` origin,
        populating the cache from cacheable responses, and count every
        delivered response (hits short-circuit through here too) so the
        delivery audit can check delivered == computed + hits."""
        out = []
        for origin, resp in pairs:
            if isinstance(origin, CacheFill):
                self.put(origin.token, resp)
                origin = origin.origin
            out.append((origin, resp))
        _obs.record_responses_delivered(len(out))
        return out

    # -- introspection --------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return self._resident

    def stats(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions,
                    "entries": len(self._entries),
                    "resident_bytes": self._resident,
                    "generation": self._generation}


class WarmStartIndex:
    """Near-miss reuse for construction solves.

    Keeps the most recent COLD solutions per ``(solver, hmax)`` (warm
    results are never indexed — chaining warm-from-warm would compound
    convergence error).  :meth:`nearest` returns a cached solution whose
    request book was within ``tol`` (relative L2) of the query's, to
    seed the solver's strictly-positive warm-start blend at a reduced
    step budget.  Hedge solves are excluded: their books are fixed
    inputs, not warm starts.
    """

    #: full-budget steps divide by this for a warm-started solve
    STEPS_DIVISOR = 4

    def __init__(self, tol: float = 0.05, per_solver: int = 64):
        if not (tol > 0):
            raise ValueError(f"tol must be > 0, got {tol}")
        self.tol = float(tol)
        self.per_solver = int(per_solver)
        self._lock = threading.Lock()
        self._rings: dict = {}
        self.uses = 0
        self.steps_saved = 0

    def add(self, solver: str, hmax: float, key_vec, solved) -> None:
        entry = (np.asarray(key_vec, np.float64).copy(),
                 np.asarray(solved, np.float64).copy())
        with self._lock:
            ring = self._rings.setdefault(
                (str(solver), float(hmax)),
                collections.deque(maxlen=self.per_solver))
            ring.append(entry)

    def nearest(self, solver: str, hmax: float, weights):
        w = np.asarray(weights, np.float64)
        with self._lock:
            ring = self._rings.get((str(solver), float(hmax)))
            if not ring:
                return None
            candidates = list(ring)
        best = None
        best_d = np.inf
        for key_vec, solved in reversed(candidates):
            if key_vec.shape != w.shape:
                continue
            d = float(np.linalg.norm(w - key_vec))
            if d <= self.tol * max(1.0, float(np.linalg.norm(key_vec))) \
                    and d < best_d:
                best, best_d = solved, d
        return None if best is None else best.copy()

    def record_use(self, steps: int, steps_saved: int) -> None:
        with self._lock:
            self.uses += 1
            self.steps_saved += int(steps_saved)
        _obs.record_warm_start(int(steps_saved))

    def stats(self) -> dict:
        with self._lock:
            return {"uses": self.uses, "steps_saved": self.steps_saved,
                    "tol": self.tol}
