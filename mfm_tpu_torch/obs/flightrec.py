"""Flight recorder: a bounded postmortem ring and atomic crash dumps
(counterpart of ``mfm_tpu/obs/flightrec.py``, the same dump format).

A bounded, thread-safe ring (drop-oldest, the loss counted) collects
recent request and batch events as the serving stack runs; on a
triggering condition — the breaker opening, a failed fence audit — the
ring is dumped atomically to ``flightrec.json`` (tmp -> fsync -> chaos
point ``flightrec.after_tmp`` -> rename -> dir fsync) with:

- the event ring (newest last), each event stamped with its wall clock
  and, when known, the trace id of the request that produced it;
- the span ring snapshot in wire form, so the dump joins to the spans;
- a full metrics snapshot (``obs/metrics.py`` registry);
- caller-supplied state (breaker state and reason).

Unarmed (no dump path, see :func:`arm`), :func:`trigger_dump` is a
no-op, so unit-level servers never write files.  Repeated triggers
overwrite the same path: the newest postmortem wins, and each dump
already holds the history that led to it.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time

from mfm_tpu_torch.obs import instrument as _obs
from mfm_tpu_torch.utils.chaos import chaos_point

#: default event-ring capacity — events are small dicts; 512 of them is
#: minutes of fleet context at steady load, one flush storm at peak
DEFAULT_RING_CAPACITY = 512

FLIGHTREC_SCHEMA_VERSION = 1

#: the dump's on-disk name beside the checkpoint/manifests (fleet workers
#: dump to ``flightrec.r{i}.json``)
FLIGHTREC_NAME = "flightrec.json"

_lock = threading.Lock()
_ring: collections.deque = collections.deque()
_capacity = DEFAULT_RING_CAPACITY
_dump_path: str | None = None


def set_capacity(n: int) -> None:
    """Resize the event ring (overflow drops oldest, counted)."""
    global _capacity
    if int(n) < 1:
        raise ValueError(f"flightrec capacity must be >= 1, got {n}")
    with _lock:
        _capacity = int(n)
        _evict_locked()


def _evict_locked() -> int:
    dropped = 0
    while len(_ring) > _capacity:
        _ring.popleft()
        dropped += 1
    return dropped


def record_event(kind: str, *, trace_id: str | None = None,
                 **fields) -> dict:
    """Append one event to the ring.  ``kind`` is the event vocabulary
    ("batch", "batch_error", "dispatch", "transport_fail",
    "breaker_open", "fence_audit", "wedge_quarantine", "rollout", ...);
    ``trace_id`` joins it to the request timeline when one is in scope;
    ``fields`` are small JSON-safe details."""
    ev = {"kind": str(kind), "wall_ts": round(time.time(), 3)}
    if trace_id is not None:
        ev["trace_id"] = str(trace_id)
    if fields:
        ev.update(fields)
    with _lock:
        _ring.append(ev)
        dropped = _evict_locked()
    _obs.record_flightrec_event(1, dropped)
    return ev


def events() -> list:
    """Snapshot of the ring, oldest first."""
    with _lock:
        return [dict(ev) for ev in _ring]


def last_trace_id() -> str | None:
    """The most recent event's trace id, if any event carried one — the
    default "triggering request" stamp for dumps whose trigger site
    (e.g. the breaker's failure counter) does not know the request."""
    with _lock:
        for ev in reversed(_ring):
            tid = ev.get("trace_id")
            if tid is not None:
                return tid
    return None


def reset_flightrec() -> None:
    """Drop every event, restore the default capacity and disarm the
    recorder (tests)."""
    global _capacity, _dump_path
    with _lock:
        _ring.clear()
        _capacity = DEFAULT_RING_CAPACITY
        _dump_path = None


# -- arming + triggered dumps -------------------------------------------------

def arm(path: str | None) -> None:
    """Point triggered dumps at ``path`` (None disarms); a server arms the
    recorder beside its checkpoint."""
    global _dump_path
    with _lock:
        _dump_path = path


def armed_path() -> str | None:
    with _lock:
        return _dump_path


def trigger_dump(trigger: str, *, trace_id: str | None = None,
                 state: dict | None = None) -> str | None:
    """Dump the recorder to the armed path (no-op when unarmed).  Never
    raises — a postmortem writer that can take down the serving loop
    would be worse than no postmortem; failures surface on stderr and in
    the returned None."""
    path = armed_path()
    if path is None:
        return None
    try:
        return dump_flightrec(path, trigger=trigger, trace_id=trace_id,
                              state=state)
    except OSError as e:  # pragma: no cover - disk-full/readonly paths
        import sys
        print(f"flightrec: dump failed ({e})", file=sys.stderr)
        return None


def dump_flightrec(path: str, *, trigger: str,
                   trace_id: str | None = None,
                   state: dict | None = None) -> str:
    """Atomically write the postmortem bundle to ``path``.

    ``trace_id`` defaults to the newest event's (the triggering
    request); ``state`` is the caller's live context (breaker, rollout,
    replica ledgers).  The write is tmp -> fsync -> chaos point ->
    rename -> dir fsync, so a SIGKILL mid-dump leaves either the prior
    dump or none — never a torn file.  Returns the final path."""
    from mfm_tpu_torch.obs import trace as _trace
    from mfm_tpu_torch.obs.metrics import REGISTRY

    bundle = {
        "schema": FLIGHTREC_SCHEMA_VERSION,
        "trigger": str(trigger),
        "trace_id": trace_id if trace_id is not None else last_trace_id(),
        "taken_at_unix": round(time.time(), 3),
        "events": events(),
        "spans": [_trace.wire_span(s) for s in _trace.spans()],
        "metrics": REGISTRY.snapshot(),
        "state": dict(state or {}),
    }
    text = json.dumps(bundle, sort_keys=True, default=str)
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
    chaos_point("flightrec.after_tmp", path)
    os.replace(tmp, path)
    try:
        fd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:  # pragma: no cover - exotic filesystems
        pass
    _obs.record_flightrec_dump(trigger)
    return path


def read_flightrec(path: str) -> dict:
    """Load + schema-check a dump; raises ValueError on anything a
    postmortem reader would choke on (the torn-file check the chaos plan
    drives)."""
    with open(path, "r", encoding="utf-8") as fh:
        try:
            obj = json.load(fh)
        except ValueError as e:
            raise ValueError(
                f"not valid JSON ({e}) — torn flightrec dump?") from e
    if not isinstance(obj, dict):
        raise ValueError("flightrec dump must be a JSON object")
    if obj.get("schema") != FLIGHTREC_SCHEMA_VERSION:
        raise ValueError(f"unsupported flightrec schema "
                         f"{obj.get('schema')!r}")
    for key in ("trigger", "events", "spans", "metrics", "state"):
        if key not in obj:
            raise ValueError(f"flightrec dump missing {key!r}")
    if not isinstance(obj["events"], list) or \
            not isinstance(obj["spans"], list):
        raise ValueError("flightrec events/spans must be lists")
    return obj
