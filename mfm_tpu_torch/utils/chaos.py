"""Deterministic fault injection (counterpart of
``mfm_tpu/utils/chaos.py``).

- **Crash points** (:func:`chaos_point`) mark a named step of a write or
  serve protocol.  Setting ``MFM_CHAOS_KILL=<point>`` in a process's
  environment SIGKILLs the process at exactly that step — a deterministic
  "kill -9 mid write", no racy timers; ``MFM_CHAOS_KILL_MATCH`` narrows
  the kill to paths containing a substring.  With the variable unset a
  point costs one dict lookup.
- **Byte faults** (:func:`truncate_file`, :func:`corrupt_file`): seeded
  truncation and bit flips of an existing checkpoint — torn writes and
  silent media corruption.  The same seed damages the same bytes as the
  reference.
- **Data faults** (:func:`poison_nan`, :func:`poison_outliers`,
  :func:`poison_universe`): seeded slab poisoning for the input guards
  (serve/guard.py), on numpy arrays or tensors, drawing ``default_rng``
  in the reference's order.
- **Transport faults** (:class:`FlakyStore`, :func:`flaky`): wrappers that
  fail the first N calls with a chosen exception — the retry-path drill
  for :func:`mfm_tpu_torch.data.etl.with_retry`.
- **Fault plans** (:class:`FaultPlan`, :func:`plan_suite`): the named,
  seeded recovery matrix, plan for plan the reference's, which
  ``python -m mfm_tpu_torch.tools.faultinject`` drives.

Host-side tooling: nothing here touches the device, and the coupling to
the serving path is the ``chaos_point`` call sites.
"""

from __future__ import annotations

import dataclasses
import os
import signal

import numpy as np

#: env var naming the crash point to SIGKILL at; ``MFM_CHAOS_KILL_MATCH``
#: optionally narrows it to paths containing the given substring
KILL_ENV = "MFM_CHAOS_KILL"
KILL_MATCH_ENV = "MFM_CHAOS_KILL_MATCH"

#: the crash points the port's modules reach, in the reference's names
CRASH_POINTS = (
    "save_artifact.after_tmp",     # tmp durable, final file still the old
                                   # one (data/artifacts.py)
    "save_artifact.after_rename",  # new file live, pointer not yet swapped
    "serve.after_batch",     # query loop: batch i's responses emitted, batch
                             # i+1 not yet drained; the path is "batch{i}"
                             # (serve/server.py)
    "scenario_manifest.after_tmp",  # scenario batch computed, manifest tmp
                                    # not yet renamed (scenario/manifest.py)
    "sweep_manifest.after_tmp",  # streaming sweep done, sweep_manifest tmp
                                 # not yet renamed (scenario/sweep.py)
    "flightrec.after_tmp",   # flight-recorder dump: tmp durable, final file
                             # not yet renamed (obs/flightrec.py)
    "run_manifest.after_tmp",  # run/serve/fleet manifest tmp durable, final
                               # file not yet renamed (obs/manifest.py)
    "trace.after_tmp",       # Chrome-trace flush: tmp durable, final file
                             # not yet renamed (obs/trace.py)
    "grad_report.after_tmp",  # grad solve done, grad_report.json tmp not
                              # yet renamed (grad/report.py)
)


def chaos_point(name: str, path: str = "") -> None:
    """SIGKILL this process iff ``MFM_CHAOS_KILL`` names this point (and
    ``MFM_CHAOS_KILL_MATCH``, when set, is a substring of ``path``).

    SIGKILL, not an exception: the contract under test is crash
    atomicity, so no cleanup handler may run.
    """
    if os.environ.get(KILL_ENV) != name:
        return
    match = os.environ.get(KILL_MATCH_ENV)
    if match and match not in path:
        return
    os.kill(os.getpid(), signal.SIGKILL)


# -- byte-level checkpoint faults -----------------------------------------------

def truncate_file(path: str, n_bytes: int) -> int:
    """Drop the last ``n_bytes`` of ``path`` (a torn tail write).  Returns
    the new size."""
    size = os.path.getsize(path)
    new = max(0, size - int(n_bytes))
    with open(path, "rb+") as f:
        f.truncate(new)
    return new


def corrupt_file(path: str, n_bytes: int, seed: int) -> list[int]:
    """Flip one bit in each of ``n_bytes`` seeded random positions of
    ``path`` (silent media corruption).  Returns the offsets touched."""
    size = os.path.getsize(path)
    rng = np.random.default_rng(seed)
    offsets = sorted(int(o) for o in
                     rng.choice(size, size=min(int(n_bytes), size),
                                replace=False))
    with open(path, "rb+") as f:
        for off in offsets:
            f.seek(off)
            b = f.read(1)
            f.seek(off)
            f.write(bytes([b[0] ^ (1 << int(rng.integers(8)))]))
    return offsets


# -- slab data faults -----------------------------------------------------------
# each takes a numpy array or a tensor and modifies it in place; the seeded
# choices are drawn on the host, in the reference's order

def _index(x, idx):
    """``idx`` (numpy) as an index into ``x``'s device when ``x`` is a
    tensor."""
    if isinstance(x, np.ndarray):
        return idx
    import torch

    return torch.as_tensor(idx, device=x.device)


def poison_nan(ret, dates, frac: float = 1.0, seed: int = 0):
    """NaN-poison a seeded ``frac`` of each listed date's return row.
    ``ret`` is modified in place ((T, N) float array or tensor); returns
    it."""
    rng = np.random.default_rng(seed)
    for t in dates:
        n = ret.shape[1]
        k = max(1, int(round(frac * n)))
        cols = rng.choice(n, size=k, replace=False)
        ret[t, _index(ret, cols)] = float("nan")
    return ret


def poison_outliers(ret, dates, magnitude: float = 5.0, frac: float = 0.3,
                    seed: int = 0):
    """Blow up a seeded ``frac`` of each listed date's returns to
    ``±magnitude`` (fat-finger / bad-split day).  In place; returns ret."""
    rng = np.random.default_rng(seed)
    for t in dates:
        n = ret.shape[1]
        k = max(1, int(round(frac * n)))
        cols = rng.choice(n, size=k, replace=False)
        vals = magnitude * rng.choice([-1.0, 1.0], size=k)
        ret[t, _index(ret, cols)] = (
            vals if isinstance(ret, np.ndarray)
            else _index(ret, vals).to(ret.dtype))
    return ret


def poison_universe(valid, dates, keep_frac: float = 0.2, seed: int = 0):
    """Collapse the listed dates' universes to a seeded ``keep_frac`` of
    their stocks (upstream join loss).  In place; returns valid."""
    rng = np.random.default_rng(seed)
    for t in dates:
        row = valid[t] if isinstance(valid, np.ndarray) else valid[t].cpu()
        idx = np.nonzero(np.asarray(row))[0]
        drop = rng.choice(idx, size=int(round((1 - keep_frac) * idx.size)),
                          replace=False)
        valid[t, _index(valid, drop)] = False
    return valid


# -- transport faults -----------------------------------------------------------

def flaky(fn, n_failures: int, exc_factory=ConnectionError):
    """Wrap ``fn`` to raise ``exc_factory(...)`` on its first ``n_failures``
    calls, then behave normally — the deterministic transient-error source
    for the ``with_retry`` drill."""
    state = {"left": int(n_failures)}

    def wrapped(*a, **kw):
        if state["left"] > 0:
            state["left"] -= 1
            raise exc_factory(f"chaos: injected transient failure "
                              f"({state['left']} more)")
        return fn(*a, **kw)

    return wrapped


class FlakyStore:
    """Store proxy whose chosen methods fail the first N calls each with a
    transient error, then delegate — exercised against
    ``IncrementalUpdater``-style retry loops."""

    def __init__(self, inner, n_failures: int = 2,
                 methods: tuple = ("insert",), exc_factory=ConnectionError):
        self._inner = inner
        self._left = {m: int(n_failures) for m in methods}
        self._exc = exc_factory

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if name not in self._left or not callable(attr):
            return attr

        def wrapped(*a, **kw):
            if self._left[name] > 0:
                self._left[name] -= 1
                raise self._exc(f"chaos: {name} transient failure")
            return attr(*a, **kw)

        return wrapped


# -- the seeded fault-plan matrix -----------------------------------------------

@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """One named, fully seeded fault scenario.  ``kind`` selects the
    mechanism; ``params`` feed it; ``seed`` pins every random choice so a
    failing plan replays exactly."""

    name: str
    kind: str
    seed: int = 0
    params: tuple = ()   # ((key, value), ...) — hashable, printable

    def param(self, key, default=None):
        return dict(self.params).get(key, default)


def plan_suite(seed: int = 0) -> tuple:
    """The standard recovery matrix, the reference's 29 plans: every
    mechanism at least once, seeds derived from ``seed`` so the whole
    suite replays deterministically."""
    s = int(seed)
    P = FaultPlan
    return (
        P("truncate-tail-64", "truncate", s + 1, (("n_bytes", 64),)),
        P("truncate-half", "truncate", s + 2, (("frac", 0.5),)),
        P("corrupt-8-bytes", "corrupt", s + 3, (("n_bytes", 8),)),
        P("kill-after-tmp", "kill", s + 4,
          (("point", "save_artifact.after_tmp"),)),
        P("kill-after-rename", "kill", s + 5,
          (("point", "save_artifact.after_rename"),)),
        P("nan-slab", "nan_slab", s + 6, (("frac", 1.0),)),
        P("outlier-slab", "outlier_slab", s + 7,
          (("magnitude", 5.0), ("frac", 0.3))),
        P("universe-collapse", "universe_slab", s + 8, (("keep_frac", 0.2),)),
        P("flaky-store", "flaky_store", s + 9, (("n_failures", 2),)),
        P("kill-at-manifest", "kill_manifest", s + 10,
          (("point", "run_manifest.after_tmp"),)),
        # the query service's request-side matrix
        P("query-kill-mid-batch", "query_kill", s + 11,
          (("point", "serve.after_batch"), ("match", "batch1"))),
        P("query-poison-slab", "query_poison", s + 12, (("n_poison", 6),)),
        P("query-overflow-storm", "query_overflow", s + 13,
          (("queue_max", 8), ("storm", 24))),
        P("query-ckpt-swap", "query_swap", s + 14, (("corrupt_bytes", 8),)),
        P("query-steady-state", "query_steady", s + 15, (("rounds", 6),)),
        # scenario manifest crash atomicity, per-lane rejection isolation
        P("scenario-kill-mid-batch", "scenario_kill", s + 16,
          (("point", "scenario_manifest.after_tmp"),)),
        P("scenario-poison-spec", "scenario_poison", s + 17,
          (("n_poison", 3),)),
        # SIGKILL mid trace flush: no torn trace, checkpoint untouched
        P("trace-kill-mid-flush", "trace_kill", s + 18,
          (("point", "trace.after_tmp"),)),
        # SIGKILL mid save of the incremental eigen carry
        P("eigen-kill-mid-update", "eigen_kill", s + 19,
          (("point", "save_artifact.after_tmp"),)),
        # the same fence under a sharded update step
        P("shard-kill-mid-append", "shard_kill", s + 20,
          (("point", "save_artifact.after_tmp"), ("mesh", "2x2"))),
        # SIGKILL between the grad report's tmp write and its rename
        P("grad-kill-mid-solve", "grad_kill", s + 21,
          (("point", "grad_report.after_tmp"),)),
        # one of three fleet replicas killed after computing a batch
        P("fleet-kill-replica", "fleet_kill", s + 22,
          (("point", "serve.after_batch"), ("match", "batch1"),
           ("replica", 1), ("replicas", 3))),
        # the response cache's generation fence across a hot reload
        P("cache-stale-generation", "cache_stale", s + 23,
          (("point", "save_artifact.after_tmp"), ("repeats", 6))),
        # SIGKILL between the sweep manifest's tmp write and its rename
        P("sweep-kill-mid-stream", "sweep_kill", s + 24,
          (("point", "sweep_manifest.after_tmp"),)),
        # deterministic-interleaving schedule drills (utils/sched.py)
        P("sync-schedule-coalescer", "sync_schedule_coalescer", s + 25,
          (("seeds", 10), ("threads", 3), ("n", 12),
           ("hammer_threads", 4), ("hammer_n", 32))),
        P("sync-schedule-cache", "sync_schedule_cache", s + 26,
          (("seeds", 10), ("threads", 3), ("ops", 10), ("bodies", 6),
           ("max_entries", 4), ("max_bytes", 4096))),
        # a whole simulated host killed, another worker wedged
        P("fleet-kill-host", "fleet_kill_host", s + 27,
          (("hosts", 2), ("workers_per_host", 2), ("kill_host", 1),
           ("wedge", 1), ("n", 96))),
        # one SIGSTOPped worker mid-storm, nothing killed
        P("fleet-wedge-worker", "fleet_wedge", s + 28,
          (("replicas", 3), ("wedge", 1), ("n", 96))),
        # SIGKILL between the flight-recorder dump's tmp write and rename
        P("flightrec-kill-mid-dump", "flightrec_kill", s + 29,
          (("point", "flightrec.after_tmp"),)),
    )
