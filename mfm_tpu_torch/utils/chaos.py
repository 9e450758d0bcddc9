"""Deterministic fault injection (counterpart of the crash-point and
transport-fault parts of ``mfm_tpu/utils/chaos.py``).

- **Crash points** (:func:`chaos_point`) mark a named step of a write or
  serve protocol.  Setting ``MFM_CHAOS_KILL=<point>`` in a process's
  environment SIGKILLs the process at exactly that step — a deterministic
  "kill -9 mid write", no racy timers; ``MFM_CHAOS_KILL_MATCH`` narrows
  the kill to paths containing a substring.  With the variable unset a
  point costs one dict lookup.
- **Transport faults** (:class:`FlakyStore`, :func:`flaky`): wrappers that
  fail the first N calls with a chosen exception — the retry-path drill
  for :func:`mfm_tpu_torch.data.etl.with_retry`.

The points here are the ones the ported serving, scenario and
observability modules reach.  The byte faults (``truncate_file``,
``corrupt_file``), the data faults (``poison_*``) and the fault plans
(``FaultPlan``, ``plan_suite``) wait for ROADMAP.md §A 15.
"""

from __future__ import annotations

import os
import signal

#: env var naming the crash point to SIGKILL at; ``MFM_CHAOS_KILL_MATCH``
#: optionally narrows it to paths containing the given substring
KILL_ENV = "MFM_CHAOS_KILL"
KILL_MATCH_ENV = "MFM_CHAOS_KILL_MATCH"

#: the crash points the port's modules reach, in the reference's names
CRASH_POINTS = (
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
