"""Deterministic crash points (counterpart of the crash-point part of
``mfm_tpu/utils/chaos.py``).

:func:`chaos_point` marks a named step of a write or serve protocol.
Setting ``MFM_CHAOS_KILL=<point>`` in a process's environment SIGKILLs the
process at exactly that step — a deterministic "kill -9 mid write", no
racy timers; ``MFM_CHAOS_KILL_MATCH`` narrows the kill to paths containing
a substring.  With the variable unset a point costs one dict lookup.

The points here are the ones the ported serving and scenario modules
reach; the
reference's byte-level and data faults, flaky stores and fault plans wait
for ROADMAP.md §A 15.
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
