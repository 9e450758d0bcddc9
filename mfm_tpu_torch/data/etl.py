"""Host data layer (counterpart of ``mfm_tpu/data/etl.py``).

Only :func:`with_retry` is here: the fleet transport dials its workers
with it and the serve CLI loads its checkpoint with it.  The panel store,
the vendor clients and the updaters wait for ROADMAP.md §A 14.
"""

from __future__ import annotations

import time
from typing import Callable


def with_retry(fn: Callable, attempts: int = 3, backoff_s: float = 5.0,
               sleep=time.sleep, *, exponential: bool = False,
               max_backoff_s: float = 60.0, jitter: float = 0.0,
               seed: int = 0, retryable: tuple = (Exception,),
               phase: str | None = None):
    """Call ``fn``; on a retryable exception retry up to ``attempts`` times.

    Defaults are a fixed 5 s backoff and a broad catch.  Production knobs:

    - ``exponential``: back off ``backoff_s * 2**i`` capped at
      ``max_backoff_s`` — repeated transient failures stop hammering a
      recovering upstream.
    - ``jitter``: multiply each delay by a seeded uniform draw from
      ``[1 - jitter, 1 + jitter]`` (decorrelates a fleet of daily jobs all
      retrying the same outage on the same schedule).  Seeded so a replay
      sleeps the same schedule.
    - ``retryable``: exception classes worth retrying; anything else
      (a programming error, an auth failure) re-raises IMMEDIATELY — two
      more identical attempts cannot fix a TypeError.

    On exhaustion the raised exception carries its retry history:
    ``e.attempts`` (calls made) and ``e.total_backoff_s`` (seconds slept
    between them) — the serve CLI's startup dead letter and reload failure
    log stamp these so an operator can tell "failed instantly"
    from "fought the outage for a minute".  ``phase`` additionally
    stamps ``e.phase`` so a caller several frames up can tell WHICH
    retried operation died — the fleet transport uses it to separate
    "never connected" (``phase="connect"``) from "connection lost
    mid-batch" (``phase="batch"``) in its manifest counters.
    """
    import random

    from mfm_tpu_torch.obs import instrument as _telemetry

    rng = random.Random(seed)
    last = None
    total_backoff = 0.0
    for i in range(attempts):
        try:
            result = fn()
            _telemetry.RETRY_ATTEMPTS_TOTAL.inc(
                outcome="ok" if i == 0 else "retried")
            return result
        except retryable as e:
            last = e
            if i < attempts - 1:
                delay = (min(backoff_s * (2.0 ** i), max_backoff_s)
                         if exponential else backoff_s)
                if jitter:
                    delay *= 1.0 + jitter * (2.0 * rng.random() - 1.0)
                _telemetry.RETRY_BACKOFF_SECONDS.observe(delay)
                total_backoff += delay
                sleep(delay)
    _telemetry.RETRY_ATTEMPTS_TOTAL.inc(outcome="exhausted")
    last.attempts = attempts
    last.total_backoff_s = total_backoff
    if phase is not None:
        last.phase = phase
    raise last
