"""SLO burn-rate engine: declarative objectives evaluated at scrape time
(counterpart of ``mfm_tpu/obs/slo.py``).

Counters say what happened; an SLO says whether it was ACCEPTABLE, and a
burn rate says how fast the error budget is going.  This module holds the
serving stack's objectives as data (:class:`SloSpec`), evaluates them at
scrape time from the live :mod:`mfm_tpu_torch.obs.metrics` registry — no
background thread, no new collection path — and derives the two-window
alert discipline of the SRE workbook:

- **fast window** (default 5 m): a burn rate >= ``FAST_BURN_THRESHOLD``
  (14.4 — the whole 30-day budget gone in ~2 days) is a page-now state
  (``fast_burn``); ``doctor --serve`` fails on it.
- **slow window** (default 1 h): a burn rate >= ``SLOW_BURN_THRESHOLD``
  (3.0) is a ticket state (``slow_burn``); doctor warns.

Burn rate is ``(bad fraction in window) / (1 - objective)`` — 1.0 means
burning exactly the budget, sustainable forever.  The engine samples
CUMULATIVE counters with timestamps and differences them over each
window, so it needs no history beyond one slow window of scrape samples,
and a process scraped rarely degrades gracefully (the window shrinks to
the data it has rather than inventing a rate).

Three spec kinds cover the serving SLOs:

- ``availability`` — good = ``ok`` outcomes of
  ``mfm_query_requests_total``; objective is the minimum good fraction.
- ``p99_latency`` — good = requests at or under ``objective`` seconds,
  read off ``mfm_query_latency_seconds``'s cumulative buckets; the budget
  is the 1% tail by construction.
- ``staleness`` — good = scrape samples where
  ``mfm_served_cov_staleness`` is at or under ``objective`` dates (a gauge
  SLO: the bad fraction is bad *time*, sampled at scrapes).

A module-level engine slot (:func:`install`) lets the serve CLI arm one
engine per process; ``serve_summary_from_registry`` then carries the
evaluation into ``/healthz``, the manifests and ``doctor --serve``.
Host-only: stdlib + the obs registry.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time

from mfm_tpu_torch.obs import instrument as _obs

#: fast-window burn that pages: the 30-day budget gone in ~2 days
FAST_BURN_THRESHOLD = 14.4
#: slow-window burn that files a ticket: budget gone in ~10 days
SLOW_BURN_THRESHOLD = 3.0

_SPEC_KINDS = ("availability", "p99_latency", "staleness")


@dataclasses.dataclass(frozen=True)
class SloSpec:
    """One declarative objective.  ``objective`` means: minimum good
    fraction for ``availability`` (e.g. 0.99), maximum seconds for
    ``p99_latency``, maximum staleness dates for ``staleness``."""

    name: str
    kind: str
    objective: float
    description: str = ""

    def __post_init__(self):
        if self.kind not in _SPEC_KINDS:
            raise ValueError(f"unknown SLO kind {self.kind!r}; have "
                             f"{list(_SPEC_KINDS)}")
        if self.kind == "availability" and not 0.0 < self.objective < 1.0:
            raise ValueError(f"availability objective must be in (0, 1), "
                             f"got {self.objective}")
        if self.kind != "availability" and self.objective < 0:
            raise ValueError(f"{self.kind} objective must be >= 0, got "
                             f"{self.objective}")

    def budget(self) -> float:
        """The error budget the burn rate divides by.  Availability's is
        ``1 - objective``; the tail-latency and staleness SLOs use the
        p99 tail budget (1%) by convention."""
        if self.kind == "availability":
            return 1.0 - self.objective
        return 0.01


#: the serving stack's default objectives (the reference's)
DEFAULT_SLOS = (
    SloSpec("availability", "availability", 0.99,
            "99% of admitted requests answer ok"),
    SloSpec("p99-latency", "p99_latency", 0.5,
            "99% of answered requests within 500 ms enqueue-to-response"),
    SloSpec("staleness", "staleness", 5.0,
            "served covariance at most 5 dates stale"),
)


def _count_le(cum: list, bound: float) -> int:
    """Cumulative count at the first bucket bound >= ``bound`` (all
    observations when ``bound`` exceeds the last finite bucket)."""
    for le, c in cum:
        if le >= bound:
            return int(c)
    return int(cum[-1][1]) if cum else 0


class SloEngine:
    """Evaluate :class:`SloSpec` objectives over fast/slow windows.

    Args:
      specs: the objectives (default :data:`DEFAULT_SLOS`).
      clock: monotonic clock, injectable for deterministic tests.
      fast_window_s / slow_window_s: the two burn windows.

    Thread-safe: sampling and evaluation run under one lock (scrapes
    arrive from N frontend connection threads).
    """

    def __init__(self, specs=DEFAULT_SLOS, *,
                 clock=time.monotonic,
                 fast_window_s: float = 300.0,
                 slow_window_s: float = 3600.0):
        specs = tuple(specs)
        if not specs:
            raise ValueError("SloEngine needs at least one SloSpec")
        if not 0 < fast_window_s <= slow_window_s:
            raise ValueError(
                f"windows must satisfy 0 < fast <= slow, got "
                f"{fast_window_s}/{slow_window_s}")
        self.specs = specs
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self._clock = clock
        self._lock = threading.Lock()
        #: (t, reading) samples, oldest first, pruned past slow_window
        self._samples: collections.deque = collections.deque()

    # -- sampling ------------------------------------------------------------
    def _read_registry(self) -> dict:
        outcomes = {k[0]: int(v)
                    for k, v in _obs.QUERY_REQUESTS_TOTAL.series().items()}
        total = sum(outcomes.values())
        cum = _obs.QUERY_LATENCY_SECONDS.cumulative()
        return {
            "total": total,
            "ok": outcomes.get("ok", 0),
            "lat_cum": [int(c) for _, c in cum],
            "lat_bounds": [le for le, _ in cum],
            "staleness": float(_obs.SERVED_COV_STALENESS.value()),
        }

    def sample(self, now: float | None = None) -> dict:
        """Take one timestamped registry reading (scrape-time hook);
        prunes samples older than the slow window.  Returns the
        reading."""
        t = self._clock() if now is None else float(now)
        reading = self._read_registry()
        with self._lock:
            self._samples.append((t, reading))
            # keep ONE sample beyond the slow window so a full-width
            # baseline survives pruning
            while (len(self._samples) >= 2
                   and t - self._samples[1][0] >= self.slow_window_s):
                self._samples.popleft()
        return reading

    def _baseline(self, now: float, window_s: float) -> tuple:
        """Newest sample at least ``window_s`` old (or the oldest one —
        a shrunk window beats an invented rate).  Callers hold no lock;
        the deque snapshot is taken under it."""
        with self._lock:
            samples = list(self._samples)
        if not samples:
            return None, 0.0
        base = samples[0]
        for t, reading in samples:
            if now - t >= window_s:
                base = (t, reading)
            else:
                break
        return base[1], max(0.0, now - base[0])

    # -- evaluation ----------------------------------------------------------
    def _bad_frac(self, spec: SloSpec, cur: dict, base: dict,
                  window_samples: list) -> float:
        if spec.kind == "availability":
            total = cur["total"] - base["total"]
            if total <= 0:
                return 0.0
            bad = total - (cur["ok"] - base["ok"])
            return max(0.0, min(1.0, bad / total))
        if spec.kind == "p99_latency":
            cur_cum = list(zip(cur["lat_bounds"], cur["lat_cum"]))
            base_cum = list(zip(base["lat_bounds"], base["lat_cum"]))
            n = (cur_cum[-1][1] if cur_cum else 0) - \
                (base_cum[-1][1] if base_cum else 0)
            if n <= 0:
                return 0.0
            good = _count_le(cur_cum, spec.objective) - \
                _count_le(base_cum, spec.objective)
            return max(0.0, min(1.0, (n - good) / n))
        # staleness: bad TIME fraction, sampled at scrapes
        if not window_samples:
            return 0.0
        bad = sum(1 for r in window_samples
                  if r["staleness"] > spec.objective)
        return bad / len(window_samples)

    def evaluate(self, now: float | None = None) -> dict:
        """Sample, then compute every SLO's two-window burn + state and
        mirror them onto the gauges.  Returns the summary block the
        manifests/healthz embed."""
        t = self._clock() if now is None else float(now)
        cur = self.sample(t)
        with self._lock:
            samples = list(self._samples)
        out = []
        worst = "ok"
        rank = {"ok": 0, "slow_burn": 1, "fast_burn": 2}
        for spec in self.specs:
            burns = {}
            for window_name, window_s in (("fast", self.fast_window_s),
                                          ("slow", self.slow_window_s)):
                base, _width = self._baseline(t, window_s)
                in_window = [r for st, r in samples if t - st <= window_s]
                if base is None:
                    burns[window_name] = 0.0
                    continue
                frac = self._bad_frac(spec, cur, base, in_window)
                burns[window_name] = round(frac / spec.budget(), 6)
            if burns["fast"] >= FAST_BURN_THRESHOLD:
                state = "fast_burn"
            elif burns["slow"] >= SLOW_BURN_THRESHOLD:
                state = "slow_burn"
            else:
                state = "ok"
            worst = worst if rank[worst] >= rank[state] else state
            _obs.record_slo_state(spec.name, state, burns["fast"],
                                  burns["slow"])
            out.append({
                "name": spec.name,
                "kind": spec.kind,
                "objective": spec.objective,
                "budget": spec.budget(),
                "burn_fast": burns["fast"],
                "burn_slow": burns["slow"],
                "state": state,
            })
        return {
            "schema": 1,
            "window_fast_s": self.fast_window_s,
            "window_slow_s": self.slow_window_s,
            "fast_burn_threshold": FAST_BURN_THRESHOLD,
            "slow_burn_threshold": SLOW_BURN_THRESHOLD,
            "slos": out,
            "worst_state": worst,
        }


# -- the process engine slot --------------------------------------------------

_engine_lock = threading.Lock()
_engine: SloEngine | None = None


def install(engine: SloEngine | None) -> None:
    """Arm (or with None, disarm) the process SLO engine.  The serve CLI
    installs one; ``serve_summary_from_registry`` then carries its
    evaluation everywhere the summary goes."""
    global _engine
    with _engine_lock:
        _engine = engine


def get_engine() -> SloEngine | None:
    with _engine_lock:
        return _engine


def reset_slo() -> None:
    """Disarm the engine (tests)."""
    install(None)


def installed_summary() -> dict | None:
    """Evaluate the installed engine, or None when disarmed."""
    engine = get_engine()
    if engine is None:
        return None
    return engine.evaluate()
