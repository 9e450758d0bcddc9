"""Metrics core: a process-wide registry of counters, gauges and histograms
(counterpart of ``mfm_tpu/obs/metrics.py``, the same names and schema).

Zero-dependency (stdlib only), thread-safe, and strictly host-side:
metrics record host values around the device work, never device tensors,
so recording never waits on the card.

Design:

- A :class:`MetricsRegistry` owns named metrics; the module-level
  :data:`REGISTRY` is the process default (the library instrumentation
  records there, so one snapshot sees everything).
- Metrics carry optional *label names*; each distinct label-value tuple is
  an independent series (Prometheus data model).  Label values are
  stringified at record time.
- Histograms use fixed upper bounds (cumulative on export, like Prometheus
  ``_bucket{le=...}``) plus exact sum/count; :meth:`Histogram.quantile_est`
  interpolates within buckets for test assertions and dashboards.
- ``enabled`` is a process-wide switch (:func:`set_enabled`): disabled
  recording is a no-op.

All mutation happens under one registry lock; a record call is a dict
update and two float adds.
"""

from __future__ import annotations

import json
import threading
import time

#: default latency buckets (seconds) — spans the ~1 ms eager ops through the
#: ~20 s e2e pipeline, log-ish spacing
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

_enabled = True


def set_enabled(on: bool) -> None:
    """Process-wide telemetry switch; disabled recording is a no-op."""
    global _enabled
    _enabled = bool(on)


def is_enabled() -> bool:
    return _enabled


def _label_key(labelnames, labels: dict) -> tuple:
    if set(labels) != set(labelnames):
        raise ValueError(
            f"labels {sorted(labels)} do not match declared label names "
            f"{sorted(labelnames)}")
    return tuple(str(labels[n]) for n in labelnames)


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_text: str, labelnames: tuple,
                 lock: threading.RLock):
        self.name = name
        self.help_text = help_text
        self.labelnames = tuple(labelnames)
        self._lock = lock
        self._series: dict[tuple, object] = {}

    def _key(self, labels: dict) -> tuple:
        return _label_key(self.labelnames, labels)

    def series(self) -> dict:
        """{label-value tuple -> recorded value} (shallow copy)."""
        with self._lock:
            return dict(self._series)


class Counter(_Metric):
    """Monotonically increasing float, per label set."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if not _enabled:
            return
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up "
                             f"(inc({amount}))")
        k = self._key(labels)
        with self._lock:
            self._series[k] = self._series.get(k, 0.0) + float(amount)

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(self._key(labels), 0.0))


class Gauge(_Metric):
    """Last-write-wins float, per label set.

    The setter is ``set_value``, the reference's name.
    """

    kind = "gauge"

    def set_value(self, value: float, **labels) -> None:
        if not _enabled:
            return
        with self._lock:
            self._series[self._key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        if not _enabled:
            return
        k = self._key(labels)
        with self._lock:
            self._series[k] = self._series.get(k, 0.0) + float(amount)

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(self._key(labels), 0.0))


class _HistState:
    __slots__ = ("counts", "total", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets   # per-bucket (non-cumulative)
        self.total = 0.0
        self.count = 0


class Histogram(_Metric):
    """Fixed-bucket histogram; buckets are upper bounds, +Inf implicit."""

    kind = "histogram"

    def __init__(self, name, help_text, labelnames, lock,
                 buckets=DEFAULT_BUCKETS):
        super().__init__(name, help_text, labelnames, lock)
        bs = tuple(float(b) for b in buckets)
        if not bs or any(b2 <= b1 for b1, b2 in zip(bs, bs[1:])):
            raise ValueError(f"{name}: buckets must be strictly increasing "
                             f"and non-empty ({bs})")
        self.buckets = bs

    def observe(self, value: float, **labels) -> None:
        if not _enabled:
            return
        v = float(value)
        k = self._key(labels)
        with self._lock:
            st = self._series.get(k)
            if st is None:
                st = self._series[k] = _HistState(len(self.buckets) + 1)
            i = 0
            while i < len(self.buckets) and v > self.buckets[i]:
                i += 1
            st.counts[i] += 1
            st.total += v
            st.count += 1

    def cumulative(self, **labels) -> list[tuple[float, int]]:
        """[(le, cumulative count), ...] ending with (inf, total count)."""
        with self._lock:
            st = self._series.get(self._key(labels))
            counts = list(st.counts) if st else [0] * (len(self.buckets) + 1)
        out, running = [], 0
        for le, c in zip(self.buckets + (float("inf"),), counts):
            running += c
            out.append((le, running))
        return out

    def quantile_est(self, q: float, **labels) -> float:
        """Bucket-interpolated quantile estimate (NaN when empty).

        Linear within a finite bucket; an answer in the +Inf bucket clamps
        to the last finite bound (the estimate's resolution floor).
        """
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        cum = self.cumulative(**labels)
        n = cum[-1][1]
        if n == 0:
            return float("nan")
        target = q * n
        lo_bound, lo_cum = 0.0, 0
        for le, c in cum:
            if c >= target:
                if le == float("inf"):
                    return self.buckets[-1]
                width = c - lo_cum
                frac = (target - lo_cum) / width if width else 1.0
                return lo_bound + frac * (le - lo_bound)
            lo_bound, lo_cum = le, c
        return self.buckets[-1]


class MetricsRegistry:
    """Named metrics with declare-once semantics (re-declaring with the same
    type/labels returns the existing metric; a conflicting redeclaration
    raises — two call sites silently writing different shapes into one name
    is how dashboards lie)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: dict[str, _Metric] = {}

    def _declare(self, cls, name, help_text, labelnames, **kw):
        labelnames = tuple(labelnames)
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls) or m.labelnames != labelnames:
                    raise ValueError(
                        f"metric {name!r} already declared as {m.kind} with "
                        f"labels {m.labelnames} — conflicting redeclaration")
                return m
            m = cls(name, help_text, labelnames, self._lock, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help_text: str = "",
                labelnames: tuple = ()) -> Counter:
        return self._declare(Counter, name, help_text, labelnames)

    def gauge(self, name: str, help_text: str = "",
              labelnames: tuple = ()) -> Gauge:
        return self._declare(Gauge, name, help_text, labelnames)

    def histogram(self, name: str, help_text: str = "", labelnames: tuple = (),
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._declare(Histogram, name, help_text, labelnames,
                             buckets=buckets)

    def metrics(self) -> list[_Metric]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def reset(self) -> None:
        """Drop every metric (tests / bench repeat runs)."""
        with self._lock:
            self._metrics.clear()

    def snapshot(self) -> dict:
        """JSON-ready dump: {name: {type, help, labelnames, series: [...]}}.

        Histogram series carry cumulative ``buckets`` ([le, count] pairs,
        le=+Inf rendered as the string "+Inf" for strict JSON) plus exact
        sum/count: the reference's stable schema, which its run manifests
        embed.
        """
        out = {}
        for m in self.metrics():
            series = []
            for key in sorted(m.series()):
                labels = dict(zip(m.labelnames, key))
                if isinstance(m, Histogram):
                    st = m.series()[key]
                    cum = m.cumulative(**labels)
                    series.append({
                        "labels": labels,
                        "buckets": [["+Inf" if le == float("inf") else le, c]
                                    for le, c in cum],
                        "sum": st.total,
                        "count": st.count,
                    })
                else:
                    series.append({"labels": labels,
                                   "value": m.series()[key]})
            out[m.name] = {"type": m.kind, "help": m.help_text,
                           "labelnames": list(m.labelnames), "series": series}
        return out

    def scalar_values(self) -> dict:
        """{name or name{k=v,...} -> value} for counters/gauges — the flat
        view of the registry."""
        out = {}
        for m in self.metrics():
            if isinstance(m, Histogram):
                continue
            for key, v in sorted(m.series().items()):
                if m.labelnames:
                    lbl = ",".join(f"{n}={val}"
                                   for n, val in zip(m.labelnames, key))
                    out[f"{m.name}{{{lbl}}}"] = v
                else:
                    out[m.name] = v
        return out


#: the process-default registry — library instrumentation records here
REGISTRY = MetricsRegistry()


def snapshot_json(registry: MetricsRegistry | None = None) -> str:
    """The default registry's snapshot as stable, sorted JSON text."""
    reg = registry if registry is not None else REGISTRY
    return json.dumps({"schema": 1, "taken_at_unix": round(time.time(), 3),
                       "metrics": reg.snapshot()}, indent=1, sort_keys=True)
