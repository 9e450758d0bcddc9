"""``mfm_tpu_torch.obs`` — the telemetry the serving stack records
(host-side only; counterpart of the serving part of ``mfm_tpu/obs``).

- :mod:`~mfm_tpu_torch.obs.metrics` — counters/gauges/histograms + REGISTRY
- :mod:`~mfm_tpu_torch.obs.instrument` — the serving metric catalog and
  its recording helpers
- :mod:`~mfm_tpu_torch.obs.trace` — request-scoped spans, the fleet-wire
  span merge and the Chrome-trace export
- :mod:`~mfm_tpu_torch.obs.flightrec` — the postmortem ring and its dumps
- :mod:`~mfm_tpu_torch.obs.exporters` — the JSONL event stream and the
  Prometheus textfile
- :mod:`~mfm_tpu_torch.obs.slo` — the SLO burn-rate engine
- :mod:`~mfm_tpu_torch.obs.manifest` — run, serve and fleet manifests
- :mod:`~mfm_tpu_torch.obs.health` — the model-health monitors and the
  manifests' health verdict
- :mod:`~mfm_tpu_torch.obs.profile` — counted flops, measured memory and
  kernel build/load walls of one run (the torch analog of the
  reference's XLA cost and memory analysis)
"""

from mfm_tpu_torch.obs.metrics import (Counter, Gauge, Histogram,
                                       MetricsRegistry, REGISTRY, is_enabled,
                                       set_enabled, snapshot_json)
from mfm_tpu_torch.obs.trace import (Span, current_trace_id, end_span,
                                     new_trace_id, reset_tracing, set_tracing,
                                     span, spans, start_span, tracing_enabled)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY", "Span",
    "current_trace_id", "end_span", "is_enabled", "new_trace_id",
    "reset_tracing", "set_enabled", "set_tracing", "snapshot_json", "span",
    "spans", "start_span", "tracing_enabled",
]
