"""Serving layer of the port: the per-date input guards and the
degraded-mode verdicts behind ``RiskModel.update_guarded``
(counterpart of ``mfm_tpu/serve/guard.py`` and ``serve/_checks.py``).

The reference's request-side stack (query engine, server, coalescer,
cache, fleet) is ROADMAP.md §A 10.
"""

from mfm_tpu_torch.serve.guard import (  # noqa: F401
    REASON_CAP_NONPOS,
    REASON_DATE_ORDER,
    REASON_FORCED,
    REASON_NAN_DENSITY,
    REASON_RET_OUTLIER,
    REASON_UNIVERSE_COLLAPSE,
    GuardReport,
    guard_ring_init,
    guard_slab,
    host_date_reasons,
    reason_names,
)
