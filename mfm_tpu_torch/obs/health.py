"""Model-health monitors: is the served risk model still trustworthy
(counterpart of ``mfm_tpu/obs/health.py``; thresholds, check names, notes
and the verdict are the reference's).

Three USE4-flavoured monitors computed from served outputs (reusing
``models/bias.py`` for the statistic itself):

- **rolling bias statistic** — eigenfactor bias stat over a trailing
  window; a well-calibrated model keeps it near 1, so the monitored value
  is the mean |b - 1| across eigenfactor ranks.
- **cross-sectional R² drift** — trailing-window mean of the regression R²
  against the run's own earlier baseline; a drop means the factor structure
  stopped explaining the cross-section.
- **factor-return outliers** — fraction of recent factor returns beyond a
  MAD-based z threshold computed from the full history.

Each check reads the ``RiskModelOutputs`` tensors on their own device and
sends one number to the host: the verdict.  Each monitor exports a gauge
and contributes a check to the health verdict (``{"status":
"ok"|"degraded"|"unknown", "checks": {...}}``) that the run manifest embeds
and ``doctor`` audits.  The bias statistic launches the full eigh kernel on
the card, so this runs at the CLI layer, never inside an update.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from mfm_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry


@dataclasses.dataclass(frozen=True)
class HealthThresholds:
    """Alert thresholds (the reference's defaults)."""

    #: mean |bias - 1| across eigenfactor ranks over the trailing window
    bias_max_mean_abs_dev: float = 0.5
    #: trailing window (dates) for the rolling bias statistic
    bias_window: int = 120
    #: fewest valid window dates before the bias monitor reports at all
    bias_min_dates: int = 40
    #: allowed drop of trailing-mean R² below the baseline mean (absolute)
    r2_max_drop: float = 0.15
    #: trailing window (dates) for the R² mean
    r2_window: int = 60
    #: MAD-z beyond which a factor return counts as an outlier
    factor_ret_outlier_z: float = 8.0
    #: allowed fraction of outlier (date, factor) cells in the window
    factor_ret_max_outlier_frac: float = 0.01
    #: trailing window (dates) for the outlier fraction
    factor_ret_window: int = 60
    #: allowed quarantine rate over the run (quarantined / served dates)
    max_quarantine_rate: float = 0.02


def _check(value, threshold, ok, note: str | None = None) -> dict:
    rec = {
        "value": None if value is None or not math.isfinite(value)
        else round(float(value), 6),
        "threshold": threshold,
        "ok": bool(ok),
    }
    if note:
        rec["note"] = note
    return rec


def _nanmedian(x: torch.Tensor) -> torch.Tensor:
    """Per-column median of the non-NaN entries of a (T, K) tensor,
    ``np.nanmedian``'s: the mean of the two middle values at an even
    count (``torch.nanmedian`` takes the lower one), NaN for an empty
    column."""
    s, _ = torch.sort(x, dim=0)          # NaN sorts last
    n = (~torch.isnan(x)).sum(dim=0)
    lo = ((n - 1).clamp(min=0) // 2)[None]
    hi = (n // 2).clamp(max=x.shape[0] - 1)[None]
    med = (s.gather(0, lo) + s.gather(0, hi))[0] / 2
    return torch.where(n > 0, med, torch.full_like(med, float("nan")))


def rolling_bias_check(outputs, thresholds: HealthThresholds) -> dict:
    """Mean |bias - 1| of the eigen-adjusted covariance over the trailing
    window (``models.bias.eigenfactor_bias_stat``)."""
    from mfm_tpu_torch.models.bias import eigenfactor_bias_stat

    valid = outputs.eigen_valid.to(torch.bool)
    T = valid.shape[0]
    lo = max(0, T - int(thresholds.bias_window))
    n_valid = int(valid[lo:].sum())
    if n_valid < thresholds.bias_min_dates:
        return _check(None, thresholds.bias_max_mean_abs_dev, True,
                      note=f"only {n_valid} valid dates in window "
                           f"(need {thresholds.bias_min_dates}) — skipped")
    b = eigenfactor_bias_stat(outputs.eigen_cov[lo:], valid[lo:],
                              outputs.factor_ret[lo:]).to(torch.float64)
    dev = (b[torch.isfinite(b)] - 1.0).abs()
    if dev.numel() == 0:
        return _check(None, thresholds.bias_max_mean_abs_dev, True,
                      note="no finite bias ranks — skipped")
    mean_dev = float(dev.mean())
    return _check(mean_dev, thresholds.bias_max_mean_abs_dev,
                  mean_dev <= thresholds.bias_max_mean_abs_dev)


def r2_drift_check(outputs, thresholds: HealthThresholds) -> dict:
    """Trailing-mean R² vs the pre-window baseline mean; the monitored
    value is ``baseline - recent`` (positive = explanatory power lost)."""
    r2 = outputs.r2.to(torch.float64).reshape(-1)
    finite = torch.isfinite(r2)
    w = int(thresholds.r2_window)
    T = r2.shape[0]
    cut = max(T - w, 0)
    recent, base = r2[cut:][finite[cut:]], r2[:cut][finite[:cut]]
    if recent.numel() == 0 or base.numel() < w:
        return _check(None, thresholds.r2_max_drop, True,
                      note="history shorter than baseline+window — skipped")
    drop = float(base.mean() - recent.mean())
    return _check(drop, thresholds.r2_max_drop,
                  drop <= thresholds.r2_max_drop)


def factor_ret_outlier_check(outputs, thresholds: HealthThresholds) -> dict:
    """Fraction of trailing-window factor returns with MAD-z beyond the
    threshold, scale fit on the full history per factor."""
    fr = outputs.factor_ret.to(torch.float64)
    finite = torch.isfinite(fr)
    if not bool(finite.any()):
        return _check(None, thresholds.factor_ret_max_outlier_frac, True,
                      note="no finite factor returns — skipped")
    nan = torch.full_like(fr, float("nan"))
    x = torch.where(finite, fr, nan)
    med = _nanmedian(x)
    mad = _nanmedian((x - med).abs())
    # a degenerate (or empty) column flags nothing
    scale = torch.where(mad > 0, 1.4826 * mad,
                        torch.full_like(mad, float("inf")))
    w = int(thresholds.factor_ret_window)
    z = (fr[-w:] - med).abs() / scale
    cells = finite[-w:]
    n = int(cells.sum())
    if n == 0:
        return _check(None, thresholds.factor_ret_max_outlier_frac, True,
                      note="empty window — skipped")
    frac = int((z[cells] > thresholds.factor_ret_outlier_z).sum()) / n
    return _check(frac, thresholds.factor_ret_max_outlier_frac,
                  frac <= thresholds.factor_ret_max_outlier_frac)


def quarantine_rate_check(guard_summary: dict,
                          thresholds: HealthThresholds) -> dict:
    """Run-level quarantine rate vs threshold (off the guard verdict
    summary :func:`mfm_tpu_torch.obs.instrument.guard_summary_from_registry`
    assembles)."""
    served = guard_summary.get("served_dates", 0)
    if not served:
        return _check(None, thresholds.max_quarantine_rate, True,
                      note="no guarded dates served — skipped")
    rate = float(guard_summary.get("quarantine_rate", 0.0))
    return _check(rate, thresholds.max_quarantine_rate,
                  rate <= thresholds.max_quarantine_rate)


def evaluate_health(outputs, thresholds: HealthThresholds | None = None,
                    registry: MetricsRegistry | None = None,
                    guard_summary: dict | None = None) -> dict:
    """Run all monitors over served outputs; export gauges; return the
    manifest's ``health`` verdict.

    ``status`` is ``degraded`` if any check with a value fails, ``unknown``
    if every check had to skip (short history), else ``ok``.
    """
    th = thresholds or HealthThresholds()
    reg = registry if registry is not None else REGISTRY
    checks = {
        "bias_mean_abs_dev": rolling_bias_check(outputs, th),
        "r2_drop": r2_drift_check(outputs, th),
        "factor_ret_outlier_frac": factor_ret_outlier_check(outputs, th),
    }
    if guard_summary is not None:
        checks["quarantine_rate"] = quarantine_rate_check(guard_summary, th)
    for name, rec in checks.items():
        if rec["value"] is not None:
            reg.gauge(f"mfm_health_{name}",
                      "model-health monitor (see docs/OBSERVABILITY.md)"
                      ).set_value(rec["value"])
    measured = [rec for rec in checks.values() if rec["value"] is not None]
    if not measured:
        status = "unknown"
    elif all(rec["ok"] for rec in measured):
        status = "ok"
    else:
        status = "degraded"
    reg.gauge("mfm_model_health",
              "1 healthy / 0 degraded / -1 unknown (short history)"
              ).set_value({"ok": 1.0, "degraded": 0.0}.get(status, -1.0))
    return {"status": status, "checks": checks}
