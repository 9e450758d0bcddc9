"""The port's model-health monitors (``obs/health.py``), the stage and
update recorders of ``obs/instrument.py``, ``utils/obs.py`` and the
append's telemetry, against the JAX package's, on the CPU at float64.

- ``evaluate_health`` and each of its checks give the reference's verdict
  on the same outputs and thresholds (values to the 6 decimals both
  round to), including degenerate outputs: all-NaN factor returns, a
  history too short for any window, and a guard summary that quarantined
  every date;
- the same sequence of ``record_*`` calls moves the new series of both
  packages' registries alike;
- a guarded append that quarantines one date counts one quarantined date
  in ``guard_summary_from_registry()`` in both packages;
- ``determinism_check`` sees a one-ulp difference.
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from mfm_tpu import pipeline as ref_pipeline
from mfm_tpu.config import PipelineConfig as RefPipelineConfig
from mfm_tpu.config import QuarantinePolicy as RefPolicy
from mfm_tpu.config import RiskModelConfig as RefConfig
from mfm_tpu.models.risk_model import RiskModelOutputs as RefOutputs
from mfm_tpu.obs import health as ref_health
from mfm_tpu.obs import instrument as ref_instrument
from mfm_tpu.obs.metrics import REGISTRY as REF_REGISTRY
from mfm_tpu.obs.metrics import MetricsRegistry as RefRegistry
from mfm_tpu.serve.guard import GuardReport as RefReport
from mfm_tpu.utils import obs as ref_obs
from mfm_tpu_torch import PipelineConfig, RiskModelConfig
from mfm_tpu_torch.config import QuarantinePolicy
from mfm_tpu_torch.obs import health, instrument
from mfm_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry
from mfm_tpu_torch.pipeline import (
    append_risk_pipeline,
    run_risk_pipeline,
    save_pipeline_state,
)
from mfm_tpu_torch.serve.guard import GuardReport
from mfm_tpu_torch.utils import obs

torch.set_num_threads(2)

T, N, P, Q = 150, 40, 4, 3
#: the series the recorders of this module write
NEW_SERIES = ("mfm_quarantine_count", "mfm_update_latency_seconds",
              "mfm_stage_seconds", "mfm_quarantined_dates_total",
              "mfm_served_dates_total", "mfm_served_cov_staleness",
              "mfm_guard_reason_total")


def _table(seed=3):
    from mfm_tpu_torch.data.synthetic import synthetic_barra_table

    table, _ = synthetic_barra_table(T=T, N=N, P=P, Q=Q, seed=seed)
    return table


@pytest.fixture(scope="module")
def outputs():
    """A float64 run's outputs, as the port's tensors and the reference's
    ``RiskModelOutputs`` of the same numbers."""
    res = run_risk_pipeline(_table(), config=PipelineConfig(
        risk=RiskModelConfig(eigen_n_sims=8), dtype="float64"),
        device="cpu")
    ref = RefOutputs(**{f: jnp.asarray(getattr(res.outputs, f).numpy())
                        for f in RefOutputs._fields})
    return res.outputs, ref


def _degenerate(port, kind):
    if kind == "nan_factor_ret":
        return port._replace(factor_ret=torch.full_like(port.factor_ret,
                                                        float("nan")))
    if kind == "short":
        return type(port)(*(x[:30] for x in port))
    if kind == "no_eigen":
        return port._replace(eigen_valid=torch.zeros_like(port.eigen_valid))
    return port


def _ref(port):
    return RefOutputs(**{f: jnp.asarray(getattr(port, f).numpy())
                         for f in RefOutputs._fields})


THRESHOLDS = {
    "default": {},
    "tight": {"bias_max_mean_abs_dev": 0.05, "r2_max_drop": -0.5,
              "factor_ret_outlier_z": 1.0, "max_quarantine_rate": 0.0},
    "short_windows": {"bias_window": 50, "bias_min_dates": 10,
                      "r2_window": 20, "factor_ret_window": 10},
}
GUARDS = {
    "none": None,
    "clean": {"served_dates": 40, "quarantined_dates": 0,
              "quarantine_rate": 0.0},
    "all_quarantined": {"served_dates": 40, "quarantined_dates": 40,
                        "quarantine_rate": 1.0},
    "never_served": {"served_dates": 0, "quarantined_dates": 0,
                     "quarantine_rate": 0.0},
}


def _same_verdict(got, want):
    assert got["status"] == want["status"]
    assert list(got["checks"]) == list(want["checks"])
    for name, w in want["checks"].items():
        g = got["checks"][name]
        assert sorted(g) == sorted(w), name
        assert (g["ok"], g["threshold"], g.get("note")) == \
            (w["ok"], w["threshold"], w.get("note")), name
        if w["value"] is None:
            assert g["value"] is None, name
        else:
            # both round to 6 decimals; the bias stat's eighs are the
            # Jacobi's against LAPACK's
            assert abs(g["value"] - w["value"]) <= 2e-6, (name, g, w)


@pytest.mark.parametrize("kind", ["full", "nan_factor_ret", "short",
                                  "no_eigen"])
@pytest.mark.parametrize("th", list(THRESHOLDS))
@pytest.mark.parametrize("guard", list(GUARDS))
def test_evaluate_health_is_the_reference(outputs, kind, th, guard):
    port = _degenerate(outputs[0], kind)
    got = health.evaluate_health(
        port, health.HealthThresholds(**THRESHOLDS[th]),
        registry=MetricsRegistry(), guard_summary=GUARDS[guard])
    want = ref_health.evaluate_health(
        _ref(port), ref_health.HealthThresholds(**THRESHOLDS[th]),
        registry=RefRegistry(), guard_summary=GUARDS[guard])
    _same_verdict(got, want)


@pytest.mark.parametrize("check", ["rolling_bias_check", "r2_drift_check",
                                   "factor_ret_outlier_check"])
def test_each_check_is_the_reference(outputs, check):
    th = health.HealthThresholds(**THRESHOLDS["short_windows"])
    rth = ref_health.HealthThresholds(**THRESHOLDS["short_windows"])
    got = getattr(health, check)(outputs[0], th)
    want = getattr(ref_health, check)(outputs[1], rth)
    _same_verdict({"status": "", "checks": {"c": got}},
                  {"status": "", "checks": {"c": want}})
    assert got["value"] is not None


def test_health_gauges_are_the_reference(outputs):
    reg, rreg = MetricsRegistry(), RefRegistry()
    health.evaluate_health(outputs[0], registry=reg,
                           guard_summary=GUARDS["clean"])
    ref_health.evaluate_health(outputs[1], registry=rreg,
                               guard_summary=GUARDS["clean"])
    got, want = reg.snapshot(), rreg.snapshot()
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name]["help"] == want[name]["help"]
        np.testing.assert_allclose(
            [s["value"] for s in got[name]["series"]],
            [s["value"] for s in want[name]["series"]], atol=2e-6)


def test_nanmedian_is_numpys():
    x = np.random.default_rng(0).standard_normal((9, 6))
    x[[1, 3], 0] = np.nan
    x[:, 2] = np.nan
    x[:4, 3] = np.nan
    x[:8, 4] = np.nan
    with np.errstate(all="ignore"), pytest.warns(RuntimeWarning):
        want = np.nanmedian(x, axis=0)
    np.testing.assert_array_equal(health._nanmedian(torch.from_numpy(x)),
                                  want)


def _series(snapshot, names=NEW_SERIES):
    """name -> [(labels, value or (count, sum))] of the new series."""
    out = {}
    for name in names:
        m = snapshot.get(name)
        out[name] = [] if m is None else [
            (s["labels"], (s["count"], s["sum"]) if "count" in s
             else s["value"]) for s in m["series"]]
    return out


def _delta(before, after):
    """What a run of recorders did: the gauges it set, the counters' and
    histograms' increments (the registry is process-wide, and other test
    files in this worker record into it too)."""
    out = {}
    for name, series in after.items():
        prev = dict((tuple(sorted(lb.items())), v) for lb, v in before[name])
        rows = []
        for lb, v in series:
            p = prev.get(tuple(sorted(lb.items())))
            if name in ("mfm_quarantine_count", "mfm_served_cov_staleness",
                        "mfm_stage_seconds"):
                # gauges: the last value of each series the calls set
                if lb.get("stage", "risk_full") in ("risk_full",
                                                    "update_total"):
                    rows.append((lb, v))
            elif isinstance(v, tuple):
                c0, s0 = p if p else (0, 0.0)
                if v[0] != c0:
                    rows.append((lb, (v[0] - c0, round(v[1] - s0, 9))))
            elif v != (p or 0):
                rows.append((lb, v - (p or 0)))
        out[name] = rows
    return out


def _report(mod, q, reasons, staleness, K=3):
    T_ = len(q)
    cov = np.zeros((T_, K, K))
    if mod is instrument:
        return GuardReport(torch.tensor(q), torch.tensor(reasons,
                                                         dtype=torch.int32),
                           torch.tensor(staleness, dtype=torch.int32),
                           torch.from_numpy(cov))
    return RefReport(jnp.asarray(q), jnp.asarray(reasons, jnp.int32),
                     jnp.asarray(staleness, jnp.int32), jnp.asarray(cov))


def test_recorders_move_the_registry_as_the_reference():
    calls = [
        ("record_guard_report", ([False, True, True, False], [0, 3, 16, 0],
                                 [0, 1, 2, 0])),
        ("record_guard_report", ([False], [0], [0])),
        ("record_update_latency", (0.0125,)),
        ("record_update_latency", (3.5,)),
        ("record_stage_seconds", ("risk_full", 1.25)),
        ("record_stage_seconds", ("update_total", 0.5)),
        ("record_stage_seconds", ("risk_full", 2.0)),
    ]
    deltas = {}
    for mod, reg in ((instrument, REGISTRY), (ref_instrument, REF_REGISTRY)):
        before = _series(reg.snapshot())
        for fn, args in calls:
            if fn == "record_guard_report":
                args = (_report(mod, *args),)
            getattr(mod, fn)(*args)
        with mod.time_stage("timed"):
            pass
        deltas[mod] = _delta(before, _series(reg.snapshot()))
    got, want = deltas[instrument], deltas[ref_instrument]
    for name in NEW_SERIES:
        assert got[name] == want[name], name
    assert got["mfm_stage_seconds"] == [({"stage": "risk_full"}, 2.0),
                                        ({"stage": "update_total"}, 0.5)]
    snap, rsnap = REGISTRY.snapshot(), REF_REGISTRY.snapshot()
    timed = [s["value"] for s in snap["mfm_stage_seconds"]["series"]
             if s["labels"]["stage"] == "timed"]
    assert len(timed) == 1 and 0 <= timed[0] < 1
    for name in NEW_SERIES:
        assert snap[name]["help"] == rsnap[name]["help"], name
        assert snap[name]["type"] == rsnap[name]["type"], name
        assert snap[name]["labelnames"] == rsnap[name]["labelnames"], name


def _drop_rows_of_date(table, date, frac, seed=0):
    """``table`` without ``frac`` of the rows of ``date``, each industry's
    first member kept."""
    names, industry = table["stocknames"], table["industry"]
    _, first_row = np.unique(industry, return_index=True)
    keep_stock = np.isin(names, names[first_row])
    on_date = np.nonzero(table["date"] == date)[0]
    droppable = on_date[~keep_stock[on_date]]
    drop = np.random.default_rng(seed).choice(
        droppable, int(round(frac * len(on_date))), replace=False)
    keep = np.ones(len(names), bool)
    keep[drop] = False
    return {k: v[keep] for k, v in table.items()}


def test_guarded_append_counts_its_quarantined_date_in_both_packages(
        tmp_path):
    """The append's telemetry: a guarded append whose one date lost 60% of
    its rows adds one quarantined date (and every appended date served)
    to ``guard_summary_from_registry()``, in the port as in the
    reference."""
    table = _table(seed=5)
    dates = np.unique(table["date"])
    T0 = 140
    head = {k: v[table["date"] < dates[T0]] for k, v in table.items()}
    poisoned = _drop_rows_of_date(table, dates[T0 + 4], 0.6)
    deltas = {}
    for who in ("port", "ref"):
        ck = tmp_path / who / "state.npz"
        summary = (instrument if who == "port"
                   else ref_instrument).guard_summary_from_registry
        if who == "port":
            cfg = PipelineConfig(risk=RiskModelConfig(
                eigen_n_sims=8, quarantine=QuarantinePolicy(enabled=True)),
                dtype="float64")
            save_pipeline_state(str(ck), run_risk_pipeline(
                head, config=cfg, with_state=True, device="cpu"))
            before = summary()
            res = append_risk_pipeline(str(ck), poisoned, config=cfg,
                                       device="cpu")
            q = res.report.quarantined.numpy()
        else:
            cfg = RefPipelineConfig(risk=RefConfig(
                eigen_n_sims=8, quarantine=RefPolicy(enabled=True)),
                dtype="float64")
            ref_pipeline.save_pipeline_state(str(ck), ref_pipeline
                                             .run_risk_pipeline(
                pd.DataFrame(head), config=cfg, with_state=True))
            before = summary()
            res = ref_pipeline.append_risk_pipeline(
                str(ck), pd.DataFrame(poisoned), config=cfg)
            q = np.asarray(res.report.quarantined)
        after = summary()
        assert np.nonzero(q)[0].tolist() == [4], who
        deltas[who] = {
            "served": after["served_dates"] - before["served_dates"],
            "quarantined": (after["quarantined_dates"]
                            - before["quarantined_dates"]),
            "universe_collapse": (
                after["reasons"].get("universe_collapse", 0)
                - before["reasons"].get("universe_collapse", 0)),
        }
    assert deltas["port"] == deltas["ref"] == {
        "served": T - T0, "quarantined": 1, "universe_collapse": 1}


def test_determinism_check_sees_one_ulp():
    x = torch.tensor([1.0, float("nan"), -2.5], dtype=torch.float64)
    outs = iter([(x.clone(), {"a": x.clone()}),
                 (x.clone(), {"a": torch.nextafter(x, x + 1)})])
    assert not obs.determinism_check(lambda: next(outs))
    assert obs.determinism_check(lambda: (x.clone(), [x.clone()]))
    np.testing.assert_equal(ref_obs.determinism_check(
        lambda: (x.numpy(),)), obs.determinism_check(lambda: (x,)))
    y = iter([x, torch.nextafter(x, x + 1)])
    assert obs.determinism_check(lambda: next(y), atol=1e-12)


def test_force_is_the_checksum_of_the_finite_entries():
    x = torch.tensor([1.0, float("nan"), 2.5, float("inf")])
    tree = {"a": (x, torch.tensor([True])), "b": [torch.tensor([0.5])]}
    assert obs.force(tree) == 4.0
    assert obs.force({"i": torch.tensor([1, 2])}) == 0.0
