"""The port's SLO burn-rate engine (``mfm_tpu_torch/obs/slo.py``): the
counterpart of ``tests/test_slo.py``, test for test — spec validation,
the two-window burn discipline over a fake clock with injected registry
readings, the fast/slow state ranking, sample pruning, and the process
engine slot ``/healthz`` and the manifests read through — and the port
held against the JAX package: ``SloEngine.evaluate`` over the same
registry history gives equal dicts, injected or live.

Every scenario drives a :class:`SloEngine` subclass whose registry reader
is a mutable feed — the burn math is deterministic arithmetic over
cumulative counters, so no sleeping and no live traffic — except the
live-registry case, which records the same traffic into both packages'
registries."""

import pytest

from mfm_tpu.obs import instrument as ref_obs
from mfm_tpu.obs import slo as ref_slo
from mfm_tpu_torch.obs import instrument as port_obs
from mfm_tpu_torch.obs import slo as port_slo
from mfm_tpu_torch.obs.slo import (
    DEFAULT_SLOS,
    FAST_BURN_THRESHOLD,
    SLOW_BURN_THRESHOLD,
    SloEngine,
    SloSpec,
    install,
    installed_summary,
    reset_slo,
)


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class _FedMixin:
    """An SloEngine reading an injected feed instead of the live registry."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.feed = {"total": 0, "ok": 0,
                     "lat_cum": [0, 0, 0],
                     "lat_bounds": [0.1, 0.5, float("inf")],
                     "staleness": 0.0}

    def _read_registry(self):
        return {k: (list(v) if isinstance(v, list) else v)
                for k, v in self.feed.items()}

    def traffic(self, n, *, n_ok=None, n_fast=None):
        """Add ``n`` requests: ``n_ok`` answered ok (default all),
        ``n_fast`` within the 0.5 s latency objective (default all)."""
        n_ok = n if n_ok is None else n_ok
        n_fast = n if n_fast is None else n_fast
        f = self.feed
        f["total"] += n
        f["ok"] += n_ok
        f["lat_cum"] = [f["lat_cum"][0] + n_fast,
                        f["lat_cum"][1] + n_fast,
                        f["lat_cum"][2] + n]


class _FedEngine(_FedMixin, SloEngine):
    pass


class _RefFedEngine(_FedMixin, ref_slo.SloEngine):
    pass


def _by_name(summary):
    return {s["name"]: s for s in summary["slos"]}


def _engine():
    clk = _Clock()
    return _FedEngine(clock=clk), clk


# -- spec validation ----------------------------------------------------------

def test_spec_validation_rejects_bad_kind_and_objective():
    with pytest.raises(ValueError, match="unknown SLO kind"):
        SloSpec("x", "latency_p50", 0.5)
    with pytest.raises(ValueError, match="availability objective"):
        SloSpec("x", "availability", 1.0)
    with pytest.raises(ValueError, match="must be >= 0"):
        SloSpec("x", "p99_latency", -1.0)


def test_budget_is_complement_for_availability_tail_for_the_rest():
    assert SloSpec("a", "availability", 0.99).budget() == pytest.approx(0.01)
    assert SloSpec("l", "p99_latency", 0.5).budget() == pytest.approx(0.01)
    assert SloSpec("s", "staleness", 5.0).budget() == pytest.approx(0.01)


def test_engine_rejects_empty_specs_and_inverted_windows():
    with pytest.raises(ValueError, match="at least one"):
        SloEngine(())
    with pytest.raises(ValueError, match="fast <= slow"):
        SloEngine(fast_window_s=7200.0, slow_window_s=3600.0)


# -- burn states --------------------------------------------------------------

def test_no_traffic_is_ok_everywhere():
    eng, _clk = _engine()
    out = eng.evaluate()
    assert out["worst_state"] == "ok"
    assert all(s["state"] == "ok" and s["burn_fast"] == 0.0
               for s in out["slos"])
    assert out["fast_burn_threshold"] == FAST_BURN_THRESHOLD
    assert out["slow_burn_threshold"] == SLOW_BURN_THRESHOLD


def test_clean_traffic_burns_nothing():
    eng, clk = _engine()
    eng.evaluate()
    clk.t = 60.0
    eng.traffic(100)
    out = eng.evaluate()
    assert out["worst_state"] == "ok"
    assert _by_name(out)["availability"]["burn_fast"] == 0.0


def test_error_storm_is_a_fast_burn_page():
    eng, clk = _engine()
    eng.evaluate()                         # baseline at t=0
    clk.t = 60.0
    eng.traffic(100, n_ok=50)              # 50% errors vs a 1% budget
    out = eng.evaluate()
    avail = _by_name(out)["availability"]
    assert avail["burn_fast"] == pytest.approx(50.0)
    assert avail["state"] == "fast_burn"
    assert out["worst_state"] == "fast_burn"


def test_old_errors_decay_to_slow_burn_ticket():
    """10% errors an hour's-width ago, clean since: the fast window has
    recovered (no page) but the slow window still burns >= 3x (ticket)."""
    eng, clk = _engine()
    eng.evaluate()                         # t=0 baseline
    clk.t = 100.0
    eng.traffic(100, n_ok=90)              # the bad stretch
    eng.sample()
    clk.t = 450.0                          # fast window (300 s) has rolled
    eng.traffic(100)                       # clean recovery traffic
    out = eng.evaluate()
    avail = _by_name(out)["availability"]
    assert avail["burn_fast"] == 0.0
    assert avail["burn_slow"] == pytest.approx(5.0)
    assert avail["state"] == "slow_burn"
    assert out["worst_state"] == "slow_burn"


def test_latency_tail_burn_reads_the_cumulative_buckets():
    eng, clk = _engine()
    eng.evaluate()
    clk.t = 60.0
    eng.traffic(100, n_fast=80)            # 20% over the 500 ms objective
    out = eng.evaluate()
    lat = _by_name(out)["p99-latency"]
    assert lat["burn_fast"] == pytest.approx(20.0)
    assert lat["state"] == "fast_burn"


def test_staleness_burns_bad_time_fraction():
    eng, clk = _engine()
    eng.evaluate()                         # sample 0: fresh
    clk.t = 60.0
    eng.feed["staleness"] = 10.0           # over the 5-date objective
    out = eng.evaluate()                   # sample 1: stale
    stale = _by_name(out)["staleness"]
    # 1 of 2 window samples over the objective -> 50% bad time / 1% budget
    assert stale["burn_fast"] == pytest.approx(50.0)
    assert stale["state"] == "fast_burn"


def test_sample_pruning_keeps_one_full_width_baseline():
    eng, clk = _engine()
    for i in range(10):
        clk.t = i * 1000.0
        eng.sample()
    # slow window is 3600 s: everything older than one window is pruned
    # EXCEPT one sample, so a full-width baseline always exists
    with eng._lock:
        ts = [t for t, _ in eng._samples]
    assert ts[0] <= clk.t - eng.slow_window_s
    assert all(clk.t - t < eng.slow_window_s for t in ts[1:])


# -- the process engine slot --------------------------------------------------

def test_install_slot_feeds_summary_and_disarms():
    try:
        install(SloEngine())
        out = installed_summary()
        assert out is not None and out["schema"] == 1
        assert {s["name"] for s in out["slos"]} == \
            {s.name for s in DEFAULT_SLOS}
    finally:
        reset_slo()
    assert installed_summary() is None


def test_states_mirror_onto_the_registry_gauges():
    from mfm_tpu_torch.obs.instrument import SLO_BURN_RATE, SLO_STATE
    eng, clk = _engine()
    eng.evaluate()
    clk.t = 60.0
    eng.traffic(100, n_ok=50)
    eng.evaluate()
    burn = {k: v for k, v in SLO_BURN_RATE.series().items()}
    assert burn[("availability", "fast")] == pytest.approx(50.0)
    states = {k[0]: v for k, v in SLO_STATE.series().items()}
    assert states["availability"] == 2.0   # fast_burn ranks 2


# -- the port against the reference ---------------------------------------------

def _script(eng, clk, kind):
    """One registry history, as (clock, action) steps; returns every
    evaluation."""
    outs = [eng.evaluate()]
    if kind == "storm":
        clk.t = 60.0
        eng.traffic(100, n_ok=50, n_fast=70)
        outs.append(eng.evaluate())
    elif kind == "decay":
        clk.t = 100.0
        eng.traffic(100, n_ok=90)
        eng.sample()
        clk.t = 450.0
        eng.traffic(100)
        outs.append(eng.evaluate())
    elif kind == "stale":
        for i in range(6):
            clk.t = 60.0 * (i + 1)
            eng.feed["staleness"] = 10.0 if i % 2 else 0.0
            eng.traffic(10 * i, n_fast=9 * i)
            outs.append(eng.evaluate())
    else:  # long: past the slow window, pruning on the way
        for i in range(12):
            clk.t = 700.0 * (i + 1)
            eng.traffic(50, n_ok=50 - (i % 3), n_fast=48)
            outs.append(eng.evaluate())
    return outs


@pytest.mark.parametrize("kind", ["storm", "decay", "stale", "long"])
def test_evaluate_is_the_reference_over_the_same_history(kind):
    port_clk, ref_clk = _Clock(), _Clock()
    got = _script(_FedEngine(clock=port_clk), port_clk, kind)
    want = _script(_RefFedEngine(clock=ref_clk), ref_clk, kind)
    assert got == want


def test_evaluate_is_the_reference_over_the_live_registries():
    """The same outcomes, latencies and staleness recorded into both
    packages' process registries: the installed engines' evaluations are
    equal dicts at every scrape."""
    port_clk, ref_clk = _Clock(), _Clock()
    port_eng = port_slo.SloEngine(clock=port_clk)
    ref_eng = ref_slo.SloEngine(clock=ref_clk)
    evals = []

    def scrape():
        evals.append((port_eng.evaluate(), ref_eng.evaluate()))

    for obs in (port_obs, ref_obs):
        obs.SERVED_COV_STALENESS.set_value(0)
    scrape()
    for step, (n_ok, n_err, lat, stale) in enumerate([
            (40, 0, 0.05, 0), (30, 5, 0.8, 2), (10, 10, 0.3, 9),
            (50, 0, 0.01, 9), (20, 1, 2.0, 0)]):
        port_clk.t = ref_clk.t = 90.0 * (step + 1)
        for obs in (port_obs, ref_obs):
            obs.record_query_outcome("ok", n_ok)
            obs.record_query_outcome("error", n_err)
            for _ in range(n_ok):
                obs.record_query_latency(lat)
            obs.SERVED_COV_STALENESS.set_value(stale)
        scrape()
    for obs in (port_obs, ref_obs):
        obs.SERVED_COV_STALENESS.set_value(0)
    for got, want in evals:
        assert got == want
    assert evals[-1][0]["worst_state"] == "fast_burn"


def test_summary_carries_the_installed_slo_block():
    """``serve_summary_from_registry`` grows the ``slo`` block exactly when
    an engine is installed, in both packages."""
    for obs, slo in ((port_obs, port_slo), (ref_obs, ref_slo)):
        slo.reset_slo()
        assert "slo" not in obs.serve_summary_from_registry()
        slo.install(slo.SloEngine())
        try:
            block = obs.serve_summary_from_registry()["slo"]
            assert block["schema"] == 1
            assert [s["name"] for s in block["slos"]] == \
                [s.name for s in slo.DEFAULT_SLOS]
        finally:
            slo.reset_slo()
