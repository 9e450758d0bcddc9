"""The per-bucket compile contracts of the serving surfaces, on the port's
compile-contract counter (``mfm_tpu_torch/utils/contracts.py``): the
counterparts of the reference's ``tests/test_query.py:178``,
``tests/test_fleet.py:145``, ``tests/test_scenario.py:206``,
``tests/test_sweep.py:237`` and ``tests/test_grad.py:478``.

Each bucketed entry point (``QueryEngine``'s batch step,
``ScenarioEngine``'s batch kernel, ``SweepEngine``'s chunk, the construct
solve) records its padded operands' signature, so a batch that escapes
its bucket is a new event, as a retrace is in JAX.  Each test starts
from an empty signature set: the warmup must count at least one event,
and the steady traffic after it at most one per bucket — none, since the
warmup saw every bucket.  The query path launches no eigh, so without
these signatures the counter would hold whatever the bucketing did; the
last test shows it catching a batch that skips its bucket.
"""

import json

import numpy as np
import pytest
import torch

from mfm_tpu_torch.grad.engine import ShockBall
from mfm_tpu_torch.scenario import (
    ScenarioBuilder,
    ScenarioEngine,
    ScenarioSpec,
    SweepEngine,
    preset,
)
from mfm_tpu_torch.scenario.sweep import UniformSampler
from mfm_tpu_torch.serve import Coalescer, QueryEngine, QueryServer
from mfm_tpu_torch.serve import ServePolicy, bucket_for
from mfm_tpu_torch.utils import contracts

torch.set_num_threads(2)

K = 6
NAMES = [f"f{i}" for i in range(K)]


@pytest.fixture(autouse=True)
def fresh_signatures(monkeypatch):
    """An empty signature set, as in a fresh process."""
    monkeypatch.setattr(contracts, "_SEEN", set())


def _cov(seed=0, k=K):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(k, k))
    return (a @ a.T + 1e-2 * np.eye(k)) * 1e-4


def _query_engine():
    return QueryEngine(_cov(), factor_names=NAMES,
                       benchmarks={"idx": np.full(K, 1.0 / K)},
                       device="cpu")


def _bucket_events(counter) -> dict:
    """Events per signature (entry point, padded shapes, dtype, device)."""
    out = {}
    for ev in counter.events:
        assert ev.startswith(contracts.BUCKET_SIGNATURE_EVENT) \
            or ev.startswith(contracts.NEW_SIGNATURE_EVENT), ev
        key = ev.split(" ", 1)[1]
        out[key] = out.get(key, 0) + 1
    return out


def _steady(counter, buckets: int):
    """At most one event per bucket after the warmup — and none, since
    the warmup served every bucket."""
    assert all(n <= 1 for n in _bucket_events(counter).values())
    assert counter.count <= buckets
    assert counter.count == 0, counter.events


def test_query_buckets_hold_one_signature_each():
    eng = _query_engine()
    rng = np.random.default_rng(6)
    with contracts.count_compiles() as warm:
        eng.query(rng.standard_normal((6, K)))          # bucket 8
        eng.query(rng.standard_normal((20, K)))         # bucket 32
    assert warm.count == 2
    assert all(e.startswith(contracts.BUCKET_SIGNATURE_EVENT)
               for e in warm.events)
    with contracts.assert_max_compiles(2, "steady-state query buckets") as c:
        for b in (3, 8, 17, 32, 5, 30):
            res = eng.query(rng.standard_normal((b, K)))
            assert res.total_vol.shape == (b,)
    _steady(c, 2)


def _mixed_lines(n, seed):
    """Plain, benchmark, scenario-tagged and both construct solvers."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        req = {"id": f"m{i}",
               "weights": np.round(0.2 * rng.standard_normal(K), 6).tolist(),
               "deadline_s": 600.0}
        kind = i % 5
        if kind == 1:
            req["benchmark"] = "idx"
        elif kind == 2:
            req["scenario"] = "stress"
        elif kind == 3:
            req["construct"] = {"solver": "min_vol"}
        elif kind == 4:
            req["construct"] = {"solver": "risk_parity"}
        lines.append(json.dumps(req, sort_keys=True))
    return lines


def test_coalesced_fleet_traffic_holds_its_buckets():
    """With the coalescer on, a warmed (kind, bucket) shape adds no event
    across repeated same-shape flushes (the reference's S4)."""
    eng = _query_engine()
    server = QueryServer(
        eng, ServePolicy(batch_max=64, queue_max=4096,
                         default_deadline_s=600.0),
        health="ok", clock=lambda: 0.0,
        scenarios={"stress": eng.with_cov(_cov() * 1.44,
                                          scenario_id="stress")})
    co = Coalescer(server, linger_s=10.0, clock=lambda: 0.0)
    with contracts.count_compiles() as warm:
        for i, ln in enumerate(_mixed_lines(20, seed=11)):
            co.submit(ln, origin=i)
        co.flush()
    # the query batches (base and scenario engines share a shape) and one
    # per construct solver
    assert warm.count >= 3
    with contracts.assert_max_compiles(0, "coalesced steady state") as c:
        for round_ in range(3):
            for i, ln in enumerate(_mixed_lines(20, seed=20 + round_)):
                co.submit(ln, origin=i)
            co.flush()
    co.stop()
    _steady(c, warm.count)


def _mixed_specs():
    return [
        ScenarioSpec.identity(),
        ScenarioBuilder("shock-add").shock("f0", add=2e-3).build(),
        ScenarioBuilder("shock-mult").shock("f1", mult=2.0).build(),
        ScenarioBuilder("shock-both").shock("f2", add=1e-3, mult=0.5)
        .build(),
        ScenarioBuilder("regime-hot").vol_regime(3.0).build(),
        ScenarioBuilder("corr-up").correlation(0.3).build(),
        ScenarioBuilder("combo").shock("f3", mult=1.5).vol_regime(1.2)
        .correlation(-0.4).build(),
        preset("crash-2015-analog"),
        preset("corr-meltup"),
    ]


def test_scenario_buckets_hold_one_signature_each():
    engine = ScenarioEngine(_cov(), device="cpu")
    small = _mixed_specs()[:3]          # S=3 -> bucket 8
    big = _mixed_specs()                # S=9 -> bucket 32
    with contracts.count_compiles() as warm:
        engine.run(small)
        engine.run(big)
    assert sum(e.startswith(contracts.BUCKET_SIGNATURE_EVENT)
               for e in warm.events) == 2
    with contracts.assert_max_compiles(2, "steady-state scenario buckets") \
            as c:
        engine.run(big)
        engine.run(small)
        # shock values change, shapes don't: still no new signature
        engine.run([ScenarioBuilder("retune").shock("f5", mult=4.0).build(),
                    ScenarioBuilder("retune2").vol_regime(0.5).build()])
    _steady(c, 2)


def test_sweep_chunk_rungs_hold_one_signature_each():
    engine = SweepEngine(_cov(k=K), factor_names=NAMES, device="cpu")
    rng = np.random.default_rng(5)
    xs = rng.standard_normal((2, K)) / np.sqrt(K)
    ball = ShockBall(shift_max=1e-3, scale_range=0.2, vol_mult_hi=2.0,
                     corr_beta_hi=0.2)
    with contracts.count_compiles() as warm:
        engine.sweep(xs, UniformSampler(ball, K, 64, seed=0), chunk=32,
                     refine=None)
        engine.sweep(xs, UniformSampler(ball, K, 256, seed=0), chunk=128,
                     refine=None)
    assert sum(e.startswith(contracts.BUCKET_SIGNATURE_EVENT)
               and contracts.SWEEP_CHUNK in e for e in warm.events) == 2
    with contracts.assert_max_compiles(0, "sweep steady state, two chunk "
                                          "rungs") as c:
        r1 = engine.sweep(xs, UniformSampler(ball, K, 64, seed=8),
                          chunk=32, refine=None)
        r2 = engine.sweep(xs, UniformSampler(ball, K, 256, seed=8),
                          chunk=128, refine=None)
    assert r1.counts["n_ok"] == 64 and r2.counts["n_ok"] == 256
    _steady(c, 2)


def test_served_construct_bucket_holds_one_signature():
    """<= 1 event per (solver, bucket): after a warm drain, further
    construct traffic at the same bucket adds none."""
    server = QueryServer(_query_engine(),
                         ServePolicy(default_deadline_s=60.0), health="ok",
                         clock=lambda: 0.0)

    def req(rid):
        return json.dumps({"id": rid, "weights": [0.1] * K,
                           "construct": {"solver": "min_vol"}})

    with contracts.count_compiles() as warm:
        for i in range(2):                     # warm the (min_vol, 8) bucket
            server.submit_line(req(f"w{i}"))
        assert all(r["ok"] for r in server.drain())
    assert [e.split(" ", 1)[1].split("[")[0] for e in warm.events] == \
        [f"{contracts.CONSTRUCT_SOLVE}/min_vol"]
    with contracts.assert_max_compiles(1, "steady-state construct bucket 8") \
            as c:
        for i in range(5):
            server.submit_line(req(f"s{i}"))
        out = server.drain()
    assert len(out) == 5 and all(r["ok"] for r in out)
    _steady(c, 1)


def test_a_batch_that_skips_its_bucket_is_caught(monkeypatch):
    """Padding a batch to its own size makes each new size a new
    signature: the steady query loop then breaks its contract."""
    from mfm_tpu_torch.serve import query

    eng = _query_engine()
    rng = np.random.default_rng(6)
    monkeypatch.setattr(query, "bucket_for", lambda n, *a, **k: int(n))
    with contracts.count_compiles():
        eng.query(rng.standard_normal((6, K)))
    with pytest.raises(AssertionError, match="steady-state query buckets"):
        with contracts.assert_max_compiles(1, "steady-state query buckets"):
            for b in (3, 8, 17):
                eng.query(rng.standard_normal((b, K)))
    assert bucket_for(17) == 32
