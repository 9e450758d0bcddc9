"""The port's response cache and coalescer (``mfm_tpu_torch/serve/cache.py``,
``serve/coalesce.py``) against the JAX package's, on the CPU at float64.

Cache keys are held equal to the reference's for the same lines; the
warm-start index's answers equal the reference's.  Inside the port: a
hit is byte-identical to a cold answer once the ``id`` and ``trace_id``
keys are stripped, a fence bump makes the old entries unreachable, the
LRU bounds hold, and the coalescer's responses are bitwise the sequential
loop's (batch == singles), with its full, linger and eof triggers and
under a threaded hammer.  A Zipf stream through a cache-fronted
coalescer is held to the reference's within rtol 1e-10.
"""

import io
import json
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from mfm_tpu.serve import Coalescer as RefCoalescer
from mfm_tpu.serve import QueryEngine as RefEngine
from mfm_tpu.serve import QueryServer as RefServer
from mfm_tpu.serve import ResponseCache as RefCache
from mfm_tpu.serve import ServePolicy as RefPolicy
from mfm_tpu.serve import WarmStartIndex as RefWarmIndex
from mfm_tpu_torch.obs import instrument as port_obs
from mfm_tpu_torch.serve import (
    CacheFill,
    Coalescer,
    QueryEngine,
    QueryServer,
    ResponseCache,
    ServePolicy,
    WarmStartIndex,
    cacheable_response,
)

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import trafficgen  # noqa: E402

torch.set_num_threads(2)

K = 4
RTOL = 1e-10
MIX = (0.65, 0.20, 0.15, 0.0, 0.0)


def _cov(scale=1.0):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((K, K)) / 2
    return (a @ a.T + 1e-3 * np.eye(K)) * 1e-4 * scale


def _engine(scale=1.0, ref=False):
    kw = {"factor_names": ["country", "ind0", "size", "mom"],
          "benchmarks": {"idx": np.random.default_rng(1).standard_normal(K)}}
    if ref:
        return RefEngine(_cov(scale), **kw)
    return QueryEngine(_cov(scale), device="cpu", **kw)


def _server(batch_max=64, ref=False, **kw):
    pol = (RefPolicy if ref else ServePolicy)(
        batch_max=batch_max, queue_max=4096, default_deadline_s=600.0)
    eng = _engine(ref=ref)
    return (RefServer if ref else QueryServer)(
        eng, pol, health="ok",
        scenarios={"stress": eng.with_cov(_cov(1.21), scenario_id="stress")},
        **kw)


def _line(i, body_seed, **extra):
    rng = np.random.default_rng(body_seed)
    req = {"id": f"c{i}",
           "weights": np.round(0.2 * rng.standard_normal(K), 6).tolist(),
           "deadline_s": 600.0, **extra}
    return json.dumps(req, sort_keys=True)


def _strip(resp: dict) -> str:
    return json.dumps({k: v for k, v in resp.items()
                       if k not in ("id", "trace_id")}, sort_keys=True)


def _ok_resp(i):
    return {"id": f"r{i}", "ok": True, "outcome": "ok", "degraded": False,
            "trace_id": f"t{i}", "total_vol": float(i)}


# -- keys ----------------------------------------------------------------------

KEY_LINES = [
    _line(0, 7), _line(1, 7), _line(2, 8), _line(3, 7, scenario="stress"),
    _line(4, 7, scenario="other"), _line(5, 7, benchmark="idx"),
    json.dumps({"id": "a", "trace_id": "mine", "weights": [0.1] * K}),
    json.dumps({"weights": [0.1] * K, "id": 3, "b": {"z": 1, "a": [2, 1]}}),
    json.dumps({"id": "s", "weights": [0.1] * K, "sweep": True}),
    json.dumps({"id": "s", "weights": [0.1] * K, "sweep": False}),
    '{"id": "torn", "weights": [0.1,', '"not an object"', '[1, 2]',
]


@pytest.mark.parametrize("line", KEY_LINES)
@pytest.mark.parametrize("generation", [0, 5])
def test_key_for_is_the_reference(line, generation):
    hashes = {"stress": "h1"}
    got = ResponseCache(8, 1 << 20, generation=generation,
                        scenario_hashes=hashes).key_for(line)
    want = RefCache(8, 1 << 20, generation=generation,
                    scenario_hashes=hashes).key_for(line)
    assert got == want


def test_cacheable_response_predicate():
    assert cacheable_response(_ok_resp(0))
    for bad in ({**_ok_resp(0), "degraded": True},
                {**_ok_resp(0), "outcome": "shed"},
                {**_ok_resp(0), "ok": False}, None, "x"):
        assert not cacheable_response(bad)


# -- hits are cold answers -------------------------------------------------------

@pytest.mark.parametrize("extra", [{}, {"benchmark": "idx"},
                                   {"scenario": "stress"}])
def test_hit_is_byte_identical_to_a_cold_answer(extra):
    cold = _server()
    cold.submit_line(_line(0, 42, **extra))
    want, = cold.drain()
    cache = ResponseCache(64, 1 << 20)
    co = Coalescer(_server(), linger_s=10.0, cache=cache)
    first = co.submit(_line(1, 42, **extra)) + co.flush()
    again = co.submit(_line(2, 42, **extra))      # a hit: answered at once
    assert cache.stats()["hits"] == 1 and len(again) == 1
    for (_, resp), rid in ((first[0], "c1"), (again[0], "c2")):
        assert resp["id"] == rid
        assert _strip(resp) == _strip(want)
    assert again[0][1]["trace_id"] != first[0][1]["trace_id"]


def test_uncacheable_outcomes_never_stored():
    cache = ResponseCache(64, 1 << 20)
    co = Coalescer(_server(), linger_s=10.0, cache=cache)
    bad = json.dumps({"id": "x", "weights": [0.1]})       # dead letter
    assert co.submit(bad)[0][1]["outcome"] == "dead_letter"
    assert co.submit(bad)[0][1]["outcome"] == "dead_letter"
    assert len(cache) == 0 and cache.stats()["hits"] == 0


def test_absorb_unwraps_cachefill_and_populates():
    cache = ResponseCache(8, 1 << 20)
    line = _line(0, 9)
    _, token = cache.lookup(line)
    out = cache.absorb([(CacheFill("conn-1", token), _ok_resp(0)),
                        ("conn-2", {**_ok_resp(1), "outcome": "shed"})])
    assert [o for o, _ in out] == ["conn-1", "conn-2"]
    resp, _ = cache.lookup(_line(9, 9))
    assert resp["id"] == "c9" and _strip(resp) == _strip(_ok_resp(0))


# -- fences and bounds -----------------------------------------------------------

def test_generation_fence_makes_old_entries_unreachable():
    cache = ResponseCache(8, 1 << 20, generation=3)
    line = _line(0, 5)
    key, _, _ = cache.key_for(line)
    cache.put(key, _ok_resp(0))
    assert cache.lookup(line)[0] is not None
    cache.set_fence(generation=4)
    assert cache.lookup(line)[0] is None
    key4, _, _ = cache.key_for(line)
    cache.put(key4, _ok_resp(4))
    assert len(cache) == 2 and cache.generation == 4
    cache.set_fence(generation=3)
    assert _strip(cache.lookup(line)[0]) == _strip(_ok_resp(0))


def test_scenario_fence_invalidates_exactly_that_scenario():
    cache = ResponseCache(8, 1 << 20, scenario_hashes={"stress": "h1"})
    tagged, plain = _line(0, 5, scenario="stress"), _line(1, 5)
    unknown = _line(2, 5, scenario="other")
    for i, ln in enumerate((tagged, plain, unknown)):
        cache.put(cache.key_for(ln)[0], _ok_resp(i))
    cache.set_fence(scenario_hashes={"stress": "h2"})
    assert cache.lookup(tagged)[0] is None
    assert cache.lookup(plain)[0] is not None
    assert cache.lookup(unknown)[0] is not None


def test_hit_path_reload_poll_moves_the_fence():
    """An all-hits stream never drains; the throttled hit-path poll runs
    the reload, and the new generation's answers replace the old."""
    cache = ResponseCache(8, 1 << 20, generation=0)
    flips = {"armed": False}

    def reload_fn():
        if not flips["armed"]:
            return None
        flips["armed"] = False
        cache.set_fence(generation=1)
        return {"engine": _engine(scale=2.25), "health": "ok"}

    t = {"now": 0.0}
    server = QueryServer(_engine(), ServePolicy(batch_max=8,
                                                default_deadline_s=600.0),
                         health="ok", reload_fn=reload_fn)
    co = Coalescer(server, linger_s=1.0, clock=lambda: t["now"], cache=cache)
    pre = [(co.submit(_line(i, 5)) + co.flush())[0][1] for i in range(4)]
    assert cache.stats()["hits"] == 3
    flips["armed"] = True
    t["now"] = 5.0
    post = [(co.submit(_line(10 + i, 5)) + co.flush())[0][1]
            for i in range(4)]
    assert post[0]["total_vol"] == pytest.approx(1.5 * pre[0]["total_vol"],
                                                 rel=1e-12)
    assert {_strip(r) for r in post[1:]} == {_strip(post[0])}


def test_lru_entry_bound_and_recency():
    cache = ResponseCache(4, 1 << 20)
    lines = [_line(i, 100 + i) for i in range(6)]
    for i, ln in enumerate(lines):
        assert cache.put(cache.key_for(ln)[0], _ok_resp(i))
    assert len(cache) == 4 and cache.stats()["evictions"] == 2
    assert cache.lookup(lines[0])[0] is None
    assert cache.lookup(lines[1])[0] is None
    assert cache.lookup(lines[2])[0] is not None
    assert cache.lookup(lines[3])[0] is not None      # refreshed
    cache.put(cache.key_for(_line(9, 900))[0], _ok_resp(9))
    assert cache.lookup(lines[3])[0] is not None
    assert cache.lookup(lines[4])[0] is None


def test_byte_bound_evicts_and_accounts():
    one = len(_strip(_ok_resp(0)))
    cache = ResponseCache(100, max_bytes=2 * one + 1)
    for i in range(5):
        cache.put(cache.key_for(_line(i, 200 + i))[0], _ok_resp(i))
    assert len(cache) == 2 and cache.resident_bytes <= 2 * one + 1
    assert cache.stats()["evictions"] == 3
    tiny = ResponseCache(100, max_bytes=one - 1)
    tiny.put(tiny.key_for(_line(0, 0))[0], _ok_resp(0))
    assert len(tiny) == 0 and tiny.resident_bytes == 0
    with pytest.raises(ValueError):
        ResponseCache(0)


# -- the warm-start index ----------------------------------------------------------

@pytest.mark.parametrize("query", [0.01, 0.2, 10.0])
@pytest.mark.parametrize("solver,hmax", [("min_vol", 0.0), ("min_vol", 0.5),
                                         ("risk_parity", 0.0)])
def test_warm_index_nearest_is_the_reference(query, solver, hmax):
    rng = np.random.default_rng(11)
    got_idx, want_idx = (WarmStartIndex(tol=0.05, per_solver=4),
                         RefWarmIndex(tol=0.05, per_solver=4))
    base = np.full(K, 0.5)
    for j in range(6):                     # the ring keeps the newest 4
        key = base + 0.02 * rng.standard_normal(K)
        solved = rng.random(K)
        for idx in (got_idx, want_idx):
            idx.add("min_vol", 0.0, key, solved)
    got = got_idx.nearest(solver, hmax, base + query)
    want = want_idx.nearest(solver, hmax, base + query)
    assert (got is None) == (want is None)
    if want is not None:
        assert np.array_equal(got, want)
        got[:] = -1.0                      # callers get a copy
        assert np.array_equal(got_idx.nearest(solver, hmax, base + query),
                              want)
    got_idx.record_use(4, 12)
    assert got_idx.stats() == {"uses": 1, "steps_saved": 12, "tol": 0.05}


# -- the coalescer ---------------------------------------------------------------

def _mixed_lines(n, seed=3):
    return trafficgen.gen_requests(seed, n, K, mix=MIX, scenario="stress")


def _sequential_by_id(lines, batch_max=64):
    out = io.StringIO()
    _server(batch_max=batch_max).run(list(lines), out, gulp=True)
    return {json.loads(ln)["id"]: ln for ln in out.getvalue().splitlines()}


@pytest.mark.parametrize("batch_max", [4, 64])
def test_coalescer_is_bitwise_the_sequential_loop(batch_max):
    lines = _mixed_lines(22)
    ref = _sequential_by_id(lines, batch_max=batch_max)
    co = Coalescer(_server(batch_max=batch_max), linger_s=10.0)
    got = {}
    for i, ln in enumerate(lines):
        for origin, resp in co.submit(ln, origin=i):
            got[origin] = resp
    for origin, resp in co.stop():
        got[origin] = resp
    assert len(got) == len(lines)
    for i, ln in enumerate(lines):
        rid = json.loads(ln)["id"]
        assert json.dumps(got[i], sort_keys=True) == ref[rid], rid


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _flushes():
    return {k[0]: v for k, v in port_obs.COALESCE_FLUSHES_TOTAL.series()
            .items()}


def test_coalescer_full_linger_eof_triggers():
    clk = Clock()
    co = Coalescer(_server(batch_max=4), linger_s=0.5, clock=clk)
    t0 = _flushes()
    pairs = []
    for i, ln in enumerate(_mixed_lines(4, seed=5)):
        pairs += co.submit(ln, origin=i)
    assert len(pairs) == 4 and co.queued() == 0          # full
    co.submit(_mixed_lines(1, seed=6)[0], origin=99)
    assert co.poll() == [] and co.queued() == 1
    assert co.next_deadline() == pytest.approx(clk.t + 0.5)
    clk.t += 0.6
    assert [o for o, _ in co.poll()] == [99]              # linger
    co.submit(_mixed_lines(1, seed=7)[0], origin=7)
    assert [o for o, _ in co.stop()] == [7]               # eof
    t1 = _flushes()
    assert {k: t1.get(k, 0) - t0.get(k, 0) for k in ("full", "linger",
                                                     "eof")} == \
        {"full": 1, "linger": 1, "eof": 1}
    with pytest.raises(ValueError):
        Coalescer(_server(), linger_s=-1.0)
    with pytest.raises(ValueError, match="deliver"):
        Coalescer(_server()).start()


def test_coalescer_flusher_thread_hammer():
    """16 submitting threads behind the background linger flusher, with a
    short switch interval: every request is delivered exactly once, each
    bitwise the sequential loop's answer."""
    lines = _mixed_lines(320, seed=13)
    ref = _sequential_by_id(lines, batch_max=32)
    delivered, lock = {}, threading.Lock()
    done = threading.Event()

    def deliver(pairs):
        with lock:
            for origin, resp in pairs:
                assert origin not in delivered
                delivered[origin] = resp
            if len(delivered) == len(lines):
                done.set()

    co = Coalescer(_server(batch_max=32), linger_s=0.002, deliver=deliver,
                   cache=ResponseCache(64, 1 << 20))
    co.start()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def submit(j):
            for i in range(j, len(lines), 16):
                assert co.submit(lines[i], origin=i) == []

        threads = [threading.Thread(target=submit, args=(j,))
                   for j in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert done.wait(timeout=60)
    finally:
        sys.setswitchinterval(old)
        co.stop()
    for i, ln in enumerate(lines):
        resp = delivered[i]
        rid = json.loads(ln)["id"]
        want = json.loads(ref[rid])
        assert _strip(resp) == _strip(want), rid
        assert resp["id"] == rid


def _body(line):
    return json.dumps({k: v for k, v in json.loads(line).items()
                       if k not in ("id", "trace_id")}, sort_keys=True)


def test_zipf_stream_through_the_cached_coalescer_matches_the_reference():
    """The cache config's stream shape (Zipf(1.0) over 150 bodies) through
    a cache-fronted coalescer in both packages: the same hit tally, every
    delivered response within RTOL of the reference's, delivered ==
    computed + hits, and every port answer byte-identical to a cache-off
    port server's answer for its body, identity keys stripped."""
    lines = trafficgen.gen_zipf_requests(7, 600, K, alpha=1.0, distinct=150,
                                         scenario="stress", mix=MIX)
    runs = []
    for ref in (False, True):
        before = port_obs.serve_summary_from_registry()
        cache = (RefCache if ref else ResponseCache)(8192, 64 << 20)
        co = (RefCoalescer if ref else Coalescer)(
            _server(batch_max=64, ref=ref), linger_s=10.0, cache=cache)
        got = {}
        for i, ln in enumerate(lines):
            got.update(co.submit(ln, origin=i))
        got.update(co.stop())
        runs.append((got, cache.stats()))
        if not ref:
            after = port_obs.serve_summary_from_registry()
            delivered = (after["cache"]["delivered_total"]
                         - before["cache"]["delivered_total"])
            computed = after["requests_total"] - before["requests_total"]
            assert delivered == len(lines) == computed + cache.stats()["hits"]
    (got, stats), (want, want_stats) = runs
    # resident bytes are the stored JSON's length, which moves with a
    # float's last digit
    assert stats.pop("resident_bytes") == pytest.approx(
        want_stats.pop("resident_bytes"), rel=1e-3)
    assert stats == want_stats
    assert stats["hits"] + stats["misses"] == len(lines)
    assert stats["hits"] > 0.7 * len(lines)
    assert len(got) == len(want) == len(lines)
    first = {}
    for ln in lines:
        first.setdefault(_body(ln), ln)
    by_id = _sequential_by_id(first.values())
    cold = {body: _strip(json.loads(by_id[json.loads(ln)["id"]]))
            for body, ln in first.items()}
    for i, ln in enumerate(lines):
        g, w = got[i], want[i]
        assert list(g) == list(w)
        for k in w:
            if isinstance(w[k], float):
                assert g[k] == pytest.approx(w[k], rel=RTOL), k
            elif isinstance(w[k], list):
                np.testing.assert_allclose(g[k], w[k], rtol=RTOL)
            else:
                assert g[k] == w[k], k
        assert _strip(g) == cold[_body(ln)]
