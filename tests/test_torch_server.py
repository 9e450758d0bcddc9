"""The port's request loop (``mfm_tpu_torch/serve/server.py``) against the
JAX package's, on the CPU at float64.

One seeded stream (``tools/trafficgen.py``: plain, benchmark and
scenario-tagged queries, plus malformed lines) runs through both
packages' ``QueryServer`` under one injected clock.  The responses are
held line by line — every non-numeric field equal, every number within
rtol 1e-10 (the engines' sums run in another order) — and the dead-letter
files, span names and summary counters are held equal.  Shed, deadline
and breaker outcomes are held equal under overload and injected batch
failures.
"""

import io
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mfm_tpu.obs import instrument as ref_obs
from mfm_tpu.obs import trace as ref_trace
from mfm_tpu.serve import QueryEngine as RefEngine
from mfm_tpu.serve import QueryServer as RefServer
from mfm_tpu.serve import ServePolicy as RefPolicy
from mfm_tpu.serve import parse_request as ref_parse
from mfm_tpu.serve import req_reason_names as ref_reason_names
from mfm_tpu_torch.data.artifacts import ArtifactStaleError
from mfm_tpu_torch.obs import flightrec
from mfm_tpu_torch.obs import instrument as port_obs
from mfm_tpu_torch.obs import trace as port_trace
from mfm_tpu_torch.serve import (
    CircuitBreaker,
    QueryEngine,
    QueryServer,
    ServePolicy,
    parse_request,
    req_reason_names,
)
from mfm_tpu_torch.serve import server as port_server
from mfm_tpu_torch.utils import chaos

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import trafficgen  # noqa: E402

torch.set_num_threads(2)

K = 6
NAMES = ["country", "ind0", "ind1", "size", "mom", "vol"]
RTOL = 1e-10
MIX = (0.65, 0.20, 0.15, 0.0, 0.0)


def _cov():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((K, K)) / 2
    return (a @ a.T + 1e-3 * np.eye(K)) * 1e-4


def _bench():
    return {"idx": np.random.default_rng(1).standard_normal(K)}


class Clock:
    """Injectable monotonic clock the tests advance."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _servers(policy_kw=None, staleness=0, health="ok", clock=None,
             dead=(None, None), engines=None):
    """(port server, reference server) over the same covariance, with the
    stressed sibling ``"stress"`` (F * 1.21) as their scenario table."""
    pair = []
    for eng_cls, srv_cls, pol_cls, kw, dl in (
            (QueryEngine, QueryServer, ServePolicy, {"device": "cpu"},
             dead[0]),
            (RefEngine, RefServer, RefPolicy, {}, dead[1])):
        eng = eng_cls(_cov(), factor_names=NAMES, benchmarks=_bench(),
                      staleness=staleness, **kw)
        if engines is not None:
            eng = engines(eng)
        scen = {"stress": eng.with_cov(_cov() * 1.21, scenario_id="stress")}
        pair.append(srv_cls(eng, pol_cls(**(policy_kw or {})), health=health,
                            clock=clock or Clock(), dead_letter_path=dl,
                            scenarios=scen))
    return pair


def _req(rid, w=None, **kw):
    return json.dumps({"id": rid, "weights": [0.1] * K if w is None else w,
                       **kw})


MALFORMED = [
    '{"id": "bad-json", "weights": [0.1,',
    _req("nan-w", [0.1, float("nan"), 0.1, 0.1, 0.1, 0.1]),
    _req("short-w", [0.1, 0.2]),
    _req("unknown-factor", {"country": 1.0, "bogus": 2.0}),
    _req("unknown-bench", benchmark="nope"),
    _req("unknown-scenario", scenario="meltdown"),
    _req("dict-w", {"size": 0.7, "mom": 0.3}, benchmark="idx"),
]


def _stream(n=200, seed=7):
    lines = trafficgen.gen_requests(seed, n, K, mix=MIX, scenario="stress")
    for j, bad in enumerate(MALFORMED):
        lines.insert(17 * j + 3, bad)
    return lines


def _hold_value(got, want, what):
    if isinstance(want, float) and isinstance(got, float):
        if math.isnan(want):
            assert math.isnan(got), what
        else:
            assert got == pytest.approx(want, rel=RTOL, abs=1e-300), what
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _hold_value(g, w, f"{what}[{i}]")
    else:
        assert type(got) is type(want) and got == want, what


def _hold_responses(got, want):
    """Line by line: same keys in the same (sorted) order, non-numeric
    fields equal, numbers within RTOL."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = json.loads(g), json.loads(w)
        assert list(g) == list(w), (g, w)
        for k in w:
            _hold_value(g[k], w[k], f"{w.get('id')}.{k}")


def _counters(obs):
    s = obs.serve_summary_from_registry()
    return {"requests": dict(s["requests"]),
            "portfolios_total": s["portfolios_total"],
            "shed_total": s["shed_total"]}


def _delta(after, before):
    req = {k: v - before["requests"].get(k, 0)
           for k, v in after["requests"].items()
           if v - before["requests"].get(k, 0)}
    return {"requests": req,
            **{k: after[k] - before[k] for k in after if k != "requests"}}


def _run(server, lines, obs, **kw):
    before = _counters(obs)
    buf = io.StringIO()
    summary = server.run(iter(lines), buf, **kw)
    return buf.getvalue().splitlines(), _delta(_counters(obs), before), \
        summary


@pytest.mark.parametrize("gulp", [False, True])
def test_stream_matches_the_reference_line_by_line(tmp_path, gulp):
    dead = (str(tmp_path / "port.jsonl"), str(tmp_path / "ref.jsonl"))
    port, ref = _servers({"batch_max": 16, "queue_max": 4096}, dead=dead)
    lines = _stream()
    got, got_n, got_sum = _run(port, lines, port_obs, gulp=gulp)
    want, want_n, want_sum = _run(ref, lines, ref_obs, gulp=gulp)
    _hold_responses(got, want)
    resps = [json.loads(x) for x in got]
    outcomes = [r["outcome"] for r in resps]
    assert outcomes.count("dead_letter") == 6 and outcomes.count("ok") == 201
    tagged = sum('"scenario": "stress"' in x for x in lines)
    stressed = [r for r in resps if r["scenario_id"] == "stress"]
    assert tagged > 10 and len(stressed) == tagged
    assert all(r["outcome"] == "ok" for r in stressed)
    assert got_n == want_n
    assert got_n["requests"] == {"ok": 201, "dead_letter": 6}
    assert got_sum["breaker_state"] == want_sum["breaker_state"] == "closed"
    # the injected clock never moves: every latency is 0 in both
    assert got_sum["query_p50_latency_s"] == want_sum["query_p50_latency_s"]
    assert Path(dead[0]).read_bytes() == Path(dead[1]).read_bytes()
    recs = [json.loads(x) for x in Path(dead[0]).read_text().splitlines()]
    assert sorted(r for rec in recs for r in rec["reasons"]) == sorted(
        ["schema", "nan_weight", "short_weights", "unknown_factor",
         "unknown_benchmark", "unknown_scenario"])


@pytest.mark.parametrize("line", MALFORMED + [
    '"not an object"', json.dumps({"id": "x"}), _req("x", deadline_s=-1),
    _req("x", w=["a"] * K), _req("x", w=[[0.1] * K]),
    _req("x", w={"country": "NaNope"}),
    json.dumps({"id": "x", "weights": [0.1] * K, "__fleet__": {}}),
    _req("x", w=[0.1, 0.12, 0.09, 99.0, 0.11, 0.1]),
])
@pytest.mark.parametrize("mad_k", [0.0, 5.0])
def test_parse_request_is_the_reference(line, mad_k):
    port_eng = QueryEngine(_cov(), factor_names=NAMES, benchmarks=_bench(),
                           device="cpu")
    ref_eng = RefEngine(_cov(), factor_names=NAMES, benchmarks=_bench())
    got = parse_request(line, port_eng, ServePolicy(weight_mad_k=mad_k),
                        scenarios={"stress": port_eng})
    want = ref_parse(line, ref_eng, RefPolicy(weight_mad_k=mad_k),
                     scenarios={"stress": ref_eng})
    assert got[1:] == want[1:]
    if want[0] is None:
        assert got[0] is None
    else:
        for g, w in zip(got[0], want[0]):
            if isinstance(w, np.ndarray):
                assert np.array_equal(g, w, equal_nan=True) \
                    and g.dtype == w.dtype
            else:
                assert g == w
    assert req_reason_names(got[1]) == ref_reason_names(want[1])


@pytest.mark.parametrize("field,item", [
    ({"construct": "min_vol"}, "§A 12"),
    ({"construct": {"solver": "hedge"}}, "§A 12"),
    ({"sweep": True}, "§A 11"),
    ({"sweep": {"n": 64}}, "§A 11"),
])
def test_construct_and_sweep_requests_are_not_ported(field, item):
    eng = QueryEngine(_cov(), device="cpu")
    with pytest.raises(NotImplementedError, match=item):
        parse_request(_req("x", **field), eng, ServePolicy())
    # a false sweep flag is no sweep
    assert parse_request(_req("x", sweep=False), eng, ServePolicy())[1] == 0


def test_shed_and_deadline_outcomes_under_overload():
    clock = Clock()
    port, ref = _servers({"queue_max": 4, "batch_max": 4,
                          "default_deadline_s": 60.0}, clock=clock)
    lines = [_req(f"q{i}", deadline_s=(1.0 if i == 8 else 60.0))
             for i in range(10)]
    outs = []
    for server in (port, ref):
        out = []
        for line in lines:
            out += server.submit_line(line)
        clock.t += 2.0                    # q8 dies in the queue
        out += server.drain()
        clock.t -= 2.0
        outs.append([json.dumps(r, sort_keys=True) for r in out])
    _hold_responses(*outs)
    got = [json.loads(x) for x in outs[0]]
    assert [r["id"] for r in got if r["outcome"] == "shed"] == \
        [f"q{i}" for i in range(6)]
    assert [r["id"] for r in got if r["outcome"] == "deadline"] == ["q8"]
    assert {r["id"] for r in got if r["outcome"] == "ok"} == \
        {"q6", "q7", "q9"}


def test_gulp_storm_sheds_three_quarters():
    policy = {"queue_max": 512, "batch_max": 256, "default_deadline_s": 30.0}
    port, ref = _servers(policy)
    rng = np.random.default_rng(0)
    lines = [json.dumps({"id": f"q{i}", "weights": np.round(
        0.2 * rng.standard_normal(K), 6).tolist()}) for i in range(2048)]
    got, got_n, got_sum = _run(port, lines, port_obs, gulp=True)
    want, want_n, _ = _run(ref, lines, ref_obs, gulp=True)
    _hold_responses(got, want)
    assert got_n == want_n
    assert got_n["requests"] == {"shed": 1536, "ok": 512}
    assert got_n["shed_total"] == 1536


class Failing:
    """An engine whose next ``fail`` batches raise."""

    def __init__(self, engine, fail):
        self._engine, self.fail = engine, fail

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def query(self, *a, **kw):
        if self.fail > 0:
            self.fail -= 1
            raise RuntimeError("injected batch failure")
        return self._engine.query(*a, **kw)


def test_breaker_opens_cools_down_and_half_opens_as_the_reference():
    clock = Clock()
    engines = []
    port, ref = _servers({"breaker_failures": 2, "breaker_cooldown_s": 5.0,
                          "default_deadline_s": 60.0}, clock=clock,
                         engines=lambda e: engines.append(Failing(e, 3))
                         or engines[-1])
    outs = []
    for server in (port, ref):
        clock.t = 100.0
        seen, states = [], []

        def step(out):
            seen.extend(json.dumps(r, sort_keys=True) for r in out)
            states.append(server.breaker.state)

        for i in range(2):                # two failing batches open it
            step(server.submit_line(_req(f"f{i}")))
            step(server.drain())
        step(server.submit_line(_req("rejected")))
        clock.t += 5.0                    # cooldown over: one probe
        step(server.submit_line(_req("probe-fails")))
        step(server.drain())              # the third failure re-opens it
        clock.t += 5.0
        step(server.submit_line(_req("probe-ok")))
        step(server.drain())
        outs.append((seen, states))
    _hold_responses(outs[0][0], outs[1][0])
    assert outs[0][1] == outs[1][1] == [
        "closed", "closed", "closed", "open", "open", "half_open", "open",
        "half_open", "closed"]
    got = [json.loads(x) for x in outs[0][0]]
    assert [r["outcome"] for r in got] == [
        "error", "error", "rejected", "error", "ok"]
    assert got[2]["breaker"] == "failures" and got[2]["retry_after_s"] == 5.0


def test_breaker_cycle_on_an_injected_clock():
    clk = Clock()
    br = CircuitBreaker(failures=2, cooldown_s=5.0, clock=clk)
    br.record_failure()
    assert br.state == "closed"
    br.record_failure()
    assert br.state == "open" and br.open_reason == "failures"
    assert not br.allow() and br.retry_after() == pytest.approx(5.0)
    clk.t += 5.0
    assert br.allow() and br.state == "half_open"
    br.record_success()
    assert br.state == "closed" and br.open_reason is None
    br.force_open("health_degraded")
    clk.t += 8.0
    br.force_open("fence_audit")
    assert br.retry_after() == pytest.approx(5.0)


def test_degraded_health_and_fence_audit_open_the_breaker(tmp_path):
    port, ref = _servers(staleness=3, health="degraded")
    for server in (port, ref):
        resp, = server.submit_line(_req("r1"))
        assert resp["outcome"] == "rejected"
        assert resp["breaker"] == "health_degraded"
        assert resp["degraded"] is True and resp["staleness"] == 3

    def reload_fn():
        raise ArtifactStaleError("older than latest.json")

    server = QueryServer(QueryEngine(_cov(), device="cpu"),
                         ServePolicy(default_deadline_s=60.0), health="ok",
                         reload_fn=reload_fn)
    server.submit_line(_req("r1"))
    server.poll_reload()
    assert server.breaker.open_reason == "fence_audit"
    out, = server.drain()
    assert out["outcome"] == "rejected" and out["breaker"] == "fence_audit"
    # a healthy reload swaps the engine and its generation
    swapped = QueryEngine(_cov() * 2, device="cpu", staleness=1)
    server = QueryServer(QueryEngine(_cov(), device="cpu"), ServePolicy(),
                         health="ok", reload_fn=lambda: {
                             "engine": swapped, "health": "ok",
                             "generation": 4})
    server.poll_reload()
    assert server.engine is swapped and server.generation == 4


def test_breaker_open_dumps_the_flight_recorder(tmp_path):
    path = str(tmp_path / "flightrec.json")
    flightrec.reset_flightrec()
    flightrec.arm(path)
    try:
        clock = Clock()
        eng = Failing(QueryEngine(_cov(), device="cpu"), 1)
        server = QueryServer(eng, ServePolicy(breaker_failures=1), health="ok",
                             clock=clock)
        server.submit_line(_req("boom"))
        server.drain()
        dump = flightrec.read_flightrec(path)
    finally:
        flightrec.reset_flightrec()
    assert dump["trigger"] == "breaker_open"
    assert dump["state"]["breaker"]["open_reason"] == "failures"
    kinds = [ev["kind"] for ev in dump["events"]]
    assert kinds[-2:] == ["batch_error", "breaker_open"]
    assert dump["trace_id"] == port_server._line_trace_id(_req("boom"))
    assert "mfm_breaker_open_total" in dump["metrics"]
    (tmp_path / "torn.json").write_text('{"schema": 1')
    with pytest.raises(ValueError, match="torn"):
        flightrec.read_flightrec(str(tmp_path / "torn.json"))


def test_spans_and_trace_ids_are_the_reference():
    got_spans = []
    for server, trace in zip(_servers({"default_deadline_s": 60.0}),
                             (port_trace, ref_trace)):
        trace.reset_tracing()
        try:
            server.submit_line(_req("q1"))
            server.submit_line(_req("q2", trace_id="t" * 32))
            resps = server.drain()
            got_spans.append([(s.name, s.trace_id, sorted(s.attrs))
                              for s in trace.spans()])
        finally:
            trace.reset_tracing()
        assert [r["trace_id"] for r in resps] == [
            port_server._line_trace_id(_req("q1")), "t" * 32]
    assert got_spans[0] == got_spans[1]
    assert [name for name, _, _ in got_spans[0]] == [
        "serve.batch", "serve.request", "serve.request"]


def test_chaos_point_kills_only_at_its_point(monkeypatch):
    killed = []
    monkeypatch.setattr(chaos.os, "kill", lambda pid, sig: killed.append(sig))
    monkeypatch.delenv(chaos.KILL_ENV, raising=False)
    chaos.chaos_point("serve.after_batch", "batch0")
    monkeypatch.setenv(chaos.KILL_ENV, "serve.after_batch")
    monkeypatch.setenv(chaos.KILL_MATCH_ENV, "batch1")
    chaos.chaos_point("serve.after_batch", "batch0")
    chaos.chaos_point("flightrec.after_tmp", "batch1")
    assert killed == []
    chaos.chaos_point("serve.after_batch", "batch1")
    assert killed == [chaos.signal.SIGKILL]


@pytest.mark.parametrize("ring", ["trace", "flightrec"])
def test_rings_drop_the_oldest_and_count_the_loss(ring):
    if ring == "trace":
        mod, dropped = port_trace, port_obs.TRACE_DROPPED_TOTAL
        reset, record, snap = (port_trace.reset_tracing,
                               lambda i: port_trace.end_span(
                                   port_trace.start_span(f"s{i}")),
                               lambda: [s.name for s in port_trace.spans()])
    else:
        mod, dropped = flightrec, port_obs.FLIGHTREC_DROPPED_TOTAL
        reset, record, snap = (flightrec.reset_flightrec,
                               lambda i: flightrec.record_event(f"s{i}"),
                               lambda: [e["kind"] for e in flightrec.events()])
    cap = mod.DEFAULT_RING_CAPACITY
    reset()
    try:
        before = dropped.value()
        for i in range(cap + 5):
            record(i)
        names = snap()
    finally:
        reset()
    assert names == [f"s{i}" for i in range(5, cap + 5)]
    assert dropped.value() - before == 5
