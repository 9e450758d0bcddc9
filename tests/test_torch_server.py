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
    _req("x", sweep=True), _req("x", sweep={"n": 128, "chunk": 64,
                                            "top_k": 4}),
    _req("x", sweep={"sampler": "sobol", "seed": 7, "bins": 8}),
    _req("x", sweep={"sampler": "bogus"}), _req("x", sweep={"n": 10 ** 9}),
    _req("x", sweep={"n": 0}), _req("x", sweep={"chunk": -1}),
    _req("x", sweep={"top_k": 1.5}), _req("x", sweep={"bins": 4}),
    _req("x", sweep="not-a-spec"), _req("x", sweep=1),
    _req("x", construct="min_vol"),
    _req("x", construct={"solver": "risk_parity"}),
    _req("x", construct={"solver": "hedge", "hedge_factors": ["size", "mom"],
                         "hmax": 0.5}),
    _req("x", construct="sharpe_max"),
    _req("x", construct={"solver": "hedge", "hedge_factors": ["bogus"]}),
    _req("x", construct={"solver": "hedge", "hmax": "x"}),
    _req("x", construct=["min_vol"]),
    _req("x", construct="min_vol", sweep=True),
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
            if isinstance(w, dict):     # the construct spec
                assert sorted(g) == sorted(w)
                g, w = ([d[k] for k in sorted(d)] for d in (g, w))
            else:
                g, w = [g], [w]
            for gi, wi in zip(g, w):
                if isinstance(wi, np.ndarray):
                    assert np.array_equal(gi, wi, equal_nan=True) \
                        and gi.dtype == wi.dtype
                else:
                    assert gi == wi
    assert req_reason_names(got[1]) == ref_reason_names(want[1])


def test_false_sweep_flag_is_no_sweep():
    eng = QueryEngine(_cov(), device="cpu")
    fields, mask, _ = parse_request(_req("x", sweep=False), eng,
                                    ServePolicy())
    assert mask == 0 and fields[6] is None and fields[7] is None


#: config 9's mix (bench.py:1336): a fifth of the lines construct solves
CONSTRUCT_MIX = (0.45, 0.20, 0.15, 0.20, 0.0)


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("gulp", [False, True])
def test_construct_stream_matches_the_reference_line_by_line(gulp, warm):
    """Config 9's traffic mix, construct lines included (min-vol and
    risk parity), through both packages' servers: every response within
    RTOL, keys and outcomes equal.  With a warm-start index on a repeating
    (Zipf) stream the seeded solves carry the reference's ``warm_start``
    stanza and both indexes end with the same stats."""
    from mfm_tpu.serve.cache import WarmStartIndex as RefWarm
    from mfm_tpu_torch.serve.cache import WarmStartIndex

    if warm:
        lines = trafficgen.gen_zipf_requests(3, 160, K, distinct=30,
                                             mix=CONSTRUCT_MIX,
                                             scenario="stress")
    else:
        lines = trafficgen.gen_requests(3, 160, K, mix=CONSTRUCT_MIX,
                                        scenario="stress")
    assert sum('"construct"' in x for x in lines) >= 20
    port, ref = _servers({"batch_max": 16, "queue_max": 4096})
    if warm:
        port.warm_index, ref.warm_index = WarmStartIndex(), RefWarm()
    got, got_n, _ = _run(port, lines, port_obs, gulp=gulp)
    want, want_n, _ = _run(ref, lines, ref_obs, gulp=gulp)
    # a construct answer's diag (the KKT residual, the contributions'
    # spread) is a residual near rounding: held to 1e-12 absolute
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = json.loads(g), json.loads(w)
        if "diag" in w:
            assert g["diag"] == pytest.approx(w["diag"], rel=1e-6,
                                              abs=1e-12), w["id"]
            g["diag"] = w["diag"]
            got[i] = json.dumps(g)
    _hold_responses(got, want)
    assert got_n == want_n
    resps = [json.loads(x) for x in got]
    kinds = {r.get("solver") for r in resps if r.get("kind") == "construct"}
    assert kinds == {"min_vol", "risk_parity"}
    seeded = [r for r in resps if "warm_start" in r]
    if warm:
        assert seeded and port.warm_index.stats() == ref.warm_index.stats()
    else:
        assert not seeded


SWEEP_LINES = [
    _req("s0", sweep={"n": 96, "chunk": 32, "top_k": 4, "seed": 3}),
    _req("q0"),
    _req("s1", w=[0.3, 0.1, 0.0, -0.2, 0.2, 0.1],
         sweep={"n": 96, "chunk": 32, "top_k": 4, "seed": 3}),
    _req("s2", w=[0.3, 0.1, 0.0, -0.2, 0.2, 0.1],
         sweep={"sampler": "grid", "n": 50, "chunk": 16, "top_k": 3}),
    _req("s3", sweep={"sampler": "sobol", "n": 40, "chunk": 16, "bins": 16}),
    _req("s4", sweep={"n": 64, "chunk": 64, "seed": 1}, scenario="stress"),
    _req("bad0", sweep={"sampler": "nope"}),
    _req("bad1", sweep={"n": 0}),
    _req("bad2", sweep={"top_k": 99}, scenario="meltdown"),
]


def _hold_tree(got, want, what):
    """A JSON tree: the same keys in the same order, numbers within RTOL,
    everything else equal."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), what
        for k in want:
            _hold_tree(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _hold_tree(g, w, f"{what}[{i}]")
    else:
        _hold_value(got, want, what)


def _sweep_lanes(rid):
    """Request ``rid``'s sweep lanes through the port's materializing
    engine: their vols, and the count of lanes whose stressed minimum
    eigenvalue lies within 1e3·eps·lambda_max of zero, where the PSD
    gate's decision may differ between the port's Jacobi and LAPACK."""
    from mfm_tpu_torch.grad import ShockBall
    from mfm_tpu_torch.scenario import (GridSampler, ScenarioEngine,
                                        SobolSampler, UniformSampler,
                                        theta_to_spec)
    from mfm_tpu_torch.scenario.kernel import book_vols

    obj = json.loads(next(x for x in SWEEP_LINES if f'"{rid}"' in x))
    eng = QueryEngine(_cov(), factor_names=NAMES, device="cpu")
    spec, _, _ = port_server._parse_sweep(obj["sweep"], eng)
    cov = _cov() * (1.21 if obj.get("scenario") == "stress" else 1.0)
    if spec["sampler"] == "grid":
        side = max(2, math.isqrt(spec["n"]))
        sampler = GridSampler(ShockBall(), K, n_vol=side, n_corr=side)
    else:
        cls = SobolSampler if spec["sampler"] == "sobol" else UniformSampler
        sampler = cls(ShockBall(), K, spec["n"], seed=spec["seed"])
    ths = np.concatenate([t for t, _, _ in sampler.blocks(spec["chunk"])])
    res = ScenarioEngine(cov, factor_names=NAMES, device="cpu").run(
        [theta_to_spec(t, NAMES, f"l{i}") for i, t in enumerate(ths)])
    covs = np.stack([r.cov for r in res])
    vols = book_vols(torch.from_numpy(covs), torch.tensor(
        [obj["weights"]], dtype=torch.float64)).numpy()[0]
    lam_max = np.linalg.eigvalsh(covs)[:, -1]
    in_band = sum(abs(r.min_eig_stressed) <= 1e3 * np.finfo(float).eps * lm
                  for r, lm in zip(res, lam_max))
    return vols, int(in_band)


@pytest.mark.parametrize("gulp", [False, True])
def test_sweep_requests_are_the_reference(tmp_path, gulp):
    """``sweep`` lines through both packages' loops: the response fields,
    each book's top table (vols within rtol 1e-10, the rest equal), its
    histogram, the counts and the sampler block, and the dead letters of
    the malformed ones."""
    dead = (str(tmp_path / "port.jsonl"), str(tmp_path / "ref.jsonl"))
    port, ref = _servers(dead=dead)
    got, got_n, _ = _run(port, SWEEP_LINES, port_obs, gulp=gulp)
    want, want_n, _ = _run(ref, SWEEP_LINES, ref_obs, gulp=gulp)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = json.loads(g), json.loads(w)
        if "book" in w:
            # a lane whose bin position lies within RTOL of a bin edge may
            # land on either side in the two packages (the grid sampler
            # puts its corr_beta = 0 row exactly on edges), and a lane
            # inside the gate's band may be projected in one package only;
            # every other lane lands in the same bin and the same count
            vols, in_band = _sweep_lanes(w["id"])
            gh, wh = g["book"].pop("hist"), w["book"].pop("hist")
            _hold_tree(gh["bin_width"], wh["bin_width"], f"{w['id']}.hist")
            pos = vols / gh["bin_width"]
            on_edge = int((np.abs(pos - np.round(pos)) <= RTOL * pos).sum())
            moved = np.abs(np.subtract(gh["counts"], wh["counts"])).sum()
            assert sum(gh["counts"]) == sum(wh["counts"])
            assert moved <= 2 * on_edge, (w["id"], moved, on_edge)
            gp = g["counts"].pop("n_psd_projected")
            wp = w["counts"].pop("n_psd_projected")
            assert abs(gp - wp) <= in_band, (w["id"], gp, wp, in_band)
        _hold_tree(g, w, "$")
    assert got_n == want_n
    resps = {r["id"]: r for r in map(json.loads, got)}
    for rid in ("s0", "s1", "s2", "s3", "s4"):
        r = resps[rid]
        assert r["outcome"] == "ok" and r["kind"] == "sweep", r
        assert r["counts"]["n_ok"] == r["counts"]["n_scenarios"] > 0
        assert sum(r["book"]["hist"]["counts"]) == r["counts"]["n_ok"]
        assert r["book"]["top"] and r["book"]["vol_base"] > 0
    assert resps["s4"]["scenario_id"] == "stress"
    assert resps["s0"]["counts"] == resps["s1"]["counts"]   # co-swept
    assert resps["q0"]["outcome"] == "ok" and "book" not in resps["q0"]
    assert [resps[f"bad{i}"]["outcome"] for i in range(3)] == \
        ["dead_letter"] * 3
    assert "bad_sweep" in resps["bad2"]["reasons"]
    assert Path(dead[0]).read_bytes() == Path(dead[1]).read_bytes()


def test_sweep_request_is_a_direct_sweep_of_its_book():
    from mfm_tpu_torch.grad import ShockBall
    from mfm_tpu_torch.scenario import SweepEngine, UniformSampler

    port, _ = _servers()
    w = [0.3, 0.1, 0.0, -0.2, 0.2, 0.1]
    out = port.submit_line(_req("s", w=w, sweep={"n": 200, "chunk": 64,
                                                 "top_k": 5, "seed": 9}))
    assert out == []
    r, = port.drain()
    se = SweepEngine(_cov(), factor_names=NAMES, device="cpu")
    want = se.sweep(np.asarray([w]), UniformSampler(ShockBall(), K, 200,
                                                    seed=9),
                    chunk=64, top_k=5, bins=64)
    assert r["book"] == want.books[0] and r["counts"] == want.counts
    assert r["sampler"] == want.sampler


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
