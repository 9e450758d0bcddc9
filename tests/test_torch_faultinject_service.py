"""The recovery matrix's service plans 1-12 (``python -m
mfm_tpu_torch.tools.faultinject``) on the CPU at the reference's geometry
(44 dates, a 32-date history, three 4-date slabs, 20 stocks, 8 draws):
the query service, scenarios, the sweep, grad, tracing, the flight
recorder and the response cache.  Each plan passes with its contracts
bitwise and its subprocesses SIGKILLed where it says; the query plans'
request lines go through the port's ``QueryServer`` and the reference's
at float64 over one guarded checkpoint carried across, with the same
dead letters, shed order, breaker transitions and answers; and a
sabotaged stack fails its plan (a serve loop that does not flush per
emit, a cache that ignores the generation fence, a query batch that
skips bucketing), so the drills are not vacuous.
"""

import io
import json
import math
import os
import sys
import textwrap

import numpy as np
import pytest
import torch

from mfm_tpu.data.artifacts import ArtifactCorruptError as RefCorrupt
from mfm_tpu.data.artifacts import load_risk_state as ref_load
from mfm_tpu.serve import QueryEngine as RefEngine
from mfm_tpu.serve import QueryServer as RefServer
from mfm_tpu.serve import ServePolicy as RefPolicy
from mfm_tpu_torch.convert import state_from_reference
from mfm_tpu_torch.data.artifacts import ArtifactCorruptError
from mfm_tpu_torch.serve import QueryEngine, QueryServer, ServePolicy
from mfm_tpu_torch.tools import faultinject as fi
from mfm_tpu_torch.utils.chaos import corrupt_file, plan_suite

FLEET = ("fleet_kill", "fleet_kill_host", "fleet_wedge")
PLANS = [p for p in plan_suite(0)
         if p.kind in fi.SERVICE_KINDS and p.kind not in FLEET]
BY_NAME = {p.name: p for p in plan_suite(0)}
RTOL = 1e-10

#: what each plan's record must show: the subprocesses SIGKILLed at its
#: crash point, the completed subprocesses that reported launches, and
#: the plan's own counts
WANT = {
    "query-kill-mid-batch": (1, 1, {"durable_responses": 8,
                                    "answered_on_replay": 24}),
    "query-poison-slab": (None, 0, {"dead_lettered": 6, "healthy_ok": 18}),
    "query-overflow-storm": (None, 0, {"shed": 16, "served": 8}),
    "query-ckpt-swap": (None, 0, {"rejected": 8, "breaker": "fence_audit"}),
    "query-steady-state": (None, 0, {"compiles": 0, "new_bucket": 128,
                                     "new_bucket_compiles": 1}),
    "scenario-kill-mid-batch": (1, 2, {"recovered_n_ok": 3}),
    "scenario-poison-spec": (None, 0, {"rejected": ["p-nan", "p-corr",
                                                    "p-vol"]}),
    "sweep-kill-mid-stream": (1, 2, {"recovered_n_ok": 512}),
    "grad-kill-mid-solve": (1, 1, {"recovered_entries": 1}),
    "trace-kill-mid-flush": (1, 1, {"trace_after_crash": "absent"}),
    "flightrec-kill-mid-dump": (1, 2, {"recovered_trigger": "breaker_open",
                                       "recovered_trace_id": "df" * 16}),
    "cache-stale-generation": (1, 3, {"pre_hits": 5, "rewarm_misses": 1,
                                      "responses": 24}),
}


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("faultinject_service"))
    return fi.Baseline(root, 0, fi.Geometry(), torch.device("cpu")), root


def _run(plan, harness, name=None):
    base, root = harness
    if name:
        plan = plan.__class__(name, plan.kind, plan.seed, plan.params)
    return fi._run_plan(lambda: fi.RUNNERS[plan.kind](plan, base, root),
                        base, {"plan": plan.name})


def test_the_service_plans_are_the_twelve_of_the_matrix():
    assert sorted(p.name for p in PLANS) == sorted(WANT)


@pytest.mark.parametrize("plan", PLANS, ids=[p.name for p in PLANS])
def test_service_plan_passes(harness, plan):
    rec = _run(plan, harness)
    assert rec["status"] == "pass", rec.get("error")
    killed, completed, counts = WANT[plan.name]
    assert rec.get("killed_subprocesses") == killed
    subs = rec.get("subprocess_launches", [])
    assert len(subs) == completed
    # on the CPU every kernel's plain version runs: no launch anywhere
    assert all(not any(s.values()) for s in subs)
    for k, v in counts.items():
        assert rec[k] == v, (k, rec[k])


# -- the query plans against the reference ------------------------------------

def _engines(path):
    """(port engine, reference engine) at float64 over one checkpoint the
    port's harness wrote, carried to the port by ``convert``."""
    port = QueryEngine.from_risk_state(*state_from_reference(path, "cpu"),
                                       device="cpu", dtype=np.float64)
    ref = RefEngine.from_risk_state(*ref_load(path), dtype=np.float64)
    return port, ref


def _servers(engines, policy_kw, **kw):
    """(port, reference) servers on a still clock."""
    port_kw = {k: v[0] if isinstance(v, tuple) else v for k, v in kw.items()}
    ref_kw = {k: v[1] if isinstance(v, tuple) else v for k, v in kw.items()}
    return (QueryServer(engines[0], ServePolicy(**policy_kw), health="ok",
                        clock=fi._still_clock, **port_kw),
            RefServer(engines[1], RefPolicy(**policy_kw), health="ok",
                      clock=fi._still_clock, **ref_kw))


def _hold(got, want, what):
    """Equal keys and strings, numbers within RTOL; the timing fields
    (``*_s``) are skipped."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            if not k.endswith("_s"):
                _hold(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _hold(g, w, f"{what}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, float), what
        assert (math.isnan(got) and math.isnan(want)) or got == \
            pytest.approx(want, rel=RTOL, abs=1e-300), (what, got, want)
    else:
        assert got == want, (what, got, want)


def _serve_both(servers, lines):
    outs = []
    for srv in servers:
        buf = io.StringIO()
        srv.run(iter(lines), buf, gulp=True)
        outs.append([json.loads(ln) for ln in buf.getvalue().splitlines()])
    return outs


def test_query_poison_matches_the_reference(harness, tmp_path):
    base, _ = harness
    engines = _engines(os.path.join(base.snaps[0], "state.npz"))
    plan = BY_NAME["query-poison-slab"]
    lines = fi._interleave_poison(
        fi._query_requests(plan.seed, 18, engines[0].K),
        fi._poison_lines(engines[0].K))
    dl = (str(tmp_path / "port.jsonl"), str(tmp_path / "ref.jsonl"))
    got, want = _serve_both(_servers(
        engines, dict(batch_max=8, default_deadline_s=600.0),
        dead_letter_path=dl), lines)
    _hold(got, want, "responses")
    records = [[json.loads(ln) for ln in open(p)] for p in dl]
    assert [(r["id"], r["mask"], r["reasons"]) for r in records[0]] == \
        [(r["id"], r["mask"], r["reasons"]) for r in records[1]]
    assert len(records[0]) == 6
    _hold(records[0], records[1], "dead letters")


def test_query_overflow_matches_the_reference(harness):
    base, _ = harness
    engines = _engines(os.path.join(base.snaps[0], "state.npz"))
    plan = BY_NAME["query-overflow-storm"]
    lines = fi._query_requests(plan.seed, 24, engines[0].K)
    got, want = _serve_both(_servers(
        engines, dict(queue_max=8, batch_max=8, default_deadline_s=600.0)),
        lines)
    shed = [[r["id"] for r in out if r["outcome"] == "shed"]
            for out in (got, want)]
    assert shed[0] == shed[1] == [f"q{i}" for i in range(16)]
    _hold(got, want, "responses")


def test_query_swap_matches_the_reference(harness, tmp_path):
    """Each package's server hot-swaps to gen B after batch 0 and then to
    a corrupt checkpoint: the same answers per generation, the same
    breaker transitions (to open on ``fence_audit``), the same
    rejections."""
    base, _ = harness
    path_a = os.path.join(base.snaps[0], "state.npz")
    path_b = os.path.join(base.snaps[1], "state.npz")
    bad = tmp_path / "bad"
    bad.mkdir()
    fi._restore(str(bad), base.snaps[1])
    corrupt_file(str(bad / "state.npz"), 8, BY_NAME["query-ckpt-swap"].seed)
    errs = []
    for load, exc in ((lambda p: state_from_reference(p, "cpu"),
                       ArtifactCorruptError), (ref_load, RefCorrupt)):
        with pytest.raises(exc) as info:
            load(str(bad / "state.npz"))
        errs.append(info.value)
    engines_a, engines_b = _engines(path_a), _engines(path_b)

    def reload_fn(i):
        steps = [None, {"engine": engines_b[i], "health": "ok"}, errs[i]]

        def fn():
            step = steps.pop(0) if steps else None
            if isinstance(step, Exception):
                raise step
            return step
        return fn

    servers = _servers(engines_a, dict(batch_max=8,
                                       default_deadline_s=600.0),
                       reload_fn=(reload_fn(0), reload_fn(1)))
    moves = ([], [])
    for srv, log in zip(servers, moves):
        real = srv.breaker._to
        srv.breaker._to = lambda st, real=real, log=log: (log.append(st),
                                                          real(st))
    lines = fi._query_requests(BY_NAME["query-ckpt-swap"].seed, 24,
                               engines_a[0].K)
    got, want = _serve_both(servers, lines)
    _hold(got, want, "responses")
    assert moves[0] == moves[1] and moves[0][-1] == "open"
    assert [s.breaker.open_reason for s in servers] == ["fence_audit"] * 2
    assert [r["outcome"] for r in got] == ["ok"] * 16 + ["rejected"] * 8
    assert all(r["retry_after_s"] > 0 for r in got[16:])


# -- sabotage: the drills must fail on a broken stack -------------------------

def _wrapped_cli(tmp_path, monkeypatch, patch: str):
    """Run the harness's CLI subprocesses through a wrapper that applies
    ``patch`` before ``cli.main``."""
    wrapper = tmp_path / "sabotaged_cli.py"
    wrapper.write_text(textwrap.dedent(patch) + textwrap.dedent("""
        from mfm_tpu_torch import cli
        cli.main()
    """))
    monkeypatch.setattr(fi, "_cli_argv", lambda: [sys.executable,
                                                  str(wrapper)])


def test_sabotage_serve_loop_without_flush_fails_query_kill(harness,
                                                           tmp_path,
                                                           monkeypatch):
    """A serve loop whose emits stay in the process's buffer loses batch
    0's responses to the SIGKILL: query-kill-mid-batch turns red."""
    _wrapped_cli(tmp_path, monkeypatch, """
        from mfm_tpu_torch.serve import server

        class Buffered:
            def __init__(self, fp):
                self._fp = fp

            def write(self, text):
                return self._fp.write(text)

            def flush(self):
                pass

            def fileno(self):
                raise ValueError("no descriptor")

        real = server.QueryServer.run

        def run(self, lines, out_fp, **kw):
            return real(self, lines, Buffered(out_fp), **kw)

        server.QueryServer.run = run
    """)
    rec = _run(BY_NAME["query-kill-mid-batch"], harness,
               name="sabotage-query-kill")
    assert rec["status"] == "FAIL"
    assert "durable responses before the kill" in rec["error"]


def test_sabotage_cache_ignoring_the_fence_fails_cache_stale(harness,
                                                            monkeypatch):
    """A response cache whose fence never moves serves the retired
    generation's body after the hot swap: cache-stale-generation turns
    red."""
    from mfm_tpu_torch.serve import cache

    monkeypatch.setattr(cache.ResponseCache, "set_fence",
                        lambda self, generation=None, scenario_hashes=None:
                        None)
    rec = _run(BY_NAME["cache-stale-generation"], harness,
               name="sabotage-cache-stale")
    assert rec["status"] == "FAIL"
    assert "pre-reload cached body" in rec["error"]


def test_sabotage_unbucketed_query_batch_fails_query_steady(harness,
                                                           monkeypatch):
    """A query batch padded to its own size instead of its bucket is a new
    signature whenever the size moves: query-steady-state turns red."""
    from mfm_tpu_torch.serve import query

    monkeypatch.setattr(query, "bucket_for", lambda n, *a, **k: int(n))
    rec = _run(BY_NAME["query-steady-state"], harness,
               name="sabotage-query-steady")
    assert rec["status"] == "FAIL"
    assert "steady-state query loop" in rec["error"]
