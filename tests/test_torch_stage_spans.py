"""The port's stage spans (``obs/trace.stage``) on the CPU at tiny sizes.

``RiskModel._run_carried`` opens ``risk.run`` over one span a stage, and
``compile_alpha_batch`` an ``alpha.batch`` span over an ``alpha.eval``
span a chunk, which the ``alpha`` CLI's ``--metrics-dir`` trace holds
beside its ``alpha.score``.  Stage spans record only with tracing and
stage tracing both on (``--metrics-dir`` turns the latter on); off, a
stage records nothing and the outputs are bitwise those with it on.  ``mfmbench/stages.py`` puts the spans on
``torch.profiler``'s clock and splits a trace's device work and idle gaps
by them; its assignment is held here on hand-made event lists.
"""

import dataclasses
import json

import numpy as np
import pandas as pd
import pytest
import torch

import chip_smoke
from mfm_tpu_torch import RiskModel, RiskModelConfig
from mfm_tpu_torch.alpha import dsl
from mfm_tpu_torch.cli import main as cli_main
from mfm_tpu_torch.config import QuarantinePolicy
from mfm_tpu_torch.models.risk_model import (
    MIN_EIGEN_DATES,
    MIN_REGRESSION_DATES,
)
from mfm_tpu_torch.obs import trace
from mfmbench import stages

T, N, P, Q = 40, 16, 3, 2
CFG = RiskModelConfig(eigen_n_sims=4, eigen_sim_length=40)
GCFG = dataclasses.replace(CFG, quarantine=QuarantinePolicy(enabled=True))
STAGES = ("risk.regression", "risk.newey_west", "risk.eigen",
          "risk.vol_regime")


@pytest.fixture(autouse=True)
def fresh_ring():
    trace.reset_tracing()
    trace.set_tracing(True)
    trace.set_stage_tracing(True)
    yield
    trace.set_tracing(True)
    trace.set_stage_tracing(False)
    trace.reset_tracing()


def _switch_off(which):
    """Turn stage spans off by one of their two switches."""
    if which == "tracing":
        trace.set_tracing(False)
    else:
        trace.set_stage_tracing(False)


def _model(sl=slice(None), cfg=CFG):
    rng = np.random.default_rng(3)
    panels = (rng.normal(0, 0.02, (T, N)), rng.lognormal(10, 1, (T, N)),
              rng.normal(size=(T, N, Q)), rng.integers(0, P, (T, N)),
              rng.random((T, N)) > 0.05)
    ps = [torch.from_numpy(np.asarray(p)[sl]) for p in panels]
    return RiskModel(*ps, n_industries=P, config=cfg, device="cpu")


def _run(entry):
    """One entry point's call, the state it resumes made first and its
    spans dropped: (its result, the dates it runs, whether guarded)."""
    if entry == "run_fused":
        return _model().run_fused(), T, False
    if entry == "init_state":
        return _model(slice(0, 30), GCFG).init_state(), 30, False
    _, state = _model(slice(0, 30), GCFG).init_state()
    trace.reset_tracing()
    slab = _model(slice(30, 33), GCFG)
    if entry == "update":
        return slab.update(state), 3, False
    return slab.update_guarded(state), 3, True


@pytest.mark.parametrize("entry", ["run_fused", "init_state", "update",
                                   "update_guarded"])
def test_every_entry_point_opens_the_stage_tree(entry):
    _, dates, guarded = _run(entry)
    got = trace.spans()
    assert [s.name for s in got] == [*STAGES, "risk.run"]
    root = got[-1]
    assert root.parent_id is None
    assert {s.trace_id for s in got} == {root.trace_id}
    assert all(s.parent_id == root.span_id for s in got[:-1])
    assert root.attrs == {"dates": dates, "stocks": N, "nw_method": "scan",
                          "guarded": guarded}
    by = {s.name: s.attrs for s in got}
    # the CPU runs the kernels' plain versions: no launch is counted
    assert by["risk.regression"] == {"dates": max(dates,
                                                  MIN_REGRESSION_DATES),
                                     "eigh_warp_launches": 0,
                                     "eigh_block_launches": 0}
    assert by["risk.newey_west"] == {"dates": dates, "nw_launches": 0}
    assert by["risk.eigen"] == {"dates": max(dates, MIN_EIGEN_DATES),
                                "eigh_warp_launches": 0,
                                "eigh_block_launches": 0, "eigh_n": 0}
    assert by["risk.vol_regime"] == {"dates": dates, "vr_launches": 0}
    # host intervals nest; a CPU stage has no device events
    for s in got[:-1]:
        assert root.start_us <= s.start_us
        assert s.start_us + s.dur_us <= root.start_us + root.dur_us
        assert s.events is None and trace.device_seconds(s) is None


def test_each_call_is_a_trace_of_its_own():
    _model().run_fused()
    _model().run_fused()
    roots = [s for s in trace.spans() if s.name == "risk.run"]
    assert len(roots) == 2 and roots[0].trace_id != roots[1].trace_id


def test_a_pushed_span_takes_the_stages_into_its_trace():
    root = trace.start_span("cli.risk", trace_id=trace.new_trace_id())
    trace.push_span(root)
    try:
        _model().run_fused()
    finally:
        trace.pop_span(root)
    trace.pop_span(root)              # where it is not, nothing happens
    run = next(s for s in trace.spans() if s.name == "risk.run")
    assert run.trace_id == root.trace_id and run.parent_id == root.span_id
    assert trace.current_trace_id() is None


@pytest.mark.parametrize("which", ["tracing", "stages"])
@pytest.mark.parametrize("entry", ["run_fused", "update_guarded"])
def test_outputs_are_bitwise_with_tracing_off(entry, which):
    on, _, _ = _run(entry)
    _switch_off(which)
    trace.reset_tracing()
    off, _, _ = _run(entry)
    assert trace.spans() == []
    outs = [on, off] if entry == "run_fused" else [on[0], off[0]]
    for a, b in zip(*outs):
        assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))


@pytest.mark.parametrize("which", ["tracing", "stages"])
def test_a_stage_off_is_the_shared_null_context(which):
    _switch_off(which)
    cm = trace.stage("x", torch.device("cpu"), a=1)
    assert cm is trace.stage("y")
    with cm as sp:
        assert sp is None
    assert trace.spans() == []


def test_a_stage_takes_counts_through_its_span():
    with trace.stage("s", torch.device("cpu"), a=1) as sp:
        sp.attrs["n"] = 7
    (got,) = trace.spans()
    assert got is sp and got.attrs == {"a": 1, "n": 7}
    with pytest.raises(ValueError):
        with trace.stage("bad"):
            raise ValueError("boom")
    assert trace.spans()[-1].attrs["error"] == "ValueError: boom"
    assert trace.current_trace_id() is None


def _alpha(n, T=30, N=8):
    panel, exprs, fwd = chip_smoke.alpha_workload(T, N, n)
    return ({k: torch.from_numpy(v).double() for k, v in panel.items()},
            exprs, torch.from_numpy(fwd).double())


def test_the_alpha_cli_traces_one_eval_span_a_chunk(tmp_path, capsys):
    panel, exprs, _ = chip_smoke.alpha_workload(30, 8, 7)
    T_, N_ = panel["close"].shape
    long = pd.DataFrame({
        "trade_date": np.repeat(pd.bdate_range("2024-01-02", periods=T_),
                                N_),
        "ts_code": np.tile([f"s{i:02d}" for i in range(N_)], T_),
        **{k: v.ravel() for k, v in panel.items()}})
    long.to_csv(tmp_path / "panel.csv", index=False)
    (tmp_path / "exprs.txt").write_text("\n".join(exprs) + "\n")
    mdir = tmp_path / "metrics"
    # --metrics-dir turns the stage spans on for its run, and only then
    trace.set_stage_tracing(False)
    cli_main(["alpha", "--exprs", str(tmp_path / "exprs.txt"), "--panel",
              str(tmp_path / "panel.csv"), "--out", str(tmp_path / "s.csv"),
              "--device", "cpu", "--chunk", "3", "--metrics-dir", str(mdir)])
    tid = json.loads(capsys.readouterr().out.splitlines()[-1])["trace_id"]
    events = [e for e in json.loads((mdir / "trace.json").read_text())[
        "traceEvents"] if e["args"]["trace_id"] == tid]
    assert [e["name"] for e in events] == [
        "alpha.eval", "alpha.eval", "alpha.eval", "alpha.batch",
        "alpha.score", "cli.alpha"]
    ids = {e["name"]: e["args"] for e in events}
    root = ids["cli.alpha"]["span_id"]
    assert ids["alpha.batch"]["parent_id"] == root
    assert ids["alpha.score"]["parent_id"] == root
    assert ids["alpha.batch"]["exprs"] == ids["alpha.score"]["exprs"] == 7
    assert ids["alpha.batch"]["chunks"] == 3
    evals = [e["args"] for e in events if e["name"] == "alpha.eval"]
    assert [(a["exprs"], a["chunk"]) for a in evals] == [(3, 0), (3, 1),
                                                         (1, 2)]
    assert {a["parent_id"] for a in evals} == {ids["alpha.batch"]["span_id"]}
    assert trace.current_trace_id() is None
    assert not trace.stage_tracing_enabled()


def test_alpha_batch_opens_one_eval_span_a_chunk():
    panel, exprs, _ = _alpha(7)
    on = dsl.compile_alpha_batch(exprs, chunk=3)(panel)
    got = trace.spans()
    assert [s.name for s in got] == ["alpha.eval"] * 3 + ["alpha.batch"]
    assert got[-1].attrs == {"exprs": 7, "chunks": 3}
    assert [s.attrs["exprs"] for s in got[:-1]] == [3, 3, 1]
    trace.set_stage_tracing(False)
    off = dsl.compile_alpha_batch(exprs, chunk=3)(panel)
    assert len(trace.spans()) == len(got)
    assert torch.equal(on.nan_to_num(7.0), off.nan_to_num(7.0))


# -- mfmbench/stages.py: one clock, kernels and idle gaps by span -------------

def test_the_probe_offset_comes_from_the_narrowest_bracket():
    # perf_counter brackets (s) around probes stamped at 1e9 + host ns
    brackets = [(10.0, 10.000040), (11.0, 11.000004), (12.0, 12.000100)]
    probe_ns = [1e9 + 10.000030e9, 1e9 + 11.000002e9, 1e9 + 12.000050e9]
    offset_ns, unc_ns, misfit_ns = stages.probe_offset(brackets, probe_ns)
    assert unc_ns == pytest.approx(2000.0)
    assert offset_ns == pytest.approx(1e9, abs=1.0)
    assert misfit_ns == 0.0
    # a probe matched to an event 1 ms off its bracket reads as a misfit:
    # 1 ms less its own 50 µs and the best's 2 µs
    probe_ns[2] += 1e6
    assert stages.probe_offset(brackets, probe_ns)[2] == pytest.approx(
        1e6 - 50000.0 - 2000.0, abs=1.0)


def test_a_kernel_counts_to_the_span_that_launched_it():
    spans = [("risk.run", 0, 1000), ("risk.newey_west", 100, 400),
             ("risk.eigen", 400, 900)]
    launches = {1: 50, 2: 150, 3: 390, 4: 500, 5: 950, 6: 2000}
    ops = [(60, 80, "k_run", 1),
           (160, 200, "k_nw", 2),
           # launched in Newey-West, run after it closed on the host
           (600, 700, "k_nw_late", 3),
           (700, 800, "k_eig", 4),
           (960, 980, "Memcpy DtoH", 5),
           (2010, 2020, "k_after", 6),
           (2030, 2040, "k_lost", 99)]
    rows = stages.assign(ops, launches, spans)
    assert rows["risk.newey_west"]["kernels"] == 2
    assert rows["risk.newey_west"]["busy_s"] == pytest.approx(140e-9)
    assert rows["risk.eigen"]["kernels"] == 1
    assert rows["risk.run"]["kernels"] == 1
    # a copy counts as an operation and busy time, not as a kernel
    assert (rows["risk.run"]["ops"], rows["risk.run"]["kernels"]) == (2, 1)
    assert rows["risk.run"]["busy_s"] == pytest.approx(40e-9)
    # launched where no span was open, or with no launch in the trace
    assert (rows["outside"]["ops"], rows["outside"]["kernels"]) == (2, 2)


@pytest.mark.parametrize("name,launch", [
    ("cudaLaunchKernel", True), ("cudaLaunchKernelExC", True),
    ("cuLaunchKernel", True), ("cudaMemcpyAsync", True),
    ("aten::mul", False), ("aten::empty", False), ("cumsum", False)])
def test_only_runtime_calls_are_launches(name, launch):
    assert stages._is_runtime_call(name) is launch


def test_an_idle_gap_counts_to_the_span_that_launched_what_ends_it():
    spans = [("risk.run", 0, 1000), ("risk.newey_west", 100, 400),
             ("risk.eigen", 400, 900)]
    # the device's stamps need not agree with the host's: the gap
    # 50-300 ends with an operation Newey-West launched, wherever the
    # host's clock puts the gap
    ops = [(0, 50, "a", 1), (300, 450, "b", 2), (440, 460, "c", 3),
           (950, 1000, "d", 4), (1100, 1200, "e", 5), (1210, 1220, "f", 6)]
    launches = {1: 0, 2: 120, 3: 130, 4: 910, 5: 1050}
    rows = stages.assign(ops, launches, spans)
    assert rows["risk.newey_west"]["idle_s"] == pytest.approx(250e-9)
    assert rows["risk.eigen"]["idle_s"] == 0.0
    # 460-950 before d (launched in risk.run, after eigen closed)
    assert rows["risk.run"]["idle_s"] == pytest.approx(490e-9)
    # 1000-1100 before e (launched after every span), 1200-1210 before f
    # (no launch in the trace)
    assert rows["outside"]["idle_s"] == pytest.approx(110e-9)
    busy = 50 + 160 + 50 + 100 + 10
    assert sum(r["idle_s"] for r in rows.values()) == pytest.approx(
        (1220 - busy) * 1e-9)


def test_by_span_reads_the_calls_spans_on_the_cpu():
    rm = _model()
    out, rec = stages.by_span(rm.run_fused, "cpu")
    assert out.vr_cov.shape == (T, 1 + P + Q, 1 + P + Q)
    rows = rec["by_span"]
    assert {*STAGES, "risk.run", "outside"} == set(rows)
    assert all(rows[name]["count"] == 1 for name in (*STAGES, "risk.run"))
    assert rec["kernels"] == 0 and rec["unmatched"] == 0
    assert len(rec["trace_ids"]) == 1
    assert 0 < rec["offset_uncertainty_s"] < 0.01
    assert rec["offset_misfit_s"] < 1e-5
    assert rows["risk.newey_west"]["host_s"] > 0
    assert rows["risk.eigen"]["device_s"] is None
