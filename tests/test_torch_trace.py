"""The port's tracing (``mfm_tpu_torch/obs/trace.py``): the Chrome-trace
export and validator and the fleet-wire span merge — the counterparts of
those parts of ``tests/test_trace.py``, test for test — held against the
JAX package on the same inputs (``clock_offset_from_probe`` and
``ingest_foreign_spans`` give equal results), and the crash points of the
atomic writers: ``trace.after_tmp`` and ``run_manifest.after_tmp`` each
kill only at their own point, and a real SIGKILL between tmp and rename
leaves no torn trace.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from mfm_tpu.obs import trace as ref_trace
from mfm_tpu_torch.obs import manifest
from mfm_tpu_torch.obs.trace import (
    chrome_trace_events,
    export_spans_to_events,
    clock_offset_from_probe,
    drain_spans,
    end_span,
    ingest_foreign_spans,
    parse_chrome_trace,
    render_chrome_trace,
    reset_tracing,
    set_ring_capacity,
    set_tracing,
    span,
    spans,
    start_span,
    write_chrome_trace,
)
from mfm_tpu_torch.utils import chaos

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_tracing():
    for mod in (sys.modules[__name__], ref_trace):
        mod.reset_tracing()
        mod.set_tracing(True)
    yield
    for mod in (sys.modules[__name__], ref_trace):
        mod.reset_tracing()
        mod.set_tracing(True)


# -- Chrome trace-event export ------------------------------------------------

def test_cross_thread_parenting_in_export():
    # a request admitted on one thread, batched on another: explicit ids
    # carry the trace across threads, and the export keeps tids distinct
    req = start_span("serve.request", request_id="q1")

    def worker():
        sp = start_span("serve.batch", trace_id=req.trace_id,
                        parent_id=req.span_id, n=1)
        time.sleep(0.001)
        end_span(sp, outcome="ok")

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    end_span(req)
    events = parse_chrome_trace(render_chrome_trace())
    by_name = {e["name"]: e for e in events}
    batch, request = by_name["serve.batch"], by_name["serve.request"]
    assert batch["args"]["trace_id"] == request["args"]["trace_id"]
    assert batch["args"]["parent_id"] == request["args"]["span_id"]
    assert batch["tid"] != request["tid"]


# -- Chrome trace-event export ------------------------------------------------

def test_chrome_render_parses_and_carries_attrs():
    with span("run", cmd="risk", n=3):
        pass
    events = parse_chrome_trace(render_chrome_trace())
    (ev,) = events
    assert ev["ph"] == "X" and ev["cat"] == "mfm"
    assert ev["pid"] == os.getpid()
    assert ev["args"]["cmd"] == "risk" and ev["args"]["n"] == 3
    # the object wrapper is what Perfetto expects
    obj = json.loads(render_chrome_trace())
    assert set(obj) == {"traceEvents", "displayTimeUnit"}


@pytest.mark.parametrize("text,msg", [
    ('{"traceEvents": [', "torn trace file"),
    ('{"a": 1}', "traceEvents"),
    ('"just a string"', "object or array"),
    ('[42]', "not an object"),
    ('[{"name": "x", "ph": "Q", "ts": 0, "pid": 1, "tid": 1}]', "phase"),
    ('[{"ph": "X", "ts": 0, "dur": 1, "pid": 1, "tid": 1}]', "name"),
    ('[{"name": "x", "ph": "X", "ts": -5, "dur": 1, "pid": 1, "tid": 1}]',
     "ts"),
    ('[{"name": "x", "ph": "X", "ts": 0, "dur": 1, "pid": "p", "tid": 1}]',
     "pid"),
    ('[{"name": "x", "ph": "X", "ts": 0, "pid": 1, "tid": 1}]', "dur"),
    ('[{"name": "x", "ph": "B", "ts": 0, "pid": 1, "tid": 1, "args": []}]',
     "args"),
])
def test_parse_rejects_malformed(text, msg):
    with pytest.raises(ValueError, match=msg):
        parse_chrome_trace(text)


def test_parse_accepts_foreign_forms():
    # bare-array form and metadata ("M") events without timestamps both
    # load in Perfetto, so the validator must take them
    events = parse_chrome_trace(
        '[{"name": "process_name", "ph": "M", "pid": 1, "tid": 0,'
        ' "args": {"name": "mfm"}},'
        ' {"name": "x", "ph": "X", "ts": 1.5, "dur": 0, "pid": 1, "tid": 0}]')
    assert len(events) == 2


def test_write_chrome_trace_is_atomic_and_loadable(tmp_path):
    with span("flush"):
        pass
    path = str(tmp_path / "metrics" / "trace.json")
    assert write_chrome_trace(path) == path
    assert not os.path.exists(path + ".tmp")
    with open(path, encoding="utf-8") as fh:
        (ev,) = parse_chrome_trace(fh.read())
    assert ev["name"] == "flush"


# -- fleet-wire span merge: clock-offset correction ---------------------------

def _worker_wire_span(name, start_us, dur_us=1000.0, trace_id="ab" * 16,
                      span_id="01" * 8, parent=None):
    return {"name": name, "trace_id": trace_id, "span_id": span_id,
            "parent_id": parent, "start_us": float(start_us),
            "dur_us": float(dur_us), "wall_ts": 123.0, "tid": 7,
            "attrs": {}}


def test_drain_spans_is_destructive_and_json_safe():
    end_span(start_span("worker.batch", n=3))
    shipped = drain_spans()
    assert spans() == []               # shipped spans leave the worker ring
    assert len(shipped) == 1
    d = shipped[0]
    assert d["name"] == "worker.batch" and d["attrs"]["n"] == 3
    json.dumps(d)                      # the piggyback payload must be JSON


def test_clock_offset_probe_midpoint_and_uncertainty():
    # peer stamped its clock somewhere inside a 2 ms round trip centered
    # on local t=1.001 s; the peer runs 50 ms ahead
    off, unc = clock_offset_from_probe(1.000, 1.002, 1_051_000.0)
    assert off == pytest.approx(50_000.0)
    assert unc == pytest.approx(1_000.0)


@pytest.mark.parametrize("skew_ms", [50.0, -50.0])
def test_injected_skew_corrects_onto_local_timeline(skew_ms):
    """A worker clock +-50 ms off the frontend's: spans corrected by the
    probe-estimated offset land inside the dispatch window, in the true
    event order, stamped with the correction they received."""
    skew_us = skew_ms * 1e3
    # true (local-clock) worker activity: recv at 1.002 s, batch at 1.003 s,
    # inside the local dispatch window [1.000 s, 1.010 s]
    shipped = [
        _worker_wire_span("worker.recv", 1_002_000 + skew_us,
                          span_id="aa" * 8),
        _worker_wire_span("worker.batch", 1_003_000 + skew_us,
                          span_id="bb" * 8),
    ]
    # probe: peer stamped (midpoint + skew) inside a 2 ms RTT
    off, unc = clock_offset_from_probe(1.000, 1.002,
                                       1_001_000.0 + skew_us)
    assert off == pytest.approx(skew_us, abs=1.0)
    got = ingest_foreign_spans(shipped, offset_us=-off, uncertainty_us=unc,
                               window_us=(1_000_000.0, 1_010_000.0),
                               worker=3)
    assert [s.name for s in got] == ["worker.recv", "worker.batch"]
    assert got[0].start_us == pytest.approx(1_002_000.0, abs=unc)
    assert got[1].start_us == pytest.approx(1_003_000.0, abs=unc)
    assert got[0].start_us < got[1].start_us   # true order survives
    for s in got:
        assert s.attrs["clock_offset_us"] == pytest.approx(-off)
        assert s.attrs["clock_uncertainty_us"] == pytest.approx(unc)
        assert s.attrs["worker"] == 3
        assert "clock_skew" not in s.attrs
    # the merged ring holds them for the Chrome export
    assert [s.span_id for s in spans()] == ["aa" * 8, "bb" * 8]


def test_uncorrectable_skew_flagged_never_reordered_or_clamped():
    """No usable offset estimate: a span whose corrected extent falls
    outside the dispatch window beyond the uncertainty is FLAGGED — its
    timestamps are neither clamped into the window nor reordered."""
    from mfm_tpu_torch.obs.instrument import TRACE_SKEW_UNCORRECTABLE_TOTAL
    before = TRACE_SKEW_UNCORRECTABLE_TOTAL.value()
    shipped = [_worker_wire_span("worker.batch", 1_052_000.0,
                                 span_id="cc" * 8),
               _worker_wire_span("worker.recv", 1_051_000.0,
                                 span_id="dd" * 8)]
    got = ingest_foreign_spans(shipped, offset_us=0.0, uncertainty_us=500.0,
                               window_us=(1_000_000.0, 1_010_000.0),
                               worker=1)
    assert [s.attrs.get("clock_skew") for s in got] == \
        ["uncorrectable", "uncorrectable"]
    # not clamped: the raw (offset-applied) timestamps survive
    assert got[0].start_us == 1_052_000.0
    assert got[1].start_us == 1_051_000.0
    # not reordered: ring order is ship order, even though start_us isn't
    assert [s.span_id for s in spans()] == ["cc" * 8, "dd" * 8]
    assert TRACE_SKEW_UNCORRECTABLE_TOTAL.value() == before + 2


def test_merged_spans_render_one_timeline_per_trace():
    tid = "fe" * 16
    sp = start_span("fleet.dispatch", trace_id=tid, replica=0)
    end_span(sp)
    ingest_foreign_spans(
        [_worker_wire_span("worker.batch", 2_000.0, trace_id=tid,
                           parent=sp.span_id)],
        offset_us=0.0, uncertainty_us=10.0, worker=0)
    events = parse_chrome_trace(render_chrome_trace())
    by_name = {e["name"]: e for e in events}
    assert by_name["fleet.dispatch"]["args"]["trace_id"] == tid
    assert by_name["worker.batch"]["args"]["trace_id"] == tid
    assert by_name["worker.batch"]["args"]["parent_id"] == sp.span_id
    assert by_name["worker.batch"]["args"]["clock_offset_us"] == 0.0


def test_ingest_disabled_tracing_is_a_noop():
    set_tracing(False)
    got = ingest_foreign_spans([_worker_wire_span("worker.batch", 1.0)],
                               offset_us=0.0)
    assert got == [] and spans() == []


def test_ring_capacity_resizes_and_resets():
    set_ring_capacity(3)
    for i in range(5):
        end_span(start_span(f"s{i}"))
    assert [s.name for s in spans()] == ["s2", "s3", "s4"]
    with pytest.raises(ValueError, match="capacity"):
        set_ring_capacity(0)
    reset_tracing()
    for i in range(5):
        end_span(start_span(f"t{i}"))
    assert len(spans()) == 5


def test_chrome_events_of_an_explicit_span_list():
    a = end_span(start_span("a", n=1))
    end_span(start_span("b"))
    (ev,) = chrome_trace_events([a])
    assert ev["name"] == "a" and ev["args"]["n"] == 1


# -- the port against the reference ---------------------------------------------

@pytest.mark.parametrize("probe", [(1.000, 1.002, 1_051_000.0),
                                   (5.0, 5.5, 12.0),
                                   (2.0, 1.999, 2_000_000.0)])
def test_clock_offset_from_probe_is_the_reference(probe):
    assert clock_offset_from_probe(*probe) \
        == ref_trace.clock_offset_from_probe(*probe)


def _wire_batch():
    return [_worker_wire_span("worker.recv", 1_002_000.0, span_id="aa" * 8),
            _worker_wire_span("worker.batch", 1_052_000.0, span_id="bb" * 8,
                              parent="aa" * 8),
            {"name": "", "start_us": 1.0},                 # skipped: no name
            {"name": "bad", "start_us": "x"},              # skipped: bad ts
            "not a span",                                  # skipped
            {"name": "bare", "start_us": 1_003_000, "trace_id": "cd" * 16,
             "span_id": "ee" * 8}]


@pytest.mark.parametrize("kw", [
    {"offset_us": 0.0},
    {"offset_us": -50_000.0, "uncertainty_us": 1_000.0,
     "window_us": (1_000_000.0, 1_010_000.0), "worker": 3},
    {"offset_us": 0.0, "uncertainty_us": 500.0,
     "window_us": (1_000_000.0, 1_010_000.0), "worker": 0},
])
def test_ingest_foreign_spans_is_the_reference(kw):
    def fields(sp):
        return (sp.name, sp.trace_id, sp.span_id, sp.parent_id, sp.start_us,
                sp.dur_us, sp.wall_ts, sp.tid, sp.attrs)

    got = ingest_foreign_spans(_wire_batch(), **kw)
    want = ref_trace.ingest_foreign_spans(_wire_batch(), **kw)
    assert [fields(s) for s in got] == [fields(s) for s in want]
    assert [fields(s) for s in spans()] \
        == [fields(s) for s in ref_trace.spans()]
    # the merged rings render the same Chrome events but for the pid
    strip = [{k: v for k, v in e.items() if k != "pid"}
             for e in parse_chrome_trace(render_chrome_trace())]
    assert strip == [{k: v for k, v in e.items() if k != "pid"}
                     for e in ref_trace.parse_chrome_trace(
                         ref_trace.render_chrome_trace())]


def test_chrome_trace_written_by_either_package_parses_in_both(tmp_path):
    with span("cli.serve", cmd="serve"):
        pass
    with ref_trace.span("cli.serve", cmd="serve"):
        pass
    ours = write_chrome_trace(str(tmp_path / "port.json"))
    theirs = ref_trace.write_chrome_trace(str(tmp_path / "ref.json"))
    for path in (ours, theirs):
        text = open(path, encoding="utf-8").read()
        assert parse_chrome_trace(text) == ref_trace.parse_chrome_trace(text)


# -- crash points ---------------------------------------------------------------

@pytest.mark.parametrize("point", ["trace.after_tmp",
                                   "run_manifest.after_tmp"])
def test_crash_point_kills_only_at_its_point(tmp_path, monkeypatch, point):
    """Each writer reaches its own crash point once, between its durable
    tmp and the rename, and no other point fires there."""
    killed = []
    monkeypatch.setattr(chaos.os, "kill",
                        lambda pid, sig: killed.append((sig, point)))
    end_span(start_span("cli.serve"))

    def write(path):
        if point == "trace.after_tmp":
            return write_chrome_trace(path)
        return manifest.write_run_manifest(
            path, manifest.build_run_manifest(backend="cpu"))

    monkeypatch.delenv(chaos.KILL_ENV, raising=False)
    write(str(tmp_path / "a.json"))
    others = [p for p in chaos.CRASH_POINTS if p != point]
    for other in others:
        monkeypatch.setenv(chaos.KILL_ENV, other)
        write(str(tmp_path / "b.json"))
    assert killed == []
    assert point in chaos.CRASH_POINTS
    monkeypatch.setenv(chaos.KILL_ENV, point)
    monkeypatch.setenv(chaos.KILL_MATCH_ENV, "c.json")
    write(str(tmp_path / "b.json"))
    assert killed == []
    write(str(tmp_path / "c.json"))
    assert killed == [(signal.SIGKILL, point)]


_FLUSH_SCRIPT = """\
import sys
sys.path.insert(0, {repo!r})
from mfm_tpu_torch.obs.trace import end_span, start_span, write_chrome_trace
end_span(start_span("cli.serve"))
end_span(start_span("serve.request"))
write_chrome_trace({path!r})
"""


def _flush_in_subprocess(path, kill=False):
    env = dict(os.environ)
    env.pop("MFM_CHAOS_KILL", None)
    env.pop("MFM_CHAOS_KILL_MATCH", None)
    if kill:
        env["MFM_CHAOS_KILL"] = "trace.after_tmp"
    return subprocess.run(
        [sys.executable, "-c",
         _FLUSH_SCRIPT.format(repo=REPO, path=path)],
        env=env, capture_output=True, text=True, timeout=120)


def test_sigkill_mid_trace_flush_leaves_no_torn_file(tmp_path):
    path = str(tmp_path / "trace.json")
    proc = _flush_in_subprocess(path, kill=True)
    assert proc.returncode == -signal.SIGKILL, proc.stderr
    # the crash fell between tmp write and rename: no half-written
    # trace.json may exist for a reader to choke on
    assert not os.path.exists(path)
    assert _flush_in_subprocess(path).returncode == 0
    with open(path, encoding="utf-8") as fh:
        events = parse_chrome_trace(fh.read())
    assert [e["name"] for e in events] == ["cli.serve", "serve.request"]


# -- the JSONL mirror of spans ------------------------------------------------

def _events(path):
    return [json.loads(x) for x in open(path, encoding="utf-8")]


def test_export_spans_to_jsonl_events(tmp_path):
    from mfm_tpu_torch.obs.exporters import (
        EVENT_REQUIRED_KEYS,
        route_events_to,
    )

    log = str(tmp_path / "events.jsonl")
    with span("run", cmd="scenario"):
        pass
    route_events_to(log)
    try:
        assert export_spans_to_events() == 1
    finally:
        route_events_to(None)
    (ev,) = _events(log)
    for k in EVENT_REQUIRED_KEYS:
        assert k in ev
    assert ev["event"] == "span" and ev["name"] == "run"
    assert ev["attr_cmd"] == "scenario"
    assert len(ev["trace_id"]) == 32 and ev["dur_s"] >= 0.0


def test_export_spans_to_events_matches_the_reference(tmp_path):
    """The same spans mirrored by both packages give the same event lines,
    the wall-clock ``ts`` aside; an explicit list and the debug level
    too."""
    from mfm_tpu.obs import exporters as ref_exporters
    from mfm_tpu_torch.obs import exporters

    with span("cli.risk", trace_id="ab" * 16, cmd="risk"):
        with span("stage", name_attr="newey_west", dates=42, ok=True):
            pass
    sp = start_span("serve.request", request_id="q7")
    end_span(sp, outcome="ok", batch=3)
    open_span = start_span("still.open")   # dur_us None: exported as 0
    done = spans() + [open_span]
    lines = {}
    for name, ex, fn in (("port", exporters, export_spans_to_events),
                         ("ref", ref_exporters,
                          ref_trace.export_spans_to_events)):
        for level in ("info", "debug"):
            path = str(tmp_path / f"{name}_{level}.jsonl")
            ex.route_events_to(path, min_level="debug")
            try:
                assert fn(done, level=level) == 4
            finally:
                ex.route_events_to(None)
            lines[name, level] = [{k: v for k, v in e.items() if k != "ts"}
                                  for e in _events(path)]
    assert lines["port", "info"] == lines["ref", "info"]
    assert lines["port", "debug"] == lines["ref", "debug"]
    first = lines["port", "info"][0]
    assert first["level"] == "info" and first["attr_name_attr"] == \
        "newey_west" and first["attr_dates"] == 42
    assert lines["port", "info"][-1]["dur_s"] == 0.0
