"""BENCHMARK.json and the harness's files: names, units, keys, and the
discovery of configurations, traffic mixes and metrics by file name."""

import json
import re
import time

import pytest

from conftest import ROOT, cell_of, tiny_copy
from mfmbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_names_and_units(bench):
    assert set(bench) == TOP
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in bench["paths"])
    assert len(bench["command"]) <= 32 and all(map(_line, bench["command"]))
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and _line(w["why"])
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")


def test_every_cell_reports_setup_another_end_to_end_and_a_layer(bench):
    cells = [w["name"] for w in bench["workloads"]]
    for cell in cells:
        e2e = [m["name"] for m in harness.metrics_for(bench, cell, 0)]
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = harness.metrics_for(bench, cell, 1)
        assert layers
        # a per-layer metric moves an end-to-end metric its cells report
        assert all(m["moves"] in e2e for m in layers)


def test_every_name_is_a_file(bench):
    base = ROOT / "mfmbench"
    for w in bench["workloads"]:
        traffic = json.loads((base / "traffic" / f"{w['traffic']}.json")
                             .read_text())
        assert (base / "configs" / f"{w['config']}.json").is_file()
        assert (base / "loops" / f"{traffic['loop']}.py").is_file()
        assert (base / "limits" / f"{w['name']}.json").is_file()
    for m in bench["end_to_end"] + bench["per_layer"]:
        reader = harness.load_module(base / "metrics" / f"{m['name']}.py")
        assert reader.read({}) is None  # nothing to read: no reading


@pytest.mark.parametrize("cell", ["alla.rebuild", "alla.alpha"])
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_keys(tiny, bench, cell, trace):
    r = harness.run_cell(bench, cell_of(bench, cell), 2**31 + 11, 0.5, trace,
                         "cpu", time.time(), base=tiny)
    want = ["correct", "attempted", "failed", "metrics", "device"]
    if trace:
        want.append("breakdown")
    assert list(r) == want + ["checked"]  # the compared numbers come last
    assert r["correct"] is True and r["failed"] == 0
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    kinds = {m["name"] for m in harness.metrics_for(bench, cell, trace)}
    assert set(r["metrics"]) <= kinds
    if not trace:
        assert set(r["metrics"]) == kinds
    json.dumps(r, allow_nan=False)


def test_new_files_are_found_by_name(tmp_path, bench):
    """A traffic mix, a metric and a cell added as files of their own run
    without an edit to any file already there."""
    base = tiny_copy(tmp_path)
    traffic = json.loads((base / "traffic" / "rebuild.json").read_text())
    (base / "traffic" / "rebuild2.json").write_text(
        json.dumps(dict(traffic, ring=2)))
    (base / "metrics" / "rebuilds_done.py").write_text(
        "def read(rec):\n    return rec.get('rebuilds')\n")
    (base / "limits" / "alla.rebuild2.json").write_text(
        (base / "limits" / "alla.rebuild.json").read_text())
    cell = {"name": "alla.rebuild2", "config": "alla",
            "traffic": "rebuild2", "chips": 1, "why": "test"}
    grown = dict(bench, workloads=bench["workloads"] + [cell],
                 end_to_end=bench["end_to_end"] + [
                     {"name": "rebuilds_done", "unit": "rebuilds",
                      "better": "higher", "bound": 0.25,
                      "source": "host_clock",
                      "workloads": ["alla.rebuild2"]}])
    r = harness.run_cell(grown, cell, 5, 0.5, 0, "cpu", time.time(),
                         base=base)
    assert r["correct"] and r["metrics"]["rebuilds_done"]["value"] >= 1
    assert "rebuild_s" not in r["metrics"]
