"""The port's recovery matrix (``python -m mfm_tpu_torch.tools.faultinject``)
on the CPU at the reference's geometry (44 dates, a 32-date history, three
4-date slabs, 20 stocks, 3 industries, 2 styles, 8 draws): every ported
plan of the risk path's checkpoint passes — their contracts are bitwise —
and so does steady-state; a sabotaged run fails (a corrupted checkpoint
that a loader lets through, a poisoned date the guard lets through), so the
harness is not vacuous; every plan of the suite is ported, so a default
run lists none as not ported.  The serving
surfaces' plans run in ``test_torch_faultinject_service.py`` and
``test_torch_faultinject_fleet.py``.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from mfm_tpu_torch.tools import faultinject as fi
from mfm_tpu_torch.utils.chaos import plan_suite

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORTED = [p for p in plan_suite(0)
          if p.kind in fi.RUNNERS and p.kind not in fi.SERVICE_KINDS]


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("faultinject"))
    return fi.Baseline(root, 0, fi.Geometry(), torch.device("cpu")), root


def _run(plan, harness, name=None):
    base, root = harness
    if name:
        plan = plan.__class__(name, plan.kind, plan.seed, plan.params)
    return fi._run_plan(lambda: fi.RUNNERS[plan.kind](plan, base, root),
                        base, {"plan": plan.name})


def test_the_ported_plans_are_the_risk_path_plans():
    assert sorted(p.name for p in PORTED) == sorted([
        "truncate-tail-64", "truncate-half", "corrupt-8-bytes",
        "kill-after-tmp", "kill-after-rename", "nan-slab", "outlier-slab",
        "universe-collapse", "flaky-store", "kill-at-manifest",
        "eigen-kill-mid-update", "sync-schedule-coalescer",
        "sync-schedule-cache", "shard-kill-mid-append"])
    kinds = {p.kind for p in plan_suite(0)}
    assert kinds == set(fi.RUNNERS) | set(fi.NOT_PORTED_KINDS)
    assert not set(fi.RUNNERS) & set(fi.NOT_PORTED_KINDS)
    # the other 15 ported plans are the serving surfaces'; none is left
    assert fi.SERVICE_KINDS <= set(fi.RUNNERS)
    assert len([p for p in plan_suite(0) if p.kind in fi.RUNNERS]) == 29
    assert fi.NOT_PORTED_KINDS == {}


@pytest.mark.parametrize("plan", PORTED, ids=[p.name for p in PORTED])
def test_ported_plan_passes(harness, plan):
    rec = _run(plan, harness)
    assert rec["status"] == "pass", rec.get("error")
    if plan.kind in ("nan_slab", "outlier_slab", "universe_slab"):
        assert rec["quarantined"] == harness[0].slab_dates[0][2]
    if plan.kind == "kill":
        assert rec["pointer_healed"] == (plan.param("point")
                                         == "save_artifact.after_rename")


def test_steady_state_adds_no_compile_event(harness):
    base, root = harness
    rec = fi._run_plan(lambda: fi.run_steady_state(base, root), base, {})
    assert rec["status"] == "pass", rec.get("error")
    assert rec["compiles"] == 0 and rec["dates_served"] == 3
    assert rec["warmup_compiles"] >= 1


def test_sabotage_corrupt_checkpoint_loaded_clean_fails(harness,
                                                        monkeypatch):
    """A loader that swallows the corruption (falls back to the previous
    generation) must turn the byte-fault plans red."""
    base, _ = harness
    real = fi.Baseline.load
    art = __import__("mfm_tpu_torch.data.artifacts", fromlist=["x"])

    def forgiving(self, path):
        try:
            return real(self, path)
        except art.ArtifactCorruptError:
            fi._restore(os.path.dirname(path), self.snaps[0])
            return real(self, path)

    monkeypatch.setattr(fi.Baseline, "load", forgiving)
    plan = next(p for p in PORTED if p.name == "corrupt-8-bytes")
    rec = _run(plan, harness, name="sabotage-corrupt")
    assert rec["status"] == "FAIL"
    assert "corrupt checkpoint loaded clean" in rec["error"]


def test_sabotage_poisoned_date_not_quarantined_fails(harness, monkeypatch):
    """A guard that lets every date through must turn the poison plans red."""
    from mfm_tpu_torch.models import risk_model

    real = risk_model.guard_slab

    def blind(*a, **k):
        quarantined, reasons, ring, pos = real(*a, **k)
        return (torch.zeros_like(quarantined), torch.zeros_like(reasons),
                ring, pos)

    monkeypatch.setattr(risk_model, "guard_slab", blind)
    plan = next(p for p in PORTED if p.name == "outlier-slab")
    rec = _run(plan, harness, name="sabotage-poison")
    assert rec["status"] == "FAIL" and "NOT quarantined" in rec["error"]


def test_main_lists_the_plans_not_ported(tmp_path, monkeypatch, capsys):
    """A default run runs every plan and steady-state and lists none as
    not ported (the runners stubbed: the plans themselves run above and
    in the service and fleet files)."""
    ran = []
    monkeypatch.setattr(fi, "RUNNERS", {
        k: (lambda plan, base, root: ran.append(plan.name) or {})
        for k in fi.RUNNERS})
    monkeypatch.setattr(fi, "run_steady_state",
                        lambda base, root: ran.append("steady-state") or {})
    out = tmp_path / "f.json"
    assert fi.main(["--device", "cpu", "--out", str(out)]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    every = [p.name for p in plan_suite(0) if p.kind in fi.RUNNERS]
    assert sorted(ran) == sorted(every + ["steady-state"])
    assert len(every) == 29
    assert summary["plans"] == 30 and summary["failed"] == []
    listed = {r["plan"]: r["roadmap"] for r in summary["not_ported"]}
    assert listed == {}
    assert json.loads(out.read_text())["summary"] == summary


@pytest.mark.parametrize("name,item", [("query-steady-state", None),
                                       ("fleet-kill-host", None),
                                       ("shard-kill-mid-append", None)],
                         ids=["query-steady-state-None",
                              "fleet-kill-host-None",
                              "shard-kill-mid-append-§A 16"])
def test_asking_for_an_unported_plan_exits_naming_its_item(name, item,
                                                           tmp_path):
    """The three plans this case asked for before they were ported (the
    query and fleet plans, and the mesh's) now run by name and pass; an
    unported plan would exit naming its item."""
    out = tmp_path / "r.json"
    proc = subprocess.run(
        [sys.executable, "-m", "mfm_tpu_torch.tools.faultinject",
         "--device", "cpu", "--plans", f"nan-slab,{name}", "--out",
         str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    if item is not None:
        assert proc.returncode != 0
        assert name in proc.stderr and f"ROADMAP.md {item}" in proc.stderr
        assert "not ported" in proc.stderr
        return
    assert proc.returncode == 0, proc.stderr[-2000:]
    rep = json.loads(out.read_text())
    assert [r["plan"] for r in rep["results"]] == ["nan-slab", name]
    assert all(r["status"] == "pass" for r in rep["results"])


def test_cli_runs_a_chosen_plan(tmp_path):
    out = tmp_path / "r.json"
    proc = subprocess.run(
        [sys.executable, "-m", "mfm_tpu_torch.tools.faultinject",
         "--device", "cpu", "--plans", "flaky-store,steady-state",
         "--out", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    rep = json.loads(out.read_text())
    assert [r["plan"] for r in rep["results"]] == ["flaky-store",
                                                   "steady-state"]
    assert all(r["status"] == "pass" for r in rep["results"])
    assert rep["summary"]["geometry"]["T"] == 44
