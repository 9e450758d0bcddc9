"""The port's IR audit (``mfm_tpu_torch/analysis/``), against the
reference's (``mfm_tpu/analysis/``).

The reference's ``run_audit`` needs ``jax.experimental.disable_x64``,
which the installed JAX lacks, so its full audit cannot serve as the
oracle (its three failing tests in ``tests/test_audit.py``).  What runs
holds the port: the reference's registry (every entry point and cell by
name, role, mesh and bucket), its surface pass over those cells, its pure
verdict functions and ``mfm_tpu.lint``'s jit roots.

Four layers, as the reference's file:
 1. the real tree audits strict-clean on the CPU (A1–A4, the mesh cells
    on 8 virtual devices, at float32) against the committed baseline, and
    its finding keys are those of the snapshot the card sealed;
 2. fixtures pin each pass's verdicts, on the reference's pure functions
    where there are some and on toy entry points run through the audit's
    own runner where the port's probes are the evidence;
 3. registry completeness against the reference's jit roots, and every
    ``note_bucket`` site belongs to a registered entry point;
 4. the committed snapshot verifies, tampered and torn copies fail, and
    ``doctor --audit`` exits as the reference's.
"""

import ast
import importlib
import inspect
import json
from pathlib import Path

import pytest
import torch

from mfm_tpu.analysis import budgets as ref_budgets
from mfm_tpu.analysis import collectives as ref_collectives
from mfm_tpu.analysis import registry as ref_registry
from mfm_tpu.analysis import run as ref_run
from mfm_tpu.analysis import surface as ref_surface
from mfm_tpu_torch import cli
from mfm_tpu_torch._device import VIRTUAL_DEVICES_ENV
from mfm_tpu_torch.analysis import (
    aliasing,
    budgets,
    collectives,
    ir,
    run,
    surface,
)
from mfm_tpu_torch.analysis.registry import (
    NON_ENTRYPOINT,
    Cell,
    Entrypoint,
    Finding,
    Spec,
    registry,
    registry_by_name,
)
from mfm_tpu_torch.parallel.mesh import gather, make_mesh, shard_panel
from mfm_tpu_torch.utils import contracts

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _codes(findings):
    return sorted(f.code for f in findings)


@pytest.fixture(scope="module")
def cpu_audit():
    """The full CPU audit (A1–A4), once per session, the mesh cells on 8
    virtual devices."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(VIRTUAL_DEVICES_ENV, "8")
        return run.run_audit(
            passes=("A1", "A2", "A3", "A4"),
            baseline=run.load_audit_baseline(run.DEFAULT_BASELINE),
            device="cpu")


# -- layer 1: the real tree ---------------------------------------------------

def test_full_cpu_audit_is_strict_clean_and_fast(cpu_audit):
    rep = cpu_audit
    assert not rep.errors, "\n".join(f.key() + " " + f.message
                                     for f in rep.errors)
    assert rep.strict_clean and rep.stale_baseline == []
    assert rep.wall_s < 60, f"the CPU audit took {rep.wall_s} s"
    # every primary and mesh cell ran (no mesh-skipped), none measured
    assert len(rep.cells) == 28 and all(c["ran"] for c in rep.cells.values())
    assert not [f for f in rep.findings if f.code == "mesh-skipped"]
    assert rep.measured == {}
    # the primary cells moved nothing; the risk mesh cells only all-gather
    for key, entry in rep.cells.items():
        kinds = set(entry["collectives"]["by_kind"])
        if entry["role"] == "primary" or not key.startswith("risk."):
            assert entry["collectives"]["total"] == 0, key
        else:
            assert kinds == {"all-gather"}, key
    # float32 path: the only wide dtype is the baselined R^2 variance
    for key, entry in rep.cells.items():
        wide = {"float64", "complex128"} & set(entry["tensor_dtypes"])
        assert wide <= ({"float64"} if key.startswith("risk.") else set())


def _keys(findings) -> set:
    return {f["pass_id"] + ":" + f["entrypoint"] + ":" + f["cell"] + ":"
            + f["code"] if isinstance(f, dict) else f.key()
            for f in findings}


def test_cpu_audit_keys_equal_the_card_snapshot(cpu_audit):
    """One baseline serves the CPU and the card: the A1–A4 keys the CPU
    run fires equal those the card's sealed run fired."""
    doc = json.loads(Path(run.latest_snapshot_path()).read_text())
    card = {k for k in _keys(doc["findings"]) | _keys(doc["baselined"])
            if k[:2] in ("A1", "A2", "A3", "A4")}
    here = _keys(cpu_audit.findings) | _keys(cpu_audit.baselined)
    assert here == card
    assert doc["device"] != "cpu" and doc["measured"]


def test_baseline_notes_name_their_lines():
    entries = run.load_audit_baseline(run.DEFAULT_BASELINE)
    assert entries
    for e in entries:
        path = e["note"].split(":", 1)[0]
        assert (ROOT / path).exists(), e


# -- layer 2: the registry against the reference's ----------------------------

def _layout(reg) -> list:
    return [(ep.name, ep.ladder, sorted(ep.collectives_allow),
             [(c.name, c.role, tuple(c.mesh) if c.mesh else None, c.bucket)
              for c in ep.cells()]) for ep in reg]


def test_registry_names_roles_meshes_and_buckets_are_the_references():
    ref = ref_registry.registry()
    assert _layout(registry()) == _layout(ref)
    assert [ep.qualname for ep in registry()] == [ep.qualname for ep in ref]
    assert ref_registry.AUDIT_MATRIX == run.AUDIT_MATRIX
    n = sum(len(ep.cells()) for ep in registry())
    roles = [c.role for ep in registry() for c in ep.cells()]
    assert (n, roles.count("primary"), roles.count("mesh"),
            roles.count("ladder")) == (58, 17, 11, 30)


def _positional(fn) -> list:
    return [p.name for p in inspect.signature(fn).parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]


def test_donation_names_are_the_references_positions():
    """The port keeps the donation contract by operand name: the
    reference's ``donate=`` positions read through its function's
    parameter names, in order."""
    for ep, rep in zip(registry(), ref_registry.registry()):
        mod, _, name = rep.qualname.partition(":")
        ref_fn = getattr(importlib.import_module(mod), name)
        params = _positional(ref_fn)
        assert ep.donate == tuple(params[i] for i in rep.donate), ep.name
        ported = set(_positional(ep.fn)) | {
            n for c in ep.cells() for n in c.operands}
        # the init's incremental carry is born inside init_state
        missing = set(ep.donate) - ported
        assert missing <= {"eig_R", "eig_p", "eig_n"}, (ep.name, missing)


def test_cells_are_cheap_and_make_their_declared_operands():
    """Building the registry makes no tensor; a cell's maker makes the
    shapes and dtypes it declares (``run.bind_cell`` checks it), at float32."""
    ep = registry_by_name("scenario.sweep_chunk")
    cell = ep.cells()[0]
    assert all(isinstance(s, Spec) for n in cell.operands
               for s in (cell.operands[n] if isinstance(cell.operands[n],
                                                        tuple)
                         else (cell.operands[n],)))
    ops, call, check = run.bind_cell(ep, cell, CPU)
    assert check is None and len(ops["carry"]) == 6
    floats = [t for t in aliasing.tensors_of(ops) if t.is_floating_point()]
    assert floats and all(t.dtype == torch.float32 for t in floats)


# -- layer 2: A1 --------------------------------------------------------------

def _toy(fn, operands, donate=(), bucket=None, role="primary", mesh=None,
         make=None):
    cell = Cell("c", {n: Spec(tuple(v.shape), v.dtype)
                      for n, v in operands.items()}, {}, role=role,
                mesh=mesh, bucket=bucket)
    ep = Entrypoint(
        name="fx", qualname="-", port="-", fn=fn, donate=donate,
        build_cells=lambda: [cell],
        make=make or (lambda c, device: {n: v.clone()
                                         for n, v in operands.items()}),
        site="fx.site" if bucket else None)
    return ep, cell


def _run_toy(ep, cell, passes):
    art = {(ep, cell): run._run_cell(ep, cell, CPU, False)}
    return [f for p in passes for f in p.run_pass(art)], art[(ep, cell)]


def test_a1_undeclared_in_place_write_fires():
    def fn(x, y, *, device):
        y.add_(1.0)
        return x * 2.0

    ep, cell = _toy(fn, {"x": torch.ones(4), "y": torch.ones(4)},
                    donate=("x",))
    found, _ = _run_toy(ep, cell, [aliasing])
    assert _codes(f for f in found if f.severity == "error") == \
        ["nondonated-mutation"]
    assert "['y']" in found[0].message


def test_a1_undeclared_view_returned_fires():
    def fn(x, y, *, device):
        return x * 2.0, y[1:]

    ep, cell = _toy(fn, {"x": torch.ones(4), "y": torch.ones(4)},
                    donate=("x",))
    found, _ = _run_toy(ep, cell, [aliasing])
    assert [(f.severity, f.code) for f in found] == [
        ("error", "nondonated-alias"), ("info", "donated-unaliased")]


def test_a1_declared_write_and_alias_are_info_only():
    def fn(x, y, *, device):
        x.mul_(2.0)
        return x, y + 1.0

    ep, cell = _toy(fn, {"x": torch.ones(4), "y": torch.ones(4)},
                    donate=("x", "y"))
    found, _ = _run_toy(ep, cell, [aliasing])
    assert [(f.severity, f.code) for f in found] == [
        ("info", "donated-unaliased")]
    assert "['y']" in found[0].message


def test_a1_pure_verdicts_and_sharded_operands():
    before = {"a": [(0, 1)], "b": [(0, 2)]}
    after = {"a": [(1, 1)], "b": [(0, 2)]}
    found = aliasing.check_aliasing("ep", "c", {"b"}, before, after, {2})
    assert [(f.severity, f.code) for f in found] == [
        ("error", "nondonated-mutation")]
    # every shard of a ShardedPanel operand is a tensor the caller holds
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(VIRTUAL_DEVICES_ENV, "2")
        panel = shard_panel(torch.zeros(4, 2), make_mesh(2, 1, device="cpu"))
    snap = aliasing.operand_versions({"p": panel})
    assert len(snap["p"]) == 2
    panel.shards[(1, 0)].add_(1.0)
    assert aliasing.operand_versions({"p": panel})["p"] != snap["p"]


# -- layer 2: A2 --------------------------------------------------------------

def test_a2_float64_fires_and_int64_inside_does_not():
    def fn(x, *, device):
        idx = torch.arange(4)                     # int64: torch's default
        return x.double().sum() + x[idx].sum()

    ep, cell = _toy(fn, {"x": torch.ones(4)})
    found, art = _run_toy(ep, cell, [ir])
    assert _codes(found) == ["wide-dtype"]
    assert "float64" in found[0].message and "int64" not in found[0].message
    assert {"float64", "int64", "float32"} <= set(art["dtypes"])


def test_a2_item_and_data_shaped_ops_are_host_callbacks():
    def fn(x, *, device):
        n = int(x.sum().item())
        return x[x > 0] * n

    ep, cell = _toy(fn, {"x": torch.ones(4)})
    found, _ = _run_toy(ep, cell, [ir])
    assert _codes(found) == ["host-callback"]
    assert "_local_scalar_dense" in found[0].message
    assert "bool mask" in found[0].message


def test_a2_int64_at_a_bucket_fires():
    def fn(w, bidx, *, device):
        return w[bidx.long()]

    ep, cell = _toy(fn, {"w": torch.ones(8, 3),
                         "bidx": torch.zeros(8, dtype=torch.int64)},
                    bucket=8)
    found, _ = _run_toy(ep, cell, [ir])
    assert _codes(found) == ["wide-dtype"]
    assert "int64 at fx.site" in found[0].message
    ep32, cell32 = _toy(fn, {"w": torch.ones(8, 3),
                             "bidx": torch.zeros(8, dtype=torch.int32)},
                        bucket=8)
    assert _run_toy(ep32, cell32, [ir])[0] == []


def test_a2_int64_at_the_eigh_dispatcher_fires():
    from mfm_tpu_torch.ops.eigh import batched_eigh

    with ir.probe() as rec:
        batched_eigh(torch.eye(3, dtype=torch.float64)[None])
    assert ("batched_eigh", ("float64",)) in rec["boundary"]
    found = ir.scan_run("ep", "c", rec["dtypes"], rec["host_reads"],
                        rec["boundary"])
    assert "float64 at batched_eigh" in found[0].message
    assert contracts._PROBES == []


# -- layer 2: A3 --------------------------------------------------------------

def test_a3_summaries_and_verdicts_are_the_references():
    panel_bytes = 64 * 48 * 4
    text = "%all-gather.1 = f32[64,48]{1,0} all-gather(f32[64,24]{1,0} %p0)"
    assert collectives.summarize([("all-gather", panel_bytes)]) == \
        ref_collectives.audit_hlo(text)
    cases = [(collectives.summarize([("all-gather", panel_bytes)]),
              frozenset({"all-reduce"})),
             (collectives.summarize([("all-reduce", 14 * 14 * 4)]),
              frozenset({"all-reduce"})),
             (collectives.summarize([]), frozenset())]
    for summary, allow in cases:
        got = collectives.check_collectives(
            "ep", "mesh4x2", summary, allow=allow, panel_bytes=panel_bytes,
            gather_budget=1024)
        want = ref_collectives.check_collectives(
            "ep", "mesh4x2", summary, allow=allow, panel_bytes=panel_bytes,
            gather_budget=1024)
        assert [f.to_dict() for f in got] == [f.to_dict() for f in want]
    for T, K in ((64, 9), (192, 13), (1390, 42)):
        assert collectives.eigh_gather_budget(T, K) == \
            ref_collectives.eigh_gather_budget(T, K)


def test_a3_panel_sized_gather_in_a_mesh_cell_fires():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(VIRTUAL_DEVICES_ENV, "8")
        mesh = make_mesh(2, 4, device="cpu")
        x = shard_panel(torch.ones(64, 48), mesh)
        with collectives.probe() as events:
            whole = gather(x)
    summary = collectives.summarize(
        [(k, b) for k, b, _ in events])
    assert summary["by_kind"] == {"all-gather": 1}
    assert summary["largest_bytes"] == whole.numel() * 4 == 64 * 48 * 4
    found = collectives.check_collectives(
        "ep", "mesh2x4", summary, allow=frozenset({"all-gather"}),
        panel_bytes=64 * 48 * 4, gather_budget=1024)
    assert _codes(found) == ["full-panel-collective", "gather-over-budget"]
    # the gather of a call's own output is placement, not a collective
    inside, placed = collectives.split_output_gathers(events, whole)
    assert inside == [] and placed == 64 * 48 * 4


def test_a3_primary_cell_with_a_collective_fires():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(VIRTUAL_DEVICES_ENV, "8")
        mesh = make_mesh(2, 4, device="cpu")

        def fn(x, *, device):
            return gather(shard_panel(x, mesh)).sum(0) + 1.0

        ep, cell = _toy(fn, {"x": torch.ones(8, 8)})
        found, art = _run_toy(ep, cell, [collectives])
    assert _codes(found) == ["unsharded-collective"]
    assert art["collectives"]["total"] == 1


def test_a3_mesh_cell_without_devices_is_skipped_with_a_warn():
    ep = registry_by_name("grad.minvol")
    cell = next(c for c in ep.cells() if c.role == "mesh")
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv(VIRTUAL_DEVICES_ENV, raising=False)
        art = {(ep, cell): run._run_cell(ep, cell, CPU, False)}
    found = collectives.run_pass(art)
    assert [(f.severity, f.code) for f in found] == [("warn", "mesh-skipped")]


def test_a3_replicated_mesh_cell_moves_nothing():
    ep = registry_by_name("grad.sensitivity")
    cell = next(c for c in ep.cells() if c.role == "mesh")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(VIRTUAL_DEVICES_ENV, "8")
        art = run._run_cell(ep, cell, CPU, False)
    assert art["ran"] and art["collectives"]["total"] == 0


# -- layer 2: A4 --------------------------------------------------------------

def _ladder_cells(idx_dtype=torch.int32, buckets=(8, 32, 128), n=3):
    return [Cell(f"bucket{b}", {"w": Spec((b, 9), torch.float32),
                                "idx": Spec((b,), idx_dtype)},
                 {"n": n}, role="ladder", bucket=b) for b in buckets]


def test_a4_clean_ladder_and_the_s64_trap():
    cells = _ladder_cells()
    assert surface.check_ladder("q", "query", cells) == []
    drift = _ladder_cells()[:2] + _ladder_cells(torch.int64, (128,))
    found = surface.check_ladder("q", "query", drift)
    assert "ladder-dtype-drift" in _codes(found)
    assert any("retrace" in f.message for f in found)


def test_a4_duplicate_collision_static_and_fixed_point():
    found = surface.check_ladder("q", "query", _ladder_cells(buckets=(8, 8)))
    assert {"duplicate-bucket", "bucket-key-collision"} <= set(_codes(found))
    drift = _ladder_cells(buckets=(8,)) + _ladder_cells(buckets=(32,), n=4)
    assert _codes(surface.check_ladder("q", "query", drift)) == \
        ["ladder-static-drift"]
    found = surface.check_ladder("q", "query", _ladder_cells(buckets=(8, 100)))
    assert "bucket-not-fixed-point" in _codes(found)


def test_a4_ladders_are_the_references():
    """Per ladder the reference's buckets and distinct-key counts, and
    both surface passes clean over the real registries."""
    ref = {ep.name: ep for ep in ref_registry.registry()}
    for ep in registry():
        if ep.ladder is None:
            continue
        rungs = [c for c in ep.cells() if c.role == "ladder"]
        ref_rungs = [c for c in ref[ep.name].cells() if c.role == "ladder"]
        assert [c.bucket for c in rungs] == [c.bucket for c in ref_rungs]
        assert len({surface.cache_key(c, ep) for c in rungs}) == \
            len({ref_surface.cache_key(c) for c in ref_rungs}) == len(rungs)
        assert surface.check_ladder(ep.name, ep.ladder, rungs, ep) == []
    cells_by_ep = {ep: ep.cells() for ep in registry()}
    assert surface.run_pass(registry(), cells_by_ep) == []


def test_a4_key_is_what_the_compile_contract_counter_records(monkeypatch):
    """A ladder rung's key is the signature ``note_bucket`` records at
    the entry point's site (less the device)."""
    from mfm_tpu_torch.serve.query import QueryEngine

    monkeypatch.setattr(contracts, "_SEEN", set())
    ep = registry_by_name("query.factor")
    rung = next(c for c in ep.cells() if c.role == "ladder")
    eng = QueryEngine(torch.eye(9, dtype=torch.float32).numpy(),
                      device="cpu")
    with contracts.count_compiles():
        eng.query(torch.ones(3, 9).numpy(), bucket=rung.bucket)
    (sig,) = [s for s in contracts._SEEN if s[0] == contracts.QUERY_BATCH]
    assert sig[:3] == surface.cache_key(rung, ep)[0]


# -- layer 2: A5 --------------------------------------------------------------

def _budget_doc(cells):
    return {"schema": budgets.BUDGETS_SCHEMA, "tolerance": 0.25,
            "cells": cells}


def test_a5_measure_cell_is_the_references():
    for mem in ({"temp_bytes": 10, "argument_bytes": 100, "output_bytes": 50,
                 "alias_bytes": 40, "generated_code_bytes": 0},
                {"argument_bytes": 7, "output_bytes": 3}):
        assert budgets.measure_cell(mem) == ref_budgets.measure_cell(mem)


def test_a5_over_stale_unbudgeted_and_floor_are_the_references():
    cells = {
        "a/over": {"temp_bytes": 1_000_000, "workspace_bytes": 1_000_000},
        "a/stale": {"temp_bytes": 4_000_000, "workspace_bytes": 4_000_000},
        "a/tiny": {"temp_bytes": 1_000, "workspace_bytes": 1_000},
        "a/gone": {"temp_bytes": 1, "workspace_bytes": 1},
    }
    measured = {
        "a/over": {"temp_bytes": 2_000_000, "workspace_bytes": 1_000_000},
        "a/stale": {"temp_bytes": 1_000_000, "workspace_bytes": 4_000_000},
        "a/tiny": {"temp_bytes": 5_000, "workspace_bytes": 5_000},
        "a/new": {"temp_bytes": 1, "workspace_bytes": 1},
    }
    got = budgets.check_budgets(measured, _budget_doc(cells))
    want = ref_budgets.check_budgets(
        measured, {**_budget_doc(cells), "schema": ref_budgets.BUDGETS_SCHEMA})
    assert [(f.key(), f.severity) for f in got] == \
        [(f.key(), f.severity) for f in want]
    assert {(f.code, f.severity) for f in got} == {
        ("over-temp_bytes", "error"), ("stale-temp_bytes", "warn"),
        ("unbudgeted", "error"), ("stale-budget", "error")}
    assert budgets.FLOOR_BYTES == ref_budgets.FLOOR_BYTES
    assert budgets.DEFAULT_TOLERANCE == ref_budgets.DEFAULT_TOLERANCE


def test_a5_committed_budgets_cover_exactly_the_budgeted_cells(tmp_path):
    doc = budgets.load_budgets()
    assert set(doc["cells"]) == run.expected_cells()
    # the atomic writer round-trips and leaves no temp file
    p = tmp_path / "b.json"
    budgets.write_budgets(doc["cells"], str(p))
    assert budgets.load_budgets(str(p))["cells"] == doc["cells"]
    assert not (tmp_path / "b.json.tmp").exists()


def test_a5_refuses_the_cpu():
    with pytest.raises(ValueError, match="allocation peak"):
        run.run_audit(passes=("A5",), device="cpu")
    assert run.main(["--device", "cpu", "--passes", "A5"]) == 2


# -- layer 3: completeness ----------------------------------------------------

def test_registry_covers_every_reference_jit_root():
    from mfm_tpu.lint import REPO_ROOT, Linter, collect_files

    lint = Linter()
    for f in collect_files(["mfm_tpu"], REPO_ROOT):
        lint.add_file(f, relto=REPO_ROOT)
    lint.build()
    roots = set(lint.jit_roots)
    registered = {ep.qualname for ep in registry()}
    assert not registered & set(NON_ENTRYPOINT)
    assert registered | set(NON_ENTRYPOINT) == roots
    assert set(NON_ENTRYPOINT) == set(ref_registry.NON_ENTRYPOINT_JITS)
    # each port counterpart resolves
    for ep in registry():
        mod, _, qual = ep.port.partition(":")
        obj = importlib.import_module(mod)
        for part in qual.split("."):
            obj = getattr(obj, part)


def _note_bucket_sites() -> set:
    """Every ``note_bucket`` call site's ``where`` in the port, resolved
    (an f-string over a solver expands over ``grad/engine.SOLVERS``)."""
    from mfm_tpu_torch.grad.engine import SOLVERS

    sites = set()
    for path in sorted((ROOT / "mfm_tpu_torch").rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and getattr(node.func, "attr", None) == "note_bucket"):
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Attribute):
                sites.add(getattr(contracts, arg.attr))
            else:
                assert isinstance(arg, ast.JoinedStr), ast.dump(arg)
                sites |= {f"{contracts.CONSTRUCT_SOLVE}/{s}" for s in SOLVERS}
    return sites


def test_every_note_bucket_site_belongs_to_a_registered_entrypoint():
    sites = _note_bucket_sites()
    assert len(sites) == 6
    assert sites == {ep.site for ep in registry() if ep.site}


# -- layer 4: the committed snapshot and the doctor ---------------------------

def test_committed_snapshot_verifies():
    snap = run.latest_snapshot_path()
    assert snap and Path(snap).parent == Path(run.TOOLS_DIR)
    problems, warns, doc = run.verify_snapshot(snap)
    assert problems == [], problems
    assert doc["strict_clean"] and len(doc["cells"]) == 28
    assert doc["measured"] == budgets.load_budgets()["cells"]


def test_report_digest_is_the_references():
    doc = json.loads(Path(run.latest_snapshot_path()).read_text())
    assert run.report_digest(doc) == ref_run.report_digest(doc) == \
        doc["sha256"]


def test_tampered_and_torn_snapshots_fail(tmp_path):
    doc = json.loads(Path(run.latest_snapshot_path()).read_text())
    forged = dict(doc, findings=[])
    p = tmp_path / "forged.json"
    p.write_text(json.dumps(forged))
    problems, _, _ = run.verify_snapshot(str(p))
    assert any("seal digest mismatch" in m for m in problems)

    lying = dict(doc, strict_clean=False)
    lying["sha256"] = run.report_digest(lying)
    p2 = tmp_path / "lying.json"
    p2.write_text(json.dumps(lying))
    problems, _, _ = run.verify_snapshot(str(p2))
    assert any("NOT strict-clean" in m for m in problems)

    stale = dict(doc, measured={})
    stale["sha256"] = run.report_digest(stale)
    p3 = tmp_path / "stale.json"
    p3.write_text(json.dumps(stale))
    problems, _, _ = run.verify_snapshot(str(p3))
    assert any("disagree with audit_budgets.json" in m for m in problems)

    p4 = tmp_path / "torn.json"
    p4.write_text(json.dumps(doc)[: len(json.dumps(doc)) // 2])
    problems, _, d = run.verify_snapshot(str(p4))
    assert d is None and problems


def test_doctor_audit_exit_codes(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["doctor", "--audit"])
    assert e.value.code == 0
    rec = json.loads(capsys.readouterr().out)["records"][0]
    assert rec["kind"] == "audit_snapshot" and rec["status"] == "ok"

    torn = tmp_path / "torn.json"
    torn.write_text('{"schema": "mfmaudit-torch/1", "cells": {')
    with pytest.raises(SystemExit) as e:
        cli.main(["doctor", "--audit", str(torn)])
    assert e.value.code == 1
    rec = json.loads(capsys.readouterr().out)["records"][0]
    assert rec["status"] == "corrupt"

    with pytest.raises(SystemExit) as e:
        cli.main(["doctor"])
    assert "PATH is required" in str(e.value)


def test_findings_key_schema_is_the_references():
    args = ("A1", "error", "risk.fused", "base", "nondonated-alias", "m")
    assert Finding(*args).key() == ref_registry.Finding(*args).key() == \
        "A1:risk.fused:base:nondonated-alias"
    assert Finding(*args).to_dict() == ref_registry.Finding(*args).to_dict()


def test_audit_baseline_suppression_and_stale_detection():
    fake = [{"key": "A4:ghost.ep:ladder:empty-ladder", "note": "test"}]
    rep = run.run_audit(passes=("A4",), baseline=fake, device="cpu")
    assert rep.stale_baseline == ["A4:ghost.ep:ladder:empty-ladder"]
    assert not rep.strict_clean
    assert run.main(["--device", "cpu", "--passes", "A4", "--strict"]) == 0

