"""The audit driver: build cells, run each once under the probes, apply
A1–A5 (counterpart of ``mfm_tpu/analysis/run.py``).

The reference lowers every cell from avals and compiles it for the CPU,
executing nothing.  The port has no program to lower, so each primary
and mesh cell runs once on concrete operands made from the seed at
float32 (``analysis/registry.py``), on ``device`` (the card unless the
caller asks for the CPU), and every pass reads that one run:

- A1 (``aliasing``) the operands' versions and storages around it and
  the outputs' storages;
- A2 (``ir``) the dispatch-mode probe's dtypes and host reads, the
  signature boundaries, the card's sync count;
- A3 (``collectives``) what ``parallel/mesh.py``'s collectives moved;
- A4 (``surface``) runs nothing: it reads the ladder cells' specs;
- A5 (``budgets``) the run's memory, measured on the card only, after a
  first run of the cell on operands of its own.

Ladder cells never run.  A mesh cell needs ``n_date * n_stock`` devices
(:func:`main` sets ``MFM_TORCH_VIRTUAL_DEVICES=8`` when it is unset).

Baseline contract (the reference's): a committed JSON list of ``{"key",
"note"}`` suppresses known findings by exact key; suppressed keys of the
passes run that no longer fire are STALE and fail ``--strict``, so the
baseline can only shrink.  The report, the baseline and the budgets live in
``mfm_tpu_torch/tools/`` (``AUDIT_r*.json``, ``mfmaudit_baseline.json``,
``audit_budgets.json``), beside the lint and sync baselines.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import hashlib
import json
import os
import sys
import time

from mfm_tpu_torch.analysis import aliasing, budgets, collectives, ir, surface
from mfm_tpu_torch.analysis.registry import AUDIT_MATRIX, leaves, registry

AUDIT_SCHEMA = "mfmaudit-torch/1"

PASS_IDS = ("A1", "A2", "A3", "A4", "A5")

TOOLS_DIR = budgets.TOOLS_DIR
DEFAULT_BASELINE = os.path.join(TOOLS_DIR, "mfmaudit_baseline.json")


@dataclasses.dataclass
class AuditReport:
    findings: list
    baselined: list
    stale_baseline: list
    measured: dict            # "ep/cell" -> budget metrics
    cells: dict               # "ep/cell" -> cell evidence
    matrix: dict
    passes: tuple
    device: str
    wall_s: float

    @property
    def errors(self) -> list:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def strict_clean(self) -> bool:
        return not self.errors and not self.stale_baseline

    def to_dict(self) -> dict:
        import torch

        return {
            "schema": AUDIT_SCHEMA,
            "torch": torch.__version__,
            "device": self.device,
            "matrix": dict(self.matrix),
            "passes": list(self.passes),
            "cells": self.cells,
            "measured": {k: dict(v) for k, v in sorted(self.measured.items())},
            "findings": [f.to_dict() for f in self.findings],
            "baselined": [f.to_dict() for f in self.baselined],
            "stale_baseline": list(self.stale_baseline),
            "summary": {
                "errors": len(self.errors),
                "warnings": sum(1 for f in self.findings
                                if f.severity == "warn"),
                "info": sum(1 for f in self.findings
                            if f.severity == "info"),
                "cells": len(self.cells),
            },
            "strict_clean": self.strict_clean,
            "wall_s": round(self.wall_s, 2),
        }


# -- running a cell -----------------------------------------------------------

def _flatten(tree) -> tuple:
    """``(leaves, rebuild)`` of a tuple tree of tensors (None kept)."""
    if isinstance(tree, tuple):
        parts = [_flatten(x) for x in tree]
        sizes = [len(p[0]) for p in parts]

        def rebuild(flat):
            out, i = [], 0
            for (_, rb), n in zip(parts, sizes):
                out.append(rb(flat[i:i + n]))
                i += n
            return tuple(out)

        return [x for p in parts for x in p[0]], rebuild
    return [tree], lambda flat: flat[0]


def bind_cell(ep, cell, device, mesh=None) -> tuple:
    """``(operands, call, check)``: the cell's operands made on ``device``
    (laid out on ``mesh`` for a mesh cell, before the call: placement is
    not part of it), a thunk that calls the entry point on them, and a
    check of its result run after the probes (a replicated mesh cell's
    positions must agree bitwise; None elsewhere)."""
    from mfm_tpu_torch.analysis.aliasing import tensors_of
    from mfm_tpu_torch.parallel.mesh import (
        PIPELINE_SPECS,
        NamedSharding,
        P,
        device_put,
        map_shards,
        replicate,
        use_mesh,
    )
    from mfm_tpu_torch.utils.obs import _same

    ops = ep.make(cell, device)
    for name, spec in cell.operands.items():
        got = leaves(ops.get(name))
        want = leaves(spec)
        if [(tuple(t.shape), t.dtype) for t in got] != \
                [(s.shape, s.dtype) for s in want]:
            raise ValueError(f"{ep.name}/{cell.name}: operand {name!r} made "
                             f"at {[(tuple(t.shape), t.dtype) for t in got]}, "
                             f"declared {want}")
    statics = dict(cell.statics)
    if mesh is None:
        return ops, lambda: ep.fn(**ops, **statics, device=device), None
    if not ep.replicated:
        ops = {n: (device_put(v, NamedSharding(mesh, PIPELINE_SPECS[n]))
                   if n in PIPELINE_SPECS and n != "sim_covs" else v)
               for n, v in ops.items()}

        def call():
            with use_mesh(mesh):
                return ep.fn(**ops, **statics, device=device)

        return ops, call, None
    names = list(ops)
    flat, rebuilds, sizes = [], [], []
    for n in names:
        lv, rb = _flatten(ops[n])
        flat += lv
        rebuilds.append(rb)
        sizes.append(len(lv))
    placed = [replicate(t, mesh) for t in flat]

    def one(*shards):
        kw, i = {}, 0
        for n, rb, k in zip(names, rebuilds, sizes):
            kw[n] = rb(list(shards[i:i + k]))
            i += k
        return tuple(tensors_of(ep.fn(**kw, **statics, device=device)))

    def call():
        return map_shards(one, *placed, out_specs=P())

    def check(out):
        for o in (out if isinstance(out, tuple) else (out,)):
            first = next(iter(o.shards.values()))
            if not all(_same(s.to(first.device), first, 0.0)
                       for s in o.shards.values()):
                raise RuntimeError(f"{ep.name}/{cell.name}: mesh positions "
                                   "computed different bits on replicated "
                                   "operands")

    placed_ops, i = {}, 0
    for n, k in zip(names, sizes):
        placed_ops[n] = placed[i:i + k]
        i += k
    return placed_ops, call, check


def _run_cell(ep, cell, device, measure: bool) -> dict:
    """The evidence of one cell's run (``{}`` for a mesh cell with too few
    devices)."""
    import torch

    from mfm_tpu_torch._device import mesh_devices
    from mfm_tpu_torch.parallel.mesh import make_mesh
    from mfm_tpu_torch.utils.obs import force, measured_call

    mesh = None
    if cell.role == "mesh":
        if len(mesh_devices(device)) < cell.mesh[0] * cell.mesh[1]:
            return {}
        mesh = make_mesh(*cell.mesh, device=device)
    if measure:   # warm-up: cuBLAS's workspace, the kernel library's load
        _, warm, _ = bind_cell(ep, cell, device, mesh)
        force(aliasing.tensors_of(warm()))
        del warm
    ops, call, check = bind_cell(ep, cell, device, mesh)
    flat = aliasing.tensors_of(ops)
    before = aliasing.operand_versions(ops)
    on_card = torch.device(device).type == "cuda"
    res = []

    def run_once(*_):
        res.append(call())
        return aliasing.tensors_of(res[0])

    with collectives.probe() as events, ir.probe(on_card) as rec:
        out, mem = (measured_call(run_once, *flat) if measure
                    else (run_once(), None))
    after = aliasing.operand_versions(ops)
    if check is not None:
        check(res[0])
    boundary = list(rec["boundary"])
    if cell.bucket is not None:
        boundary.append((ep.site or ep.name, tuple(
            str(t.dtype).removeprefix("torch.")
            for t in aliasing.tensors_of(
                [ops[n] for n in (ep.padded or tuple(ops))]))))
    inside, placed = collectives.split_output_gathers(events, out)
    art = {"ran": True, "before": before, "after": after,
           "out_storages": aliasing.output_storages(out),
           "dtypes": sorted(rec["dtypes"]), "host_reads": rec["host_reads"],
           "boundary": boundary, "syncs": rec["syncs"] if on_card else None,
           "collectives": collectives.summarize(inside),
           "output_gather_bytes": placed}
    if mem is not None:
        art["memory"] = mem
    return art


def _run_cells(entrypoints, cells_by_ep, device, measure: bool) -> dict:
    artifacts = {}
    for ep in entrypoints:
        for cell in cells_by_ep[ep]:
            if cell.role != "ladder":
                artifacts[(ep, cell)] = _run_cell(ep, cell, device, measure)
    return artifacts


# -- the report ---------------------------------------------------------------

def report_digest(doc: dict) -> str:
    """Content hash of a report payload, excluding the embedded hash
    itself.  ``doctor --audit`` recomputes this over the committed
    AUDIT_r*.json — a hand-edited or re-formatted snapshot no longer
    matches and the doctor refuses it."""
    body = {k: v for k, v in doc.items() if k != "sha256"}
    blob = json.dumps(body, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()


def write_report(doc: dict, path: str) -> dict:
    """Seal ``doc`` with its digest and write it atomically."""
    doc = dict(doc)
    doc["sha256"] = report_digest(doc)
    budgets.write_json_atomic(doc, path)
    return doc


def load_audit_baseline(path: str | None) -> list:
    if not path or not os.path.exists(path):
        return []
    with open(path, encoding="utf-8") as fh:
        entries = json.load(fh)
    for e in entries:
        if "key" not in e or "note" not in e:
            raise ValueError(f"audit baseline entry missing key/note: {e}")
    return entries


def run_audit(passes=PASS_IDS, baseline: list | None = None,
              budgets_path: str | None = None, device=None) -> AuditReport:
    """Run every registered cell once under the probes and apply the
    passes.  Writes no file (the CLI owns report and budget IO).  A5
    measures the card's allocation peak, so asking for it on the CPU
    raises."""
    from mfm_tpu_torch._device import resolve_device

    passes = tuple(passes)
    unknown = set(passes) - set(PASS_IDS)
    if unknown:
        raise ValueError(f"unknown audit passes {sorted(unknown)}")
    device = resolve_device(device)
    measure = "A5" in passes
    if measure and device.type != "cuda":
        raise ValueError(
            "pass A5 measures the card's allocation peak and the CPU keeps "
            "none (utils/obs.compiled_memory): run it with --device cuda, "
            "or leave A5 out of --passes on the CPU")
    t0 = time.perf_counter()
    entrypoints = registry()
    cells_by_ep = {ep: ep.cells() for ep in entrypoints}
    need_run = bool({"A1", "A2", "A3", "A5"} & set(passes))
    artifacts = (_run_cells(entrypoints, cells_by_ep, device, measure)
                 if need_run else {})
    findings: list = []
    if "A1" in passes:
        findings += aliasing.run_pass(artifacts)
    if "A2" in passes:
        findings += ir.run_pass(artifacts)
    if "A3" in passes:
        findings += collectives.run_pass(artifacts)
    if "A4" in passes:
        findings += surface.run_pass(entrypoints, cells_by_ep)
    measured: dict = {}
    if "A5" in passes:
        b_findings, measured = budgets.run_pass(
            artifacts, budgets_path or budgets.DEFAULT_BUDGETS_PATH)
        findings += b_findings

    # evidence per cell (rides into AUDIT_r*.json)
    cells = {}
    for (ep, cell), art in artifacts.items():
        entry = {"role": cell.role, "ran": bool(art.get("ran"))}
        if cell.mesh:
            entry["mesh"] = list(cell.mesh)
        if art.get("ran"):
            entry.update(collectives=art["collectives"],
                         output_gather_bytes=art["output_gather_bytes"],
                         tensor_dtypes=art["dtypes"],
                         host_callbacks=len(art["host_reads"]))
            if art["syncs"] is not None:
                entry["syncs"] = art["syncs"]
        cells[f"{ep.name}/{cell.name}"] = entry

    baseline = baseline or []
    keys = {e["key"] for e in baseline}
    fired = {f.key() for f in findings if f.key() in keys}
    kept = [f for f in findings if f.key() not in keys]
    suppressed = [f for f in findings if f.key() in keys]
    # an entry of a pass this run left out cannot be judged
    stale = sorted(k for k in keys - fired if k.split(":", 1)[0] in passes)
    return AuditReport(
        findings=kept, baselined=suppressed, stale_baseline=stale,
        measured=measured, cells=cells, matrix=AUDIT_MATRIX, passes=passes,
        device=_device_name(device), wall_s=time.perf_counter() - t0)


def _device_name(device) -> str:
    import torch

    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def latest_snapshot_path(root: str = TOOLS_DIR) -> str | None:
    """The newest committed ``AUDIT_r*.json`` in ``root``, or None."""
    found = sorted(glob.glob(os.path.join(root, "AUDIT_r*.json")))
    return found[-1] if found else None


def expected_cells() -> set:
    """The ``ep/cell`` keys of the live registry's primary and mesh
    cells."""
    return {f"{ep.name}/{cell.name}" for ep in registry()
            for cell in ep.cells() if cell.role != "ladder"}


def verify_snapshot(path: str, budgets_path: str | None = None):
    """``doctor --audit``: is the committed audit snapshot intact,
    strict-clean, and still describing THIS tree?

    Returns ``(problems, warnings, doc)``; ``doc`` is None when the file
    is torn or unreadable.  Checks, in order: parseability, schema, the
    seal digest, strict-cleanliness of the recorded run, measurement
    agreement with the committed budget file, and cell-coverage agreement
    with the live registry; a snapshot sealed under another torch is a
    warning.
    """
    import torch

    problems: list = []
    warns: list = []
    try:
        with open(path, encoding="utf-8") as fh:
            doc = json.load(fh)
    except OSError as err:
        return [f"snapshot unreadable: {err}"], warns, None
    except json.JSONDecodeError as err:
        return [f"snapshot torn or not JSON: {err}"], warns, None
    if not isinstance(doc, dict) or doc.get("schema") != AUDIT_SCHEMA:
        got = doc.get("schema") if isinstance(doc, dict) else type(doc)
        problems.append(f"unsupported snapshot schema {got!r} "
                        f"(want {AUDIT_SCHEMA})")
        return problems, warns, doc
    sha = doc.get("sha256")
    if not isinstance(sha, str):
        problems.append("snapshot carries no seal (sha256) — regenerate "
                        "with `audit --write-budgets --json FILE` on the "
                        "card")
    elif report_digest(doc) != sha:
        problems.append("seal digest mismatch — the snapshot was edited "
                        "after it was sealed (or the write tore)")
    if not doc.get("strict_clean", False):
        problems.append("snapshot records a run that was NOT strict-clean "
                        "— the audited tree had gating findings")

    live_budgets = budgets.load_budgets(
        budgets_path or budgets.DEFAULT_BUDGETS_PATH)
    snap = {k: {m: int(v) for m, v in d.items()}
            for k, d in (doc.get("measured") or {}).items()}
    live = {k: {m: int(v) for m, v in d.items()}
            for k, d in (live_budgets.get("cells") or {}).items()}
    if snap != live:
        drift = sorted(k for k in set(snap) | set(live)
                       if snap.get(k) != live.get(k))
        problems.append(
            f"snapshot measurements disagree with audit_budgets.json at "
            f"{drift} — one of the two is stale; re-run `audit "
            f"--write-budgets --json AUDIT_r*.json` on the card")
    try:
        expected = expected_cells()
    except Exception as err:   # the registry must never crash the doctor
        warns.append(f"could not rebuild the live registry for the "
                     f"drift check: {err!r}")
    else:
        got = set(doc.get("cells") or {})
        if got != expected:
            problems.append(
                f"snapshot covers cells {sorted(got ^ expected)} "
                f"differently than the live registry — the snapshot "
                f"vouches for a different tree; regenerate it")
    if doc.get("torch") != torch.__version__:
        warns.append(f"snapshot was sealed under torch {doc.get('torch')}, "
                     f"running {torch.__version__} — re-audit before "
                     f"trusting the budget numbers")
    return problems, warns, doc


def main(argv=None) -> int:
    """The CLI body behind ``python -m mfm_tpu_torch.cli audit`` and
    ``mfm_tpu_torch/tools/mfmaudit.py``.  Mesh cells need 8 devices: on
    one device, ``MFM_TORCH_VIRTUAL_DEVICES=8`` is set here when it is
    unset, before any mesh is built."""
    from mfm_tpu_torch._device import VIRTUAL_DEVICES_ENV

    os.environ.setdefault(VIRTUAL_DEVICES_ENV, "8")
    ap = argparse.ArgumentParser(
        prog="mfmaudit",
        description="the port's IR audit: every registered entry point run "
                    "once under probes, passes A1-A5")
    ap.add_argument("--passes", default=",".join(PASS_IDS),
                    help="comma-separated subset of passes to run")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="baseline JSON of suppressed findings "
                         "('none' disables)")
    ap.add_argument("--budgets", default=None,
                    help="budget file for A5 (default: "
                         "mfm_tpu_torch/tools/audit_budgets.json)")
    ap.add_argument("--write-budgets", action="store_true",
                    help="freeze the measured A5 numbers as the new "
                         "budget file instead of gating against them")
    ap.add_argument("--json", dest="json_out", default=None, metavar="FILE",
                    help="write the sealed report JSON to FILE "
                         "('-' for stdout)")
    ap.add_argument("--strict", action="store_true",
                    help="also fail on stale baseline entries")
    ap.add_argument("--device", default="cuda",
                    help="where the cells run: cuda (default) or cpu "
                         "(A1-A4 only)")
    args = ap.parse_args(argv)

    passes = tuple(p.strip() for p in args.passes.split(",") if p.strip())
    bl_path = None if args.baseline.lower() == "none" else args.baseline
    budgets_path = args.budgets or budgets.DEFAULT_BUDGETS_PATH
    try:
        rep = run_audit(passes=passes, baseline=load_audit_baseline(bl_path),
                        budgets_path=budgets_path, device=args.device)
    except ValueError as err:
        print(f"mfmaudit: {err}", file=sys.stderr)
        return 2

    if args.write_budgets:
        if not rep.measured:
            print("mfmaudit: --write-budgets needs pass A5 in --passes",
                  file=sys.stderr)
            return 2
        budgets.write_budgets(rep.measured, budgets_path)
        # re-gate A5 against the file just frozen: the pre-freeze
        # unbudgeted/over findings are the reason the user regenerated
        rep.findings = (
            [f for f in rep.findings if f.pass_id != "A5"]
            + budgets.check_budgets(rep.measured,
                                    budgets.load_budgets(budgets_path)))
        print(f"mfmaudit: froze {len(rep.measured)} cell budget(s) -> "
              f"{budgets_path}")

    doc = rep.to_dict()
    if args.json_out == "-":
        doc["sha256"] = report_digest(doc)
        print(json.dumps(doc, indent=1, sort_keys=True))
    else:
        if args.json_out:
            write_report(doc, args.json_out)
            print(f"mfmaudit: wrote sealed report -> {args.json_out}")
        for f in rep.findings:
            print(f"{f.pass_id} {f.severity:5s} {f.entrypoint}/{f.cell} "
                  f"[{f.code}] {f.message}")
        for key in rep.stale_baseline:
            print(f"STALE baseline entry: {key} — the finding no longer "
                  f"fires; remove it")
        s = doc["summary"]
        print(f"mfmaudit: {s['errors']} error(s), {s['warnings']} "
              f"warning(s), {s['info']} info over {s['cells']} cell(s), "
              f"{len(rep.baselined)} baselined, "
              f"{len(rep.stale_baseline)} stale baseline entr(ies) "
              f"[{doc['wall_s']:.1f}s]")
    if rep.errors:
        return 1
    if args.strict and rep.stale_baseline:
        return 1
    return 0
