"""A5 — memory budgets per entrypoint x config cell (counterpart of
``mfm_tpu/analysis/budgets.py``).

The reference prices a compiled program without running it
(``compiled.memory_analysis()``).  The port measures the cell's one run
with ``utils/obs.measured_call``: argument, output and aliased bytes,
and on the card the transient peak above them
(``torch.cuda.max_memory_allocated``).  The CPU keeps no allocation peak
(``utils/obs.compiled_memory``), so A5 measures on the card only; the
audit runs each cell once before the measured run, so cuBLAS's workspace
and the kernel library's first load are not in it.  The budgets freeze
those numbers per cell in ``mfm_tpu_torch/tools/audit_budgets.json``.

Gate semantics per cell, the reference's:

- ``temp_bytes`` and ``workspace_bytes`` (argument + output + temp -
  alias) regress when they exceed budget * (1 + tolerance), beyond an
  absolute floor (:data:`FLOOR_BYTES`) that keeps KB-scale cells from
  crying wolf over allocator rounding;
- a measurement far below budget (< budget * (1 - tolerance), beyond the
  floor) is a *warn*: the budget is stale and should be re-frozen
  (``audit --write-budgets``);
- a registered cell with no budget entry is an error (``unbudgeted``); a
  budget entry with no registered cell is a STALE error
  (``stale-budget``).

Budget identity: the numbers measure the AUDIT_MATRIX shapes at float32
on the card's torch — regenerate when either moves, never to paper over
a regression.
"""

from __future__ import annotations

import json
import os

from mfm_tpu_torch.analysis.registry import Finding

BUDGETS_SCHEMA = "mfmaudit-budgets/1"
DEFAULT_TOLERANCE = 0.25
#: differences under this many bytes never gate (allocator granularity)
FLOOR_BYTES = 64 * 1024

#: the measured metrics a budget freezes, in gate order
METRICS = ("temp_bytes", "workspace_bytes")

TOOLS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")
DEFAULT_BUDGETS_PATH = os.path.join(TOOLS_DIR, "audit_budgets.json")


def measure_cell(mem: dict) -> dict:
    """Reduce ``utils/obs.measured_call``'s memory fields to the budgeted
    metrics.  ``workspace_bytes`` is the call's whole footprint net of
    the outputs that reuse an argument's storage."""
    temp = int(mem.get("temp_bytes") or 0)
    work = (int(mem.get("argument_bytes") or 0)
            + int(mem.get("output_bytes") or 0) + temp
            - int(mem.get("alias_bytes") or 0))
    return {"temp_bytes": temp, "workspace_bytes": work}


def load_budgets(path: str = DEFAULT_BUDGETS_PATH) -> dict:
    """The committed budget file, or an empty skeleton when absent (every
    registered cell then reports ``unbudgeted``)."""
    if not os.path.exists(path):
        return {"schema": BUDGETS_SCHEMA, "tolerance": DEFAULT_TOLERANCE,
                "cells": {}}
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    if doc.get("schema") != BUDGETS_SCHEMA:
        raise ValueError(f"unsupported budget schema {doc.get('schema')!r} "
                         f"in {path} (want {BUDGETS_SCHEMA})")
    return doc


def write_json_atomic(doc: dict, path: str) -> None:
    """tmp -> fsync -> rename -> directory fsync: a SIGKILL mid-write must
    not tear a committed gate file."""
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)
        fh.write("\n")
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    dirfd = os.open(os.path.dirname(os.path.abspath(path)) or ".",
                    os.O_RDONLY)
    try:
        os.fsync(dirfd)
    finally:
        os.close(dirfd)


def write_budgets(measured: dict, path: str = DEFAULT_BUDGETS_PATH,
                  tolerance: float = DEFAULT_TOLERANCE) -> dict:
    """Freeze ``measured`` (cell key -> metric dict) as the new budget
    file, atomically."""
    doc = {"schema": BUDGETS_SCHEMA, "tolerance": tolerance,
           "cells": {k: dict(v) for k, v in sorted(measured.items())}}
    write_json_atomic(doc, path)
    return doc


def check_budgets(measured: dict, budgets: dict) -> list:
    """The pure A5 verdicts: ``measured`` maps ``"ep/cell"`` ->
    metric dict, ``budgets`` is the loaded budget doc."""
    tol = float(budgets.get("tolerance", DEFAULT_TOLERANCE))
    cells = budgets.get("cells", {})
    findings = []
    for key in sorted(measured):
        ep_name, _, cell_name = key.partition("/")
        got = measured[key]
        want = cells.get(key)
        if want is None:
            findings.append(Finding(
                "A5", "error", ep_name, cell_name, "unbudgeted",
                f"no committed budget for {key} — freeze one on the card "
                f"with `audit --write-budgets` and commit "
                f"mfm_tpu_torch/tools/audit_budgets.json"))
            continue
        for metric in METRICS:
            cur = int(got.get(metric) or 0)
            ref = int(want.get(metric) or 0)
            if cur > ref * (1 + tol) and cur - ref > FLOOR_BYTES:
                findings.append(Finding(
                    "A5", "error", ep_name, cell_name, f"over-{metric}",
                    f"{key} {metric} {cur} exceeds budget {ref} by "
                    f"{cur - ref} bytes (> {tol:.0%} band) — a memory "
                    f"regression"))
            elif ref * (1 - tol) > cur and ref - cur > FLOOR_BYTES:
                findings.append(Finding(
                    "A5", "warn", ep_name, cell_name, f"stale-{metric}",
                    f"{key} {metric} {cur} is far under budget {ref} — "
                    f"re-freeze so the band measures from reality"))
    for key in sorted(set(cells) - set(measured)):
        ep_name, _, cell_name = key.partition("/")
        findings.append(Finding(
            "A5", "error", ep_name, cell_name, "stale-budget",
            f"budget entry {key} matches no registered cell — remove it "
            f"or restore the registration"))
    return findings


def run_pass(artifacts: dict, budgets_path: str = DEFAULT_BUDGETS_PATH):
    """A5 over every measured primary and mesh cell (ladder cells stay
    A4-only).  Returns ``(findings, measured)``."""
    measured = {}
    for (ep, cell), art in artifacts.items():
        if cell.role not in ("primary", "mesh") or "memory" not in art:
            continue
        measured[f"{ep.name}/{cell.name}"] = measure_cell(art["memory"])
    findings = check_budgets(measured, load_budgets(budgets_path))
    return findings, measured
