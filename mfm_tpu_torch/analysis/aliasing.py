"""A1 — the aliasing proof (counterpart of ``mfm_tpu/analysis/aliasing.py``).

PR 4's worst bug class: a buffer the caller still holds is overwritten
or handed back as an output, and a later read (the recovery matrix's
bitwise replay from a prior state) sees other bits.  The reference proves
at lowering time that XLA's alias map reuses donated operands only.
Eager torch has no alias map; what it has is each tensor's version
counter (``Tensor._version``, bumped by every in-place write to the
tensor or a view of it) and its storage (``untyped_storage().data_ptr()``,
which ``utils/obs.measured_call`` already reads to find outputs that
share an argument's storage).  So the port's proof reads the cell's one
run: before and after it, every tensor operand's version and storage —
every shard of a ``ShardedPanel`` operand too — and after it, the storage
of every output tensor.

Verdicts per cell, over operands by name against the registry's
``donate`` contract:

- ``nondonated-mutation`` (error; the one code the port adds): an operand
  outside the contract whose version moved — the call wrote into a tensor
  its caller still holds;
- ``nondonated-alias`` (error): an output shares the storage of an operand
  outside the contract — the caller's tensor and the result are one
  buffer, so a later write to either changes both;
- ``donated-unaliased`` (info): declared operands the call neither wrote
  nor handed back — the donation is inert, as in the reference.

The reference's ``donation-contract-mismatch`` compares the registry with
the lowering's ``args_info``.  Eager torch declares no donation, so there
is nothing for the contract to disagree with: the code is kept and never
fires, as ``lint.py`` keeps R4.

:func:`check_aliasing` is pure over the recorded evidence, so fixtures
drive it without a run.
"""

from __future__ import annotations

import dataclasses

import torch

from mfm_tpu_torch.analysis.registry import Finding, flat_donated

def tensors_of(tree) -> list:
    """Every tensor of a result or operand tree: tensors, the shards of a
    ``ShardedPanel``, and the fields of tuples (NamedTuples too), lists,
    dicts and dataclasses (``RiskModelState``), in order."""
    from mfm_tpu_torch.parallel.mesh import ShardedPanel

    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, ShardedPanel):
        return list(tree.shards.values())
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensors_of(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in tensors_of(v)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree)
                for t in tensors_of(getattr(tree, f.name))]
    return []


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def operand_versions(operands: dict) -> dict:
    """``name -> [(version, storage pointer), ...]`` of every tensor of
    every operand (empty tensors have no storage to share and are
    skipped)."""
    return {name: [(t._version, _storage(t)) for t in tensors_of(v)
                   if t.numel()]
            for name, v in operands.items()}


def output_storages(out) -> set:
    """The storage pointers of every non-empty output tensor."""
    return {_storage(t) for t in tensors_of(out) if t.numel()}


def check_aliasing(ep_name: str, cell_name: str, declared: set,
                   before: dict, after: dict, out_storages: set) -> list:
    """The pure A1 verdicts for one cell run.

    Args:
      declared: the operand names the registry's contract retires
        (:func:`mfm_tpu_torch.analysis.registry.flat_donated`).
      before, after: :func:`operand_versions` of the operands around the run.
      out_storages: :func:`output_storages` of its result.
    """
    mutated = sorted(n for n in before
                     if [v for v, _ in before[n]] != [v for v, _ in after[n]])
    aliased = sorted(n for n in before
                     if any(p in out_storages for _, p in before[n]))
    findings = []
    for code, names, what in (
            ("nondonated-mutation", mutated,
             "were written in place"),
            ("nondonated-alias", aliased,
             "share their storage with an output")):
        bad = [n for n in names if n not in declared]
        if bad:
            findings.append(Finding(
                "A1", "error", ep_name, cell_name, code,
                f"operands {bad} outside the donation contract {what} — "
                f"the caller still holds them (the PR 4 corruption class)"))
    inert = sorted(n for n in declared
                   if n in before and n not in aliased and n not in mutated)
    if inert:
        findings.append(Finding(
            "A1", "info", ep_name, cell_name, "donated-unaliased",
            f"donated operands {inert} were neither written nor handed "
            f"back — donation is inert there"))
    return findings


def run_pass(artifacts: dict) -> list:
    """A1 over every primary and mesh cell that ran.  ``artifacts`` maps
    ``(ep, cell)`` to the evidence of its one run
    (:mod:`mfm_tpu_torch.analysis.run`)."""
    findings = []
    for (ep, cell), art in artifacts.items():
        if not art.get("ran"):
            continue
        findings.extend(check_aliasing(
            ep.name, cell.name, flat_donated(ep, cell), art["before"],
            art["after"], art["out_storages"]))
    return findings
