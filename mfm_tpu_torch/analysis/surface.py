"""A4 — recompile-surface enumeration over the declared bucket ladders
(counterpart of ``mfm_tpu/analysis/surface.py``).

The serving paths all make one steady-state promise: host-side padding
quantizes batch shapes onto a small declared ladder (the query and
scenario 8*4^i buckets, the eigen power-of-two >= 64 draw buckets), so the
reference's jit cache holds one entry per bucket and the port's
compile-contract counter (``utils/contracts.py``) one signature per
bucket.  This pass proves it without running anything:

- every ladder cell's **cache key** is the shapes and dtypes of every
  operand the entry point's signature records — its ``padded`` operands
  at a ``note_bucket`` site, as ``contracts.signature_of`` records them
  there (less the device: a spec lives nowhere), every operand where the
  entry point has no site — plus the ``repr`` of its statics;
- the number of distinct keys must equal the number of declared buckets:
  fewer means two rungs collide, more means something besides the
  bucketed axis moved — an index operand whose dtype drifts from int32 to
  torch's int64 default, PR 1's s64 retrace trap;
- within a ladder, every cell must agree on the dtype signature and on
  the statics — only shapes may move between rungs;
- every declared bucket must be a fixed point of the production bucket
  function (``serve/query.bucket_for``, ``models/eigen.draw_bucket``).

The codes are the reference's six: ``duplicate-bucket``,
``bucket-key-collision``, ``ladder-dtype-drift``, ``ladder-static-drift``,
``bucket-not-fixed-point`` and ``empty-ladder``.
"""

from __future__ import annotations

from mfm_tpu_torch.analysis.registry import (
    Cell,
    Finding,
    key_operands,
    leaves,
)
from mfm_tpu_torch.utils.contracts import signature_of


def _ladder_fn(name: str):
    """Ladder name -> the production bucket function it must agree with."""
    if name == "eigen":
        from mfm_tpu_torch.models.eigen import draw_bucket

        return draw_bucket
    if name in ("query", "scenario"):
        # the scenario engine reuses serve.query's geometric ladder
        from mfm_tpu_torch.serve.query import bucket_for

        return bucket_for
    return None


def cache_key(cell: Cell, ep=None) -> tuple:
    """The audit's model of the signature one cell records: ``(where,
    shapes, dtypes)`` of ``contracts.signature_of`` over the recorded
    operands (``ep``'s ``padded`` ones at its site; every operand, under
    ``"-"``, without ``ep``), and the statics.  Two cells with equal keys
    are one signature; anything that makes them differ is a new one."""
    if ep is None:
        where = "-"
        specs = [s for n in cell.operands for s in leaves(cell.operands[n])]
    else:
        where = ep.site or ep.name
        specs = key_operands(ep, cell)
    sig = signature_of(where, *specs)[:3] if specs else (where, (), ())
    statics = tuple(sorted((k, repr(v)) for k, v in cell.statics.items()))
    return (sig, statics)


def dtype_signature(cell: Cell, ep=None) -> tuple:
    """The shape-free half of the key: the recorded operands' dtypes."""
    return cache_key(cell, ep)[0][2]


def check_ladder(ep_name: str, ladder: str, cells: list, ep=None) -> list:
    """The pure A4 verdicts for one entrypoint's ladder cells."""
    findings = []
    declared = [c.bucket for c in cells]
    if len(set(declared)) != len(declared):
        findings.append(Finding(
            "A4", "error", ep_name, ladder, "duplicate-bucket",
            f"declared ladder repeats buckets: {declared}"))
    keys = {}
    for c in cells:
        keys.setdefault(cache_key(c, ep), []).append(c.name)
    if len(keys) != len(cells):
        collided = [names for names in keys.values() if len(names) > 1]
        findings.append(Finding(
            "A4", "error", ep_name, ladder, "bucket-key-collision",
            f"{len(cells)} declared buckets produce only {len(keys)} "
            f"distinct signatures — colliding rungs: {collided}"))
    sigs = {}
    for c in cells:
        sigs.setdefault(dtype_signature(c, ep), []).append(c.name)
    if len(sigs) > 1:
        findings.append(Finding(
            "A4", "error", ep_name, ladder, "ladder-dtype-drift",
            f"operand dtypes differ across ladder rungs "
            f"{ {str(k): v for k, v in sigs.items()} } — only shapes may "
            f"move between buckets (an int64 index rung is PR 1's s64 "
            f"retrace trap)"))
    statics = {cache_key(c, ep)[1] for c in cells}
    if len(statics) > 1:
        findings.append(Finding(
            "A4", "error", ep_name, ladder, "ladder-static-drift",
            f"static arguments differ across ladder rungs — each change "
            f"is a whole extra signature per bucket ({len(statics)} static "
            f"signatures over {len(cells)} rungs)"))
    fn = _ladder_fn(ladder)
    if fn is not None:
        broken = [b for b in declared if b is None or fn(b) != b]
        if broken:
            findings.append(Finding(
                "A4", "error", ep_name, ladder, "bucket-not-fixed-point",
                f"declared buckets {broken} are not fixed points of the "
                f"production ladder function — the registry has drifted "
                f"from the code"))
    return findings


def run_pass(entrypoints, cells_by_ep: dict) -> list:
    """A4 over every registered ladder.  ``cells_by_ep`` maps Entrypoint ->
    its built cells (shared with the other passes so the builders run
    once)."""
    findings = []
    for ep in entrypoints:
        if ep.ladder is None:
            continue
        ladder_cells = [c for c in cells_by_ep[ep] if c.role == "ladder"]
        if not ladder_cells:
            findings.append(Finding(
                "A4", "error", ep.name, ep.ladder, "empty-ladder",
                "entrypoint declares a bucket ladder but registers no "
                "ladder cells"))
            continue
        findings.extend(check_ladder(ep.name, ep.ladder, ladder_cells, ep))
    return findings
