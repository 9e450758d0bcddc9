"""A3 — the per-entrypoint collective audit, and the stage-level
mesh-doctrine report (counterpart of ``mfm_tpu/analysis/collectives.py``).

The mesh doctrine (``parallel/mesh.py``) makes checkable claims: the
rolling kernels' stock-only layout needs no communication, and no stage
moves a full (T, N) panel between devices — with one carve-out, the
batched decompositions' small K x K matrix batches.  The reference reads
the collectives out of each compiled program's optimized HLO.  The port
has no program: data moves between shards only through
``parallel/mesh.py``'s three collectives, so each of them tells a probe
(``mesh._PROBES``) what it moved, and this pass reads those reports for
the cell's one run.

The mapping to the reference's kind names: every one of the three is an
``all-gather`` — ``all_gather_stock`` gathers the stock axis of a date row
(XLA's all-gather along 'stock'), ``gather`` assembles every block on the
mesh's first device, ``replicate`` puts one tensor on every position; each
position that receives data ends holding a whole axis or array, which is
what an all-gather leaves.  The bytes are those of the result one
position holds (the reference sizes a collective by its result type).
The port reduces nothing across shards (the cross-sectional sums run
shard-local after the stock gather, for bits), so it has no
``all-reduce``.  Operands laid out before the call are placement, not a
collective: the reference's cells arrive already sharded.  A gather
whose result the call returns is the outputs' placement on the first
device (the reference's compiled stage returns them sharded): it is
reported apart, as ``output_gather_bytes``, and not counted.

Per cell the summary has the reference's fields (``total``, ``by_kind``,
``largest_bytes``, ``largest_non_reduce_bytes``, ``non_reduce_kinds``), so
:func:`check_collectives`, :func:`eigh_gather_budget` and
:func:`check_invariants` are the reference's pure functions.  Mesh cells
are held to their entry point's allowlist, the full-panel ceiling and the
carve-out budget; primary cells to zero collectives
(``unsharded-collective``).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from mfm_tpu_torch.analysis.registry import AUDIT_MATRIX, Finding, _K

_REDUCES = ("all-reduce", "reduce-scatter")


@contextlib.contextmanager
def probe():
    """Within the block, every collective of ``parallel/mesh.py`` appends
    ``(kind, nbytes, result)`` to the yielded list."""
    from mfm_tpu_torch.parallel import mesh

    events: list = []

    def record(kind, nbytes, result):
        events.append((kind, nbytes, result))

    mesh._PROBES.append(record)
    try:
        yield events
    finally:
        mesh._PROBES.remove(record)


def split_output_gathers(events, out) -> tuple:
    """``(inside, output_gather_bytes)``: the ``(kind, nbytes)`` of the
    collectives inside the call, and the bytes of those whose result is a
    tensor the call returned."""
    from mfm_tpu_torch.analysis.aliasing import tensors_of

    outs = {id(t) for t in tensors_of(out)}
    inside, placed = [], 0
    for kind, nbytes, result in events:
        if torch.is_tensor(result) and id(result) in outs:
            placed += nbytes
        else:
            inside.append((kind, nbytes))
    return inside, placed


def summarize(found) -> dict:
    """The reference's summary of a program's collectives, over
    ``(kind, nbytes)`` pairs."""
    by_kind: dict = {}
    for kind, _ in found:
        by_kind[kind] = by_kind.get(kind, 0) + 1
    return {
        "total": len(found),
        "by_kind": by_kind,
        "largest_bytes": max((b for _, b in found), default=0),
        "largest_non_reduce_bytes": max(
            (b for k, b in found if k not in _REDUCES), default=0),
        "non_reduce_kinds": sorted({k for k, _ in found
                                    if k not in _REDUCES}),
    }


def eigh_gather_budget(T: int, K: int) -> int:
    """The one structural carve-out, as a byte bound (the reference's
    formula): the batched decompositions' (T, K, K) matrix batches plus a
    (2K, 2K) workspace each, at 8 bytes — replicated small matrices,
    never panel movement."""
    return T * (2 * K) * (2 * K) * 8


def check_collectives(ep_name: str, cell_name: str, summary: dict, *,
                      allow: frozenset, panel_bytes: int,
                      gather_budget: int) -> list:
    """The pure A3 verdicts for one mesh cell (the reference's)."""
    findings = []
    bad_kinds = sorted(set(summary["by_kind"]) - set(allow))
    if bad_kinds:
        findings.append(Finding(
            "A3", "error", ep_name, cell_name, "collective-kind",
            f"collectives {bad_kinds} outside the entrypoint allowlist "
            f"{sorted(allow)} (counts: {summary['by_kind']})"))
    ceiling = max(panel_bytes, gather_budget)
    if summary["largest_bytes"] >= ceiling:
        findings.append(Finding(
            "A3", "error", ep_name, cell_name, "full-panel-collective",
            f"largest collective moves {summary['largest_bytes']} bytes "
            f">= the full-panel/carve-out ceiling {ceiling} — the "
            f"N=5000 scale-up killer"))
    if summary["largest_non_reduce_bytes"] > gather_budget:
        findings.append(Finding(
            "A3", "error", ep_name, cell_name, "gather-over-budget",
            f"non-reduce collective moves "
            f"{summary['largest_non_reduce_bytes']} bytes > the eigh "
            f"carve-out budget {gather_budget}"))
    return findings


def run_pass(artifacts: dict) -> list:
    """A3 over the runs: mesh cells against their allowlists, primary
    cells against zero collectives, and a ``mesh-skipped`` warn for a mesh
    of more devices than are up."""
    from mfm_tpu_torch._device import VIRTUAL_DEVICES_ENV

    T, N = AUDIT_MATRIX["T"], AUDIT_MATRIX["N"]
    panel_bytes = T * N * 4
    budget = eigh_gather_budget(T, _K)
    findings = []
    for (ep, cell), art in artifacts.items():
        if not art.get("ran"):
            if cell.role == "mesh":
                findings.append(Finding(
                    "A3", "warn", ep.name, cell.name, "mesh-skipped",
                    f"mesh {cell.mesh} needs {cell.mesh[0] * cell.mesh[1]} "
                    f"devices — run with {VIRTUAL_DEVICES_ENV}=8 to audit"))
            continue
        summary = art["collectives"]
        if cell.role == "mesh":
            findings.extend(check_collectives(
                ep.name, cell.name, summary, allow=ep.collectives_allow,
                panel_bytes=panel_bytes, gather_budget=budget))
        elif summary["total"]:
            findings.append(Finding(
                "A3", "error", ep.name, cell.name, "unsharded-collective",
                f"single-device run moved data between shards "
                f"{summary['by_kind']} — a mesh leaked into the entrypoint"))
    return findings


# -- the stage-level doctrine report (tools/collective_audit.py) -------------

def check_invariants(regression: dict, full_pipeline: dict,
                     rolling_beta: dict, *, panel_bytes: int,
                     eigh_gather_budget: int) -> dict:
    """The mesh-layout doctrine on the three stages' summaries (the
    reference's): the rolling stage moves nothing, no stage moves a
    full panel past the carve-out, and the regression communicates by
    reductions plus bounded all-gathers only."""
    inv = {
        "rolling_is_communication_free": rolling_beta["total"] == 0,
        "no_full_panel_collective": all(
            e["largest_bytes"] < max(panel_bytes, eigh_gather_budget)
            for e in (regression, full_pipeline)),
        "regression_is_reduce_only": (
            set(regression["non_reduce_kinds"]) <= {"all-gather"}
            and regression["largest_non_reduce_bytes"] <= eigh_gather_budget),
    }
    inv["ok"] = all(inv.values())
    return inv


def _stage(fn, *args) -> tuple:
    """(summary, output_gather_bytes) of one call of a stage."""
    with probe() as events:
        out = fn(*args)
    inside, placed = split_output_gathers(events, out)
    return summarize(inside), placed


def build_report(T=192, N=96, P=8, Q=4, meshes=((8, 1), (4, 2), (2, 4)),
                 device=None) -> dict:
    """The stage-level doctrine report on each mesh of ``meshes``: the
    regression, the full pipeline and ``rolling_beta_hsigma`` at float32
    (the production path) on panels laid out in the doctrine's layouts
    before each call, the inputs made from a fixed numpy seed.  A mesh
    needs that many devices (``MFM_TORCH_VIRTUAL_DEVICES``)."""
    from mfm_tpu_torch._device import resolve_device
    from mfm_tpu_torch.config import RiskModelConfig
    from mfm_tpu_torch.models.risk_model import RiskModel
    from mfm_tpu_torch.ops.rolling import rolling_beta_hsigma
    from mfm_tpu_torch.parallel.mesh import (
        PIPELINE_SPECS,
        NamedSharding,
        device_put,
        make_mesh,
        panel_sharding,
        replicate,
        use_mesh,
    )

    device = resolve_device(device)
    rng = np.random.default_rng(0)
    f32 = torch.float32

    def on_device(a, dtype=None):
        return torch.from_numpy(np.asarray(a)).to(device=device, dtype=dtype)

    panels = {"ret": on_device(rng.normal(0, 0.02, (T, N)), f32),
              "cap": on_device(rng.lognormal(10, 1, (T, N)), f32),
              "styles": on_device(rng.normal(0, 1, (T, N, Q)), f32),
              "industry": on_device(rng.integers(0, P, (T, N)), torch.int32),
              "valid": on_device(rng.random((T, N)) > 0.05)}
    mkt = on_device(rng.normal(0, 0.01, T), f32)
    cfg = RiskModelConfig(eigen_n_sims=4, eigen_sim_length=64)
    K = 1 + P + Q
    sim = rng.normal(size=(4, K, 64))
    d = sim - sim.mean(axis=-1, keepdims=True)
    sim_covs = on_device(np.einsum("mkt,mlt->mkl", d, d) / 63.0, f32)
    names = ("ret", "cap", "styles", "industry", "valid")

    def model(*xs):
        return RiskModel(*xs, n_industries=P, config=cfg, device=device)

    panel_bytes = int(panels["ret"].numel() * panels["ret"].element_size())
    budget = eigh_gather_budget(T, K)
    report = {"shape": {"T": T, "N": N, "K": K},
              "panel_bytes": panel_bytes, "meshes": {}}
    ok = True
    for nd, ns in meshes:
        mesh = make_mesh(nd, ns, device=device)
        placed = [device_put(panels[n], NamedSharding(mesh, PIPELINE_SPECS[n]))
                  for n in names]
        entry = {}
        with use_mesh(mesh):
            entry["regression"], reg_out = _stage(
                lambda *xs: model(*xs).reg_by_time()[:2], *placed)
            entry["full_pipeline"], full_out = _stage(
                lambda *xs: model(*xs).run(sim_covs=sim_covs,
                                           sim_length=64), *placed)
        roll = device_put(panels["ret"], panel_sharding(mesh, rolling=True))
        entry["rolling_beta"], roll_out = _stage(
            lambda r, m: rolling_beta_hsigma(r, m, window=64, half_life=16,
                                             min_periods=8),
            roll, replicate(mkt, mesh))
        entry["output_gather_bytes"] = {"regression": reg_out,
                                        "full_pipeline": full_out,
                                        "rolling_beta": roll_out}
        entry["eigh_gather_budget_bytes"] = budget
        inv = check_invariants(
            entry["regression"], entry["full_pipeline"],
            entry["rolling_beta"], panel_bytes=panel_bytes,
            eigh_gather_budget=budget)
        entry.update((k, v) for k, v in inv.items() if k != "ok")
        ok &= inv["ok"]
        report["meshes"][f"{nd}x{ns}"] = {**mesh.describe(), **entry}
    report["invariants_hold"] = ok
    return report
