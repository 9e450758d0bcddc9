"""The port's communication-layout doctrine (``parallel/mesh.py``) as a
test, through ``mfm_tpu_torch/analysis/collectives.py``'s stage report —
the counterpart of ``tests/test_collective_audit.py``, whose reference
report cannot run here (``disable_x64`` is gone from the installed JAX).

The port's stages move data only through ``parallel/mesh.py``'s three
collectives, so the report counts what they move: the cross-sectional
stage's stock gather at entry and the gathers between stages are
bounded all-gathers, the rolling stage moves nothing, and no stage moves
a full panel past the carve-out.  The sharded stages' numbers are the
unsharded ones, bit for bit, at float64."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mfm_tpu.analysis import collectives as ref_collectives
from mfm_tpu_torch._device import VIRTUAL_DEVICES_ENV
from mfm_tpu_torch.analysis import collectives
from mfm_tpu_torch.analysis.collectives import (
    build_report,
    check_invariants,
    summarize,
)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def report():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(VIRTUAL_DEVICES_ENV, "8")
        return build_report(T=64, N=48, P=5, Q=3, meshes=((4, 2), (2, 4)),
                            device="cpu")


@pytest.mark.parametrize("mesh", ["4x2", "2x4"])
def test_collective_doctrine_holds_on_virtual_mesh(report, mesh):
    entry = report["meshes"][mesh]
    assert entry["virtual"] and entry["mesh"] == mesh
    # the stock axis is split: the cross-sectional stage gathers it once
    # at entry (bounded all-gathers), and every stage stays under the
    # full-panel / carve-out ceiling
    assert entry["regression"]["by_kind"].get("all-gather", 0) >= 5
    assert entry["regression_is_reduce_only"]
    assert entry["rolling_is_communication_free"]
    assert entry["no_full_panel_collective"]
    assert report["invariants_hold"]
    # the rolling stage's outputs are placed on the first device at the
    # end (two (T, N) float32 panels), apart from the stage's own movement
    assert entry["output_gather_bytes"]["rolling_beta"] == 2 * 64 * 48 * 4
    assert entry["rolling_beta"]["total"] == 0

    inv = check_invariants(
        entry["regression"], entry["full_pipeline"], entry["rolling_beta"],
        panel_bytes=report["panel_bytes"],
        eigh_gather_budget=entry["eigh_gather_budget_bytes"])
    assert inv["ok"]
    for k in ("rolling_is_communication_free", "no_full_panel_collective",
              "regression_is_reduce_only"):
        assert inv[k] == entry[k]
    # the invariants are the reference's function's on the same summaries
    ref = ref_collectives.check_invariants(
        entry["regression"], entry["full_pipeline"], entry["rolling_beta"],
        panel_bytes=report["panel_bytes"],
        eigh_gather_budget=entry["eigh_gather_budget_bytes"])
    assert ref == inv


def test_styles_gather_is_the_largest_regression_movement(report):
    """The stock gather of the (T/nd, N, Q) styles block is the largest
    movement of the cross-sectional stage: 32 x 48 x 3 float32 on 2x4."""
    entry = report["meshes"]["2x4"]
    assert entry["regression"]["largest_bytes"] == 32 * 48 * 3 * 4
    assert entry["eigh_gather_budget_bytes"] == \
        ref_collectives.eigh_gather_budget(64, 9)


def test_check_invariants_rejects_panel_sized_collective():
    clean = summarize([])
    bad = summarize([("all-gather", 64 * 48 * 4)])
    assert bad == ref_collectives.audit_hlo(
        "%all-gather.1 = f32[64,48]{1,0} all-gather(f32[64,24]{1,0} %p0)")
    panel_bytes = 64 * 48 * 4
    inv = check_invariants(bad, clean, clean, panel_bytes=panel_bytes,
                           eigh_gather_budget=1024)
    assert not inv["regression_is_reduce_only"] and not inv["ok"]
    assert inv == ref_collectives.check_invariants(
        bad, clean, clean, panel_bytes=panel_bytes, eigh_gather_budget=1024)
    ok_reg = summarize([("all-reduce", 14 * 14 * 4)])
    inv2 = check_invariants(ok_reg, clean, clean, panel_bytes=panel_bytes,
                            eigh_gather_budget=1024)
    assert inv2["ok"]
    moving = summarize([("all-gather", 8)])
    assert not check_invariants(clean, clean, moving,
                                panel_bytes=panel_bytes,
                                eigh_gather_budget=1024)["ok"]


def test_sharded_stages_are_the_unsharded_numbers_at_float64(monkeypatch):
    """What the probes count moves bits unchanged: the regression and the
    rolling stage on a 2x4 mesh give the single-device numbers bitwise at
    float64."""
    from mfm_tpu_torch.models.risk_model import RiskModel
    from mfm_tpu_torch.ops.rolling import rolling_beta_hsigma
    from mfm_tpu_torch.parallel.mesh import (
        device_put,
        make_mesh,
        panel_sharding,
        replicate,
        shard_panel,
        use_mesh,
    )

    monkeypatch.setenv(VIRTUAL_DEVICES_ENV, "8")
    rng = np.random.default_rng(1)
    T, N, P, Q = 32, 24, 3, 2
    panels = (torch.from_numpy(rng.normal(0, 0.02, (T, N))),
              torch.from_numpy(rng.lognormal(10, 1, (T, N))),
              torch.from_numpy(rng.normal(0, 1, (T, N, Q))),
              torch.from_numpy(rng.integers(0, P, (T, N)).astype(np.int32)),
              torch.from_numpy(rng.random((T, N)) > 0.05))
    mkt = torch.from_numpy(rng.normal(0, 0.01, T))
    want = RiskModel(*panels, n_industries=P, device="cpu").reg_by_time()
    mesh = make_mesh(2, 4, device="cpu")
    sharded = shard_panel(panels, mesh)
    with collectives.probe() as events, use_mesh(mesh):
        got = RiskModel(*sharded, n_industries=P,
                        device="cpu").reg_by_time()
    assert events
    for g, w in zip(got, want):
        assert torch.equal(torch.nan_to_num(g, nan=-7.0),
                           torch.nan_to_num(w, nan=-7.0))
    # placement before the call: the rolling layout, the index replicated
    roll = device_put(panels[0], panel_sharding(mesh, rolling=True))
    mkt_rep = replicate(mkt, mesh)
    with collectives.probe() as events:
        got = rolling_beta_hsigma(roll, mkt_rep, window=16, half_life=4,
                                  min_periods=4)
    inside, placed = collectives.split_output_gathers(events, got)
    assert inside == [] and placed == 2 * T * N * 8
    for g, w in zip(got, rolling_beta_hsigma(panels[0], mkt, window=16,
                                             half_life=4, min_periods=4)):
        assert torch.equal(torch.nan_to_num(g, nan=-7.0),
                           torch.nan_to_num(w, nan=-7.0))


def test_collective_audit_shim_exports_the_report(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT / "mfm_tpu_torch" / "tools"))
    sys.modules.pop("collective_audit", None)
    import collective_audit  # noqa: E402  (the shim, by path)

    assert collective_audit.build_report is build_report
    assert collective_audit.check_invariants is check_invariants
    sys.modules.pop("collective_audit", None)
