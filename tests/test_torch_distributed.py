"""The port's multi-process helpers (``mfm_tpu_torch/parallel/
distributed.py``) on the CPU, the counterpart of
``tests/test_distributed_multiprocess.py``.

Single process: ``initialize()`` is False without a coordinator, the
shapes and ``ValueError``s of ``make_global_mesh``, ``process_date_slice``.
Two gloo processes over a ``file://`` store, each with 4 virtual CPU
devices: the (4, 2) global mesh with each stock row inside one rank, the
date slices, one cross-process sum through the mesh's gather, one
``all_reduce``, and ``run_fused`` on the global mesh bitwise the
single-process run.  One round, each worker with its own timeout.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from mfm_tpu_torch._device import VIRTUAL_DEVICES_ENV
from mfm_tpu_torch.parallel import distributed as D

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_initialize_without_a_coordinator_is_false(monkeypatch):
    monkeypatch.delenv("MFM_COORDINATOR_ADDRESS", raising=False)
    assert D.initialize() is False
    assert D.initialize(device="cpu") is False


def test_process_count_without_an_address_raises(monkeypatch):
    monkeypatch.delenv("MFM_COORDINATOR_ADDRESS", raising=False)
    with pytest.raises(ValueError, match="coordinator"):
        D.initialize(num_processes=2, process_id=0, device="cpu")


@pytest.mark.parametrize("n_dev,n_stock,shape", [
    ("8", 1, (8, 1)), ("8", 2, (4, 2)), ("8", 4, (2, 4)), ("1", 1, (1, 1))])
def test_make_global_mesh_in_one_process(monkeypatch, n_dev, n_stock, shape):
    monkeypatch.setenv(VIRTUAL_DEVICES_ENV, n_dev)
    mesh = D.make_global_mesh(n_stock=n_stock, device="cpu")
    assert mesh.devices.shape == shape
    assert mesh.axis_names == ("date", "stock")
    assert mesh.process_count == 1 and mesh.rank == 0


def test_make_global_mesh_raises_the_references_errors(monkeypatch):
    monkeypatch.setenv(VIRTUAL_DEVICES_ENV, "8")
    with pytest.raises(ValueError, match="n_stock=3 must divide device "
                                         "count 8"):
        D.make_global_mesh(n_stock=3, device="cpu")
    # two processes of two devices: a 4-wide stock axis would span them
    monkeypatch.setenv(VIRTUAL_DEVICES_ENV, "2")
    monkeypatch.setattr(D, "_world", lambda: (2, 0))
    with pytest.raises(ValueError, match="stock axis \\(4\\) must fit "
                                         "within one host's 2 devices"):
        D.make_global_mesh(n_stock=4, device="cpu")
    mesh = D.make_global_mesh(n_stock=2, device="cpu")
    assert mesh.devices.shape == (2, 2) and mesh.ranks.tolist() == [[0, 0],
                                                                    [1, 1]]


@pytest.mark.parametrize("world,rank,T,want", [
    (1, 0, 10, (0, 10)), (2, 0, 10, (0, 5)), (2, 1, 10, (5, 10)),
    (3, 2, 10, (8, 10)), (4, 3, 5, (6, 5))])
def test_process_date_slice(monkeypatch, world, rank, T, want):
    """The reference's blocks of ceil(T / world) dates; a rank past the
    end gets an empty slice, as in the reference."""
    monkeypatch.setattr(D, "_world", lambda: (world, rank))
    assert D.process_date_slice(T) == slice(*want)


WORKER = r"""
import json, sys
import torch
import torch.distributed as dist
from mfm_tpu_torch import RiskModel, RiskModelConfig
from mfm_tpu_torch.data.synthetic import synthetic_risk_inputs
from mfm_tpu_torch.parallel.distributed import (
    initialize, make_global_mesh, process_date_slice)
from mfm_tpu_torch.parallel.mesh import (
    P, NamedSharding, gather, make_sharded, use_mesh)

pid, store = int(sys.argv[1]), sys.argv[2]
multi = initialize(f"file://{store}", num_processes=2, process_id=pid,
                   device="cpu", timeout_s=120)
mesh = make_global_mesh(n_stock=2, device="cpu")
rows_ok = all(len({int(r) for r in row}) == 1 for row in mesh.ranks)
sl = process_date_slice(10)
x = make_sharded((8,), NamedSharding(mesh, P("date")),
                 lambda idx: torch.arange(8, dtype=torch.float64)[idx])
total = float(gather(x).sum())
y = torch.full((2,), float(pid + 1))
dist.all_reduce(y)

# run_fused on the global mesh against the single-process run
torch.manual_seed(0)
panel = [torch.as_tensor(a) for a in synthetic_risk_inputs(32, 20, 3, 2,
                                                            seed=1)]
panel = [a.double() if a.is_floating_point() else a for a in panel]
cfg = RiskModelConfig(eigen_n_sims=4, eigen_sim_length=40)
base = RiskModel(*panel, n_industries=3, config=cfg, device="cpu").run_fused()
with use_mesh(mesh):
    out = RiskModel(*panel, n_industries=3, config=cfg,
                    device="cpu").run_fused()
bitwise = all(a.numpy().tobytes() == b.numpy().tobytes()
              for a, b in zip(base, out))
print(json.dumps({"pid": pid, "multi": multi,
                  "shape": list(mesh.devices.shape), "rows_ok": rows_ok,
                  "virtual": mesh.virtual, "local": len(mesh.local_positions),
                  "slice": [sl.start, sl.stop], "total": total,
                  "all_reduce": y.tolist(), "run_fused_bitwise": bitwise}))
dist.destroy_process_group()
"""


def test_two_process_mesh_and_collective(tmp_path):
    env = dict(os.environ)
    env[VIRTUAL_DEVICES_ENV] = "4"
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    env.pop("MFM_COORDINATOR_ADDRESS", None)
    store = str(tmp_path / "store")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(pid), store], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
            recs = [json.loads(line) for line in out.splitlines()
                    if line.startswith("{") and '"pid"' in line]
            assert recs, out[-2000:]
            outs.append(recs[-1])
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
                q.communicate()
    for pid, rec in enumerate(outs):
        assert rec["pid"] == pid and rec["multi"] is True
        assert rec["shape"] == [4, 2] and rec["rows_ok"] is True
        assert rec["virtual"] is True and rec["local"] == 4
        assert rec["slice"] == ([0, 5] if pid == 0 else [5, 10])
        assert rec["total"] == float(sum(range(8)))
        assert rec["all_reduce"] == [3.0, 3.0]
        assert rec["run_fused_bitwise"] is True
    assert torch.distributed.is_available()
