"""``--mesh DxS`` on the port's CLI (``risk``, ``risk --update``,
``pipeline --append``) on virtual CPU meshes, held against the in-process
API: every table bit for bit (each csv cell parsed with Python's
``float``, which reads a ``repr`` back exactly) and every checkpoint leaf
bitwise the unsharded run's; the refusals as the reference's.
"""

import contextlib
import csv
import io
import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from mfm_tpu.cli import main as ref_main
from mfm_tpu_torch._device import VIRTUAL_DEVICES_ENV
from mfm_tpu_torch.cli import main
from mfm_tpu_torch.config import PipelineConfig, QuarantinePolicy
from mfm_tpu_torch.config import RiskModelConfig
from mfm_tpu_torch.data.artifacts import _numpy, load_artifact
from mfm_tpu_torch.data.csvio import read_csv, write_csv
from mfm_tpu_torch.data.etl import PanelStore
from mfm_tpu_torch.data.synthetic import (
    synthetic_barra_table,
    synthetic_collections,
)
from mfm_tpu_torch.parallel.mesh import make_mesh
from mfm_tpu_torch.pipeline import (
    append_risk_pipeline,
    run_risk_pipeline,
)

torch.set_num_threads(2)

T, N, P, Q, T0 = 44, 20, 3, 2, 40
FLAGS = ["--eigen-sims", "8", "--eigen-sim-length", "44", "--quarantine"]
TABLES = ("factor_returns", "r_squared", "specific_returns",
          "final_covariance", "lambda")


def run(pkg, argv):
    buf = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(buf):
        try:
            if pkg == "ref":
                ref_main(["--platform", "cpu", *argv])
            else:
                main([*argv, "--device", "cpu"])
        except SystemExit as e:
            code = e.code
    return code, buf.getvalue().splitlines()


def read_exact(path):
    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))
    return rows[0], [r[0] for r in rows[1:]], np.array(
        [[float(x) if x else np.nan for x in r[1:]] for r in rows[1:]])


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(a, b, equal_nan=True)


@pytest.fixture(scope="module")
def csvs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_cli")
    table, _ = synthetic_barra_table(T=T, N=N, P=P, Q=Q, seed=3)
    dates = np.unique(table["date"])
    head = {k: v[table["date"] < dates[T0]] for k, v in table.items()}
    write_csv(root / "full.csv", table)
    write_csv(root / "head.csv", head)
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        code, _ = run("port", ["risk", "--barra", "head.csv", "--out", "h",
                               "--save-state", "ck/state.npz", *FLAGS])
        assert code == 0, code
    return root


def _cfg():
    return PipelineConfig(risk=RiskModelConfig(
        eigen_n_sims=8, eigen_sim_length=44,
        quarantine=QuarantinePolicy(enabled=True)))


def test_risk_update_mesh_is_the_in_process_append(csvs, tmp_path,
                                                   monkeypatch):
    """``risk --update --mesh 2x2``: its tables are the unsharded CLI
    update's byte for byte and the in-process append's bit for bit, and
    its checkpoint's leaves are bitwise the unsharded update's."""
    monkeypatch.setenv(VIRTUAL_DEVICES_ENV, "4")
    monkeypatch.chdir(tmp_path)
    for d in ("plain", "mesh", "api"):
        shutil.copytree(csvs / "ck", d)
    full = str(csvs / "full.csv")
    code, lines = run("port", ["risk", "--barra", full, "--out", "o_plain",
                               "--update", "plain/state.npz", *FLAGS])
    assert code == 0, code
    code, lines = run("port", ["risk", "--barra", full, "--out", "o_mesh",
                               "--update", "mesh/state.npz", "--mesh", "2x2",
                               *FLAGS])
    assert code == 0, code
    rec = json.loads(lines[-1])
    assert len(rec["appended_dates"]) == T - T0
    for name in TABLES:
        assert (Path("o_mesh") / f"{name}.csv").read_bytes() == \
            (Path("o_plain") / f"{name}.csv").read_bytes(), name
    a, _ = load_artifact("mesh/state.npz")
    b, _ = load_artifact("plain/state.npz")
    assert a.keys() == b.keys()
    for k in b:
        assert _same(a[k], b[k]), k
    res = append_risk_pipeline("api/state.npz", read_csv(full),
                               config=_cfg(), device="cpu")
    _, _, fr = read_exact("o_mesh/factor_returns.csv")
    assert _same(fr, _numpy(res.outputs.factor_ret).astype(np.float64))
    _, _, lam = read_exact("o_mesh/lambda.csv")
    assert _same(lam[:, 0], _numpy(res.outputs.lamb).astype(np.float64))


def test_risk_full_run_mesh_is_the_in_process_mesh_run(csvs, tmp_path,
                                                      monkeypatch):
    """``risk --mesh 2x2`` over the full table (44 dates x 20 stocks):
    the tables are the unsharded run's byte for byte, and the sharded
    in-process run's bit for bit."""
    monkeypatch.setenv(VIRTUAL_DEVICES_ENV, "4")
    monkeypatch.chdir(tmp_path)
    full = str(csvs / "full.csv")
    flags = FLAGS[:-1]
    for out, extra in (("o_plain", []), ("o_mesh", ["--mesh", "2x2"])):
        code, _ = run("port", ["risk", "--barra", full, "--out", out,
                               *flags, *extra])
        assert code == 0, code
    for name in TABLES:
        assert (Path("o_mesh") / f"{name}.csv").read_bytes() == \
            (Path("o_plain") / f"{name}.csv").read_bytes(), name
    cfg = PipelineConfig(risk=RiskModelConfig(eigen_n_sims=8,
                                              eigen_sim_length=44))
    res = run_risk_pipeline(read_csv(full), config=cfg, device="cpu",
                            mesh=make_mesh(2, 2, device="cpu"))
    _, _, fr = read_exact("o_mesh/factor_returns.csv")
    assert _same(fr, _numpy(res.outputs.factor_ret).astype(np.float64))


def test_risk_update_mesh_refuses_as_the_reference(csvs, tmp_path,
                                                   monkeypatch):
    """A slab that does not divide the mesh refuses with the reference's
    message; so does a mesh of more devices than are up (the port naming
    its virtual-device variable)."""
    monkeypatch.chdir(tmp_path)
    for d in ("ref", "port"):
        shutil.copytree(csvs / "ck", d)
    monkeypatch.setenv(VIRTUAL_DEVICES_ENV, "8")
    msgs = {}
    for pkg in ("ref", "port"):
        code, _ = run(pkg, ["risk", "--barra", str(csvs / "full.csv"),
                            "--out", f"o_{pkg}", "--update",
                            f"{pkg}/state.npz", "--mesh", "8x1", *FLAGS])
        msgs[pkg] = code.replace(f"{pkg}/state.npz", "S")
    assert "must divide" in msgs["port"] and msgs["port"] == msgs["ref"]
    monkeypatch.delenv(VIRTUAL_DEVICES_ENV)
    code, _ = run("port", ["risk", "--barra", str(csvs / "full.csv"),
                           "--out", "o", "--mesh", "4x1", *FLAGS])
    assert code == (f"--mesh 4x1: needs 4 devices but only 1 are up — set "
                    f"{VIRTUAL_DEVICES_ENV}=4 before launch for a virtual "
                    "mesh")
    code, _ = run("port", ["risk", "--barra", "x.csv", "--mesh", "2y2"])
    assert code == "--mesh: want DATExSTOCK (e.g. 2x4), got '2y2'"


def test_pipeline_append_mesh_is_bitwise_from_scratch(tmp_path,
                                                      monkeypatch):
    """``pipeline --append --mesh`` over a store that grew: the tables and
    checkpoint are the unsharded append's bitwise, and so from scratch."""
    monkeypatch.setenv(VIRTUAL_DEVICES_ENV, "2")
    store = str(tmp_path / "store")
    synthetic_collections(PanelStore(store), T=100, N=30, n_industries=4,
                          seed=7)
    px = PanelStore(store).read("daily_prices")
    dates, counts = np.unique(px["trade_date"], return_counts=True)
    n = len(np.unique(px["ts_code"]))
    cut = [d for d, c in zip(dates[-12:-4], counts[-12:-4]) if c == n][-1]
    common = ["--store", store, "--eigen-sims", "8", "--eigen-sim-length",
              "50"]
    outs = {}
    for name, extra in (("plain", []), ("mesh", ["--mesh", "1x2"])):
        out = str(tmp_path / name)
        code, _ = run("port", ["pipeline", *common, "--out", out, "--end",
                               str(cut)])
        assert code == 0, code
        code, lines = run("port", ["pipeline", *common, "--out", out,
                                   "--append", *extra])
        assert code == 0, code
        outs[name] = json.loads(lines[-1])
    assert outs["mesh"]["appended_dates"] == outs["plain"]["appended_dates"]
    assert len(outs["mesh"]["appended_dates"]) >= 4
    for name in TABLES:
        assert (tmp_path / "mesh" / f"{name}.csv").read_bytes() == \
            (tmp_path / "plain" / f"{name}.csv").read_bytes(), name
    for art in ("risk_outputs.npz", "risk_state.npz"):
        a, _ = load_artifact(os.path.join(tmp_path / "mesh", art))
        b, _ = load_artifact(os.path.join(tmp_path / "plain", art))
        for k in b:
            assert _same(a[k], b[k]), (art, k)
