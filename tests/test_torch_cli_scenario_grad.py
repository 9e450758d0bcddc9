"""The port's ``scenario`` and ``grad`` subcommands and ``doctor
--scenarios`` on the CPU at float64, against the JAX package's, on one
guarded checkpoint written by the reference's CLI (``risk --save-state
--quarantine`` over ``synthetic_barra_table(T=100, N=60, P=6, Q=4)``), so
no Monte-Carlo draw differs between the packages.

- ``scenario list`` prints the reference's JSON byte for byte;
- ``scenario run`` (three presets, a replay, a counterfactual and a
  shock spec; the CLI builds its engine without history, so the replay
  and the counterfactual are rejected with the reference's problems),
  ``scenario sweep --no-refine`` and ``grad reverse|sensitivity|construct``
  agree with the reference's manifests and reports at 1e-8, but for the
  bands ROADMAP.md §C names: the PSD gate decides an exactly singular
  stressed covariance (the Jacobi's 0 against LAPACK's -1e-20) otherwise,
  so ``n_psd_projected`` differs; spec hashes hash the last bits; a
  min-vol optimum is flat, so its weights agree at 1e-7;
- the refined sweep equals the port's ``SweepEngine`` in this process bit
  for bit;
- ``doctor --scenarios`` exits as the reference's on a clean directory
  and on a torn manifest.
"""

import contextlib
import io
import json
import math
import shutil

import numpy as np
import pytest
import torch

from mfm_tpu.cli import main as ref_main
from mfm_tpu_torch.cli import main
from mfm_tpu_torch.data.artifacts import load_risk_state
from mfm_tpu_torch.data.csvio import write_csv
from mfm_tpu_torch.data.synthetic import synthetic_barra_table
from mfm_tpu_torch.grad import ShockBall
from mfm_tpu_torch.scenario import SweepEngine, UniformSampler

torch.set_num_threads(2)

RTOL = 1e-8
PRESETS = ("corr-meltup", "covid-2020-analog", "crash-2015-analog")
SPECS = [{"name": "replay-jan", "replay": ["2020-01-02", "2020-02-03"]},
         {"name": "cf-mar", "flip_quarantine": ["2020-03-02"]},
         {"name": "shock", "shift": [["country", 0.002]], "vol_mult": 1.5}]
SWEEP = ["--n", "1024", "--chunk", "256"]
#: fields that differ by run (timings, trace ids) or hash float bits
VOLATILE = ("summary", "spec_hash", "worst_spec_hash", "theta_spec_hash",
            "n_psd_projected", "psd_projections_total")


def run(pkg: str, argv: list, device: bool = True) -> tuple:
    """One in-process CLI call: (exit code, stdout); the port's on the
    CPU (``--device cpu``) when the command takes a device."""
    buf = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        try:
            if pkg == "ref":
                ref_main(["--platform", "cpu", *argv])
            else:
                main([*argv, "--device", "cpu"] if device else argv)
        except SystemExit as e:
            code = e.code
    return code, buf.getvalue()


def same_json(got, want, path="$", rtol=RTOL, weights_atol=None):
    """Equal structure, keys and strings; numbers within ``rtol``; the
    VOLATILE keys skipped; with ``weights_atol`` (a flat min-vol optimum)
    ``weights`` within it and the KKT residual ``diag`` within 10%, as
    ``tests/test_torch_serve_cli.py`` holds a served construct answer."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            if k in VOLATILE:
                continue
            if k == "weights" and weights_atol is not None:
                np.testing.assert_allclose(list(got[k].values()),
                                           list(want[k].values()), rtol=0,
                                           atol=weights_atol, err_msg=path)
                continue
            if k == "diag" and weights_atol is not None:
                np.testing.assert_allclose(got[k], want[k], rtol=0.1,
                                           err_msg=path)
                continue
            same_json(got[k], want[k], f"{path}.{k}", rtol, weights_atol)
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            same_json(g, w, f"{path}[{i}]", rtol, weights_atol)
    elif isinstance(want, float):
        assert isinstance(got, (float, int)), path
        assert (math.isnan(got) and math.isnan(want)) or math.isclose(
            got, want, rel_tol=rtol, abs_tol=1e-14), (path, got, want)
    else:
        assert got == want, (path, got, want)


@pytest.fixture(scope="module")
def ck(tmp_path_factory):
    """The reference CLI's guarded checkpoint, the spec file, and each
    package's scenario and grad outputs over it."""
    root = tmp_path_factory.mktemp("cli_scenario")
    table, _ = synthetic_barra_table(T=100, N=60, P=6, Q=4)
    write_csv(root / "barra.csv", table)
    (root / "specs.json").write_text(json.dumps(SPECS))
    outs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MFM_COMPILATION_CACHE", "off")
        mp.chdir(root)
        code, _ = run("ref", ["risk", "--barra", "barra.csv", "--out", "r",
                              "--save-state", "ck/state.npz", "--quarantine",
                              "--dtype", "float64", "--eigen-sims", "16"])
        assert code == 0
        pre = [a for p in PRESETS for a in ("--preset", p)]
        for pkg in ("ref", "port"):
            runs = {
                "run": ["scenario", "run", "ck/state.npz", *pre, "--spec",
                        "specs.json", "--out", f"{pkg}_run"],
                "sweep": ["scenario", "sweep", "ck/state.npz", *SWEEP,
                          "--no-refine", "--out", f"{pkg}_sweep"],
                "reverse": ["grad", "reverse", "ck/state.npz", "--steps",
                            "30", "--out", f"{pkg}_reverse"],
                "sensitivity": ["grad", "sensitivity", "ck/state.npz",
                                "--out", f"{pkg}_sensitivity"],
                "construct": ["grad", "construct", "ck/state.npz",
                              "min_vol", "--out", f"{pkg}_construct"],
            }
            for name, argv in runs.items():
                code, out = run(pkg, argv)
                assert code == 0, (pkg, name, code)
                outs[pkg, name] = out
    return root, outs


def _json(root, pkg, name, fname):
    return json.loads((root / f"{pkg}_{name}" / fname).read_text())


def test_scenario_list_is_the_reference_byte_for_byte():
    assert run("port", ["scenario", "list"], device=False) == \
        run("ref", ["scenario", "list"])


def test_scenario_run_is_the_reference(ck):
    root, outs = ck
    got = _json(root, "port", "run", "scenario_manifest.json")
    want = _json(root, "ref", "run", "scenario_manifest.json")
    same_json(got, want)
    assert got["n_ok"] == 4 and got["n_rejected"] == 2
    assert got["n_psd_projected"] >= 1
    lines = [json.loads(x) for x in outs["port", "run"].splitlines()]
    ref = [json.loads(x) for x in outs["ref", "run"].splitlines()]
    assert [(x["scenario"], x["status"], x["problems"]) for x in lines] == \
        [(x["scenario"], x["status"], x["problems"]) for x in ref]


def test_scenario_sweep_is_the_reference(ck):
    root, _ = ck
    got = _json(root, "port", "sweep", "sweep_manifest.json")
    want = _json(root, "ref", "sweep", "sweep_manifest.json")
    same_json(got, want)
    assert got["sweep"]["counts"]["n_psd_projected"] >= 1


def test_refined_sweep_is_the_in_process_engine(ck, tmp_path):
    """With its refinement (through the PSD gate's gradient, so across the
    packages only within the band), the CLI's sweep is the port's
    ``SweepEngine`` in this process, bit for bit."""
    root, _ = ck
    code, _ = run("port", ["scenario", "sweep", str(root / "ck/state.npz"),
                           *SWEEP, "--out", str(tmp_path)])
    assert code == 0
    got = json.loads((tmp_path / "sweep_manifest.json").read_text())
    st, meta = load_risk_state(str(root / "ck/state.npz"), device="cpu")
    eng = SweepEngine.from_risk_state(st, meta, device="cpu")
    W = np.full((1, eng.K), 1.0 / eng.K)
    ball = ShockBall()
    res = eng.sweep(W, UniformSampler(ball, eng.K, 1024, seed=0),
                    chunk=256, ball=ball, refine={"seed": 0})
    assert got["sweep"]["books"] == json.loads(json.dumps(res.books))
    assert got["sweep"]["refined"] == json.loads(json.dumps(res.refined))
    assert got["sweep"]["counts"] == res.counts


@pytest.mark.parametrize("name", ["reverse", "sensitivity", "construct"])
def test_grad_reports_are_the_reference(ck, name):
    root, outs = ck
    got = _json(root, "port", name, "grad_report.json")
    want = _json(root, "ref", name, "grad_report.json")
    same_json(got, want, weights_atol=1e-7 if name == "construct" else None)
    assert len(got["entries"]) == len(want["entries"]) >= 1
    if name == "sensitivity":
        same_json(_json(root, "port", name, "scenario_manifest.json"),
                  _json(root, "ref", name, "scenario_manifest.json"))


def test_doctor_scenarios_exits_as_the_reference(ck, tmp_path):
    root, _ = ck
    d = tmp_path / "d"
    shutil.copytree(root / "ck", d)
    for src in ("run", "sweep"):
        for f in (root / f"port_{src}").iterdir():
            shutil.copy(f, d / f.name)
    codes = {pkg: run(pkg, ["doctor", str(d), "--scenarios"], False)[0]
             for pkg in ("ref", "port")}
    assert codes == {"ref": 0, "port": 0}
    man = d / "scenario_manifest.json"
    man.write_text(man.read_text()[:200])
    out = {pkg: run(pkg, ["doctor", str(d), "--scenarios"], False)
           for pkg in ("ref", "port")}
    assert out["port"][0] == out["ref"][0] == 1
    recs = json.loads(out["port"][1])["records"]
    assert [r["status"] for r in recs if r["kind"] == "scenario_manifest"] \
        == ["corrupt"]
    (d / "scenario_manifest.json").unlink()
    codes = {pkg: run(pkg, ["doctor", str(d), "--scenarios"], False)[0]
             for pkg in ("ref", "port")}
    assert codes == {"ref": 0, "port": 0}   # a sweep alone only warns
