"""The port's ``risk`` subcommand (``python -m mfm_tpu_torch.cli risk``) on
the CPU at float64, against the JAX package's.

One synthetic barra table (``synthetic_barra_table(T=120, N=60, P=6,
Q=4)``) is written as a csv, with its first 100 dates as a second csv.
Both packages' CLIs run ``risk --save-state --quarantine --specific-risk
--save-outputs --portfolio-bias --portfolio --bias-plot`` on the head and
``risk --update`` on the whole table, at ``--eigen-sims 16``:

- the tables no Monte-Carlo draw reaches (``factor_returns``,
  ``r_squared``, ``specific_returns``, ``specific_risk``, and of
  ``portfolio_risk.json`` the date, the exposures and the specific
  variance) agree with the reference's at 1e-8;
- the ones the draws reach (``final_covariance``, ``lambda``,
  ``portfolio_bias.json``, ``bias_stats.json``, and the factor variance
  of ``portfolio_risk.json``, which is priced with the adjusted
  covariance) differ, since ``jax.random`` is not ``torch.Generator``:
  they equal the port's ``run_risk_pipeline`` with the same seed bit for
  bit (that function is held to the reference with injected draws in
  ``tests/test_torch_pipeline.py``);
- a checkpoint written by either package's ``--save-state`` is taken by
  the other's ``--update``: the appended dates' regression tables and
  Newey-West covariances agree at 1e-8;
- every refusal exits with the reference's message; the csv path needs
  no pandas, and its reader types a date column as ``pd.read_csv`` does.
"""

import contextlib
import csv
import io
import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from mfm_tpu import pipeline as ref_pipeline
from mfm_tpu.cli import main as ref_main
from mfm_tpu.utils.report import load_results
from mfm_tpu_torch.cli import main
from mfm_tpu_torch.config import (
    PipelineConfig,
    QuarantinePolicy,
    RiskModelConfig,
)
from mfm_tpu_torch.data.artifacts import _numpy, load_risk_outputs
from mfm_tpu_torch.data.csvio import read_csv, write_csv
from mfm_tpu_torch.data.synthetic import synthetic_barra_table
from mfm_tpu_torch.models.bias import bias_stats_summary
from mfm_tpu_torch.pipeline import (
    date_stamp,
    load_risk_pipeline_result,
    run_risk_pipeline,
)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
T, T0, N, P, Q, M = 120, 100, 60, 6, 4, 16
BURN_IN = 20
RTOL = 1e-8
TABLES_NO_DRAW = ("factor_returns", "r_squared", "specific_returns",
                  "specific_risk")
RISK_FLAGS = ["--eigen-sims", str(M), "--dtype", "float64", "--quarantine"]
FULL_FLAGS = ["--specific-risk", "--save-outputs", "--portfolio-bias", "5",
              "--bias-burn-in", str(BURN_IN), "--bias-plot", "bias.png"]


def run(pkg: str, argv: list) -> tuple:
    """One in-process CLI call: (exit code or message, stdout lines)."""
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


def read_exact(path) -> tuple:
    """A result table as (index, columns, float64 values), each cell
    parsed by Python's ``float`` (a ``repr`` reads back bit for bit)."""
    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))
    vals = np.array([[float(c) if c else np.nan for c in r[1:]]
                     for r in rows[1:]])
    return [r[0] for r in rows[1:]], rows[0][1:], vals


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs over the same csvs: a full run with a checkpoint, and an
    update of each package's checkpoint by itself and by the other."""
    root = tmp_path_factory.mktemp("cli_risk")
    table, _ = synthetic_barra_table(T=T, N=N, P=P, Q=Q)
    dates = np.unique(table["date"])
    head = {k: v[table["date"] < dates[T0]] for k, v in table.items()}
    write_csv(root / "full.csv", table)
    write_csv(root / "head.csv", head)
    stocks = np.unique(table["stocknames"])
    with open(root / "pf.csv", "w") as fh:
        fh.write("ts_code,weight\n" + "".join(
            f"{s},{float(w)!r}\n" for s, w in zip(stocks[:12], np.linspace(
                0.05, 0.15, 12))))
    out = {"root": root, "head": head, "table": table}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MFM_COMPILATION_CACHE", "off")
        mp.chdir(root)
        for pkg in ("ref", "port"):
            code, lines = run(pkg, [
                "risk", "--barra", "head.csv", "--out", f"{pkg}_full",
                "--save-state", f"{pkg}_ck/state.npz", "--portfolio",
                "pf.csv", *FULL_FLAGS, *RISK_FLAGS])
            assert code == 0, code
            out[f"{pkg}_full"] = json.loads(lines[-1])
        for ck in ("ref", "port"):
            for pkg in ("ref", "port"):
                d = f"{ck}_ck_by_{pkg}"
                shutil.copytree(f"{ck}_ck", d)
                code, lines = run(pkg, [
                    "risk", "--barra", "full.csv", "--out", f"{d}_out",
                    "--update", f"{d}/state.npz", "--save-outputs",
                    *RISK_FLAGS])
                assert code == 0, (d, code)
                out[d] = json.loads(lines[-1])
    return out


@pytest.mark.parametrize("name", TABLES_NO_DRAW)
def test_tables_no_draw_reaches_agree_with_the_reference(runs, name):
    root = runs["root"]
    got = pd.read_csv(root / "port_full" / f"{name}.csv", index_col=0)
    want = pd.read_csv(root / "ref_full" / f"{name}.csv", index_col=0)
    assert list(got.index) == list(want.index)
    assert list(got.columns) == list(want.columns)
    np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), rtol=RTOL,
                               atol=1e-12, equal_nan=True, err_msg=name)


@pytest.fixture(scope="module")
def in_process(runs):
    """The port's pipeline in this process on the same csv and seed, as
    the CLI runs it."""
    cfg = PipelineConfig(risk=RiskModelConfig(
        eigen_n_sims=M, seed=0, quarantine=QuarantinePolicy(enabled=True)),
        dtype="float64")
    return run_risk_pipeline(read_csv(runs["root"] / "head.csv"),
                             config=cfg, with_state=True, device="cpu")


def test_portfolio_risk_agrees_where_no_draw_enters(runs, in_process):
    root = runs["root"]
    got = json.loads((root / "port_full" / "portfolio_risk.json").read_text())
    want = json.loads((root / "ref_full" / "portfolio_risk.json").read_text())
    assert list(got) == list(want)
    assert got["date"] == want["date"]
    np.testing.assert_allclose(got["specific_var"], want["specific_var"],
                               rtol=RTOL)
    assert list(got["factor_exposures"]) == list(want["factor_exposures"])
    np.testing.assert_allclose(list(got["factor_exposures"].values()),
                               list(want["factor_exposures"].values()),
                               rtol=RTOL, atol=1e-14)
    # the factor variance is priced with the adjusted covariance
    pf = read_csv(root / "pf.csv")
    w = np.zeros(N)
    w[np.searchsorted(in_process.arrays.stocks, pf["ts_code"])] = pf["weight"]
    rep = in_process._portfolio_risk(w, -1, None, 42.0, 10, 1.0, 10)
    for k in ("factor_var", "specific_var", "total_vol"):
        assert got[k] == rep[k], k
    assert list(got["factor_risk_contribution"].values()) == \
        rep["factor_risk_contribution"].tolist()


@pytest.mark.parametrize("name", ["final_covariance", "lambda"])
def test_tables_draws_reach_are_the_in_process_pipeline(runs, in_process,
                                                        name):
    index, columns, vals = read_exact(runs["root"] / "port_full"
                                      / f"{name}.csv")
    o, a = in_process.outputs, in_process.arrays
    if name == "lambda":
        want, want_index = _numpy(o.lamb)[:, None], list(a.dates)
    else:
        want, want_index = _numpy(o.vr_cov[-1]), a.factor_names()
    assert index == [str(x) for x in want_index]
    assert np.array_equal(vals, want, equal_nan=True)


def test_bias_json_are_the_in_process_pipeline(runs, in_process):
    root = runs["root"] / "port_full"
    o = in_process.outputs
    summary = bias_stats_summary(o.nw_cov, o.nw_valid, o.eigen_cov,
                                 o.eigen_valid, o.factor_ret,
                                 burn_in=BURN_IN)
    summary["backend"] = "cpu"
    assert json.loads((root / "bias_stats.json").read_text()) == summary
    assert (root / "bias.png").stat().st_size > 0
    assert json.loads((root / "portfolio_bias.json").read_text()) == \
        in_process.portfolio_bias(n_portfolios=5, burn_in=BURN_IN)
    ref = json.loads((runs["root"] / "ref_full" / "bias_stats.json")
                     .read_text())
    assert sorted(ref) == sorted(summary)


def test_json_records_have_the_reference_keys(runs):
    """The port adds only its ``kernels`` block (launches by kernel and
    design; none on the CPU)."""
    for kind in ("full", "ck_by"):
        got = runs["port_full" if kind == "full" else "port_ck_by_port"]
        want = runs["ref_full" if kind == "full" else "ref_ck_by_ref"]
        assert set(got) - set(want) == {"kernels"}
        assert set(want) <= set(got)
        assert not any(got["kernels"]["launches"].values())
    for k in ("dates", "stocks", "factors"):
        assert runs["port_full"][k] == runs["ref_full"][k]
    assert runs["port_ck_by_port"]["appended_dates"] == \
        runs["ref_ck_by_ref"]["appended_dates"]
    assert runs["port_ck_by_port"]["quarantined"] == []
    np.testing.assert_allclose(runs["port_full"]["mean_r2"],
                               runs["ref_full"]["mean_r2"], rtol=RTOL)


@pytest.mark.parametrize("ck", ["ref", "port"])
def test_checkpoints_cross_between_packages(runs, ck):
    """Each package's checkpoint updated by both packages: the appended
    dates' regression tables and Newey-West covariance agree."""
    root = runs["root"]
    by_ref, by_port = (root / f"{ck}_ck_by_ref_out",
                       root / f"{ck}_ck_by_port_out")
    for name in ("factor_returns", "r_squared", "specific_returns"):
        got = pd.read_csv(by_port / f"{name}.csv", index_col=0)
        want = pd.read_csv(by_ref / f"{name}.csv", index_col=0)
        assert list(got.index) == list(want.index)
        assert len(got) == T - T0
        np.testing.assert_allclose(got.to_numpy(), want.to_numpy(),
                                   rtol=RTOL, atol=1e-12, equal_nan=True,
                                   err_msg=name)
    got, _ = load_risk_outputs(str(by_port / "risk_outputs.npz"), "cpu")
    want = np.load(by_ref / "risk_outputs.npz")
    assert np.array_equal(_numpy(got.nw_valid), want["nw_valid"])
    np.testing.assert_allclose(_numpy(got.nw_cov), want["nw_cov"],
                               rtol=RTOL, atol=1e-14)
    # the state advanced in place, past the table's last date
    for pkg in ("ref", "port"):
        rec = runs[f"{ck}_ck_by_{pkg}"]
        assert rec["appended_dates"][-1] == date_stamp(
            runs["table"]["date"][-1])


def test_manifest_beside_the_checkpoint_and_doctor(runs, capsys):
    root = runs["root"]
    man = json.loads((root / "port_ck" / "run_manifest.json").read_text())
    ref = json.loads((root / "ref_ck" / "run_manifest.json").read_text())
    assert set(ref) - set(man) == set()
    assert man["backend"] == "cpu" and man["checkpoint"] == "state.npz"
    assert man["health"]["status"] in ("ok", "degraded", "unknown")
    assert set(man["health"]["checks"]) == set(ref["health"]["checks"])
    assert man["trace_id"] == runs["port_full"]["trace_id"]
    with pytest.raises(SystemExit) as exc:
        main(["doctor", str(root / "port_ck")])
    assert exc.value.code == 0, capsys.readouterr().out
    # the update's manifest counts the appended dates it guarded
    upd = json.loads((root / "port_ck_by_port" / "run_manifest.json")
                     .read_text())
    assert upd["health"]["status"] == runs["port_ck_by_port"]["health"]
    assert upd["guard"]["served_dates"] >= T - T0


def test_result_tables_read_back_in_both_packages(runs, tmp_path):
    """The reference's ``load_results`` reads the port's tables, and the
    port's ``load_risk_pipeline_result`` rehydrates its npz with the
    barra csv."""
    root = runs["root"]
    got = load_results(str(root / "port_full"))
    want = load_results(str(root / "ref_full"))
    assert set(got) == set(want)
    for k in ("factor_returns", "r_squared", "specific_returns"):
        assert (got[k].index == want[k].index).all()
        np.testing.assert_allclose(got[k].to_numpy(), want[k].to_numpy(),
                                   rtol=RTOL, atol=1e-12, equal_nan=True)
    res = load_risk_pipeline_result(str(root / "port_full"),
                                    barra_csv=str(root / "head.csv"),
                                    device="cpu")
    index, _, vals = read_exact(root / "port_full" / "factor_returns.csv")
    assert index == [str(d) for d in res.arrays.dates]
    assert np.array_equal(vals, _numpy(res.outputs.factor_ret),
                          equal_nan=True)


def test_risk_runs_without_pandas(runs, tmp_path):
    """The csv path in a process where pandas cannot be imported writes
    the same bytes."""
    root = runs["root"]
    out = tmp_path / "nopd"
    code = textwrap.dedent(f"""
        import sys
        sys.modules["pandas"] = None
        import torch
        torch.set_num_threads(2)
        from mfm_tpu_torch.cli import main
        main(["risk", "--barra", {str(root / "head.csv")!r}, "--out",
              {str(out)!r}, "--device", "cpu", "--specific-risk",
              "--portfolio", {str(root / "pf.csv")!r}, "--eigen-sims",
              "{M}", "--dtype", "float64"])
    """)
    env = {**os.environ, "PYTHONPATH": str(ROOT), "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "pandas" not in proc.stderr
    # the same tables as the in-process run of the same flags
    base = tmp_path / "base"
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        assert run("port", ["risk", "--barra", "head.csv", "--out",
                            str(base), "--specific-risk", "--portfolio",
                            "pf.csv", "--eigen-sims", str(M),
                            "--dtype", "float64"])[0] == 0
    for name in (*TABLES_NO_DRAW, "final_covariance", "lambda"):
        assert (out / f"{name}.csv").read_bytes() == \
            (base / f"{name}.csv").read_bytes(), name
    assert json.loads((out / "portfolio_risk.json").read_text()) == \
        json.loads((base / "portfolio_risk.json").read_text())


@pytest.mark.parametrize("form", ["int", "float", "str"])
def test_csv_reader_types_a_date_column_as_pandas(tmp_path, form):
    """An integer, float and string ``date`` column reach ``date_stamp``
    as the values ``pd.read_csv`` gives, so each stamps as the port stamps
    pandas' frame; a string date stamps as the reference does (an integer
    or float date stamps as its digits' day in the port, and as
    ``1970-01-01`` in the reference: ``test_torch_pipeline``)."""
    days = ["20200102", "20200103", "20200106"]
    col = {"int": days, "float": [d + ".0" for d in days],
           "str": [f"{d[:4]}-{d[4:6]}-{d[6:]}" for d in days]}[form]
    path = tmp_path / "b.csv"
    path.write_text("date,stocknames,capital,ret,industry,size\n" + "".join(
        f"{d},s{j},1.5,0.01,i{j % 2},0.3\n" for d in col for j in range(4)))
    got, want = read_csv(path), pd.read_csv(path)
    assert list(got) == list(want.columns)
    for c in want.columns:
        g, w = got[c], want[c].to_numpy()
        assert all(isinstance(x, str) == isinstance(y, str)
                   for x, y in zip(g, w)), c
        assert list(g) == list(w), c
    stamps = [date_stamp(d) for d in got["date"]]
    assert stamps == [date_stamp(d) for d in want["date"]]
    if form == "str":
        assert stamps == [ref_pipeline.date_stamp(d) for d in want["date"]]
    assert {"int": np.int64, "float": np.float64,
            "str": np.str_}[form] == type(got["date"][0])


def _error_cases(root):
    bad_pf = root / "bad_pf.csv"
    bad_pf.write_text("ts_code,w\nx,1\n")
    unknown_pf = root / "unknown_pf.csv"
    unknown_pf.write_text("ts_code,weight\nnope,1\n")
    stocks = np.unique(read_csv(root / "head.csv")["stocknames"])
    dup_pf = root / "dup_pf.csv"
    dup_pf.write_text(f"ts_code,weight\n{stocks[0]},1\n{stocks[0]},2\n")
    return {
        "update_and_save_state": ["--update", "a.npz", "--save-state",
                                  "b.npz"],
        "save_state_associative": ["--save-state", "b.npz", "--nw-method",
                                   "associative"],
        "update_portfolio_bias": ["--update", "a.npz", "--portfolio-bias",
                                  "3"],
        "update_bias_plot": ["--update", "a.npz", "--bias-plot", "x.png"],
        "portfolio_columns": ["--portfolio", str(bad_pf)],
        "portfolio_unknown": ["--portfolio", str(unknown_pf)],
        "portfolio_duplicates": ["--portfolio", str(dup_pf)],
        "update_no_new_date": ["--update", "{ck}/state.npz"],
        "update_torn_checkpoint": ["--update", "{ck}/state.npz"],
    }


@pytest.mark.parametrize("case", [
    "update_and_save_state", "save_state_associative",
    "update_portfolio_bias", "update_bias_plot", "portfolio_columns",
    "portfolio_unknown", "portfolio_duplicates", "update_no_new_date",
    "update_torn_checkpoint"])
def test_refusals_exit_with_the_reference_message(runs, case):
    root = runs["root"]
    flags = _error_cases(root)[case]
    msgs = {}
    for pkg in ("ref", "port"):
        ck = root / f"err_{case}_{pkg}"
        shutil.copytree(root / f"{pkg}_ck", ck)
        if case == "update_torn_checkpoint":
            blob = (ck / "state.npz").read_bytes()
            (ck / "state.npz").write_bytes(blob[:len(blob) // 2])
        argv = ["risk", "--barra", str(root / "head.csv"), "--out",
                str(root / f"err_out_{pkg}"), "--eigen-sims", str(M),
                "--dtype", "float64",
                *(f.format(ck=ck) for f in flags)]
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("MFM_COMPILATION_CACHE", "off")
            mp.chdir(root)
            code, _ = run(pkg, argv)
        assert isinstance(code, str), (pkg, code)
        msgs[pkg] = code.replace(str(ck), "CK")
    # the port's artifact errors point at no document of the reference
    assert msgs["port"] == msgs["ref"].replace(" (docs/SERVING.md)", "")


def test_bias_plot_without_matplotlib_exits_as_the_reference(runs):
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "matplotlib", None)
        msgs = [run(pkg, ["risk", "--barra", "x.csv", "--bias-plot",
                          "b.png"])[0] for pkg in ("ref", "port")]
    assert msgs[0] == msgs[1] and "needs matplotlib" in msgs[0]


@pytest.mark.parametrize("flag,item", [(["--barra", "x.csv", "--mesh",
                                         "1x2"], "§A 16"),
                                       (["--barra", "x.csv", "--mesh",
                                         "2x1"], "§A 16")],
                         ids=["flag0-§A 16", "flag1-§A 16"])
def test_unported_flags_name_their_item(flag, item, monkeypatch, tmp_path):
    """``--mesh`` is ported (§A 16d).  With one device up it refuses as
    the reference does, naming the virtual-device variable where the
    reference names XLA_FLAGS; with two virtual devices the command gets
    past its flags to its input and fails there exactly as the
    reference does."""
    from mfm_tpu_torch._device import VIRTUAL_DEVICES_ENV

    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv(VIRTUAL_DEVICES_ENV, raising=False)
    code, _ = run("port", ["risk", *flag])
    spec = flag[-1]
    assert code == (f"--mesh {spec}: needs 2 devices but only 1 are up — "
                    f"set {VIRTUAL_DEVICES_ENV}=2 before launch for a "
                    "virtual mesh")
    assert "not ported" not in code
    monkeypatch.setenv(VIRTUAL_DEVICES_ENV, "2")
    errs = []
    for pkg in ("ref", "port"):
        with pytest.raises((ValueError, OSError)) as exc:
            run(pkg, ["risk", *flag])
        errs.append((type(exc.value), str(exc.value)))
    assert errs[0] == errs[1]


def test_device_cuda_raises_without_a_card(runs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: --device cuda runs on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["risk", "--barra", str(runs["root"] / "head.csv"), "--out",
              str(tmp_path / "never")])
    assert not (tmp_path / "never").exists()


@pytest.mark.parametrize("flag", ["--profile", "--jax-profile"])
def test_profile_and_metrics_dir(runs, tmp_path, flag):
    """``--profile DIR`` (``--jax-profile`` its synonym) writes a
    ``torch.profiler`` Chrome trace and its summary; ``--metrics-dir``
    the snapshot with the run's stage walls."""
    root = runs["root"]
    prof, mdir = tmp_path / "prof", tmp_path / "metrics"
    code, lines = run("port", ["risk", "--barra", str(root / "head.csv"),
                               "--out", str(tmp_path / "out"), flag,
                               str(prof), "--metrics-dir", str(mdir),
                               "--eigen-sims", str(M), "--dtype", "float64"])
    assert code == 0
    assert json.loads((prof / "trace.json").read_text())["traceEvents"]
    summary = json.loads((prof / "profile_summary.json").read_text())
    assert summary["device"] == "cpu" and summary["wall_s"] > 0
    assert summary["device_s"] is None and summary["peak_memory_bytes"] is None
    snap = json.loads((mdir / "metrics.json").read_text())["metrics"]
    stages = {s["labels"]["stage"] for s in
              snap["mfm_stage_seconds"]["series"]}
    assert {"read_barra_csv", "write_result_tables", "risk_full"} <= stages
    tid = json.loads(lines[-1])["trace_id"]
    assert tid
    # the run's body goes on under its root span: the rebuild's stage
    # spans land in the root's trace, in the run's trace.json
    events = [e for e in json.loads((mdir / "trace.json").read_text())[
        "traceEvents"] if e["args"]["trace_id"] == tid]
    (root,) = [e for e in events if e["name"] == "cli.risk"]
    ids = {e["name"]: e["args"] for e in events}
    assert ids["risk.run"]["parent_id"] == root["args"]["span_id"]
    for name in ("risk.regression", "risk.newey_west", "risk.eigen",
                 "risk.vol_regime"):
        assert ids[name]["parent_id"] == ids["risk.run"]["span_id"]
