"""The port's ``demo`` and ``factors`` subcommands on the CPU at float64,
against the JAX package's.

- ``demo`` (``synthetic_barra_table(T=120, N=60, P=6, Q=4)``, 16 eigen
  simulations): the regression tables agree with the reference's at
  1e-8; the covariance and lambda tables, which the Monte-Carlo draws
  reach, equal the port's ``run_risk_pipeline`` on the same table and
  seed bit for bit; ``--check-determinism`` reports true.
- ``factors`` on a raw CSI300-like panel (``synthetic_market_panel(T=300,
  N=30)`` as a long csv, its index prices and industry map): the port's
  ``barra_data.csv`` agrees with the reference's within the float64 level
  of ``tests/test_torch_factor_pipeline.py`` (rtol 1e-8, the NaN pattern
  exact), equals ``run_factor_pipeline`` on the panel read from the same
  csv bit for bit, and a parquet panel or a ``--prepared`` directory
  gives the same table.  The csv path needs no pandas.
"""

import contextlib
import csv
import io
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from mfm_tpu.cli import main as ref_main
from mfm_tpu_torch.cli import _read_long_table, _reindex, main
from mfm_tpu_torch.config import PipelineConfig, RiskModelConfig
from mfm_tpu_torch.data.artifacts import _numpy
from mfm_tpu_torch.data.csvio import read_csv
from mfm_tpu_torch.data.synthetic import (
    PANEL_META_KEYS,
    synthetic_barra_table,
    synthetic_market_panel,
)
from mfm_tpu_torch.panel import Panel
from mfm_tpu_torch.pipeline import run_factor_pipeline, run_risk_pipeline

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-8
DEMO = ["--dtype", "float64"]
FT, FN = 300, 30


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


def exact_values(path, skip: int = 1) -> np.ndarray:
    """The numeric cells of a csv, each parsed by Python's ``float`` (a
    ``repr`` reads back bit for bit); the first ``skip`` columns left
    out."""
    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))[1:]
    return np.array([[float(c) if c else np.nan for c in r[skip:]]
                     for r in rows])


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_demo")
    recs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MFM_COMPILATION_CACHE", "off")
        mp.chdir(root)
        for pkg in ("ref", "port"):
            code, lines = run(pkg, ["demo", "--out", pkg, *DEMO,
                                    "--check-determinism"])
            assert code == 0, code
            recs[pkg] = json.loads(lines[-1])
    return root, recs


@pytest.mark.parametrize("name", ["factor_returns", "r_squared",
                                  "specific_returns"])
def test_demo_regression_tables_agree_with_the_reference(demo, name):
    root, _ = demo
    got = pd.read_csv(root / "port" / f"{name}.csv", index_col=0)
    want = pd.read_csv(root / "ref" / f"{name}.csv", index_col=0)
    assert list(got.index) == list(want.index)
    assert list(got.columns) == list(want.columns)
    np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), rtol=RTOL,
                               atol=1e-12, equal_nan=True)


def test_demo_checks_determinism(demo):
    _, recs = demo
    assert set(recs["port"]) == set(recs["ref"])
    assert recs["port"]["deterministic"] is True
    assert recs["port"]["out"] == "port"


@pytest.mark.parametrize("name", ["final_covariance", "lambda"])
def test_demo_tables_draws_reach_are_the_in_process_pipeline(demo, name):
    root, _ = demo
    table, _ = synthetic_barra_table(T=120, N=60, P=6, Q=4, seed=0)
    res = run_risk_pipeline(table, config=PipelineConfig(
        risk=RiskModelConfig(eigen_n_sims=16), dtype="float64"),
        device="cpu")
    want = (_numpy(res.outputs.vr_cov[-1]) if name == "final_covariance"
            else _numpy(res.outputs.lamb)[:, None])
    assert np.array_equal(exact_values(root / "port" / f"{name}.csv"), want,
                          equal_nan=True)


@pytest.fixture(scope="module")
def panel_files(tmp_path_factory):
    """The raw panel as the three inputs of ``factors``: a long csv (and
    the same as parquet), the index prices and the industry map."""
    root = tmp_path_factory.mktemp("cli_factors")
    d = synthetic_market_panel(T=FT, N=FN, n_industries=5, seed=0)
    fields = [k for k in d if k not in PANEL_META_KEYS]
    ed = d["end_date_code"].astype(float)
    ed[ed < 0] = np.nan
    long = {"trade_date": np.repeat([str(x) for x in d["dates"]], FN),
            "ts_code": np.tile(d["stocks"], FT),
            **{k: d[k].reshape(-1) for k in fields},
            "end_date": (20_000_000 + ed).reshape(-1)}
    pd.DataFrame(long).to_csv(root / "panel.csv", index=False)
    prep = root / "prepared"
    prep.mkdir()
    frame = pd.DataFrame(long)
    frame["trade_date"] = pd.to_datetime(frame["trade_date"])
    frame.to_parquet(prep / "panel.parquet", index=False)
    index = pd.DataFrame({"trade_date": [str(x) for x in d["dates"]],
                          "close": d["index_close"]})
    ind = pd.DataFrame({"ts_code": d["stocks"], "l1_code": d["industry"]})
    for dst in (root, prep):
        index.to_csv(dst / ("index_prices.csv" if dst == prep
                            else "index.csv"), index=False)
        ind.to_csv(dst / ("industry_map.csv" if dst == prep
                          else "ind.csv"), index=False)
    outs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MFM_COMPILATION_CACHE", "off")
        mp.chdir(root)
        for pkg in ("ref", "port"):
            code, lines = run(pkg, ["factors", "--panel", "panel.csv",
                                    "--index", "index.csv", "--industry",
                                    "ind.csv", "--out", f"{pkg}_out",
                                    "--dtype", "float64"])
            assert code == 0, code
            outs[pkg] = json.loads(lines[-1])
    return root, outs


def test_factors_agree_with_the_reference(panel_files):
    root, outs = panel_files
    assert outs["port"]["rows"] == outs["ref"]["rows"]
    got = pd.read_csv(root / "port_out" / "barra_data.csv")
    want = pd.read_csv(root / "ref_out" / "barra_data.csv")
    assert list(got.columns) == list(want.columns)
    for c in ("date", "stocknames", "industry"):
        assert (got[c] == want[c]).all(), c
    num = [c for c in want.columns if c not in ("date", "stocknames",
                                                "industry")]
    g, w = got[num].to_numpy(), want[num].to_numpy()
    np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
    m = np.isfinite(w)
    for j, c in enumerate(num):
        col = m[:, j]
        scale = np.abs(w[col, j]).max()
        np.testing.assert_allclose(g[col, j], w[col, j], rtol=RTOL,
                                   atol=1e-12 * scale, err_msg=c)


def test_factors_are_the_in_process_pipeline(panel_files):
    """``barra_data.csv`` is ``run_factor_pipeline`` on the panel read from
    the same csv, bit for bit."""
    root, _ = panel_files
    p = Panel.from_long(_read_long_table(str(root / "panel.csv")))
    index = read_csv(root / "index.csv", parse_dates=("trade_date",))
    ind = read_csv(root / "ind.csv")
    ed = p.fields.pop("end_date")
    ok = np.isfinite(ed)
    rid = np.full(ed.shape, -1, np.int32)
    rid[ok] = np.searchsorted(np.unique(ed[ok]), ed[ok])
    p.fields["end_date_code"] = rid
    table, _ = run_factor_pipeline(
        p.fields, _reindex(index["trade_date"], index["close"], p.dates),
        _reindex(ind["ts_code"], ind["l1_code"], p.stocks), p.dates,
        p.stocks, PipelineConfig(dtype="float64"), device="cpu")
    cli = read_csv(root / "port_out" / "barra_data.csv")
    assert list(cli) == list(table)
    assert cli["stocknames"].tolist() == table["stocknames"].tolist()
    assert cli["date"].tolist() == [str(d.astype("datetime64[D]"))
                                    for d in table["date"]]
    vals = exact_values(root / "port_out" / "barra_data.csv", skip=2)
    cols = [c for c in table if c not in ("date", "stocknames")]
    want = np.stack([np.asarray(table[c], np.float64) for c in cols], 1)
    assert np.array_equal(vals, want, equal_nan=True)


@pytest.mark.parametrize("how", ["parquet", "prepared"])
def test_parquet_and_prepared_give_the_csv_table(panel_files, how):
    """The parquet panel holds the written float64 values, the csv the
    ones pandas' parser reads back (within ~1e-13), so the tables agree
    at 1e-8."""
    root, _ = panel_files
    out = root / f"port_{how}"
    src = (["--prepared", str(root / "prepared")] if how == "prepared" else
           ["--panel", str(root / "prepared" / "panel.parquet"), "--index",
            str(root / "index.csv"), "--industry", str(root / "ind.csv")])
    code, _ = run("port", ["factors", *src, "--out", str(out), "--dtype",
                           "float64"])
    assert code == 0, code
    got = pd.read_csv(out / "barra_data.csv")
    want = pd.read_csv(root / "port_out" / "barra_data.csv")
    assert list(got.columns) == list(want.columns)
    assert (got["date"] == want["date"]).all()
    num = [c for c in want.columns if c not in ("date", "stocknames",
                                                "industry")]
    np.testing.assert_allclose(got[num].to_numpy(), want[num].to_numpy(),
                               rtol=RTOL, atol=1e-12, equal_nan=True)


@pytest.mark.parametrize("case", ["both", "neither", "missing"])
def test_factors_refusals_exit_with_the_reference_message(panel_files,
                                                          tmp_path, case):
    root, _ = panel_files
    argv = {"both": ["--prepared", str(root / "prepared"), "--panel", "x"],
            "neither": ["--panel", "x"],
            "missing": ["--prepared", str(tmp_path)]}[case]
    msgs = [run(pkg, ["factors", *argv])[0] for pkg in ("ref", "port")]
    assert isinstance(msgs[0], str) and msgs[0] == msgs[1]


def test_factors_run_without_pandas(panel_files, tmp_path):
    root, _ = panel_files
    out = tmp_path / "nopd"
    code = textwrap.dedent(f"""
        import sys
        sys.modules["pandas"] = None
        import torch
        torch.set_num_threads(2)
        from mfm_tpu_torch.cli import main
        main(["factors", "--panel", {str(root / "panel.csv")!r}, "--index",
              {str(root / "index.csv")!r}, "--industry",
              {str(root / "ind.csv")!r}, "--out", {str(out)!r},
              "--dtype", "float64", "--device", "cpu"])
    """)
    env = {**os.environ, "PYTHONPATH": str(ROOT), "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert (out / "barra_data.csv").read_bytes() == \
        (root / "port_out" / "barra_data.csv").read_bytes()


def test_reindex_is_pandas_reindex():
    keys = np.array(["b", "a", "c"])
    got = _reindex(keys, np.array([1, 2, 3]), np.array(["a", "x", "c"]))
    want = pd.Series([1, 2, 3], index=keys).reindex(["a", "x", "c"])
    np.testing.assert_array_equal(got, want.to_numpy())
    assert got.dtype == want.dtype
    with pytest.raises(ValueError, match="duplicate"):
        _reindex(np.array(["a", "a"]), np.array([1, 2]), np.array(["a"]))
