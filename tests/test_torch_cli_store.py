"""The port's store commands (``prepare``, ``factors --prepared``,
``pipeline`` with ``--append`` / ``--to-store``, ``risk --barra-store``
and ``etl-*``) on the CPU at float64, against the JAX package's.

Both packages' ``synthetic_collections`` fill a store each from the same
seed (the stores are the same rows, ``tests/test_torch_pit_prepare.py``).
Then:

- ``prepare``'s panel reads back as the reference's panel, cell for cell;
- ``factors --prepared`` and ``pipeline``'s factor table, and the tables
  no Monte-Carlo draw reaches (``factor_returns``, ``r_squared``,
  ``specific_returns``), agree with the reference's at 1e-8;
- the covariance and ``risk_outputs.npz`` are bit for bit the port's own
  ``run_risk_pipeline`` on the same table and seed (``jax.random`` is not
  ``torch.Generator``);
- ``--append`` over a store that grew lands bitwise on a from-scratch run
  (tables, ``risk_outputs.npz``, ``risk_state.npz``), and refuses a
  revised history with the reference's message;
- ``risk --barra-store`` on ``pipeline --to-store``'s collections gives
  ``pipeline``'s outputs bit for bit;
- every ``etl-*`` record is the reference's;
- the whole path runs with pandas and pyarrow unimportable.
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

from mfm_tpu.cli import main as ref_main
from mfm_tpu.data.etl import PanelStore as RefStore
from mfm_tpu.data.synthetic import synthetic_collections as ref_collections
from mfm_tpu.obs import instrument as ref_instrument
from mfm_tpu_torch.cli import main
from mfm_tpu_torch.data.artifacts import _numpy, load_artifact
from mfm_tpu_torch.data.columns import take
from mfm_tpu_torch.data.csvio import read_csv
from mfm_tpu_torch.data.etl import PanelStore, read_table
from mfm_tpu_torch.data.prepare import prepare_factor_inputs
from mfm_tpu_torch.data.synthetic import synthetic_collections
from mfm_tpu_torch.obs import instrument

from tests.test_torch_store import canon
from tests.test_xlsx import write_xlsx

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-8
GEN = dict(T=100, N=30, n_industries=4, seed=7)
COMMON = ["--eigen-sims", "8", "--eigen-sim-length", "50", "--dtype",
          "float64"]
#: an append compares the prior run's csv with the refreshed table at the
#: risk dtype; the csv's floats are pandas' parse of each value (not
#: correctly rounded), so the append runs at the default float32, as in
#: the reference's own append test
APPEND = ["--eigen-sims", "8", "--eigen-sim-length", "50"]
TABLES = ("factor_returns", "r_squared", "specific_returns",
          "final_covariance", "lambda")
NO_DRAW = ("factor_returns", "r_squared", "specific_returns")


def run(pkg: str, argv: list) -> tuple:
    """One in-process CLI call: (exit code or message, stdout lines)."""
    buf = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(buf):
        try:
            if pkg == "ref":
                ref_main(["--platform", "cpu", *argv])
            else:
                main([*argv, "--device", "cpu"] if argv[0] in (
                    "pipeline", "risk", "factors") else argv)
        except SystemExit as e:
            code = e.code
    return code, buf.getvalue().splitlines()


def record(pkg, argv) -> dict:
    code, lines = run(pkg, argv)
    assert code == 0, code
    return json.loads(lines[-1])


def read_exact(path) -> tuple:
    """A csv as (header, first column, float64 values of the others),
    each cell parsed by Python's ``float``."""
    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))
    return rows[0], [r[0] for r in rows[1:]], rows[1:]


def numbers(rows, skip=1) -> np.ndarray:
    return np.array([[float(c) if c else np.nan for c in r[skip:]]
                     for r in rows])


def close(got, want):
    """Within 1e-8 of the reference, relative to each column's scale
    (a residual of ~1e-17 carries float64 noise of ~1e-13)."""
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    for j in range(want.shape[1]):
        m = np.isfinite(want[:, j])
        if m.any():
            scale = np.abs(want[m, j]).max()
            np.testing.assert_allclose(got[m, j], want[m, j], rtol=RTOL,
                                       atol=RTOL * scale, err_msg=str(j))


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_store")
    synthetic_collections(PanelStore(str(root / "port_store")), **GEN)
    ref_collections(RefStore(str(root / "ref_store")), **GEN)
    return root


def test_prepare_and_factors_prepared_match_the_reference(stores):
    root = stores
    recs = {pkg: record(pkg, ["prepare", "--store", str(root / f"{pkg}_store"),
                              "--out", str(root / f"{pkg}_prep")])
            for pkg in ("ref", "port")}
    assert {k: v for k, v in recs["port"].items() if k in ("rows", "stocks")} \
        == {k: v for k, v in recs["ref"].items() if k in ("rows", "stocks")}
    assert recs["port"]["panel"].endswith("panel.npz")
    got = read_table(recs["port"]["panel"])
    want = pd.read_parquet(recs["ref"]["panel"])
    assert canon(got) == canon(want)
    for name in ("index_prices.csv", "industry_map.csv"):
        assert (root / "port_prep" / name).read_bytes() == \
            (root / "ref_prep" / name).read_bytes()

    for pkg in ("ref", "port"):
        record(pkg, ["factors", "--prepared", str(root / f"{pkg}_prep"),
                     "--out", str(root / f"{pkg}_fac"), "--dtype", "float64"])
    gh, gi, grows = read_exact(root / "port_fac" / "barra_data.csv")
    wh, wi, wrows = read_exact(root / "ref_fac" / "barra_data.csv")
    assert gh == wh and gi == wi
    assert [r[1] for r in grows] == [r[1] for r in wrows]   # stocknames
    assert [r[4] for r in grows] == [r[4] for r in wrows]   # industry
    cols = [2, 3] + list(range(5, len(gh)))
    close(numbers([[r[j] for j in cols] for r in grows], 0),
          numbers([[r[j] for j in cols] for r in wrows], 0))

    # --prepared over the reference's directory reads its panel.parquet
    record("port", ["factors", "--prepared", str(root / "ref_prep"),
                    "--out", str(root / "port_fac_refprep"), "--dtype",
                    "float64"])
    assert (root / "port_fac_refprep" / "barra_data.csv").read_bytes() == \
        (root / "port_fac" / "barra_data.csv").read_bytes()


#: the process-lifetime counters ``guard_summary_from_registry`` reads,
#: which the ``health`` verdict's quarantine-rate check is built from
GUARD_COUNTERS = ("SERVED_DATES_TOTAL", "QUARANTINED_DATES_TOTAL",
                  "GUARD_REASON_TOTAL", "SERVED_COV_STALENESS")


def zero_guard_counters():
    """Both packages' guard counters back to zero.  Whatever guarded
    appends ran earlier in this process (another test file on the same
    worker) would otherwise reach one package's ``health`` only
    (``REGISTRY.reset()`` drops the registry's entries, not the module
    level metrics' counts)."""
    for mod in (instrument, ref_instrument):
        for name in GUARD_COUNTERS:
            metric = getattr(mod, name)
            with metric._lock:
                metric._series.clear()
    assert instrument.guard_summary_from_registry() == \
        ref_instrument.guard_summary_from_registry()


@pytest.fixture(scope="module")
def pipelines(stores):
    """Both pipelines over the whole stores, the port's with --to-store,
    each from zeroed guard counters."""
    root = stores
    recs = {}
    zero_guard_counters()
    for pkg in ("ref", "port"):
        extra = (["--to-store", str(root / "fstore")] if pkg == "port"
                 else [])
        recs[pkg] = record(pkg, ["pipeline", "--store",
                                 str(root / f"{pkg}_store"), "--out",
                                 str(root / f"{pkg}_pipe"), *COMMON, *extra])
    return root, recs


def test_pipeline_matches_the_reference(pipelines):
    root, recs = pipelines
    for k in ("rows", "dates", "stocks", "factors", "alpha_styles",
              "health"):
        assert recs["port"][k] == recs["ref"][k], k
    assert recs["port"]["kernels"]["launches"] == {
        "jacobi_eigh/warp": 0, "jacobi_eigh/block": 0,
        "jacobi_eigh_weighted/warp": 0, "jacobi_eigh_weighted/block": 0}
    got, want = root / "port_pipe", root / "ref_pipe"
    assert (got / "industry_info.csv").read_bytes() == \
        (want / "industry_info.csv").read_bytes()
    gh, gi, grows = read_exact(got / "barra_data.csv")
    wh, wi, wrows = read_exact(want / "barra_data.csv")
    assert gh == wh and gi == wi
    cols = [2, 3] + list(range(5, len(gh)))
    close(numbers([[r[j] for j in cols] for r in grows], 0),
          numbers([[r[j] for j in cols] for r in wrows], 0))
    for name in NO_DRAW:
        gh, gi, grows = read_exact(got / f"{name}.csv")
        wh, wi, wrows = read_exact(want / f"{name}.csv")
        assert gh == wh and gi == wi, name
        close(numbers(grows), numbers(wrows))


def test_zeroed_guard_counters_give_both_packages_one_summary():
    """A guarded append that quarantined a date in one package only (the
    in-process fault plans do so in the port) reads as ``degraded`` there
    until the counters are zeroed; after, both summaries are the same."""
    instrument.SERVED_DATES_TOTAL.inc(40)
    instrument.QUARANTINED_DATES_TOTAL.inc(1)
    assert instrument.guard_summary_from_registry()["quarantine_rate"] > 0.02
    zero_guard_counters()
    assert instrument.guard_summary_from_registry()["served_dates"] == 0


def test_pipeline_is_the_in_process_api(pipelines):
    """Every table and ``risk_outputs.npz`` is ``run_factor_pipeline`` +
    ``run_risk_pipeline`` on the prepared store, bit for bit."""
    from mfm_tpu_torch import PipelineConfig, RiskModelConfig
    from mfm_tpu_torch.pipeline import run_factor_pipeline, run_risk_pipeline

    root, _ = pipelines
    prep = prepare_factor_inputs(PanelStore(str(root / "port_store")))
    cfg = PipelineConfig(risk=RiskModelConfig(eigen_n_sims=8,
                                              eigen_sim_length=50),
                         dtype="float64")
    barra, _ = run_factor_pipeline(prep.fields, prep.index_close,
                                   prep.industry_l1, prep.dates, prep.stocks,
                                   cfg, device="cpu")
    codes = read_csv(root / "port_pipe" / "industry_info.csv")["code"]
    res = run_risk_pipeline(barra, config=cfg, industry_codes=codes,
                            with_state=True, device="cpu")
    o = res.outputs
    want = {"factor_returns": _numpy(o.factor_ret), "r_squared":
            _numpy(o.r2)[:, None], "specific_returns": _numpy(o.specific_ret),
            "final_covariance": _numpy(o.vr_cov[-1]),
            "lambda": _numpy(o.lamb)[:, None]}
    for name, vals in want.items():
        _, _, rows = read_exact(root / "port_pipe" / f"{name}.csv")
        assert np.array_equal(numbers(rows), vals, equal_nan=True), name
    saved, _ = load_artifact(str(root / "port_pipe" / "risk_outputs.npz"))
    for f in o._fields:
        assert np.array_equal(saved[f], _numpy(getattr(o, f)),
                              equal_nan=True), f


def test_risk_barra_store_is_the_pipelines_run(pipelines, tmp_path):
    root, _ = pipelines
    out = tmp_path / "rb"
    rec = record("port", ["risk", "--barra-store", str(root / "fstore"),
                          "--out", str(out), *COMMON, "--save-outputs"])
    assert rec["dates"] > 0
    for name in TABLES:
        assert (out / f"{name}.csv").read_bytes() == \
            (root / "port_pipe" / f"{name}.csv").read_bytes(), name
    a, _ = load_artifact(str(out / "risk_outputs.npz"))
    b, _ = load_artifact(str(root / "port_pipe" / "risk_outputs.npz"))
    for k in b:
        assert np.array_equal(a[k], b[k], equal_nan=True), k
    msgs = [run(pkg, ["risk", "--barra-store", str(tmp_path / "none"),
                      "--out", str(tmp_path / "x")])[0]
            for pkg in ("ref", "port")]
    assert isinstance(msgs[0], str) and msgs[0] == msgs[1]


def _cut_dates(store_dir):
    px = PanelStore(store_dir).read("daily_prices")
    dates, counts = np.unique(px["trade_date"], return_counts=True)
    n = len(np.unique(px["ts_code"]))
    full = [d for d, c in zip(dates[-12:-4], counts[-12:-4]) if c == n]
    gap = [d for d, c in zip(dates[-8:-3], counts[-8:-3]) if c < n]
    return full[-1], gap[-1]


def test_append_is_bitwise_from_scratch(stores, tmp_path):
    root = stores
    store = str(root / "port_store")
    cut, _ = _cut_dates(store)
    out, ref = str(tmp_path / "out"), str(tmp_path / "ref")
    record("port", ["pipeline", "--store", store, "--out", out, *APPEND,
                    "--end", cut])
    rec = record("port", ["pipeline", "--store", store, "--out", out,
                          *APPEND, "--append"])
    assert len(rec["appended_dates"]) >= 4 and rec["update_wall_s"] > 0
    record("port", ["pipeline", "--store", store, "--out", ref, *APPEND])
    for name in TABLES:
        assert (Path(out) / f"{name}.csv").read_bytes() == \
            (Path(ref) / f"{name}.csv").read_bytes(), name
    for art in ("risk_outputs.npz", "risk_state.npz"):
        a, ma = load_artifact(os.path.join(out, art))
        b, mb = load_artifact(os.path.join(ref, art))
        for k in b:
            assert np.array_equal(a[k], b[k], equal_nan=True), (art, k)
    assert ma["last_date"] == mb["last_date"]
    code, _ = run("port", ["pipeline", "--store", store, "--out", out,
                           *APPEND, "--append"])
    assert "already covers every date" in code


def test_append_refuses_revised_history_as_the_reference(stores, tmp_path):
    root = stores
    msgs = []
    for pkg in ("ref", "port"):
        store = str(root / f"{pkg}_store")
        _, gap = _cut_dates(str(root / "port_store"))
        out = str(tmp_path / pkg)
        record(pkg, ["pipeline", "--store", store, "--out", out, *APPEND,
                     "--end", gap])
        msgs.append(run(pkg, ["pipeline", "--store", store, "--out", out,
                              *APPEND, "--append"])[0])
    assert "revised history" in msgs[1]
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("argv", [
    ["pipeline", "--store", "S", "--append", "--resume"],
    ["pipeline", "--store", "S", "--append", "--nw-method", "associative"],
    ["etl-missing", "--store", "S", "--fix", "--name", "balancesheet"],
    ["etl-verify", "--store", "S", "--diagnose"],
])
def test_refusals_exit_with_the_reference_message(stores, argv):
    msgs = [run(pkg, [str(stores / f"{pkg}_store") if a == "S" else a
                      for a in argv])[0] for pkg in ("ref", "port")]
    assert isinstance(msgs[0], str) and msgs[0] == msgs[1]


@pytest.mark.parametrize("argv,flag", [
    (["pipeline", "--store", "S", "--mesh", "2x1"], "--mesh"),
    (["pipeline", "--store", "S", "--nw-method", "associative"],
     "--nw-method associative"),
    (["risk", "--barra", "x.csv", "--nw-method", "associative"],
     "--nw-method associative"),
])
def test_mesh_and_associative_name_their_item(argv, flag, tmp_path,
                                               monkeypatch):
    """``--mesh`` and ``--nw-method associative`` are ported, so the
    command gets past its flags to its input and fails there exactly as
    the reference does (``pipeline`` reads ``--mesh`` at its append
    step)."""
    monkeypatch.chdir(tmp_path)
    errs = []
    for pkg in ("ref", "port"):
        with pytest.raises((ValueError, OSError)) as exc:
            run(pkg, argv)
        errs.append((type(exc.value), str(exc.value)))
    assert errs[0] == errs[1]


@pytest.mark.parametrize("argv", [
    ["etl-verify"],
    ["etl-verify", "--name", "balancesheet", "--date-col", "end_date"],
    ["etl-verify", "--diagnose", "--name", "balancesheet"],
    ["etl-verify", "--diagnose", "--name", "financial_indicators",
     "--ann-col", "ann_date"],
    ["etl-missing"],
    ["etl-missing", "--universe", "index_components", "--code-col",
     "con_code", "--name", "index_components"],
    ["etl-update", "--start", "20200101", "--end", "20200701", "--dry-run"],
    ["etl-update", "--start", "20200101", "--end", "20200701", "--dry-run",
     "--no-sw", "--components-date", "20200630", "--statements", ""],
])
def test_etl_records_are_the_references(stores, argv):
    recs = [record(pkg, [argv[0], "--store", str(stores / f"{pkg}_store"),
                         *argv[1:]]) for pkg in ("ref", "port")]
    assert recs[0] == recs[1]


def test_etl_xlsx_is_the_references(tmp_path):
    edb = str(tmp_path / "edb.xlsx")
    write_xlsx(edb, [("中信", [["指标名称", "中信行业指数:计算机"],
                              [38352.0, 1000.0], [38356.0, 997.85]]),
                     ("申万", [["指标名称", "申万:银行"], [38352.0, 5.0]])])
    for _ in range(2):
        recs = [record(pkg, ["etl-xlsx", "--store", str(tmp_path / pkg),
                             "--industry-index", edb])
                for pkg in ("ref", "port")]
        assert recs[0] == recs[1]
    assert canon(PanelStore(str(tmp_path / "port")).read(
        "industry_index_prices")) == canon(RefStore(str(
            tmp_path / "ref")).read("industry_index_prices"))


def test_store_path_runs_without_pandas(stores, tmp_path):
    """prepare, factors --prepared, pipeline, pipeline --append, risk
    --barra-store and etl-verify with pandas and pyarrow unimportable."""
    store = str(tmp_path / "store")
    shutil.copytree(stores / "port_store", store)
    cut, _ = _cut_dates(store)
    px = PanelStore(store).read("daily_prices")
    head = str(tmp_path / "head")
    PanelStore(head).replace("daily_prices",
                             take(px, px["trade_date"] <= cut))
    for name in os.listdir(store):
        if name != "daily_prices":
            shutil.copytree(os.path.join(store, name),
                            os.path.join(head, name))
    t = str(tmp_path)
    code = textwrap.dedent(f"""
        import sys
        sys.modules["pandas"] = None
        sys.modules["pyarrow"] = None
        import torch
        torch.set_num_threads(2)
        from mfm_tpu_torch.cli import main
        common = {APPEND!r} + ["--device", "cpu"]
        main(["prepare", "--store", {store!r}, "--out", {t!r} + "/prep"])
        main(["factors", "--prepared", {t!r} + "/prep", "--out",
              {t!r} + "/fac", "--device", "cpu"])
        main(["pipeline", "--store", {head!r}, "--out", {t!r} + "/pipe",
              "--to-store", {t!r} + "/fstore", *common])
        main(["pipeline", "--store", {store!r}, "--out", {t!r} + "/pipe",
              "--append", *common])
        main(["risk", "--barra-store", {t!r} + "/fstore", "--out",
              {t!r} + "/rb", *common])
        main(["etl-verify", "--store", {store!r}])
        assert "pandas" not in [m for m in sys.modules
                                if sys.modules[m] is not None]
    """)
    env = {**os.environ, "PYTHONPATH": str(ROOT), "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    recs = [json.loads(x) for x in proc.stdout.strip().splitlines()]
    assert [sorted(r)[:2] for r in recs][0] == ["index", "industry"]
    assert len(recs[3]["appended_dates"]) >= 4
    assert recs[-1]["rows"] == len(px["ts_code"])
    for name in TABLES:   # the barra-store run is the head pipeline's
        assert (tmp_path / "rb" / f"{name}.csv").exists()


def test_pipeline_alphas_match_the_reference(pipelines, tmp_path):
    """``--alphas`` (and ``--alphas-llm``) over the factor stage's table
    (``--resume``): the same expressions picked as the reference picks,
    their mean ICs within float32 rounding, the alpha columns priced in
    ``factor_returns.csv``; a bad file fails fast with the reference's
    message."""
    root, _ = pipelines
    exprs = tmp_path / "alphas.txt"
    # no two candidates tie exactly: which of x and 1.0001 * x is picked
    # is decided by float32 rounding, in each package its own way
    exprs.write_text("# candidates\n-delta(close, 5)\n"
                     "cs_rank(ts_mean(turnover_rate, 10))\n"
                     "ts_mean(pb, 3)\n")
    llm = tmp_path / "chat.md"
    llm.write_text("Here are ideas:\n1. `-delta(close, 5)`\n"
                   "2. alpha = cs_rank(ts_mean(turnover_rate, 10))\n"
                   "3. ts_mean(no_such_field, 3)\n")
    for flags in ([str(exprs)], [str(llm), "--alphas-llm"]):
        reps = {}
        for pkg in ("ref", "port"):
            out = tmp_path / f"{pkg}{len(flags)}"
            shutil.copytree(root / f"{pkg}_pipe", out)
            rec = record(pkg, ["pipeline", "--store",
                               str(root / f"{pkg}_store"), "--out", str(out),
                               *COMMON, "--resume", "--alphas", *flags,
                               "--alpha-top", "2"])
            reps[pkg] = json.loads((out / "alpha_styles.json").read_text())
            header = (out / "factor_returns.csv").read_text().split("\n")[0]
            assert all(name in header.split(",") for name in reps[pkg])
            assert rec["alpha_styles"] == len(reps[pkg]) >= 1
        assert {k: v["expression"] for k, v in reps["port"].items()} == \
            {k: v["expression"] for k, v in reps["ref"].items()}
        for k, v in reps["ref"].items():
            assert reps["port"][k]["mean_ic"] == pytest.approx(
                v["mean_ic"], abs=1e-5)
    bad = tmp_path / "bad_alphas.txt"
    bad.write_text("delta(close, 5\n")
    for path in (bad, tmp_path / "nope.txt"):
        msgs = [run(pkg, ["pipeline", "--store", str(root / f"{pkg}_store"),
                          "--out", str(tmp_path / "never"), "--alphas",
                          str(path)])[0] for pkg in ("ref", "port")]
        assert isinstance(msgs[0], str) and msgs[0] == msgs[1]
