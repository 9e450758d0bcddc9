"""The port's alpha selection, integration and ``alpha`` CLI
(``mfm_tpu_torch/alpha/select.py``, ``integrate.py``, ``cli.py``) against
the JAX package's and pandas, on the CPU (``--device cpu``)."""

import io
import json

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from mfm_tpu.alpha import integrate as ref_integrate
from mfm_tpu.alpha import select as ref_select
from mfm_tpu.cli import main as ref_main
from mfm_tpu_torch.alpha import dsl, select
from mfm_tpu_torch.alpha.integrate import alpha_style_columns
from mfm_tpu_torch.cli import main
from mfm_tpu_torch.panel import Panel

from test_alpha_cli import panel_csv  # noqa: F401  (fixture reuse)

torch.set_num_threads(2)


# -- selection --------------------------------------------------------------------

def test_series_correlation_matches_pandas_and_reference():
    rng = np.random.default_rng(0)
    E, T = 7, 60
    s = rng.standard_normal((E, T))
    s[rng.random((E, T)) < 0.25] = np.nan  # ragged validity per pair
    s[5, :58] = np.nan  # only 2 dates valid -> below min_periods vs most
    got = select.series_correlation_matrix(torch.from_numpy(s),
                                           min_periods=3).numpy()
    want = pd.DataFrame(s.T).corr(min_periods=3).to_numpy()
    np.testing.assert_allclose(got, want, atol=1e-12)
    ref = np.asarray(ref_select.series_correlation_matrix(jnp.asarray(s), 3))
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-15)
    f32 = select.series_correlation_matrix(torch.from_numpy(s).float(), 3)
    assert f32.dtype == torch.float32
    np.testing.assert_allclose(f32.numpy(), want, atol=2e-5)


def test_greedy_select_cap_and_order():
    scores = np.array([0.5, 0.4, 0.3, np.nan, 0.2])
    corr = np.eye(5)
    corr[0, 1] = corr[1, 0] = 0.9   # 1 is redundant with 0
    corr[0, 2] = corr[2, 0] = 0.1
    corr[2, 4] = corr[4, 2] = np.nan  # undefined must not block
    out = select.greedy_select(scores, corr, k=3, max_corr=0.7)
    assert out["indices"] == [0, 2, 4]
    assert out["rejected"] == {1: 0}
    assert out["scores"] == [0.5, 0.3, 0.2]
    assert np.isnan(out["max_corr_to_selected"][0])
    assert out["max_corr_to_selected"][1] == pytest.approx(0.1)
    out = select.greedy_select(scores, corr, k=5, max_corr=0.7, min_score=0.25)
    assert out["indices"] == [0, 2]


def test_greedy_select_matches_reference_on_random_inputs():
    rng = np.random.default_rng(11)
    for _ in range(20):
        E = int(rng.integers(2, 25))
        scores = rng.standard_normal(E)
        scores[rng.random(E) < 0.2] = np.nan
        A = rng.standard_normal((E, E))
        corr = np.clip((A + A.T) / 2, -1, 1)
        np.fill_diagonal(corr, 1.0)
        corr[rng.random((E, E)) < 0.1] = np.nan
        corr = np.triu(corr) + np.triu(corr, 1).T
        cap = float(rng.uniform(0.2, 0.9))
        k = int(rng.integers(1, E + 1))
        got = select.greedy_select(scores, corr, k=k, max_corr=cap)
        want = ref_select.greedy_select(scores, corr, k=k, max_corr=cap)
        np.testing.assert_equal(got, want)


def test_select_alphas_drops_near_duplicate():
    rng = np.random.default_rng(1)
    T, N = 120, 40
    fwd = 0.02 * rng.standard_normal((T, N))
    base = fwd + 0.05 * rng.standard_normal((T, N))   # informative
    dup = base + 1e-3 * rng.standard_normal((T, N))   # its clone
    indep = 0.05 * rng.standard_normal((T, N))        # uncorrelated noise
    alphas = np.stack([base, dup, indep])
    out = select.select_alphas(torch.from_numpy(alphas),
                               torch.from_numpy(fwd), k=2, max_corr=0.7)
    assert len(out["indices"]) == 2 and 2 in out["indices"]
    assert len(set(out["indices"]) & {0, 1}) == 1
    [(loser, winner)] = out["rejected"].items()
    assert {loser, winner} == {0, 1}
    assert abs(out["corr"][0, 1]) > 0.95
    ref = ref_select.select_alphas(jnp.asarray(alphas), jnp.asarray(fwd), k=2,
                                   max_corr=0.7)
    assert out["indices"] == ref["indices"]
    np.testing.assert_allclose(out["corr"], ref["corr"], rtol=1e-9)
    ic = select.signal_series(torch.from_numpy(alphas),
                              torch.from_numpy(fwd), kind="ic")
    np.testing.assert_allclose(ic.numpy(), np.asarray(ref_select.signal_series(
        jnp.asarray(alphas), jnp.asarray(fwd), kind="ic")), rtol=1e-9)
    with pytest.raises(ValueError, match="unknown signal kind"):
        select.signal_series(torch.from_numpy(alphas), torch.from_numpy(fwd),
                             kind="pnl")


# -- integration --------------------------------------------------------------------

@pytest.fixture(scope="module")
def raw_panel():
    rng = np.random.default_rng(0)
    T, N = 80, 30
    close = np.cumprod(1 + 0.02 * rng.standard_normal((T, N)), axis=0) * 20
    vol = np.exp(rng.normal(12, 1, (T, N)))
    close[rng.random((T, N)) < 0.05] = np.nan
    fwd = np.vstack([close[1:] / close[:-1] - 1.0, np.full((1, N), np.nan)])
    return {"close": close, "volume": vol}, fwd


def test_alpha_style_columns_match_reference(raw_panel):
    fields, fwd = raw_panel
    srcs = ["-delta(close, 5)", "cs_rank(ts_mean(volume, 10))",
            "-delta(close, 5) * 1.0001"]
    names, expo, report = alpha_style_columns(srcs, fields, fwd, k=2,
                                              max_corr=0.9, device="cpu")
    rnames, rexpo, rreport = ref_integrate.alpha_style_columns(
        srcs, {k: jnp.asarray(v) for k, v in fields.items()},
        jnp.asarray(fwd), k=2, max_corr=0.9)
    assert names == rnames and report.keys() == rreport.keys()
    assert expo.dtype == np.float32 and expo.shape == (80, 30, len(names))
    np.testing.assert_allclose(expo, rexpo, rtol=1e-6, atol=1e-6)
    assert np.isfinite(expo).all()
    for n in names:
        assert report[n]["expression"] == rreport[n]["expression"]
        assert report[n]["mean_ic"] == pytest.approx(rreport[n]["mean_ic"],
                                                     rel=1e-9)
        assert report[n]["score"] == pytest.approx(rreport[n]["score"],
                                                   rel=1e-9)
    picked = {report[n]["expression"] for n in names}
    assert not {"-delta(close, 5)", "-delta(close, 5) * 1.0001"} <= picked


def test_alpha_style_columns_validates_and_needs_a_device(raw_panel):
    fields, fwd = raw_panel
    with pytest.raises(ValueError, match="unknown panel field"):
        alpha_style_columns(["delta(nope, 3)"], fields, fwd, k=1,
                            device="cpu")
    with pytest.raises(ValueError, match="no alpha expressions"):
        alpha_style_columns([], fields, fwd, k=1, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            alpha_style_columns(["-delta(close, 5)"], fields, fwd, k=1)


# -- the alpha CLI ----------------------------------------------------------------------

def _long_panel(tmp_path, seed, T, N, name="panel.csv"):
    rng = np.random.default_rng(seed)
    dates = pd.bdate_range("2024-01-02", periods=T)
    stocks = [f"s{i:03d}" for i in range(N)]
    close = np.exp(np.cumsum(0.02 * rng.standard_normal((T, N)), axis=0))
    long = pd.DataFrame({
        "trade_date": np.repeat(dates, N),
        "ts_code": np.tile(stocks, T),
        "close": close.ravel(),
        "ret": np.vstack([np.full((1, N), np.nan),
                          close[1:] / close[:-1] - 1]).ravel(),
    })
    path = str(tmp_path / name)
    long.to_csv(path, index=False)
    return path, long


def test_alpha_cli_scores_expressions_as_the_reference(panel_csv, tmp_path,
                                                       capsys):  # noqa: F811
    exprs = tmp_path / "exprs.txt"
    exprs.write_text("# candidate alphas\ncs_rank(delta(close, 3))\n\n"
                     "-ts_corr(close, volume, 10)\n"
                     "signed_power(cs_winsorize(ret, 2.5), 0.5)\n")
    out, ref_out = str(tmp_path / "scores.csv"), str(tmp_path / "ref.csv")
    main(["alpha", "--exprs", str(exprs), "--panel", panel_csv, "--out", out,
          "--device", "cpu"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["n_exprs"] == 3 and rec["stocks"] == 10
    assert rec["device"] == "cpu"
    ref_main(["--platform", "cpu", "alpha", "--exprs", str(exprs), "--panel",
              panel_csv, "--out", ref_out])
    ref_rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {k: rec[k] for k in ("n_exprs", "dates", "stocks")} == {
        k: ref_rec[k] for k in ("n_exprs", "dates", "stocks")}
    score = pd.read_csv(out, index_col="expression")
    ref = pd.read_csv(ref_out, index_col="expression")
    assert list(score.index) == list(ref.index)
    assert list(score.columns) == list(ref.columns)
    # both float32 runs, summed in other orders
    np.testing.assert_allclose(score.to_numpy(), ref.to_numpy(), rtol=2e-3,
                               atol=2e-5)
    assert (score["coverage"] > 0.5).all()


def test_alpha_cli_reports_bad_lines(panel_csv, tmp_path):  # noqa: F811
    exprs = tmp_path / "exprs.txt"
    for text, match in (("cs_rank(close)\n__import__('os')\n", "exprs.txt:2"),
                        ("cs_rank(close)\nclose +\n", "exprs.txt:2"),
                        ("cs_rank(vwap)\n", "exprs.txt:1.*vwap")):
        exprs.write_text(text)
        with pytest.raises(SystemExit, match=match):
            main(["alpha", "--exprs", str(exprs), "--panel", panel_csv,
                  "--device", "cpu"])
    exprs.write_text("cs_rank(close)\n")
    with pytest.raises(SystemExit, match="no field"):
        main(["alpha", "--exprs", str(exprs), "--panel", panel_csv,
              "--fwd-field", "nope", "--device", "cpu"])


def test_alpha_cli_runs_on_the_card_unless_asked_for_the_cpu(panel_csv,
                                                              tmp_path):  # noqa: F811
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the check is for one without")
    exprs = tmp_path / "exprs.txt"
    exprs.write_text("cs_rank(close)\n")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["alpha", "--exprs", str(exprs), "--panel", panel_csv])


def test_alpha_exprs_from_stdin(tmp_path, capsys, monkeypatch):
    path, _ = _long_panel(tmp_path, 8, 30, 8)
    monkeypatch.setattr("sys.stdin", io.StringIO(
        "cs_rank(delta(close, 2))\n# a comment\n-ts_mean(ret, 3)\n"))
    main(["alpha", "--exprs", "-", "--panel", path,
          "--out", str(tmp_path / "scores.csv"), "--device", "cpu"])
    rec = json.loads(capsys.readouterr().out)
    assert rec["n_exprs"] == 2
    assert len(pd.read_csv(tmp_path / "scores.csv")) == 2


def test_alpha_cli_select_as_the_reference(tmp_path, capsys):
    path, _ = _long_panel(tmp_path, 2, 80, 25)
    (tmp_path / "exprs.txt").write_text(
        "cs_rank(delta(close, 3))\n2.0 * cs_rank(delta(close, 3))\n"
        "-ts_mean(ret, 5)\n")
    outs = {}
    for who, run, flags in (("port", main, ["--device", "cpu"]),
                            ("ref", ref_main, [])):
        pre = ["--platform", "cpu"] if who == "ref" else []
        run(pre + ["alpha", "--exprs", str(tmp_path / "exprs.txt"),
                   "--panel", path, "--out", str(tmp_path / f"{who}.csv"),
                   "--select", "2", "--select-out",
                   str(tmp_path / f"{who}.txt")] + flags)
        outs[who] = json.loads(capsys.readouterr().out)
    rep = outs["port"]
    assert rep["n_selected"] == 2 and rep["n_rejected_by_corr"] == 1
    for k in ("n_selected", "n_rejected_by_corr"):
        assert rep[k] == outs["ref"][k]
    picked = (tmp_path / "port.txt").read_text().splitlines()
    assert picked == (tmp_path / "ref.txt").read_text().splitlines()
    score = pd.read_csv(tmp_path / "port.csv", index_col=0)
    ref = pd.read_csv(tmp_path / "ref.csv", index_col=0)
    assert int(score["selected"].sum()) == 2
    pd.testing.assert_series_equal(score["selected"], ref["selected"])
    pd.testing.assert_series_equal(score["select_rank"], ref["select_rank"])
    second = score[score["select_rank"] == 1]
    assert np.isfinite(second["select_max_corr"]).all()


def test_alpha_cli_select_flag_validation(capsys):
    for argv in (["--select", "0"], ["--select", "-3"],
                 ["--select-out", "sel.txt"]):
        with pytest.raises(SystemExit):
            main(["alpha", "--exprs", "x", "--panel", "y", "--device", "cpu"]
                 + argv)
    capsys.readouterr()


def test_alpha_cli_values_out(tmp_path, capsys):
    path, long = _long_panel(tmp_path, 5, 40, 10)
    (tmp_path / "exprs.txt").write_text(
        "cs_rank(delta(close, 2))\n-ts_mean(ret, 3)\n")
    vout = str(tmp_path / "values.parquet")
    main(["alpha", "--exprs", str(tmp_path / "exprs.txt"), "--panel", path,
          "--out", str(tmp_path / "scores.csv"), "--values-out", vout,
          "--device", "cpu"])
    rep = json.loads(capsys.readouterr().out)
    assert rep["values_out"] == vout
    got = pd.read_parquet(vout)
    assert list(got.columns) == ["trade_date", "ts_code",
                                 "alpha_0000", "alpha_0001"]
    assert len(got) == 40 * 10
    p = Panel.from_long(long)
    direct = dsl.compile_alpha("cs_rank(delta(close, 2))")(
        {"close": torch.as_tensor(p.fields["close"], dtype=torch.float32)})
    np.testing.assert_allclose(
        got["alpha_0000"].to_numpy().reshape(40, 10), direct.numpy(),
        rtol=1e-6, equal_nan=True)
    lines = (tmp_path / "values.parquet.exprs.txt").read_text().splitlines()
    assert lines == ["alpha_0000\tcs_rank(delta(close, 2))",
                     "alpha_0001\t-ts_mean(ret, 3)"]


def test_alpha_cli_min_ic_fence(tmp_path, capsys):
    path, _ = _long_panel(tmp_path, 6, 60, 15)
    (tmp_path / "e.txt").write_text("cs_rank(delta(close, 2))\n"
                                    "-ts_mean(ret, 3)\n")
    main(["alpha", "--exprs", str(tmp_path / "e.txt"), "--panel", path,
          "--out", str(tmp_path / "s.csv"), "--select", "2",
          "--min-ic", "0.99", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out)["n_selected"] == 0


def test_read_long_table_needs_no_pandas(tmp_path):
    """The csv reader and Panel.from_long run on numpy alone, and give
    the panel of the reference's ``pd.read_csv(parse_dates=["trade_date"])``
    bit for bit: pandas' float parser, which reads a 17-digit float up to
    ~1e-13 off the DataFrame that wrote it."""
    from mfm_tpu_torch.cli import _read_long_table

    path, long = _long_panel(tmp_path, 3, 12, 5)
    cols = _read_long_table(path)
    assert cols["trade_date"].dtype.kind == "M"
    got = Panel.from_long(cols)
    want = Panel.from_long(pd.read_csv(path, parse_dates=["trade_date"]))
    written = Panel.from_long(long)
    np.testing.assert_array_equal(got.stocks, want.stocks)
    np.testing.assert_array_equal(got.dates, want.dates)
    for k in want.fields:
        np.testing.assert_array_equal(got[k], want[k])
        # pandas keeps 17 digits, leading zeros included
        np.testing.assert_allclose(got[k], written[k], rtol=1e-12, atol=0)
