"""The port's model-health report (``mfm_tpu_torch/utils/report.py``) and
its ``report`` subcommand, against the JAX package's — the counterparts of
``tests/test_report.py``.  The port's summary is held equal to the
reference's (both rounded to 6 decimals, compared as parsed dicts,
exactly) on two results directories: a hand-made one with every optional
JSON, and one the port's ``risk`` CLI wrote on the CPU at a small size.
The PNG tests skip where matplotlib is absent.
"""

import json
import os

import numpy as np
import pandas as pd
import pytest

from mfm_tpu import cli as ref_cli
from mfm_tpu.utils.report import model_health_summary as ref_summary
from mfm_tpu_torch import cli
from mfm_tpu_torch.utils.report import (
    load_results,
    model_health_summary,
    nanstd,
    plot_model_health,
)


def _write_results(tmp_path, with_bias=False, with_specific=False):
    rng = np.random.default_rng(0)
    dates = pd.bdate_range("2024-01-02", periods=120)
    factors = ["country", "size", "beta", "momentum", "growth",
               "leverage", "liquidity", "ind_a", "ind_b"]
    fr = pd.DataFrame(0.01 * rng.standard_normal((120, len(factors))),
                      index=dates, columns=factors)
    fr.iloc[0] = np.nan  # a leading all-NaN date (pre-burn-in), must drop
    fr.iloc[5, 2] = np.nan
    fr.to_csv(tmp_path / "factor_returns.csv")
    r2 = pd.DataFrame({"R2": np.clip(rng.normal(0.3, 0.1, 120), 0, 1)},
                      index=dates)
    r2.iloc[3] = np.nan
    r2.to_csv(tmp_path / "r_squared.csv")
    lam = pd.DataFrame({"lambda": 1 + 0.1 * rng.standard_normal(120)},
                       index=dates)
    lam.to_csv(tmp_path / "lambda.csv")
    if with_specific:
        sp = pd.DataFrame(0.02 * rng.standard_normal((120, 5)), index=dates,
                          columns=[f"s{i}" for i in range(5)])
        sp.iloc[7, :4] = np.nan   # a row with one observation: std NaN
        sp.to_csv(tmp_path / "specific_returns.csv")
    if with_bias:
        bias = {
            "all_valid_dates": {
                "newey_west": {"bias": [34.5, 1.2, 1.1, None],
                               "mean_abs_dev_from_1": 11.266},
                "eigen_adjusted": {"bias": [20.1, 1.0, 0.98, None],
                                   "mean_abs_dev_from_1": 6.373},
            },
            "after_burn_in_252": {
                "newey_west": {"bias": [1.4, 1.2, 1.1, None],
                               "mean_abs_dev_from_1": 0.2333},
                "eigen_adjusted": {"bias": [1.05, 1.0, 0.98, None],
                                   "mean_abs_dev_from_1": 0.0233},
            },
        }
        (tmp_path / "bias_stats.json").write_text(json.dumps(bias))
    return fr, r2, lam


def _optional_jsons(tmp_path):
    (tmp_path / "portfolio_bias.json").write_text(json.dumps({
        "n_portfolios": 7,
        "all_valid_dates": {"mean": 1.31, "median": 1.2,
                            "mean_abs_dev_from_1": 0.31},
        "after_burn_in_252": {"mean": 1.02, "median": 1.01,
                              "mean_abs_dev_from_1": 0.05},
    }))
    (tmp_path / "portfolio_risk.json").write_text(json.dumps({
        "date": "2020-06-30", "total_vol": 0.012,
        "factor_var": 1e-4, "specific_var": 4.4e-5,
        "factor_exposures": {"country": 1.0}}))
    (tmp_path / "alpha_styles.json").write_text(json.dumps({
        "alpha_01": {"expression": "-delta(close, 5)", "mean_ic": 0.03,
                     "score": 0.03}}))


def assert_summary_equal(got: dict, want: dict):
    # the same keys in the same order, every number equal after rounding;
    # the factor order is the reference's (the cumulative returns here are
    # distinct)
    assert json.dumps(got) == json.dumps(want)


def test_summary_matches_the_reference_and_hand_computed(tmp_path):
    fr, r2, lam = _write_results(tmp_path)
    s = model_health_summary(str(tmp_path))
    assert_summary_equal(s, ref_summary(str(tmp_path)))
    valid = fr.dropna(how="all")
    assert s["dates"]["count"] == len(valid) == 119
    assert s["dates"]["first"] == str(valid.index[0].date())
    np.testing.assert_allclose(
        s["factors"]["size"]["cum_return"],
        valid["size"].fillna(0).cumsum().iloc[-1], rtol=1e-5)
    np.testing.assert_allclose(
        s["factors"]["beta"]["ann_vol"],
        valid["beta"].std(ddof=1) * np.sqrt(252), rtol=1e-5)
    np.testing.assert_allclose(s["r2"]["mean"], r2["R2"].mean(), atol=1e-5)
    np.testing.assert_allclose(s["lambda"]["last"], lam["lambda"].iloc[-1],
                               atol=1e-5)
    assert "bias" not in s and "specific_dispersion" not in s


def test_summary_optional_sections(tmp_path):
    _write_results(tmp_path, with_bias=True, with_specific=True)
    _optional_jsons(tmp_path)
    s = model_health_summary(str(tmp_path))
    assert_summary_equal(s, ref_summary(str(tmp_path)))
    assert s["bias"]["scope"] == "after_burn_in_252"
    assert s["bias"]["eigen_adjusted"]["mean_abs_dev_from_1"] == 0.0233
    assert s["portfolio_bias"] == {
        "scope": "after_burn_in_252", "n_portfolios": 7, "mean": 1.02,
        "median": 1.01, "mean_abs_dev_from_1": 0.05}
    sp = pd.read_csv(tmp_path / "specific_returns.csv", index_col=0)
    np.testing.assert_allclose(s["specific_dispersion"]["mean_xsec_std"],
                               sp.std(axis=1, ddof=1).mean(), atol=1e-5)
    assert s["portfolio_risk"] == {"date": "2020-06-30", "total_vol": 0.012,
                                   "factor_var": 1e-4,
                                   "specific_var": 4.4e-5}
    assert s["alpha_styles"]["alpha_01"]["expression"] == "-delta(close, 5)"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nanstd_is_pandas_std(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(200) * 10.0 ** rng.integers(-3, 3)
    x[rng.random(200) < 0.2] = np.nan
    assert nanstd(x) == pd.Series(x).std(ddof=1)
    assert np.isnan(nanstd(np.array([1.0, np.nan])))


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    """A results directory the port's ``risk`` CLI wrote on the CPU."""
    from mfm_tpu_torch.data.csvio import write_csv
    from mfm_tpu_torch.data.synthetic import synthetic_barra_table

    d = tmp_path_factory.mktemp("port_risk")
    table, _ = synthetic_barra_table(T=70, N=30, P=3, Q=2, seed=3)
    write_csv(str(d / "barra.csv"), table)
    out = d / "res"
    cli.main(["risk", "--barra", str(d / "barra.csv"), "--out", str(out),
              "--eigen-sims", "4", "--specific-risk", "--portfolio-bias",
              "5", "--bias-burn-in", "20", "--device", "cpu"])
    return out


def test_summary_of_a_port_risk_run_is_the_references(port_results, capsys):
    capsys.readouterr()
    s = model_health_summary(str(port_results))
    assert_summary_equal(s, ref_summary(str(port_results)))
    assert s["dates"]["count"] == 70 and len(s["factors"]) == 6
    assert set(s) >= {"r2", "lambda", "specific_dispersion",
                      "portfolio_bias"}


def test_report_cli_json_is_the_references(port_results, capsys):
    capsys.readouterr()
    cli.main(["report", "--results", str(port_results), "--json", "p.json"])
    port = capsys.readouterr().out
    ref_cli.main(["--platform", "cpu", "report", "--results",
                  str(port_results), "--json", "r.json"])
    ref = capsys.readouterr().out
    assert json.loads(port) == json.loads(ref)
    assert (port_results / "p.json").read_text() == \
        (port_results / "r.json").read_text()


def test_missing_factor_returns_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        model_health_summary(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        load_results(str(tmp_path))


def test_report_plot_without_matplotlib_names_the_install(tmp_path,
                                                          monkeypatch):
    import sys

    _write_results(tmp_path)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(SystemExit, match="--plot needs matplotlib"):
        cli.main(["report", "--results", str(tmp_path), "--plot", "h.png"])
    assert not (tmp_path / "h.png").exists()


def test_plot_writes_png_both_variants(tmp_path):
    pytest.importorskip("matplotlib")
    _write_results(tmp_path, with_bias=True)
    p1 = str(tmp_path / "health_bias.png")
    plot_model_health(str(tmp_path), p1)
    assert os.path.getsize(p1) > 5000
    os.remove(tmp_path / "bias_stats.json")  # vol-bars fallback panel
    p2 = str(tmp_path / "health_vols.png")
    plot_model_health(str(tmp_path), p2)
    assert os.path.getsize(p2) > 5000
    p3 = str(tmp_path / "health_k0.png")  # --top-k 0: everything folds gray
    plot_model_health(str(tmp_path), p3, top_k=0)
    assert os.path.getsize(p3) > 5000


def test_report_cli(tmp_path, capsys):
    pytest.importorskip("matplotlib")
    _write_results(tmp_path, with_bias=True)
    cli.main(["report", "--results", str(tmp_path), "--plot", "health.png",
              "--json", "health.json"])
    out = json.loads(capsys.readouterr().out)
    assert out["dates"]["count"] == 119
    assert out["plot"] == os.path.join(str(tmp_path), "health.png")
    assert os.path.getsize(tmp_path / "health.png") > 5000
    on_disk = json.loads((tmp_path / "health.json").read_text())
    assert on_disk["r2"]["mean"] == out["r2"]["mean"]
