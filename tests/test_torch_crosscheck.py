"""The port's factor crosscheck (``mfm_tpu_torch/utils/crosscheck.py``) and
its ``crosscheck`` subcommand, against the JAX package's — the
counterparts of ``tests/test_crosscheck_cli.py``'s crosscheck cases: the
statistics, duplicate keys, disjoint tables, string sentinels, int
yyyymmdd dates against parquet datetimes, and ``--gate`` pass / fail /
empty.  Reports are held equal to the reference's exactly (NaN equal to
NaN), the printed JSON equal as text, the report csv equal as bytes, and
the gate's verdicts and exit codes equal (the reference prints a numpy
scalar's ``repr``, ``np.float64(x)``, where the port prints ``x``).
"""

import json
import re

import numpy as np
import pandas as pd
import pytest

from mfm_tpu import cli as ref_cli
from mfm_tpu.utils.crosscheck import crosscheck_factors as ref_crosscheck
from mfm_tpu_torch import cli
from mfm_tpu_torch.utils.crosscheck import (
    REPORT_COLUMNS,
    _json_float,
    crosscheck_factors,
)


@pytest.fixture
def factor_tables():
    rng = np.random.default_rng(0)
    dates = pd.to_datetime(["2024-01-02", "2024-01-03", "2024-01-04"])
    codes = [f"s{i:03d}.SZ" for i in range(40)]
    idx = pd.MultiIndex.from_product([dates, codes],
                                     names=["trade_date", "ts_code"])
    a = pd.DataFrame(index=idx).reset_index()
    a["size"] = rng.standard_normal(len(a))
    a["beta"] = rng.standard_normal(len(a))
    b = a.copy()
    b["size"] = a["size"] + 1e-6 * rng.standard_normal(len(a))
    b["beta"] = 2.0 * a["beta"] + 0.5
    a.loc[:10, "size"] = np.nan
    b.loc[20:25, "size"] = np.nan
    # the external side in another row order: the merge orders by key
    return a, b.sample(frac=1.0, random_state=3).reset_index(drop=True)


def assert_report_equal(got, want):
    assert list(got.index) == list(want.index)
    assert list(want.columns) == list(REPORT_COLUMNS)
    for f in want.index:
        for c in want.columns:
            x, y = got[f][c], want.loc[f, c]
            assert x == y or (np.isnan(x) and np.isnan(y)), (f, c, x, y)
    assert got.to_json() == want.to_json(orient="index")


def test_crosscheck_statistics(factor_tables):
    a, b = factor_tables
    rep = crosscheck_factors(a, b)
    assert_report_equal(rep, ref_crosscheck(a, b))
    assert rep["size"]["pearson"] > 0.999999
    assert rep["size"]["max_abs_diff"] < 1e-4
    assert rep["beta"]["rank_corr"] > 0.999999
    assert rep["beta"]["max_abs_diff"] > 0.1
    assert rep["size"]["n_overlap"] < len(a)


def test_crosscheck_on_column_dicts_equals_on_frames(factor_tables):
    a, b = factor_tables
    as_dict = {c: a[c].to_numpy() for c in a.columns}
    assert crosscheck_factors(as_dict, b).to_json() == \
        crosscheck_factors(a, b).to_json()


def test_crosscheck_duplicate_keys_not_double_counted(factor_tables):
    a, b = factor_tables
    b_dup = pd.concat([b, b.iloc[::-1]], ignore_index=True)
    b_dup.loc[len(b):, "beta"] = 99.0    # later duplicates never count
    rep, rep_dup = crosscheck_factors(a, b), crosscheck_factors(a, b_dup)
    assert_report_equal(rep_dup, ref_crosscheck(a, b_dup))
    assert rep.to_json() == rep_dup.to_json()


def test_crosscheck_disjoint_tables():
    a = pd.DataFrame({"trade_date": pd.to_datetime(["2024-01-02"]),
                      "ts_code": ["x"], "size": [1.0]})
    b = pd.DataFrame({"trade_date": pd.to_datetime(["2024-01-03"]),
                      "ts_code": ["y"], "size": [2.0]})
    rep = crosscheck_factors(a, b)
    assert_report_equal(rep, ref_crosscheck(a, b))
    assert rep["size"]["n_overlap"] == 0 and np.isnan(rep["size"]["pearson"])


def test_crosscheck_ties_rank_at_their_average():
    a = pd.DataFrame({"trade_date": pd.to_datetime(["2024-01-02"] * 6),
                      "ts_code": list("abcdef"),
                      "f": [1.0, 1.0, 2.0, 3.0, 3.0, 3.0]})
    b = a.copy()
    b["f"] = [5.0, 4.0, 4.0, 4.0, 1.0, 2.0]
    assert_report_equal(crosscheck_factors(a, b), ref_crosscheck(a, b))


def test_crosscheck_explicit_factors_validated_and_sentinels_coerced():
    a = pd.DataFrame({"trade_date": pd.to_datetime(["2024-01-02"] * 4),
                      "ts_code": ["x", "y", "z", "w"],
                      "size": [1.0, 2.0, 3.0, 4.0]})
    b = a.copy()
    b["size"] = ["1.0", "NULL", "3.5", "--"]   # vendor sentinels
    rep = crosscheck_factors(a, b, factors=["size"])
    assert_report_equal(rep, ref_crosscheck(a, b, factors=["size"]))
    assert rep["size"]["n_overlap"] == 2
    for fn in (crosscheck_factors, ref_crosscheck):
        with pytest.raises(ValueError, match="not found"):
            fn(a, b, factors=["Beta"])


def test_json_floats_are_to_jsons():
    rng = np.random.default_rng(1)
    vals = np.concatenate([
        rng.standard_normal(3000) * 10.0 ** rng.integers(-20, 20, 3000),
        [0.0, -0.0, 0.5, 1.5, 2.5e-10, 5e-11, 1e16, 1e-15, 5e-16, -3.25,
         9999999999999998.0, 123456789.123456789, np.inf, -np.inf, np.nan]])
    want = json.loads(pd.DataFrame({"v": vals}).to_json(orient="index"))
    for i, v in enumerate(vals):
        assert json.loads(_json_float(v)) == want[str(i)]["v"], v
    text = pd.DataFrame({"v": vals}).to_json(orient="index")
    got = "{" + ",".join(f'"{i}":{{"v":{_json_float(v)}}}'
                         for i, v in enumerate(vals)) + "}"
    assert got == text


def _both_clis(argv, capsys):
    """(exit code, stdout, stderr) of the port's and the reference's
    ``crosscheck`` on the same argv."""
    out = []
    for main, pre in ((cli.main, []), (ref_cli.main, ["--platform", "cpu"])):
        code = 0
        try:
            main(pre + argv)
        except SystemExit as e:
            code = e.code
        o, e = capsys.readouterr()
        out.append((code, o, re.sub(r"np\.float64\((.*?)\)", r"\1", e)))
    return out


def test_crosscheck_cli_roundtrip(factor_tables, tmp_path, capsys):
    a, b = factor_tables
    pa, pb = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    a.to_csv(pa, index=False)
    b.to_csv(pb, index=False)
    port, ref = _both_clis(["crosscheck", "--ours", pa, "--external", pb,
                            "--out", str(tmp_path / "port.csv")], capsys)
    ref_cli.main(["--platform", "cpu", "crosscheck", "--ours", pa,
                  "--external", pb, "--out", str(tmp_path / "ref.csv")])
    capsys.readouterr()
    assert port == ref and port[0] == 0
    assert json.loads(port[1])["size"]["pearson"] > 0.999
    assert (tmp_path / "port.csv").read_bytes() == \
        (tmp_path / "ref.csv").read_bytes()


def test_crosscheck_cli_int_yyyymmdd_dates_vs_parquet_datetimes(tmp_path,
                                                                capsys):
    pytest.importorskip("pyarrow")
    a = pd.DataFrame({"trade_date": [20240102, 20240103],
                      "ts_code": ["x", "x"], "size": [1.0, 2.0]})
    b = pd.DataFrame({"trade_date": pd.to_datetime(["2024-01-02",
                                                    "2024-01-03"]),
                      "ts_code": ["x", "x"], "size": [1.0, 2.0]})
    pa, pb = str(tmp_path / "a.csv"), str(tmp_path / "b.parquet")
    a.to_csv(pa, index=False)
    b.to_parquet(pb)
    port, ref = _both_clis(["crosscheck", "--ours", pa, "--external", pb,
                            "--factors", " size"], capsys)
    assert port == ref
    rep = json.loads(port[1])
    assert rep["size"]["n_overlap"] == 2 and rep["size"]["max_abs_diff"] == 0


def test_crosscheck_gate(tmp_path, capsys):
    a = pd.DataFrame({"trade_date": [20240102, 20240103],
                      "ts_code": ["x", "x"],
                      "size": [1.0, 2.0], "beta": [0.5, 0.6]})
    b = a.copy()
    b["beta"] = [0.5, 0.7]  # 0.1 off
    pa, pb = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    a.to_csv(pa, index=False)
    b.to_csv(pb, index=False)
    base = ["crosscheck", "--ours", pa, "--external", pb, "--gate"]
    # within tolerance: clean exit
    port, ref = _both_clis(base + ["0.2"], capsys)
    assert port == ref and port[0] == 0
    # beyond tolerance: exit 1 naming the factor
    port, ref = _both_clis(base + ["0.05"], capsys)
    assert port == ref and port[0] == 1
    assert "GATE FAIL beta" in port[2] and "GATE FAIL size" not in port[2]
    # a factor with zero overlap fails, not silently passes (NaN diff)
    b2 = b.copy()
    b2["size"] = np.nan
    b2.to_csv(pb, index=False)
    port, ref = _both_clis(base + ["1.0"], capsys)
    assert port == ref and port[0] == 1 and "GATE FAIL size" in port[2]


def test_crosscheck_gate_empty_comparison_fails(tmp_path, capsys):
    a = pd.DataFrame({"trade_date": [20240102], "ts_code": ["x"],
                      "size": [1.0]})
    b = a.rename(columns={"size": "size_f"})
    pa, pb = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    a.to_csv(pa, index=False)
    b.to_csv(pb, index=False)
    argv = ["crosscheck", "--ours", pa, "--external", pb]
    port, ref = _both_clis(argv, capsys)
    assert port == ref and port[0] == 0 and port[1].strip() == "{}"
    port, ref = _both_clis(argv + ["--gate", "1.0"], capsys)
    assert port == ref and port[0] == 1
    assert "no shared numeric factor columns" in port[2]


def test_crosscheck_runs_without_pandas(tmp_path):
    """The csv path imports no pandas."""
    import subprocess
    import sys

    a = {"trade_date": [20240102, 20240103], "ts_code": ["x", "y"],
         "size": [1.0, 2.0]}
    pa = tmp_path / "a.csv"
    pd.DataFrame(a).to_csv(pa, index=False)
    code = ("import sys; sys.modules['pandas'] = None\n"
            f"sys.path.insert(0, {str(cli.__file__.rsplit('/', 2)[0])!r})\n"
            "from mfm_tpu_torch import cli\n"
            f"cli.main(['crosscheck', '--ours', {str(pa)!r}, '--external', "
            f"{str(pa)!r}, '--gate', '0'])\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout)["size"]["n_overlap"] == 2
