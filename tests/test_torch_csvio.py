"""The port's csv reader (``mfm_tpu_torch/data/csvio.py``): the byte-position
split and the ``csv`` module's reading give every column the same type
and bits, on seeded random tables of numbers in many written forms,
missing markers, booleans, integers, text and dates; and both equal
``pd.read_csv`` (float bits included).  Files the split declines (quotes,
carriage returns, non-ASCII, ragged rows) go through the ``csv`` module.
"""

import random

import numpy as np
import pandas as pd
import pytest

from mfm_tpu_torch.data import csvio

POOL = ["", "NA", "nan", "NULL", "True", "False", "1", "-2", "+3", " 4",
        "1.5", "-0.0", ".5", "5.", "1e5", "1E+05", "1e-300", "1e400", "inf",
        "-Infinity", "abc", "x y", "00012", "1.0000000000000000001",
        "123456789012345678901234", "#N/A", "n/a", "-", "2020-01-02",
        "20200102"]


def _table_text(seed: int) -> str:
    rng, nrng = random.Random(seed), np.random.default_rng(seed)
    ncol, nrow = rng.randint(1, 5), rng.randint(0, 25)
    cols = []
    for _ in range(ncol):
        kind = rng.choice(["pool", "float", "int", "mixed", "text"])
        if kind == "float":
            v = nrng.standard_normal(nrow) * 10.0 ** nrng.integers(-20, 20,
                                                                   nrow)
            cells = [repr(float(x)) if rng.random() > 0.1 else ""
                     for x in v]
        elif kind == "int":
            cells = [str(int(x)) for x in nrng.integers(-10**9, 10**9, nrow)]
        elif kind == "text":
            cells = [rng.choice(["a", "bb", "600000.SH"]) for _ in range(nrow)]
        elif kind == "mixed":
            cells = [rng.choice(POOL) for _ in range(nrow)]
        else:
            cells = [rng.choice(POOL)] * nrow
        cols.append(cells)
    header = [f"c{j}" if rng.random() < 0.8 else "" for j in range(ncol)]
    text = ",".join(header) + "\n" + "".join(
        ",".join(c[i] for c in cols) + "\n" for i in range(nrow))
    return text.rstrip("\n") if rng.random() < 0.2 else text


def _same(a: dict, b: dict) -> bool:
    if list(a) != list(b):
        return False
    for k in a:
        x, y = a[k], b[k]
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        if x.dtype.kind in "fM":
            if not np.array_equal(x.view(np.int64), y.view(np.int64)):
                return False
        elif x.dtype.kind == "O":
            if [repr(u) for u in x] != [repr(v) for v in y]:
                return False
        elif not np.array_equal(x, y):
            return False
    return True


@pytest.mark.parametrize("block", range(4))
def test_split_reads_as_the_csv_module(tmp_path, monkeypatch, block):
    path = tmp_path / "t.csv"
    for seed in range(block * 100, block * 100 + 100):
        path.write_text(_table_text(seed))
        fast = csvio.read_csv(path)
        with monkeypatch.context() as m:
            m.setattr(csvio, "_split_columns", lambda p: None)
            slow = csvio.read_csv(path)
        assert _same(fast, slow), path.read_text()


def test_split_reads_a_float_table_as_pandas(tmp_path):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2000, 3)) * 10.0 ** rng.integers(-12, 12,
                                                              (2000, 3))
    x[rng.random((2000, 3)) < 0.05] = np.nan
    path = tmp_path / "f.csv"
    csvio.write_csv(path, {"date": np.repeat(["2020-01-02"], 2000),
                           "a": x[:, 0], "b": x[:, 1], "c": x[:, 2],
                           "n": rng.integers(0, 9, 2000)})
    assert csvio._split_columns(path) is not None
    got, want = csvio.read_csv(path), pd.read_csv(path)
    for c in want.columns:
        w = want[c].to_numpy()
        # text: pandas' object column, the port's unicode one (module doc)
        assert got[c].dtype == w.dtype or w.dtype.kind == "O", c
        if w.dtype.kind == "f":
            assert np.array_equal(got[c].view(np.int64), w.view(np.int64)), c
        else:
            assert list(got[c]) == list(w), c


@pytest.mark.parametrize("text", ['a,b\n"1,5",2\n', "a,b\r\n1,2\r\n",
                                  "a,b\né,2\n", "a,b\n1,2,3\n", "a,b\n\n1,2\n",
                                  ""])
def test_split_declines_what_needs_the_csv_module(tmp_path, text):
    path = tmp_path / "d.csv"
    path.write_text(text)
    assert csvio._split_columns(path) is None


@pytest.mark.parametrize("cells", [["é", "NA", "1.5"], ["1.5", "ü"],
                                   ["NA", "", "ß"]])
def test_non_ascii_column_reads_as_pandas(tmp_path, cells):
    path = tmp_path / "u.csv"
    path.write_text("a,b\n" + "".join(f"{c},{i}\n"
                                      for i, c in enumerate(cells)),
                    encoding="utf-8")
    got, want = csvio.read_csv(path), pd.read_csv(path)

    def cells(col):   # text as str (the port's column is unicode), NaN as nan
        return [repr(v) if isinstance(v, float) else str(v) for v in col]

    assert cells(got["a"]) == cells(want["a"])
    assert list(got["b"]) == list(want["b"])
