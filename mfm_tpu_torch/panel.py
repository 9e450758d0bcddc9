"""The dense masked Panel (counterpart of ``mfm_tpu/panel.py``), in numpy.

The reference keeps its data in long DataFrames (one row per stock-date)
and loops over ``groupby`` groups.  Here a panel is a dict of dense
``(T, N)`` arrays (dates x stocks) where NaN marks a missing observation,
so ragged per-date universes become masking, never dynamic shapes.
:meth:`Panel.from_long` takes a DataFrame or a dict of numpy columns;
only :meth:`Panel.to_long` imports pandas, when called.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable

import numpy as np


@dataclasses.dataclass
class Panel:
    """A dense (T, N) panel of named fields with NaN-as-missing semantics.

    Attributes:
      dates:  (T,) ascending dates (datetime64[D] or int-like).
      stocks: (N,) sorted stock identifiers.
      fields: name -> (T, N) float array; NaN = missing.
      static: name -> (N,) per-stock data (e.g. the industry code).
    """

    dates: np.ndarray
    stocks: np.ndarray
    fields: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    static: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    @property
    def T(self) -> int:
        return len(self.dates)

    @property
    def N(self) -> int:
        return len(self.stocks)

    def __getitem__(self, name: str) -> np.ndarray:
        return self.fields[name]

    def __setitem__(self, name: str, value) -> None:
        value = np.asarray(value) if not hasattr(value, "shape") else value
        if value.shape != (self.T, self.N):
            raise ValueError(
                f"field {name!r} has shape {value.shape}, want {(self.T, self.N)}")
        self.fields[name] = value

    def __contains__(self, name: str) -> bool:
        return name in self.fields

    def mask(self, *names: str) -> np.ndarray:
        """Joint validity mask across the given fields (all finite)."""
        m = np.ones((self.T, self.N), dtype=bool)
        for n in names or tuple(self.fields):
            m &= np.isfinite(np.asarray(self.fields[n], dtype=np.float64))
        return m

    @classmethod
    def from_long(cls, df, *, date_col: str = "trade_date",
                  stock_col: str = "ts_code",
                  value_cols: Iterable[str] | None = None,
                  dtype=np.float64) -> "Panel":
        """Pivot a long (stock-date rows) table — a DataFrame or a dict of
        numpy columns — into a dense Panel.  Value columns are read as
        numbers, anything unparsable as NaN (``pd.to_numeric(...,
        errors="coerce")``).  A duplicated (date, stock) pair keeps its
        last row."""
        dates, ti = np.unique(np.asarray(df[date_col]), return_inverse=True)
        stocks, si = np.unique(np.asarray(df[stock_col]),
                               return_inverse=True)
        if value_cols is None:
            value_cols = [c for c in df if c not in (date_col, stock_col)]
        fields: Dict[str, np.ndarray] = {}
        for c in value_cols:
            arr = np.full((len(dates), len(stocks)), np.nan, dtype=dtype)
            arr[ti, si] = _numeric(df[c], dtype)  # later rows overwrite
            fields[c] = arr
        return cls(dates=dates, stocks=stocks, fields=fields)

    def to_long(self, *names: str, dropna: bool = True):
        """Flatten back to a long DataFrame, by default one row per
        stock-date with at least one of ``names`` present."""
        import pandas as pd

        names = names or tuple(self.fields)
        out = {"trade_date": np.repeat(self.dates, self.N),
               "ts_code": np.tile(self.stocks, self.T)}
        for n in names:
            out[n] = np.asarray(self.fields[n]).reshape(-1)
        df = pd.DataFrame(out)
        if dropna:
            df = df.dropna(how="all", subset=list(names)).reset_index(drop=True)
        return df

    def select(self, names: Iterable[str]) -> "Panel":
        return Panel(dates=self.dates, stocks=self.stocks,
                     fields={n: self.fields[n] for n in names},
                     static=dict(self.static))


def _numeric(col, dtype) -> np.ndarray:
    """A column as numbers in ``dtype``; an entry that does not parse as a
    number is NaN."""
    a = np.asarray(col)
    if a.dtype.kind in "fiub":
        return a.astype(dtype)
    out = np.full(a.shape, np.nan, dtype=dtype)
    for i, v in enumerate(a.tolist()):
        try:
            out[i] = float(v)
        except (TypeError, ValueError):
            pass
    return out


def pct_change(close: np.ndarray) -> np.ndarray:
    """Per-stock simple returns along the date axis of a (T, N) close
    panel against the previous row (not the previous valid observation),
    like ``groupby('ts_code')['close'].pct_change()`` without fill."""
    close = np.asarray(close, dtype=np.float64)
    out = np.full_like(close, np.nan)
    out[1:] = close[1:] / close[:-1] - 1.0
    return out


def log_return(close: np.ndarray) -> np.ndarray:
    """log(close_t) - log(close_{t-1}) per stock
    (``factor_calculator.py:51``)."""
    close = np.asarray(close, dtype=np.float64)
    out = np.full_like(close, np.nan)
    with np.errstate(divide="ignore", invalid="ignore"):
        lc = np.log(close)
    out[1:] = lc[1:] - lc[:-1]
    return out
