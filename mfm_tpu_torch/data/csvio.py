"""CSV tables without pandas (the card's machine has none): a reader that
gives each column the type ``pd.read_csv`` infers for it, and a writer in
the layout ``DataFrame.to_csv`` gives.

A table is a ``dict`` of 1-D numpy columns in file order.  The reader
infers per column as pandas' C parser does with its defaults: a column
whose every cell is an integer is int64, one whose every non-missing cell
is a number is float64 (missing cells NaN), all ``True``/``False`` is
bool, and anything else is text (NaN at missing cells).  The missing
markers are pandas' default ``na_values``.  The type matters downstream:
``pipeline.date_stamp`` stamps an integer date otherwise than a string
one, and an append compares stamps.

The numbers are pandas' too, bit for bit: its default float parser
(``precise_xstrtod``) is not correctly rounded.  It keeps the first 17
digits, leading zeros included, accumulates them in float64 one digit at
a time and scales the result by one power of ten, so ``0.0044963...``
written with 17 significant digits reads an ulp or more away from
Python's ``float``.  :func:`_parse_floats` does the same arithmetic on
whole columns at once.

A file of ASCII without quotes or carriage returns, whose rows all have
the header's field count, is split into columns by byte positions in
numpy (:func:`_split_columns`); any other file goes through the ``csv``
module.  Both give each column's cells to the same inference.
"""

from __future__ import annotations

import csv
import re

import numpy as np

#: pandas' default ``na_values``
NA_VALUES = frozenset((
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"))
_TRUE = frozenset(("True", "TRUE", "true"))
_BOOL = _TRUE | frozenset(("False", "FALSE", "false"))


#: the powers of ten of pandas' parser, 1e0 ... 1e308 as float64 literals
_POW10 = np.array([float(f"1e{k}") for k in range(309)])
_INF = frozenset(("inf", "+inf", "-inf", "infinity", "+infinity",
                  "-infinity"))
_NUMBER = re.compile(r"\s*([+-]?)(\d*)(?:\.(\d*))?(?:[eE]([+-]?\d+))?\s*")


def _scale(number, exponent):
    """``number`` times ten to ``exponent`` as pandas' parser scales it:
    one multiply or divide by a tabled power (two below 1e-308)."""
    with np.errstate(over="ignore", invalid="ignore"):
        out = np.where(exponent > 0,
                       number * _POW10[np.clip(exponent, 0, 308)],
                       number / _POW10[np.clip(-exponent, 0, 308)])
        out = np.where(exponent < -308,
                       number / _POW10[np.clip(-308 - exponent, 0, 308)]
                       / _POW10[308], out)
        out = np.where(exponent < -616, number * 0.0, out)
        return np.where(exponent > 308, np.copysign(np.inf, number), out)


def _parse_float(cell: str) -> float:
    """One cell through pandas' float parser (the rare forms the column
    parser leaves: surrounding blanks, infinities); ValueError when the
    cell is not a number."""
    t = cell.strip().lower()
    if t in _INF:
        return -np.inf if t[0] == "-" else np.inf
    m = _NUMBER.fullmatch(cell)
    if m is None or not (m.group(2) or m.group(3)):
        raise ValueError(f"not a number: {cell!r}")
    sign, ip, fp, ex = m.groups()
    digits = ip + (fp or "")
    kept = digits[:17]
    exponent = (int(ex or 0) + max(len(ip) - 17, 0)
                - max(len(kept) - len(ip), 0))
    number = 0.0
    for ch in kept:
        number = number * 10.0 + (ord(ch) - 48)
    return float(_scale(-number if sign == "-" else number,
                        np.int64(exponent)))


def _parse_floats(cells) -> np.ndarray:
    """float64 of each cell of a column, as pandas' default C parser
    reads it; ValueError when a cell is not a number.  A state machine
    over the characters' positions, each step on the whole column."""
    return _parse_bytes(np.array(cells, dtype="S"))


def _parse_bytes(S: np.ndarray) -> np.ndarray:
    """:func:`_parse_floats` of a column already as bytes (numpy ``S``)."""
    n = len(S)
    B = (np.ascontiguousarray(S.view(np.uint8).reshape(n, -1).T)
         if S.dtype.itemsize else np.zeros((1, n), np.uint8))
    # 0 start, 1 integer digits, 2 fraction, 3 exponent sign, 4 its digits
    state = np.zeros(n, np.int8)
    bad = np.zeros(n, bool)
    neg = np.zeros(n, bool)
    eneg = np.zeros(n, bool)
    ndig, extra, dec, ev = (np.zeros(n, np.int32) for _ in range(4))
    number = np.zeros(n)
    prev_sign = np.zeros(n, bool)
    for p, c in enumerate(B):
        d = c - np.uint8(48)
        digit = d < 10
        in_mant = state <= 2
        mant = digit & in_mant
        keep = mant & (ndig < 17)
        np.multiply(number, 10.0, out=number, where=keep)
        np.add(number, d, out=number, where=keep)
        extra += mant & ~keep & (state <= 1)
        dec += keep & (state == 2)
        ndig += mant
        state[mant & (state == 0)] = 1
        expd = digit & ~in_mant
        np.multiply(ev, 10, out=ev, where=expd)
        np.add(ev, d, out=ev, where=expd)
        np.minimum(ev, 10**6, out=ev)
        state[expd] = 4
        dot = c == 46
        bad |= dot & ~in_mant | dot & (state == 2)
        state[dot & (state <= 1)] = 2
        e = (c == 101) | (c == 69)
        bad |= e & (~in_mant | (ndig == 0))
        state[e & in_mant & (ndig > 0)] = 3
        minus = c == 45
        sg = (c == 43) | minus
        first = sg if p == 0 else np.zeros(n, bool)
        neg |= first & minus
        esg = sg & (state == 3) & ~prev_sign if p else first & False
        eneg |= esg & minus
        bad |= (sg & ~first & ~esg) | ((c != 0) & ~digit & ~dot & ~e & ~sg)
        prev_sign = sg
    bad |= (ndig == 0) | (state == 3)
    ev = ev.astype(np.int64)
    out = _scale(np.where(neg, -number, number),
                 np.where(eneg, -ev, ev) + extra - dec)
    for i in np.nonzero(bad)[0]:
        out[i] = _parse_float(S[i].decode())
    return out


_NA_BYTES = np.array(sorted(v.encode() for v in NA_VALUES), dtype="S")
_NA_TEXT = np.array(sorted(NA_VALUES))
_BOOL_BYTES = np.array(sorted(v.encode() for v in _BOOL), dtype="S")
_TRUE_BYTES = np.array(sorted(v.encode() for v in _TRUE), dtype="S")


def _infer_column(S: np.ndarray) -> np.ndarray:
    """A column typed as pandas would type it (see the module doc): its
    cells as numpy ``S`` bytes, or as ``U`` text where a cell is not
    ASCII (such a column is text)."""
    n = len(S)
    na = np.isin(S, _NA_BYTES if S.dtype.kind == "S" else _NA_TEXT)
    if na.all():
        return np.full(n, np.nan)
    if S.dtype.kind == "S":
        first = S[int(np.argmin(na))].decode()
        if not na.any():
            if first in _BOOL and np.isin(S, _BOOL_BYTES).all():
                return np.isin(S, _TRUE_BYTES)
            if first.strip().lstrip("+-").isdigit():
                try:
                    return S.astype(str).astype(np.int64)
                except (ValueError, OverflowError):
                    pass
        try:
            _parse_float(first)   # a text column fails here, cheaply
            out = _parse_bytes(np.where(na, b"0", S) if na.any() else S)
        except ValueError:
            pass
        else:
            out[na] = np.nan
            return out
    text = S.astype(str)
    if not na.any():
        return text
    out = text.astype(object)
    out[na] = np.nan
    return out


def _split_columns(path):
    """``(header, columns)`` of a csv by byte positions, each column's
    cells as numpy ``S`` bytes; None where the file needs the ``csv``
    module (quotes, carriage returns or non-ASCII bytes, a blank line, a
    row whose field count is not the header's, no header)."""
    buf = np.fromfile(path, np.uint8)
    if not buf.size:
        return None
    if buf[-1] != 10:
        buf = np.append(buf, np.uint8(10))
    if ((buf >= 128) | (buf == 34) | (buf == 13) | (buf == 0)).any():
        return None
    ends = np.flatnonzero(buf == 10)
    starts = np.r_[0, ends[:-1] + 1]
    if (ends == starts).any():
        return None
    header = bytes(buf[:ends[0]]).decode().split(",")
    ncol, n = len(header), len(ends) - 1
    comma = np.flatnonzero(buf == 44)
    per_line = np.searchsorted(comma, ends) - np.searchsorted(comma, starts)
    if (per_line != ncol - 1).any():
        return None
    inner = comma[ncol - 1:].reshape(n, ncol - 1)
    first = np.column_stack([starts[1:], inner + 1])
    length = np.column_stack([inner, ends[1:]]) - first
    widest = int(length.max()) if n else 0
    # a window of the widest field's bytes at every offset; a field is its
    # window's first `length` bytes, the rest zeroed
    windows = np.lib.stride_tricks.sliding_window_view(
        np.concatenate([buf, np.zeros(widest, np.uint8)]), max(widest, 1))
    columns = []
    for j in range(ncol):
        width = int(length[:, j].max()) if n else 0
        if not width:
            columns.append(np.zeros(n, "S1"))
            continue
        cells = windows[first[:, j], :width]
        cells[np.arange(width) >= length[:, j, None]] = 0
        columns.append(np.ascontiguousarray(cells).view(f"S{width}")
                       .reshape(n))
    return header, columns


def _infer(cells: tuple) -> np.ndarray:
    """One column's cells (strings) as pandas would type them."""
    try:
        return _infer_column(np.array(cells, dtype="S"))
    except UnicodeEncodeError:
        return _infer_column(np.array(cells, dtype=str))


def _dates(cells: tuple) -> np.ndarray:
    """A ``parse_dates`` column: ISO dates (a time allowed) and tushare's
    ``YYYYMMDD`` as datetime64[ns]; a column that does not parse keeps
    its inferred type."""
    try:
        return np.array([f"{c[:4]}-{c[4:6]}-{c[6:]}"
                         if len(c) == 8 and c.isdigit()
                         else c.strip().replace(" ", "T") for c in cells],
                        dtype="datetime64[ns]")
    except ValueError:
        return _infer(cells)


def read_csv(path, parse_dates=()) -> dict:
    """``path`` as a dict of typed numpy columns (see the module doc); a
    column named in ``parse_dates`` is read as dates where it parses.  An
    empty header cell is named ``Unnamed: {j}``, as pandas names it."""
    split = _split_columns(path)
    if split is not None:
        header, columns = split
        names = [h or f"Unnamed: {j}" for j, h in enumerate(header)]
        return {name: (_dates(tuple(col.astype(str).tolist()))
                       if name in parse_dates else _infer_column(col))
                for name, col in zip(names, columns)}
    with open(path, newline="") as fh:
        rows = csv.reader(fh)
        header = next(rows, None)
        if header is None:
            raise ValueError(f"{path}: empty table")
        body = list(zip(*rows)) or [()] * len(header)
    names = [h or f"Unnamed: {j}" for j, h in enumerate(header)]
    return {name: (_dates(cells) if name in parse_dates else _infer(cells))
            for name, cells in zip(names, body)}


def _cells(col) -> list:
    """One column as the strings ``DataFrame.to_csv`` writes by default:
    NaN empty, a float as the ``repr`` of its float64 value, a date at
    midnight as its day, anything else as ``str``."""
    col = np.asarray(col)
    if col.dtype.kind == "f":
        return [repr(x) if x == x else "" for x in col.tolist()]
    if col.dtype.kind == "M":
        days = col.astype("datetime64[D]")
        if (days == col).all():
            return days.astype(str).tolist()
        return [str(x).replace("T", " ") for x in col]
    if col.dtype.kind in "iub":
        return [str(x) for x in col.tolist()]
    return ["" if isinstance(x, float) and x != x else str(x) for x in col]


def write_csv(path, columns: dict, index=None) -> None:
    """Write ``columns`` (name -> 1-D sequence) as a csv; with ``index``,
    that column first under an empty name, as ``DataFrame.to_csv`` lays
    out a frame with an unnamed index."""
    names = list(columns)
    cols = [_cells(columns[k]) for k in names]
    if index is not None:
        names.insert(0, "")
        cols.insert(0, _cells(index))
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh, lineterminator="\n")
        w.writerow(names)
        w.writerows(zip(*cols))
