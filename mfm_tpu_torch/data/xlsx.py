"""Static-workbook ingestion (counterpart of ``mfm_tpu/data/xlsx.py``): a
dependency-free xlsx reader + loaders for the reference's two shipped
workbooks, with column tables out.

The reference ships ``data/index_list.xlsx`` (a tushare ``index_basic``
export: ts_code/name/market/publisher/..., inline-string cells) and
``data/industry_index_data.xlsx`` (a Wind EDB export of CITIC and SW L1
industry index daily closes: a banner row, a header row of series names,
two meta rows (frequency/unit), then rows of [excel-date-serial,
close...]).  The files are plain zip+XML, so the reader below implements
exactly the subset those workbooks use: shared strings, inline strings,
cached formula strings, numbers, and sheet resolution by name or index.

    from mfm_tpu_torch.data.xlsx import ingest_workbooks
    ingest_workbooks(store, index_list="data/index_list.xlsx",
                     industry_index="data/industry_index_data.xlsx")

storing ``index_list`` (one row per index) and ``industry_index_prices``
(long (index_name, trade_date, close) rows, yyyymmdd dates — the same
storage format as every other collection).
"""

from __future__ import annotations

import datetime
import re
import zipfile
from typing import Dict, List
from xml.etree import ElementTree

from mfm_tpu_torch.data.columns import as_column, nrows

_NS = "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"
_REL_NS = ("{http://schemas.openxmlformats.org/officeDocument/2006/"
           "relationships}")

#: Excel's day-serial epoch (the 1900 system, with its phantom 1900-02-29
#: already absorbed — serial 1 = 1900-01-01, so the base is 1899-12-30)
_EPOCH = datetime.date(1899, 12, 30)


def excel_serial_to_date(serial: float) -> datetime.date:
    return _EPOCH + datetime.timedelta(days=int(serial))


def _col_index(ref: str) -> int:
    """'A1' -> 0, 'AB17' -> 27."""
    n = 0
    for ch in ref:
        if not ch.isalpha():
            break
        n = n * 26 + (ord(ch.upper()) - ord("A") + 1)
    return n - 1


def _sheet_path(z: zipfile.ZipFile, sheet) -> str:
    """Resolve a sheet name or 0-based index to its archive member via
    workbook.xml + its rels (sheet order need not match file numbering)."""
    wb = ElementTree.fromstring(z.read("xl/workbook.xml"))
    rels = ElementTree.fromstring(z.read("xl/_rels/workbook.xml.rels"))
    rel_to_target = {
        r.get("Id"): r.get("Target")
        for r in rels.iter(f"{{http://schemas.openxmlformats.org/package/"
                           f"2006/relationships}}Relationship")
    }
    sheets = wb.find(f"{_NS}sheets")
    entries = [(s.get("name"), rel_to_target[s.get(f"{_REL_NS}id")])
               for s in sheets]
    if isinstance(sheet, int):
        if not 0 <= sheet < len(entries):
            raise ValueError(f"sheet index {sheet} out of range "
                             f"({len(entries)} sheets)")
        target = entries[sheet][1]
    else:
        matches = [t for n, t in entries if n == sheet]
        if not matches:
            raise ValueError(f"no sheet named {sheet!r}; have "
                             f"{[n for n, _ in entries]}")
        target = matches[0]
    target = target.lstrip("/")
    return target if target.startswith("xl/") else "xl/" + target


def _shared_strings(z: zipfile.ZipFile) -> List[str]:
    if "xl/sharedStrings.xml" not in z.namelist():
        return []
    root = ElementTree.fromstring(z.read("xl/sharedStrings.xml"))
    out = []
    for si in root.iter(f"{_NS}si"):
        # rich-text runs split one string across <r><t> chunks
        out.append("".join(t.text or "" for t in si.iter(f"{_NS}t")))
    return out


def read_xlsx(path: str, sheet=0) -> List[List[object]]:
    """Read one worksheet into a dense list-of-rows grid.

    Cells come back as str (shared/inline/formula strings), float
    (numbers), bool, or None (absent).  Rows are padded to the widest row.
    The caller interprets headers/dates — this is deliberately a GRID
    reader, not a table reader, because the Wind EDB export's meaning
    lives in its banner/meta rows.
    """
    with zipfile.ZipFile(path) as z:
        strings = _shared_strings(z)
        root = ElementTree.fromstring(z.read(_sheet_path(z, sheet)))
        rows: Dict[int, Dict[int, object]] = {}
        for row in root.iter(f"{_NS}row"):
            rr = row.get("r")
            if rr is None:
                raise ValueError(f"{path}: <row> without an r attribute — "
                                 "implied-position rows are not supported")
            r = int(rr) - 1
            cells: Dict[int, object] = {}
            for c in row.iter(f"{_NS}c"):
                ref = c.get("r")
                if not ref:
                    # spec-legal implied positions (some writers omit r on
                    # re-save) would land at index -1 and silently vanish
                    # from the grid — refuse loudly instead
                    raise ValueError(f"{path}: <c> without an r attribute "
                                     f"in row {r + 1} — implied-position "
                                     "cells are not supported")
                ci = _col_index(ref)
                t = c.get("t", "n")
                if t == "inlineStr":
                    is_el = c.find(f"{_NS}is")
                    val = "".join(tt.text or "" for tt in
                                  is_el.iter(f"{_NS}t")) if is_el is not None \
                        else None
                else:
                    v = c.find(f"{_NS}v")
                    if v is None or v.text is None:
                        val = None
                    elif t == "s":
                        val = strings[int(v.text)]
                    elif t == "str":  # cached formula result
                        val = v.text
                    elif t == "b":
                        val = v.text == "1"
                    else:
                        val = float(v.text)
                if val is not None:
                    cells[ci] = val
            if cells:
                rows[r] = cells
    if not rows:
        return []
    width = max(max(cs) for cs in rows.values()) + 1
    height = max(rows) + 1
    return [[rows.get(r, {}).get(c) for c in range(width)]
            for r in range(height)]


def read_index_list(path: str) -> dict:
    """``index_list.xlsx`` -> column table (header row 1: ts_code, name,
    ...), each column typed as a DataFrame built from the rows types it."""
    grid = read_xlsx(path, sheet=0)
    if not grid:
        raise ValueError(f"{path}: sheet 0 is empty — no header row to read")
    header = [str(h) for h in grid[0]]
    return {h: as_column([row[j] for row in grid[1:]], h)
            for j, h in enumerate(header)}


def read_industry_index_prices(path: str, sheet=0) -> dict:
    """One Wind EDB sheet -> long (index_name, trade_date, close) table
    (``{}`` when the sheet holds no data row).

    Layout (verified against the shipped workbook): optional banner row(s),
    one header row whose first cell is ``指标名称`` (series names follow),
    meta rows (frequency/unit — string-valued), then data rows whose first
    cell is an Excel date serial.
    """
    grid = read_xlsx(path, sheet=sheet)
    header = None
    records = []
    for row in grid:
        first = row[0] if row else None
        if header is None:
            if isinstance(first, str) and first.strip() == "指标名称":
                header = [str(h) if h is not None else "" for h in row[1:]]
            continue
        if isinstance(first, bool) or not isinstance(first, (int, float)):
            # meta rows (frequency/unit) between header and data; bool is
            # an int subclass, and a stray TRUE cell is not a date serial
            continue
        date = excel_serial_to_date(first).strftime("%Y%m%d")
        for name, val in zip(header, row[1:]):
            if name and isinstance(val, (int, float)) \
                    and not isinstance(val, bool):
                records.append({"index_name": name, "trade_date": date,
                                "close": float(val)})
    if header is None:
        raise ValueError(f"{path}: no 指标名称 header row — not a Wind EDB "
                         "export sheet")
    if not records:
        return {}
    return {k: as_column([r[k] for r in records], k)
            for k in ("index_name", "trade_date", "close")}


def ingest_workbooks(store, index_list: str | None = None,
                     industry_index: str | None = None,
                     industry_sheets=(0, 1)) -> Dict[str, int]:
    """Load the static workbooks into store collections.

    ``index_list`` -> full-refresh ``index_list`` collection;
    ``industry_index`` sheets -> duplicate-tolerant inserts into
    ``industry_index_prices`` keyed (index_name, trade_date) — re-ingesting
    an updated workbook only adds the new rows (the same idempotent-load
    discipline as the API collections).
    """
    counts: Dict[str, int] = {}
    if index_list:
        df = read_index_list(index_list)
        store.replace("index_list", df)
        counts["index_list"] = nrows(df)
    if industry_index:
        n = 0
        for sh in industry_sheets:
            df = read_industry_index_prices(industry_index, sheet=sh)
            n += store.insert("industry_index_prices", df,
                              unique=("index_name", "trade_date"))
        counts["industry_index_prices"] = n
    return counts
