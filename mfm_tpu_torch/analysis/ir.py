"""A2 — the dtype-leak and host-callback audit (counterpart of
``mfm_tpu/analysis/ir.py``).

The reference walks the tensor types of each lowered StableHLO module
(under ``disable_x64``, the production float32 mode) and its host-callback
custom calls.  Eager torch lowers nothing, so the port reads the cell's
one run (at float32, ``analysis/registry.py``) under a
``TorchDispatchMode`` that sees every aten op the call dispatches:

- **tensor_dtypes** (the evidence): the dtype of every tensor an op
  returns.  ``float64`` or ``complex128`` anywhere is a ``wide-dtype``
  error — a 64-bit leak into the production float32 path, a 2x memory bill.
  ``int64`` is torch's index default (``arange``, ``long()`` indices), so
  it is flagged only where it reaches a signature boundary, where PR 1's
  s64 retrace trap lives in the port: the operands the eigh dispatchers
  record (``ops/eigh.py``, through ``utils/contracts``'s audit probes) and
  the padded operands of a bucketed entry point (a cell with a bucket).
- **host-callback**: the port's host round trip is an op that reads
  device values into the host's control flow — ``_local_scalar_dense``
  (``.item()``, ``float(t)``, ``int(t)``), ``is_nonzero`` (``bool(t)``),
  ``equal`` — or one whose output shape depends on the data (``nonzero``,
  ``masked_select``, the ``unique`` family, indexing by a bool mask).
  Each stops a CUDA graph from capturing the call.  The set holds ops
  that dispatch alike on the CPU and on the card, so one baseline serves
  both runs; a copy to the host (``.cpu()``, ``.tolist()``, ``.numpy()``)
  dispatches only on the card and is not in it.  On the card the run
  also counts ``torch.cuda.set_sync_debug_mode``'s warnings, as evidence
  in the cell's entry (``syncs``), not as a finding.

:func:`scan_run` is pure over the recorded evidence.
"""

from __future__ import annotations

import contextlib
import warnings

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mfm_tpu_torch.analysis.registry import Finding
from mfm_tpu_torch.utils import contracts

#: element dtypes that must never appear in the production float32 path
_WIDE = {"float64", "complex128"}
#: the index dtype, flagged only at a signature boundary
_WIDE_INDEX = "int64"

#: ops that read device values into the host's control flow
_HOST_READ_OPS = {"_local_scalar_dense", "is_nonzero", "equal"}
#: ops whose output shape depends on the data
_DATA_SHAPE_OPS = {"nonzero", "masked_select", "_unique", "_unique2",
                   "unique_dim", "unique_consecutive",
                   "unique_dim_consecutive"}
#: indexing ops that take a bool mask in their index list
_INDEX_OPS = {"index", "index_put", "index_put_", "_index_put_impl_"}


def _short(dtype) -> str:
    return str(dtype).removeprefix("torch.")


class DtypeProbe(TorchDispatchMode):
    """Records the dtype of every tensor an op returns (``dtypes``) and
    every host-read or data-shaped op (``host_reads``)."""

    def __init__(self):
        super().__init__()
        self.dtypes: set = set()
        self.host_reads: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if name in _HOST_READ_OPS or name in _DATA_SHAPE_OPS:
            self.host_reads.append(name)
        elif name in _INDEX_OPS and len(args) > 1 and any(
                torch.is_tensor(i) and i.dtype in (torch.bool, torch.uint8)
                for i in (args[1] or ())):
            self.host_reads.append(f"{name}[bool mask]")
        out = func(*args, **kwargs)
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if torch.is_tensor(t):
                self.dtypes.add(_short(t.dtype))
        return out


@contextlib.contextmanager
def probe(on_card: bool = False):
    """Within the block: the dispatch-mode probe, the signature-boundary
    probe (``(where, dtypes)`` of every ``note_signature`` call) and, with
    ``on_card``, the sync-debug warnings.  Yields a dict that holds
    ``dtypes``, ``host_reads``, ``boundary`` and ``syncs`` after it."""
    rec = {"boundary": [], "syncs": 0}

    def boundary(where, tensors):
        rec["boundary"].append(
            (where, tuple(_short(t.dtype) for t in tensors)))

    contracts._PROBES.append(boundary)
    mode = DtypeProbe()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if on_card:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                with mode:
                    yield rec
            finally:
                if on_card:
                    torch.cuda.set_sync_debug_mode(0)
        rec["syncs"] = sum("synchroniz" in str(w.message) for w in caught)
    finally:
        contracts._PROBES.remove(boundary)
        rec["dtypes"] = mode.dtypes
        rec["host_reads"] = mode.host_reads


def scan_run(ep_name: str, cell_name: str, dtypes, host_reads,
             boundary) -> list:
    """The pure A2 verdicts for one cell run.

    Args:
      dtypes: the dtypes (short names, ``"float32"``) the run's ops
        returned.
      host_reads: the host-read and data-shaped ops it dispatched.
      boundary: ``(where, dtypes)`` of every operand set that reached a
        signature boundary (the eigh dispatchers, a bucketed entry
        point's padded operands).
    """
    findings = []
    wide = sorted(set(dtypes) & _WIDE)
    at = sorted({f"{dt} at {where}" for where, dts in boundary
                 for dt in dts if dt == _WIDE_INDEX or dt in _WIDE})
    if wide or at:
        findings.append(Finding(
            "A2", "error", ep_name, cell_name, "wide-dtype",
            f"the float32 run produced {wide + at} — a 64-bit leak (PR 1's "
            f"retrace class when it is an index at a signature, a 2x "
            f"memory bill when it is data)"))
    if host_reads:
        counts = {op: host_reads.count(op) for op in sorted(set(host_reads))}
        findings.append(Finding(
            "A2", "error", ep_name, cell_name, "host-callback",
            f"the call reads the device into the host {counts} — each "
            f"stops a CUDA graph from capturing the step"))
    return findings


def run_pass(artifacts: dict) -> list:
    """A2 over every cell that ran (primary AND mesh — a leak only the
    sharded path makes still gates)."""
    findings = []
    for (ep, cell), art in artifacts.items():
        if not art.get("ran"):
            continue
        findings.extend(scan_run(ep.name, cell.name, art["dtypes"],
                                 art["host_reads"], art["boundary"]))
    return findings
