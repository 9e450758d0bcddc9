"""Atomic grad reports: the differentiable-risk subsystem's evidence file
(counterpart of ``mfm_tpu/grad/report.py``; the same JSON, so a report
either package writes reads in the other).

A reverse-stress or sensitivity run is evidence in the same sense a
scenario batch is — "the worst admissible shock costs this book 2.4x its
vol" drives hedging decisions — so its results persist with the same
discipline as scenario manifests: ONE ``grad_report.json`` written
atomically (tmp -> fsync -> chaos point -> rename -> dir fsync).  The
chaos point (``grad_report.after_tmp``, ``utils/chaos.py``) lets a test
SIGKILL the writer mid-write and find no torn report.

Host-only: pure JSON and filesystem.
"""

from __future__ import annotations

import json
import os

from mfm_tpu_torch.utils.chaos import chaos_point

GRAD_REPORT_SCHEMA_VERSION = 1
GRAD_REPORT_NAME = "grad_report.json"


class GradReportError(RuntimeError):
    """A grad report exists but is unreadable or schema-incompatible."""


def grad_report_path_for(artifact_dir: str) -> str:
    """The grad-report slot inside an artifact directory."""
    return os.path.join(artifact_dir, GRAD_REPORT_NAME)


def build_grad_report(kind: str, entries, *, stamp_json=None, backend=None,
                      staleness: int | None = None,
                      params: dict | None = None) -> dict:
    """Assemble the report dict (pure; :func:`write_grad_report` persists).

    ``kind``: ``"reverse_stress"`` | ``"sensitivity"`` | ``"construct"``;
    ``entries``: the per-portfolio / per-scenario result dicts the engine
    built; ``params``: the solver knobs that produced them (steps, step
    rate, ball bounds) so a report is replayable from its own bytes.
    """
    entries = list(entries)
    return {
        "schema_version": GRAD_REPORT_SCHEMA_VERSION,
        "kind": "grad_report",
        "grad_kind": str(kind),
        "config_stamp": stamp_json,
        "backend": backend,
        "staleness": staleness,
        "params": params or {},
        "n_entries": len(entries),
        "entries": entries,
    }


def write_grad_report(path: str, report: dict) -> str:
    """Atomic write (tmp -> fsync -> chaos point -> rename -> dir fsync);
    ``path`` may be the artifact directory.  Returns the final path."""
    if os.path.isdir(path):
        path = os.path.join(path, GRAD_REPORT_NAME)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    try:
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(report, fh, indent=1, sort_keys=True, default=str)
            fh.write("\n")
            fh.flush()
            os.fsync(fh.fileno())
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    chaos_point("grad_report.after_tmp", path)
    os.replace(tmp, path)
    try:
        fd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:  # pragma: no cover - exotic filesystems
        pass
    return path


def read_grad_report(path: str) -> dict:
    """Load + schema-check a grad report (``path`` may be its directory).
    Raises :class:`GradReportError` on unreadable / torn JSON, wrong
    ``schema_version`` or ``kind``, or a missing ``entries`` list."""
    if os.path.isdir(path):
        path = os.path.join(path, GRAD_REPORT_NAME)
    try:
        with open(path, encoding="utf-8") as fh:
            r = json.load(fh)
    except OSError as e:
        raise GradReportError(f"{path}: unreadable grad report ({e})") from e
    except ValueError as e:
        raise GradReportError(
            f"{path}: grad report is not valid JSON ({e}) — torn write?"
        ) from e
    if not isinstance(r, dict):
        raise GradReportError(f"{path}: grad report is not a JSON object")
    if r.get("schema_version") != GRAD_REPORT_SCHEMA_VERSION:
        raise GradReportError(
            f"{path}: grad report schema_version "
            f"{r.get('schema_version')!r} unsupported (expected "
            f"{GRAD_REPORT_SCHEMA_VERSION})")
    if r.get("kind") != "grad_report":
        raise GradReportError(
            f"{path}: kind {r.get('kind')!r} is not a grad report")
    if not isinstance(r.get("entries"), list):
        raise GradReportError(f"{path}: grad report has no entries list")
    return r
