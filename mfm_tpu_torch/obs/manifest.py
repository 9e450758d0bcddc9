"""Per-run manifest: what produced this checkpoint, and was it healthy
(counterpart of ``mfm_tpu/obs/manifest.py``).

One JSON file (``run_manifest.json``) written atomically NEXT TO the
checkpoint artifact it describes, carrying the run's identity (config
stamp, git describe, the device it ran on, argv), a metrics snapshot, the
guard verdict summary and the model-health verdict.  ``doctor`` audits it
against the checkpoint it sits beside: a manifest whose stamp does not
match the checkpoint's identity means the directory holds artifacts from
two different runs.  The serve and fleet manifests
(``serve_manifest.json``, ``serve_manifest.r{i}.json``,
``fleet_manifest.json``) share the format.

The write mirrors ``data/artifacts.py``'s discipline (tmp -> fsync ->
rename -> dir fsync) with its own chaos point
(``run_manifest.after_tmp``), so a SIGKILL mid-manifest-write never leaves
a torn manifest or touches the checkpoint.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

from mfm_tpu_torch.utils.chaos import chaos_point

MANIFEST_SCHEMA_VERSION = 1
MANIFEST_NAME = "run_manifest.json"


class ManifestError(RuntimeError):
    """A run manifest exists but is unreadable, schema-incompatible, or
    inconsistent with the checkpoint it sits beside."""


def git_describe(cwd: str | None = None) -> str | None:
    """``git describe --always --dirty`` of the source tree (None outside a
    repo / without git) — the manifest's code-identity field."""
    try:
        out = subprocess.run(
            ["git", "describe", "--always", "--dirty"],
            cwd=cwd or os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__)))),
            capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None if out.returncode == 0 else None


def manifest_path_for(checkpoint_path: str) -> str:
    """The manifest slot next to a checkpoint artifact (same directory)."""
    return os.path.join(os.path.dirname(checkpoint_path) or ".",
                        MANIFEST_NAME)


def build_run_manifest(*, stamp_json=None, checkpoint: str | None = None,
                       backend: str | None = None,
                       metrics_snapshot: dict | None = None,
                       guard_summary: dict | None = None,
                       health: dict | None = None,
                       extra: dict | None = None) -> dict:
    """Assemble the manifest dict (pure; :func:`write_run_manifest` persists).

    ``stamp_json`` is the checkpoint identity in its JSON-encoded form (the
    ``{"__tuple__": [...]}`` shape ``data/artifacts.py`` stores), so doctor
    can compare manifest and checkpoint stamps by JSON equality without
    rehydrating tuples.  ``backend`` is the device the run computed on
    (:func:`device_name`).
    """
    return {
        "schema_version": MANIFEST_SCHEMA_VERSION,
        "written_at_unix": round(time.time(), 3),
        "argv": list(sys.argv),
        "git": git_describe(),
        "backend": backend,
        "checkpoint": (os.path.basename(checkpoint) if checkpoint else None),
        "config_stamp": stamp_json,
        "guard": guard_summary or {},
        "health": health or {"status": "unknown", "checks": {}},
        "metrics": metrics_snapshot or {},
        **(extra or {}),
    }


def write_run_manifest(path: str, manifest: dict) -> str:
    """Atomic manifest write (tmp -> fsync -> chaos point -> rename -> dir
    fsync).  ``path`` may be a directory (the checkpoint dir) or a file.
    Returns the final path."""
    if os.path.isdir(path):
        path = os.path.join(path, MANIFEST_NAME)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    try:
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(manifest, fh, indent=1, sort_keys=True, default=str)
            fh.write("\n")
            fh.flush()
            os.fsync(fh.fileno())
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    chaos_point("run_manifest.after_tmp", path)
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


def read_run_manifest(path: str) -> dict:
    """Load + schema-check a manifest (``path`` may be its directory).

    Raises :class:`ManifestError` on unreadable JSON, a missing/unsupported
    ``schema_version``, or a missing ``health`` field — the three ways a
    manifest stops being auditable.
    """
    if os.path.isdir(path):
        path = os.path.join(path, MANIFEST_NAME)
    try:
        with open(path, encoding="utf-8") as fh:
            m = json.load(fh)
    except OSError as e:
        raise ManifestError(f"{path}: unreadable run manifest ({e})") from e
    except ValueError as e:
        raise ManifestError(f"{path}: run manifest is not valid JSON ({e}) "
                            "— torn write?") from e
    if not isinstance(m, dict):
        raise ManifestError(f"{path}: run manifest is not a JSON object")
    ver = m.get("schema_version")
    if ver != MANIFEST_SCHEMA_VERSION:
        raise ManifestError(
            f"{path}: manifest schema_version {ver!r} unsupported "
            f"(expected {MANIFEST_SCHEMA_VERSION})")
    health = m.get("health")
    if not isinstance(health, dict) or "status" not in health:
        raise ManifestError(f"{path}: manifest has no health verdict")
    return m


def device_name(device) -> str:
    """The manifest's ``backend`` field: the CUDA card's name
    (``torch.cuda.get_device_name``) for a CUDA device, else ``"cpu"``."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu"
