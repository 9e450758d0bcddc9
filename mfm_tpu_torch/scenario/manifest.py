"""Atomic scenario manifests + the audit over them (counterpart of
``mfm_tpu/scenario/manifest.py``; the same JSON, field for field, so a
manifest either package writes audits clean in the other).

A scenario batch is evidence — "under covid-2020-analog this book runs
3.1x hot" drives real decisions — so its results persist with the same
discipline as checkpoints: ONE ``scenario_manifest.json`` written
atomically (tmp -> fsync -> chaos point -> rename -> dir fsync) next to
the artifacts it was computed against.  The chaos point
(``scenario_manifest.after_tmp``, ``utils/chaos.py``) lets a test SIGKILL
the writer mid-write and find no torn manifest.

The manifest is DETERMINISTIC except for its ``summary`` block (obs
latency quantiles): per-scenario entries carry the full spec, its
canonical hash, the audit numbers (vol deltas, top factor swings, PSD
projection flags) — so byte-comparing two manifests modulo ``summary``
IS a bitwise-replay check.

:func:`audit_scenario_manifest` (the reference's ``mfm-tpu doctor
--scenarios`` audit) reports torn JSON, wrong schema/kind, and entries
whose recomputed spec hash disagrees with the recorded one (a mismatched
manifest — results edited or mixed from another run).

Host-only: pure JSON and filesystem.
"""

from __future__ import annotations

import json
import os

import numpy as np

from mfm_tpu_torch.scenario.spec import ScenarioSpec
from mfm_tpu_torch.utils.chaos import chaos_point

SCENARIO_MANIFEST_SCHEMA_VERSION = 1
SCENARIO_MANIFEST_NAME = "scenario_manifest.json"
#: factor-vol swings recorded per scenario (largest |delta| first)
TOP_SWINGS = 5


class ScenarioManifestError(RuntimeError):
    """A scenario manifest exists but is unreadable, schema-incompatible,
    or inconsistent with the specs it claims to record."""


def scenario_manifest_path_for(artifact_dir: str) -> str:
    """The scenario-manifest slot inside an artifact directory."""
    return os.path.join(artifact_dir, SCENARIO_MANIFEST_NAME)


def _entry(result, factor_names) -> dict:
    spec = result.spec
    e = {
        "name": spec.name,
        "kinds": list(spec.kinds),
        "spec": spec.to_dict(),
        "spec_hash": spec.spec_hash(),
        "status": result.status,
        "problems": list(result.problems),
    }
    if not result.ok:
        return e
    before = np.asarray(result.base_factor_vol, np.float64)
    after = np.asarray(result.factor_vol, np.float64)
    delta = after - before
    # "total vol" here is the vol of the equal-exposure unit portfolio's
    # factor part proxied by the trace — a portfolio-free scalar that
    # still moves when anything in the matrix does
    e.update({
        "psd_projected": bool(result.psd_projected),
        "min_eig_stressed": float(result.min_eig_stressed),
        "total_vol_before": float(np.sqrt(np.sum(before ** 2))),
        "total_vol_after": float(np.sqrt(np.sum(after ** 2))),
    })
    # top factor-contribution swings: the factors whose share of total
    # variance moved most (what a risk reader asks first: "what drove it")
    var_b, var_a = before ** 2, after ** 2
    share_b = var_b / max(float(var_b.sum()), 1e-300)
    share_a = var_a / max(float(var_a.sum()), 1e-300)
    order = np.argsort(-np.abs(delta))[:TOP_SWINGS]
    e["top_vol_swings"] = [
        {"factor": str(factor_names[i]), "vol_before": float(before[i]),
         "vol_after": float(after[i]), "vol_delta": float(delta[i]),
         "share_swing": float(share_a[i] - share_b[i])}
        for i in order]
    return e


def build_scenario_manifest(results, factor_names, *, stamp_json=None,
                            backend=None, summary: dict | None = None,
                            staleness: int | None = None,
                            sensitivities: dict | None = None) -> dict:
    """Assemble the manifest dict (pure; :func:`write_scenario_manifest`
    persists).  ``results``: a batch's :class:`ScenarioResult` list;
    ``summary``: the obs block (``scenario_summary_from_registry``) —
    the ONE volatile field, excluded from replay comparison;
    ``sensitivities``: optional name-keyed grad entries
    (``GradEngine.sensitivities``) — each ok entry gains a deterministic
    ``sensitivity`` block (exact d vol/d shock + d vol/d exposure rows),
    additive next to the hash-audited spec so replay comparison and
    :func:`audit_scenario_manifest` are untouched."""
    entries = [_entry(r, factor_names) for r in results]
    if sensitivities:
        for e in entries:
            s = sensitivities.get(e["name"])
            if s is not None and e["status"] == "ok":
                e["sensitivity"] = {k: v for k, v in s.items()
                                    if k not in ("name", "status",
                                                 "problems")}
    return {
        "schema_version": SCENARIO_MANIFEST_SCHEMA_VERSION,
        "kind": "scenario_manifest",
        "config_stamp": stamp_json,
        "backend": backend,
        "staleness": staleness,
        "n_scenarios": len(entries),
        "n_ok": sum(1 for e in entries if e["status"] == "ok"),
        "n_rejected": sum(1 for e in entries if e["status"] == "rejected"),
        "n_psd_projected": sum(1 for e in entries
                               if e.get("psd_projected")),
        "scenarios": entries,
        "summary": summary or {},
    }


def write_scenario_manifest(path: str, manifest: dict) -> str:
    """Atomic write (tmp -> fsync -> chaos point -> rename -> dir fsync);
    ``path`` may be the artifact directory.  Returns the final path."""
    if os.path.isdir(path):
        path = os.path.join(path, SCENARIO_MANIFEST_NAME)
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
    chaos_point("scenario_manifest.after_tmp", path)
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


def read_scenario_manifest(path: str) -> dict:
    """Load + schema-check a scenario manifest (``path`` may be its
    directory).  Raises :class:`ScenarioManifestError` on unreadable /
    torn JSON, wrong ``schema_version`` or ``kind``, or a missing
    ``scenarios`` list."""
    if os.path.isdir(path):
        path = os.path.join(path, SCENARIO_MANIFEST_NAME)
    try:
        with open(path, encoding="utf-8") as fh:
            m = json.load(fh)
    except OSError as e:
        raise ScenarioManifestError(
            f"{path}: unreadable scenario manifest ({e})") from e
    except ValueError as e:
        raise ScenarioManifestError(
            f"{path}: scenario manifest is not valid JSON ({e}) — torn "
            "write?") from e
    if not isinstance(m, dict):
        raise ScenarioManifestError(
            f"{path}: scenario manifest is not a JSON object")
    if m.get("schema_version") != SCENARIO_MANIFEST_SCHEMA_VERSION:
        raise ScenarioManifestError(
            f"{path}: scenario manifest schema_version "
            f"{m.get('schema_version')!r} unsupported (expected "
            f"{SCENARIO_MANIFEST_SCHEMA_VERSION})")
    if m.get("kind") != "scenario_manifest":
        raise ScenarioManifestError(
            f"{path}: kind {m.get('kind')!r} is not a scenario manifest")
    if not isinstance(m.get("scenarios"), list):
        raise ScenarioManifestError(
            f"{path}: scenario manifest has no scenarios list")
    return m


def audit_scenario_manifest(path: str) -> tuple:
    """Deep audit of a scenario manifest (the reference's ``doctor
    --scenarios``).

    Returns ``(problems, warnings)`` (lists of strings); an unreadable
    manifest raises :class:`ScenarioManifestError` (doctor reports it as
    corrupt).  Problems: per-entry recomputed spec hash disagreeing with
    the recorded one (mismatched manifest), malformed entries, duplicate
    names, count fields inconsistent with the entry list.  Warnings:
    rejected scenarios (legal, but a drill that asked for them should
    know).
    """
    m = read_scenario_manifest(path)
    problems, warnings = [], []
    seen = set()
    for i, e in enumerate(m["scenarios"]):
        label = f"scenarios[{i}]"
        if not isinstance(e, dict) or "spec" not in e or \
                "spec_hash" not in e or "name" not in e:
            problems.append(f"{label}: malformed entry (need name/spec/"
                            "spec_hash)")
            continue
        if e["name"] in seen:
            problems.append(f"{label}: duplicate scenario name "
                            f"{e['name']!r}")
        seen.add(e["name"])
        try:
            spec = ScenarioSpec.from_dict(e["spec"])
        except (ValueError, TypeError, KeyError, IndexError) as exc:
            problems.append(f"{label} ({e['name']!r}): embedded spec does "
                            f"not parse ({exc})")
            continue
        if spec.name != e["name"]:
            problems.append(f"{label}: entry name {e['name']!r} != spec "
                            f"name {spec.name!r}")
        if spec.spec_hash() != e["spec_hash"]:
            problems.append(
                f"{label} ({e['name']!r}): spec hash mismatch — manifest "
                f"records {str(e['spec_hash'])[:12]}…, the embedded spec "
                f"hashes to {spec.spec_hash()[:12]}… (results edited or "
                "mixed from another run)")
        if e.get("status") == "rejected":
            warnings.append(f"{e['name']!r} was rejected: "
                            f"{'; '.join(e.get('problems', [])[:2])}")
    n = len(m["scenarios"])
    n_ok = sum(1 for e in m["scenarios"]
               if isinstance(e, dict) and e.get("status") == "ok")
    if m.get("n_scenarios") != n or m.get("n_ok") != n_ok:
        problems.append(
            f"count fields disagree with the entry list (n_scenarios="
            f"{m.get('n_scenarios')} vs {n}, n_ok={m.get('n_ok')} vs "
            f"{n_ok})")
    return problems, warnings
