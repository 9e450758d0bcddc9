"""Command-line entry point of the port (counterpart of ``mfm_tpu/cli.py``).

    python -m mfm_tpu_torch.cli risk --barra barra_data.csv --out results/
    python -m mfm_tpu_torch.cli risk --barra NEW.csv --update ck/state.npz
    python -m mfm_tpu_torch.cli demo --out results/     # synthetic end-to-end
    python -m mfm_tpu_torch.cli factors --panel P.csv --index I.csv \
        --industry M.csv --out results/
    python -m mfm_tpu_torch.cli scenario list|run|sweep ...
    python -m mfm_tpu_torch.cli grad reverse|sensitivity|construct ...
    python -m mfm_tpu_torch.cli serve STATE [--device cuda|cpu] ...
    python -m mfm_tpu_torch.cli serve STATE --replicas N      # pipe fleet
    python -m mfm_tpu_torch.cli serve STATE --listen HOST:PORT [--http]
    python -m mfm_tpu_torch.cli serve STATE --worker --listen HOST:PORT
    python -m mfm_tpu_torch.cli doctor DIR [--serve] [--scenarios]
    python -m mfm_tpu_torch.cli doctor --audit [SNAPSHOT] [--sync]
    python -m mfm_tpu_torch.cli audit [--strict] [--json FILE] \
        [--passes A1,...] [--write-budgets] [--device cuda|cpu]
    python -m mfm_tpu_torch.cli metrics dump|snapshot|diff ...
    python -m mfm_tpu_torch.cli alpha --exprs FILE --panel LONG.csv \
        [--select K] [--llm] [--device cuda|cpu]
    python -m mfm_tpu_torch.cli prepare --store STORE --out prepared/
    python -m mfm_tpu_torch.cli pipeline --store STORE --out results/ \
        [--append] [--to-store STORE2] [--alphas FILE]
    python -m mfm_tpu_torch.cli risk --barra-store STORE2 --out results/
    python -m mfm_tpu_torch.cli etl-update|etl-verify|etl-missing|etl-xlsx \
        --store STORE ...
    python -m mfm_tpu_torch.cli report --results results/ [--plot F.png]
    python -m mfm_tpu_torch.cli crosscheck --ours A.csv --external B.csv \
        [--gate TOL]

``risk`` runs the risk model over a barra-format csv, checkpoints it
(``--save-state``, with the run manifest and its health verdict beside
the checkpoint) or serves new dates from a checkpoint (``--update``);
``demo`` runs it on a seeded synthetic table; ``factors`` produces the
barra table from a raw long panel.  ``scenario`` and ``grad`` stress,
differentiate and construct against a guarded checkpoint.  ``serve`` is
the batched portfolio-query service over a guarded risk-state
checkpoint, alone or as a fleet: worker replicas over pipes or TCP behind
a coalescing front end, a socket/HTTP listener, rolling rollouts, the
response cache, SLOs, the flight recorder and the serve and fleet
manifests.  ``doctor`` audits the checkpoint directory's artifacts and
run manifest, with ``--serve`` its serve and fleet manifests, their SLO
blocks and flight-recorder dumps, and with ``--scenarios`` its scenario
and sweep manifests.  ``metrics`` reads what ``--metrics-dir`` wrote.
``alpha`` evaluates a batch of alpha-DSL expressions over a long panel and
writes their scorecard, optionally with a de-correlated selection.
``prepare`` turns a store of raw tushare-shaped collections into the
factor inputs (``panel.npz``, the index prices, the industry map);
``pipeline`` runs the store through factors and risk in one command, with
a resumable checkpoint that ``--append`` serves new dates from, and
``--to-store`` keeps the factor table as collections that ``risk
--barra-store`` reads.  ``etl-update`` refreshes the store from the
vendor (``--dry-run`` plans it from the watermarks alone), ``etl-verify``
and ``etl-missing`` check it, ``etl-xlsx`` loads the static workbooks.
``report`` summarizes a results directory's model health (and plots it
with matplotlib); ``crosscheck`` compares two factor tables and, with
``--gate``, fails on disagreement.
The csv and store paths need no pandas (a parquet file, from a store or
a ``prepare`` directory the reference wrote, is read through it).  The flags, outputs, manifests and exit codes
are the reference's; ``--device`` (default ``cuda``) takes the place of
its ``JAX_PLATFORMS``: a command computes on the CUDA card unless asked
for the CPU, and without a card ``--device cuda`` raises.  The serve path
launches no CUDA kernel, and importing this module builds and loads none.

``lint`` and ``sync`` run the port's stdlib-only doctrine passes
(``mfm_tpu_torch/lint.py``, ``mfm_tpu_torch/analysis/sync.py``) and
``doctor --sync`` the latter against its committed baseline.  ``audit``
runs the IR audit (``mfm_tpu_torch/analysis/``: every registered entry
point once under probes, passes A1-A5; A5 measures on the card, so
``--device cpu`` runs A1-A4) and ``doctor --audit`` verifies its
committed snapshot (``mfm_tpu_torch/tools/AUDIT_r*.json``).
``risk --mesh DxS`` (and ``--update``) and ``pipeline --append --mesh
DxS`` compute on a ('date', 'stock') device mesh; on one device a
virtual one (``MFM_TORCH_VIRTUAL_DEVICES=N``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os

from mfm_tpu_torch.data.columns import reindex

SERVE_MANIFEST_NAME = "serve_manifest.json"


def _metrics_init(args) -> None:
    """``--metrics-dir``: route the JSONL event stream there, start the
    compile-event counter and record the stage spans (telemetry records
    regardless; this adds sinks)."""
    mdir = getattr(args, "metrics_dir", None)
    if not mdir:
        return
    from mfm_tpu_torch.obs.exporters import emit_event, route_events_to
    from mfm_tpu_torch.obs.instrument import watch_compiles
    from mfm_tpu_torch.obs.trace import set_stage_tracing

    os.makedirs(mdir, exist_ok=True)
    route_events_to(os.path.join(mdir, "events.jsonl"))
    watch_compiles()
    set_stage_tracing(True)
    emit_event("info", "run_start", cmd=args.cmd)


def _metrics_flush(args) -> None:
    """``--metrics-dir``: write the Prometheus textfile + snapshot JSON +
    the run's Chrome trace (atomic, Perfetto-loadable)."""
    mdir = getattr(args, "metrics_dir", None)
    if not mdir:
        return
    from mfm_tpu_torch.obs.exporters import (
        emit_event,
        write_prometheus_textfile,
    )
    from mfm_tpu_torch.obs.metrics import snapshot_json
    from mfm_tpu_torch.obs.trace import spans, write_chrome_trace

    write_prometheus_textfile(os.path.join(mdir, "metrics.prom"))
    with open(os.path.join(mdir, "metrics.json"), "w") as fh:
        fh.write(snapshot_json() + "\n")
    if spans():
        write_chrome_trace(os.path.join(mdir, "trace.json"))
    emit_event("info", "run_end", cmd=args.cmd)


def _root_span(args, nest: bool = True):
    """Open the per-run root span; its trace_id lands in the run manifest
    so ``doctor`` can join manifests to traces.  With ``nest`` the rest of
    the run goes on under it (the stage spans of ``models/`` and
    ``alpha/`` join its trace) until :func:`main` returns; ``serve`` opens
    its requests' traces of their own."""
    from mfm_tpu_torch.obs.trace import new_trace_id, push_span, start_span

    root = start_span(f"cli.{args.cmd}", trace_id=new_trace_id())
    if nest:
        push_span(root)
        args.root_span = root
    return root


def _kernel_block() -> dict:
    """What this process did with the port's CUDA kernels: launches by
    kernel and design, and the libraries it loaded (a serve process
    launches none and loads none)."""
    from mfm_tpu_torch.ops import _build
    from mfm_tpu_torch.ops.eigh_cuda import launch_counts

    return {"launches": launch_counts(),
            "libraries_loaded": _build.load.cache_info().currsize}


# -- doctor ---------------------------------------------------------------------

def _audit_artifacts(paths, force: bool):
    """One record per ``.npz``: payload checksum, generation vs the
    ``latest.json`` pointer, and the risk-state field/stamp schema.
    Returns ``(records, metas)``."""
    from mfm_tpu_torch.data.artifacts import (
        _NW_SCALARS,
        _NW_STACKED,
        ArtifactCorruptError,
        ArtifactStaleError,
        _file_sha256,
        _stamp_from_json,
        load_artifact,
        read_pointer,
    )

    records, metas = [], {}
    for p in paths:
        rec = {"file": p, "status": "ok", "problems": [], "warnings": []}
        records.append(rec)
        try:
            arrays, meta = load_artifact(p, fenced=True, force=force)
        except ArtifactStaleError as err:
            rec["status"] = "stale"
            rec["problems"].append(str(err))
            continue
        except ArtifactCorruptError as err:
            rec["status"] = "corrupt"
            rec["problems"].append(str(err))
            continue
        metas[os.path.basename(p)] = meta
        rec["kind"] = meta.get("kind", "raw")
        rec["arrays"] = len(arrays)
        if meta.get("sha256") is None:
            rec["warnings"].append("no payload checksum (legacy artifact)")
        gen = meta.get("generation")
        entry = read_pointer(p)
        if gen is not None:
            rec["generation"] = gen
        if entry is not None:
            ptr_gen = entry.get("generation")
            rec["pointer_generation"] = ptr_gen
            if isinstance(gen, int) and isinstance(ptr_gen, int) \
                    and gen < ptr_gen:
                rec["warnings"].append(
                    f"generation {gen} older than the pointer ({ptr_gen}) "
                    "— audited past the fence via --force")
            if gen == ptr_gen and isinstance(entry.get("sha256"), str) \
                    and _file_sha256(p) != entry["sha256"]:
                rec["problems"].append(
                    "file hash differs from the latest.json pointer's — "
                    "the live file changed after its pointer swap")
        if meta.get("kind") == "risk_state":
            required = (set(_NW_SCALARS) | set(_NW_STACKED)
                        | {"vr_num", "vr_den"})
            if "eig_draws" in arrays:
                required |= {"eig_draws", "eig_R", "eig_p", "eig_n"}
            else:
                required |= {"sim_covs"}
            missing = sorted(required - set(arrays))
            if missing:
                rec["problems"].append(f"missing state field(s) {missing}")
            guard_keys = sorted(k for k in arrays if k.startswith("guard_"))
            rec["guarded"] = len(guard_keys) == 5
            if guard_keys and len(guard_keys) != 5:
                rec["problems"].append(
                    f"partial guard state {guard_keys} — expected all "
                    "five guard_* leaves or none")
            try:
                stamp = _stamp_from_json(meta["stamp"])
                if not isinstance(stamp, tuple):
                    raise ValueError("stamp is not a tuple")
            except (KeyError, TypeError, ValueError) as err:
                rec["problems"].append(f"unusable config stamp ({err}) — "
                                       "updates would be refused")
            rec["last_date"] = meta.get("last_date")
        if rec["problems"]:
            rec["status"] = "unhealthy" if rec["status"] == "ok" \
                else rec["status"]
    return records, metas


def _audit_run_manifest(mpath: str, metas: dict) -> dict:
    """The run manifest beside the artifacts: schema, health field, and
    stamp-vs-checkpoint identity."""
    from mfm_tpu_torch.obs.manifest import ManifestError, read_run_manifest

    rec = {"file": mpath, "kind": "run_manifest", "status": "ok",
           "problems": [], "warnings": []}
    try:
        man = read_run_manifest(mpath)
    except ManifestError as err:
        rec["status"] = "corrupt"
        rec["problems"].append(str(err))
        return rec
    rec["health"] = man["health"].get("status")
    ckpt = man.get("checkpoint")
    meta = metas.get(ckpt)
    if ckpt and meta is None:
        rec["problems"].append(
            f"manifest names checkpoint {ckpt!r}, which is missing or "
            "failed its own audit")
    elif meta is not None and man.get("config_stamp") != meta.get("stamp"):
        rec["problems"].append(
            "manifest config_stamp does not match the checkpoint's identity "
            "stamp — artifacts from different runs in one directory")
    if rec["health"] == "degraded":
        rec["warnings"].append(
            "model health was degraded at manifest write time (see manifest "
            "health.checks)")
    if rec["problems"]:
        rec["status"] = "unhealthy"
    return rec


def _audit_serve_manifest(man_dir: str, metas: dict) -> dict:
    """The serve summary (``serve_manifest.json``, or a fleet run's merged
    ``fleet_manifest.json``): breaker, shed, cache delivery, trace id and
    SLO burn."""
    from mfm_tpu_torch.obs.manifest import ManifestError, read_run_manifest
    from mfm_tpu_torch.serve.replica import FLEET_MANIFEST_NAME

    spath = os.path.join(man_dir, SERVE_MANIFEST_NAME)
    rec = {"file": spath, "kind": "serve_manifest", "status": "ok",
           "problems": [], "warnings": []}
    fpath = os.path.join(man_dir, FLEET_MANIFEST_NAME)
    if not os.path.exists(spath) and os.path.exists(fpath):
        # a fleet run writes ONE merged manifest — the front end's serve
        # summary lives there, not in serve_manifest.json
        spath = fpath
        rec["file"] = fpath
    if not os.path.exists(spath):
        rec["status"] = "missing"
        rec["problems"].append(
            "no serve_manifest.json beside the artifacts — has `serve` run "
            "against this checkpoint dir?")
        return rec
    try:
        man = read_run_manifest(spath)
    except ManifestError as err:
        rec["status"] = "corrupt"
        rec["problems"].append(str(err))
        return rec
    serve = man.get("serve")
    if not isinstance(serve, dict):
        rec["problems"].append("serve manifest has no 'serve' summary block")
    else:
        for k in ("breaker_state", "breaker_open_total", "shed_total",
                  "shed_rate", "requests_total"):
            rec[k] = serve.get(k)
        if serve.get("breaker_state") == "open":
            rec["problems"].append(
                "circuit breaker was OPEN at shutdown — the service exited "
                "rejecting traffic (see serve.requests outcomes in the "
                "manifest)")
        if serve.get("shed_rate") or serve.get("shed_total"):
            rec["warnings"].append(
                f"load shedding occurred (shed_total="
                f"{serve.get('shed_total')}, shed_rate="
                f"{serve.get('shed_rate')})")
        cb = serve.get("cache")
        if isinstance(cb, dict) and cb.get("delivered_total"):
            # delivery audit: every delivered response was either computed
            # (a recorded outcome) or a cache hit
            rec["cache_hits_total"] = cb.get("hits_total")
            rec["cache_hit_rate"] = cb.get("hit_rate")
            rec["cache_delivered_total"] = cb.get("delivered_total")
            computed = serve.get("requests_total") or 0
            expect = computed + (cb.get("hits_total") or 0)
            if cb["delivered_total"] != expect:
                rec["warnings"].append(
                    "response-cache delivery audit is off: delivered "
                    f"{cb['delivered_total']} != computed {computed} + "
                    f"cache hits {cb.get('hits_total')} — responses "
                    "bypassed or double-counted the cache seat")
        ckpt = man.get("checkpoint")
        if ckpt and ckpt not in metas:
            rec["warnings"].append(
                f"serve manifest names checkpoint {ckpt!r}, which is not "
                "among the audited artifacts")
    if man.get("health", {}).get("status") == "degraded":
        rec["warnings"].append(
            "query service ran with degraded model health (responses were "
            "stamped degraded)")
    if not man.get("trace_id"):
        rec["warnings"].append(
            "serve manifest carries no root trace_id — this run cannot be "
            "joined to its trace (tracing disabled)")
    # SLO burn audit: a fast-burning objective at shutdown is a page-now
    # condition doctor FAILS on; slow burn warns
    slo = serve.get("slo") if isinstance(serve, dict) else None
    if isinstance(slo, dict):
        rec["slo_worst_state"] = slo.get("worst_state")
        for s in slo.get("slos", []):
            if s.get("state") == "fast_burn":
                rec["problems"].append(
                    f"SLO {s.get('name')!r} was FAST-BURNING (burn "
                    f"{s.get('burn_fast')} over the "
                    f"{slo.get('window_fast_s')}s window, threshold "
                    f"{slo.get('fast_burn_threshold')}) — the error budget "
                    "was being spent at page-now rate")
            elif s.get("state") == "slow_burn":
                rec["warnings"].append(
                    f"SLO {s.get('name')!r} was slow-burning (burn "
                    f"{s.get('burn_slow')} over the "
                    f"{slo.get('window_slow_s')}s window)")
    if rec["problems"]:
        rec["status"] = "unhealthy"
    return rec


def _audit_fleet_manifest(fpath: str) -> dict:
    """The merged fleet manifest: per-replica delivered outcomes plus the
    front end's locally-answered ledger must sum to the accepted count,
    and the transport totals must agree with the per-replica counters."""
    from mfm_tpu_torch.obs.manifest import ManifestError, read_run_manifest

    frec = {"file": fpath, "kind": "fleet_manifest", "status": "ok",
            "problems": [], "warnings": []}
    try:
        fman = read_run_manifest(fpath)
    except ManifestError as err:
        frec["status"] = "corrupt"
        frec["problems"].append(str(err))
        return frec
    fm = fman.get("fleet")
    if not isinstance(fm, dict):
        frec["problems"].append("fleet manifest has no 'fleet' merge block")
    else:
        audit = fm.get("audit", {})
        frec["accepted_total"] = audit.get("accepted_total")
        frec["replica_outcomes_sum"] = audit.get("replica_outcomes_sum")
        frec["frontend_local_total"] = audit.get("frontend_local_total")
        delivered = audit.get("delivered_total",
                              audit.get("replica_outcomes_sum"))
        frec["delivered_total"] = delivered
        if not audit.get("consistent"):
            frec["problems"].append(
                "delivered outcome counts (replicas + frontend-local = "
                f"{delivered}) do not sum to the front end's accepted count "
                f"({audit.get('accepted_total')}) — responses were lost "
                "between dispatch and delivery")
        redisp = 0
        for rep in fm.get("replicas", []):
            if rep.get("lost"):
                frec["warnings"].append(
                    f"replica {rep.get('replica')} was lost (exit "
                    f"{rep.get('exit_code')}) — its in-flight batch "
                    "re-dispatched to survivors")
            if rep.get("wedged"):
                frec["warnings"].append(
                    f"replica {rep.get('replica')} wedged (deadline/"
                    "heartbeat expiry with the process still alive) — "
                    "quarantined and its in-flight batch re-dispatched")
            elif rep.get("quarantined"):
                frec["warnings"].append(
                    f"replica {rep.get('replica')} was quarantined after "
                    "failing its fence audit")
            tp = rep.get("transport")
            if isinstance(tp, dict):
                redisp += int(tp.get("redispatches", 0) or 0)
                neg = sorted(k for k, v in tp.items()
                             if isinstance(v, int) and v < 0)
                if neg:
                    frec["problems"].append(
                        f"replica {rep.get('replica')} transport counters "
                        f"went negative ({', '.join(neg)}) — the counter "
                        "plumbing is corrupt")
                if tp.get("heartbeat_misses"):
                    frec["warnings"].append(
                        f"replica {rep.get('replica')} missed "
                        f"{tp['heartbeat_misses']} heartbeat(s)")
        tr = fm.get("transport")
        if isinstance(tr, dict):
            frec["transport"] = tr
            if int(tr.get("redispatches", 0) or 0) != redisp:
                frec["problems"].append(
                    "fleet transport totals disagree with per-replica "
                    f"counters (redispatches {tr.get('redispatches')} != "
                    f"{redisp})")
    if frec["problems"]:
        frec["status"] = "unhealthy"
    return frec


def _audit_flightrec(fr_path: str) -> dict:
    """A flight-recorder dump beside the artifacts: the run hit a
    postmortem trigger (a warning); a torn dump is a failure."""
    from mfm_tpu_torch.obs.flightrec import read_flightrec

    rec = {"file": fr_path, "kind": "flightrec", "status": "ok",
           "problems": [], "warnings": []}
    try:
        dump = read_flightrec(fr_path)
    except (ValueError, OSError) as err:
        rec["status"] = "corrupt"
        rec["problems"].append(str(err))
        return rec
    rec["trigger"] = dump.get("trigger")
    rec["trace_id"] = dump.get("trace_id")
    rec["events"] = len(dump.get("events", []))
    rec["spans"] = len(dump.get("spans", []))
    rec["warnings"].append(
        f"flight-recorder dump present (trigger={dump.get('trigger')!r}, "
        f"trace_id={dump.get('trace_id')!r}) — the serve run hit a "
        "postmortem trigger; inspect the bundled events/spans/metrics")
    return rec


def _audit_scenario_manifests(man_dir: str) -> list:
    """``--scenarios``: the scenario manifest beside the artifacts (a torn
    write, an embedded spec whose recomputed hash disagrees with the
    recorded one, or inconsistent counts all mean the last stress run
    cannot be trusted), and the sweep manifest when one is there."""
    from mfm_tpu_torch.scenario.manifest import (
        ScenarioManifestError,
        audit_scenario_manifest,
        read_scenario_manifest,
        scenario_manifest_path_for,
    )
    from mfm_tpu_torch.scenario.sweep import (
        SweepManifestError,
        audit_sweep_manifest,
        read_sweep_manifest,
        sweep_manifest_path_for,
    )

    no_trace = ("manifest carries no root trace_id — this run cannot be "
                "joined to its trace (pre-tracing build, or tracing "
                "disabled)")
    scpath = scenario_manifest_path_for(man_dir)
    swpath = sweep_manifest_path_for(man_dir)
    rec = {"file": scpath, "kind": "scenario_manifest", "status": "ok",
           "problems": [], "warnings": []}
    records = [rec]
    if not os.path.exists(scpath):
        if os.path.exists(swpath):
            # a sweep ran here but no preset drill did — fine for the
            # artifacts, just worth flagging
            rec["warnings"].append(
                "no scenario_manifest.json beside the artifacts (only a "
                "sweep manifest) — run `mfm-tpu scenario run` for the "
                "preset drill record")
        else:
            rec["status"] = "missing"
            rec["problems"].append(
                "no scenario_manifest.json beside the artifacts — has "
                "`mfm-tpu scenario run` run against this checkpoint dir?")
    else:
        try:
            problems, warnings = audit_scenario_manifest(scpath)
        except ScenarioManifestError as err:
            rec["status"] = "corrupt"
            rec["problems"].append(str(err))
        else:
            rec["problems"].extend(problems)
            rec["warnings"].extend(warnings)
            summary = read_scenario_manifest(scpath).get("summary") or {}
            if not summary.get("trace_id"):
                rec["warnings"].append("scenario " + no_trace)
            if rec["problems"]:
                rec["status"] = "unhealthy"
    # sweep manifests are optional — audit one only when present, so
    # checkpoints that never ran a sweep stay green
    if os.path.exists(swpath):
        swrec = {"file": swpath, "kind": "sweep_manifest", "status": "ok",
                 "problems": [], "warnings": []}
        records.append(swrec)
        try:
            problems, warnings = audit_sweep_manifest(swpath)
        except SweepManifestError as err:
            swrec["status"] = "corrupt"
            swrec["problems"].append(str(err))
        else:
            swrec["problems"].extend(problems)
            swrec["warnings"].extend(warnings)
            summary = read_sweep_manifest(swpath).get("summary") or {}
            if not summary.get("trace_id"):
                swrec["warnings"].append("sweep " + no_trace)
            if swrec["problems"]:
                swrec["status"] = "unhealthy"
    return records


def _doctor(args):
    """Audit a serving state directory (or one artifact): payload
    checksums, fencing generation vs ``latest.json``, the risk-state
    field/stamp schema and the run manifest; with ``--serve`` the serve
    and fleet manifests and flight-recorder dumps beside them, with
    ``--scenarios`` the scenario and sweep manifests.  Prints one
    JSON record per file and exits non-zero when anything is corrupt,
    stale, schema-broken or unhealthy.  ``--audit`` verifies the
    committed IR-audit snapshot and ``--sync`` runs the lock-discipline
    pass; neither needs PATH."""
    import glob

    if args.path is None:
        if not (args.sync or args.audit):
            raise SystemExit("doctor: PATH is required unless --audit or "
                             "--sync is given (the static checks need no "
                             "serving artifacts)")
        records = _static_records(args)
        unhealthy = sum(r["status"] != "ok" for r in records)
        print(json.dumps({"audited": len(records), "unhealthy": unhealthy,
                          "records": records}, indent=1))
        raise SystemExit(1 if unhealthy else 0)
    if os.path.isdir(args.path):
        paths = sorted(glob.glob(os.path.join(args.path, "*.npz")))
        if not paths:
            raise SystemExit(f"{args.path}: no .npz artifacts to audit")
        man_dir = args.path
    elif os.path.exists(args.path):
        paths = [args.path]
        man_dir = os.path.dirname(args.path) or "."
    else:
        raise SystemExit(f"{args.path}: not found")

    records, metas = _audit_artifacts(paths, args.force)
    mpath = os.path.join(man_dir, "run_manifest.json")
    if os.path.exists(mpath):
        records.append(_audit_run_manifest(mpath, metas))
    if args.serve:
        from mfm_tpu_torch.serve.replica import FLEET_MANIFEST_NAME

        records.append(_audit_serve_manifest(man_dir, metas))
        fpath = os.path.join(man_dir, FLEET_MANIFEST_NAME)
        if os.path.exists(fpath):
            records.append(_audit_fleet_manifest(fpath))
        for fr_path in sorted(glob.glob(
                os.path.join(man_dir, "flightrec*.json"))):
            records.append(_audit_flightrec(fr_path))
    if args.scenarios:
        records.extend(_audit_scenario_manifests(man_dir))
    records.extend(_static_records(args))
    unhealthy = sum(r["status"] != "ok" for r in records)
    print(json.dumps({"audited": len(records), "unhealthy": unhealthy,
                      "records": records}, indent=1))
    raise SystemExit(1 if unhealthy else 0)


def _static_records(args) -> list:
    """The records of ``--audit`` and ``--sync``, which need no PATH."""
    records = []
    if args.audit:
        records.append(_audit_snapshot(args.audit))
    if args.sync:
        records.extend(_audit_sync())
    return records


def _audit_snapshot(apath: str) -> dict:
    """``doctor --audit [PATH]``: verify the committed IR-audit snapshot
    (default the newest ``mfm_tpu_torch/tools/AUDIT_r*.json``) — torn
    writes, broken seals, a run that was not strict-clean, measurements
    that disagree with the budget file and cells that disagree with the
    live registry are problems; another torch is a warning."""
    from mfm_tpu_torch.analysis.run import (
        latest_snapshot_path,
        verify_snapshot,
    )

    if apath == "latest":
        apath = latest_snapshot_path()
    rec = {"file": apath, "kind": "audit_snapshot", "status": "ok",
           "problems": [], "warnings": []}
    if apath is None:
        rec.update(file="mfm_tpu_torch/tools/AUDIT_r*.json",
                   status="missing")
        rec["problems"].append(
            "no committed AUDIT_r*.json snapshot — run `audit "
            "--write-budgets --json mfm_tpu_torch/tools/AUDIT_r01.json` "
            "on the card and commit it")
        return rec
    problems, warns, doc = verify_snapshot(apath)
    rec["problems"].extend(problems)
    rec["warnings"].extend(warns)
    if doc is None:
        rec["status"] = "corrupt"
        return rec
    if isinstance(doc, dict):
        rec["strict_clean"] = doc.get("strict_clean")
        rec["summary"] = doc.get("summary")
    if rec["problems"]:
        rec["status"] = "unhealthy"
    return rec


def _audit_sync() -> list:
    """``doctor --sync``: the lock-discipline pass, strict against its
    committed baseline — new findings are problems, a stale baseline entry
    is a problem too (the justified exception no longer exists), baselined
    findings are warnings so the operator sees what is being excused."""
    from mfm_tpu_torch.analysis.sync import (
        DEFAULT_BASELINE,
        REPO_ROOT,
        load_baseline,
        run_sync,
    )

    bpath = os.path.join(REPO_ROOT, DEFAULT_BASELINE)
    rec = {"file": bpath, "kind": "sync_analysis", "status": "ok",
           "problems": [], "warnings": []}
    res = run_sync(baseline=load_baseline(bpath))
    for v in res.new:
        rec["problems"].append(
            f"{v.file}:{v.line}: {v.rule} [{v.qualname}] {v.message}")
    for b in res.stale:
        rec["problems"].append(
            f"stale baseline entry: {b['file']} {b['rule']} "
            f"[{b['qualname']}] — the finding no longer exists")
    for v in res.baselined:
        rec["warnings"].append(
            f"baselined: {v.file} {v.rule} [{v.qualname}]")
    rec["baselined"] = len(res.baselined)
    if rec["problems"]:
        rec["status"] = "unhealthy"
    return [rec]


def _gate_cmd(main_fn, args):
    """``lint`` / ``sync``: the stdlib-only pass's own CLI, with the
    subcommand's flags passed on."""
    argv = list(args.paths)
    if args.baseline:
        argv += ["--baseline", args.baseline]
    if args.strict:
        argv.append("--strict")
    if args.json:
        argv.append("--json")
    raise SystemExit(main_fn(argv))


def _lint_cmd(args):
    # pure-AST pass (mfm_tpu_torch/lint.py): no torch, no numpy
    from mfm_tpu_torch.lint import main as lint_main

    _gate_cmd(lint_main, args)


def _audit_cmd(args):
    # the IR audit (mfm_tpu_torch/analysis/run.py): every registered entry
    # point run once under probes; the mesh cells run on
    # MFM_TORCH_VIRTUAL_DEVICES=8 when the variable is unset
    from mfm_tpu_torch.analysis.run import main as audit_main

    argv = ["--device", args.device]
    for flag, value in (("--passes", args.passes),
                        ("--baseline", args.baseline),
                        ("--budgets", args.budgets), ("--json", args.json)):
        if value:
            argv += [flag, value]
    if args.write_budgets:
        argv.append("--write-budgets")
    if args.strict:
        argv.append("--strict")
    raise SystemExit(audit_main(argv))


def _sync_cmd(args):
    # stdlib-only AST pass (mfm_tpu_torch/analysis/sync.py): lock
    # discipline and shared state in the serving fleet
    from mfm_tpu_torch.analysis.sync import main as sync_main

    _gate_cmd(sync_main, args)


# -- serve ----------------------------------------------------------------------

def _serve(args):
    """Batched portfolio-query service over a guarded risk-state checkpoint:
    JSONL requests in (stdin or --input), JSONL responses out, with request
    guards + dead-letter quarantine, bounded-queue admission control with
    oldest-first load shedding, per-request deadlines, degraded-serving
    stamps (staleness + health verdict), and a circuit breaker.  At
    shutdown the serve summary is written to ``serve_manifest.json``
    beside the checkpoint (``fleet_manifest.json`` for a fleet,
    ``serve_manifest.r{i}.json`` for a worker), which ``doctor --serve``
    audits."""
    import sys

    from mfm_tpu_torch._device import resolve_device
    from mfm_tpu_torch.data.artifacts import (
        ArtifactCorruptError,
        ArtifactStaleError,
        load_risk_state,
        read_pointer,
    )
    from mfm_tpu_torch.data.etl import with_retry
    from mfm_tpu_torch.obs.instrument import guard_summary_from_registry
    from mfm_tpu_torch.obs.manifest import (
        ManifestError,
        build_run_manifest,
        device_name,
        manifest_path_for,
        read_run_manifest,
        write_run_manifest,
    )
    from mfm_tpu_torch.obs.metrics import REGISTRY
    from mfm_tpu_torch.obs.trace import end_span
    from mfm_tpu_torch.serve.cache import ResponseCache, WarmStartIndex
    from mfm_tpu_torch.serve.query import QueryEngine
    from mfm_tpu_torch.serve.server import QueryServer, ServePolicy

    # the card unless the caller asked for the CPU; raises without a card
    device = resolve_device(args.device)
    _metrics_init(args)
    root = _root_span(args, nest=False)
    state_path = args.state

    def _dead_letter_startup(rec: dict) -> None:
        if not args.dead_letter:
            return
        rec = dict(rec)
        rec.setdefault("kind", "startup_failure")
        with open(args.dead_letter, "a", encoding="utf-8") as fh:
            fh.write(json.dumps(rec, sort_keys=True) + "\n")

    def _load():
        return load_risk_state(state_path, device=device)

    try:
        state, meta = with_retry(_load, attempts=args.load_attempts,
                                 backoff_s=args.load_backoff_s,
                                 retryable=(OSError,))
    except (ArtifactCorruptError, ArtifactStaleError) as e:
        # fence audit failed before the loop even started: nothing to
        # serve degraded FROM, so refuse outright
        raise SystemExit(f"serve: checkpoint failed its fence audit: {e}")
    except OSError as e:
        # the retry history rides into the dead letter so the operator can
        # tell "failed instantly" from "fought the outage"
        _dead_letter_startup({
            "path": state_path, "error": str(e),
            "attempts": getattr(e, "attempts", 1),
            "total_backoff_s": round(getattr(e, "total_backoff_s", 0.0), 3)})
        raise SystemExit(f"serve: cannot load {state_path}: {e}")

    benchmarks = None
    if args.benchmarks:
        with open(args.benchmarks, encoding="utf-8") as fh:
            benchmarks = {str(k): v for k, v in json.load(fh).items()}

    def _health_beside() -> str:
        mpath = manifest_path_for(state_path)
        if not os.path.exists(mpath):
            return "unknown"
        try:
            return read_run_manifest(mpath)["health"].get("status",
                                                          "unknown")
        except ManifestError:
            return "unknown"

    try:
        engine = QueryEngine.from_risk_state(state, meta,
                                             benchmarks=benchmarks,
                                             device=device)
    except ValueError as e:
        raise SystemExit(f"serve: {e}")

    policy = ServePolicy(
        queue_max=args.queue_max, batch_max=args.batch_max,
        default_deadline_s=args.deadline_s,
        breaker_failures=args.breaker_failures,
        breaker_cooldown_s=args.breaker_cooldown_s,
        weight_mad_k=args.weight_mad_k,
        fsync_emits=args.fsync_emits)

    def _scenario_hashes_beside() -> dict | None:
        # the cache fences scenario-tagged requests on the served spec
        # hash; absent manifest -> name-keyed fallback inside the cache
        from mfm_tpu_torch.scenario.manifest import (
            ScenarioManifestError,
            read_scenario_manifest,
            scenario_manifest_path_for,
        )
        try:
            m = read_scenario_manifest(scenario_manifest_path_for(
                os.path.dirname(state_path) or "."))
        except (ScenarioManifestError, OSError):
            return None
        return {str(e.get("name")): str(e.get("spec_hash"))
                for e in m.get("scenarios", []) if e.get("spec_hash")}

    cache = None
    if not (args.no_cache or args.worker):
        cache = ResponseCache(
            args.cache_entries, args.cache_bytes,
            generation=int((meta or {}).get("generation") or 0),
            scenario_hashes=_scenario_hashes_beside())
    warm_index = (WarmStartIndex(tol=args.warm_tol)
                  if args.warm_tol > 0 else None)

    reload_fn = None
    if args.watch or args.rollout or args.hold_fence:
        # --rollout implies watching: the front end needs the reload hook
        # to move its admission engine + cache fence once the fleet
        # agrees.  --hold-fence implies it too — that flag's one job is
        # "re-fence on the front end's reload frame", which is this hook
        seen = {"gen": (read_pointer(state_path) or {}).get("generation")}

        def reload_fn():
            gen = (read_pointer(state_path) or {}).get("generation")
            if gen == seen["gen"]:
                return None
            # fence-audit failures propagate (the server force-opens the
            # breaker); transient IO keeps the old engine serving
            try:
                st, mt = with_retry(_load, attempts=2, backoff_s=0.05,
                                    retryable=(OSError,))
            except OSError as e:
                print(f"serve: reload failed after "
                      f"{getattr(e, 'attempts', 1)} attempts "
                      f"({getattr(e, 'total_backoff_s', 0.0):.3f}s backoff)"
                      f": {e} — still serving the previous engine",
                      file=sys.stderr)
                return None
            seen["gen"] = gen
            if cache is not None:
                # bump the fence BEFORE the engine swap lands: stale
                # entries become unreachable, no sweep needed
                cache.set_fence(
                    generation=int(gen or 0),
                    scenario_hashes=_scenario_hashes_beside())
            return {"engine": QueryEngine.from_risk_state(
                        st, mt, benchmarks=benchmarks, device=device),
                    "health": _health_beside(),
                    "generation": int(gen or 0)}

    server = QueryServer(engine, policy, health=_health_beside(),
                         dead_letter_path=args.dead_letter,
                         reload_fn=reload_fn, warm_index=warm_index)
    # generation stamp for the rolling-rollout agreement protocol (a
    # worker reports it in its "reloaded" frame)
    server.generation = int((meta or {}).get("generation") or 0)
    man_dir = os.path.dirname(state_path) or "."

    # SLO engine + flight recorder: every serve process evaluates its own
    # burn rates at scrape time, and triggered postmortem dumps land
    # beside the checkpoint — workers get per-replica shard names so a
    # fleet on one host never races the front end's dump
    from mfm_tpu_torch.obs import flightrec as _frec
    from mfm_tpu_torch.obs import slo as _slo
    _slo.install(_slo.SloEngine())
    frec_name = (f"flightrec.r{args.worker_id}.json" if args.worker
                 else _frec.FLIGHTREC_NAME)
    _frec.arm(os.path.join(man_dir, frec_name))

    def _finish(summary: dict, manifest_name: str, extra: dict) -> None:
        manifest = build_run_manifest(
            stamp_json=meta.get("stamp"),
            checkpoint=state_path,
            backend=device_name(device),
            metrics_snapshot=REGISTRY.snapshot(),
            guard_summary=guard_summary_from_registry(),
            health={"status": server.health, "checks": {}},
            extra=dict(extra, serve=summary, trace_id=root.trace_id,
                       kernels=_kernel_block()),
        )
        spath = os.path.join(man_dir, manifest_name)
        write_run_manifest(spath, manifest)
        end_span(root)
        _metrics_flush(args)
        print(json.dumps({"serve": summary, "manifest": spath,
                          "trace_id": root.trace_id},
                         indent=1), file=sys.stderr)

    if args.worker:
        # fleet worker: admitted lines in, seq envelopes out (the wire
        # protocol in serve/replica.py); manifest shard beside the
        # checkpoint for the front end's merge.  With --listen the same
        # loop runs over ONE accepted TCP connection instead of stdin —
        # the multi-host worker a front end attaches to with --workers
        from mfm_tpu_torch.serve.replica import (
            WORKER_MANIFEST_FMT,
            run_worker,
        )

        if args.listen:
            from mfm_tpu_torch.serve.transport import serve_worker_socket

            host, _, port = args.listen.rpartition(":")

            def announce(addr):
                print(json.dumps({
                    "worker_listening": f"{addr[0]}:{addr[1]}",
                    "worker_id": args.worker_id}),
                    file=sys.stderr, flush=True)

            summary = serve_worker_socket(
                server, host or "127.0.0.1", int(port or 0),
                announce=announce, poll_on_flush=not args.hold_fence)
        else:
            summary = run_worker(server, sys.stdin, sys.stdout,
                                 poll_on_flush=not args.hold_fence)
        _finish(summary, WORKER_MANIFEST_FMT.format(idx=args.worker_id),
                {"worker_id": args.worker_id})
        return

    if args.replicas or args.listen or args.workers:
        _serve_fleet(args, server, state_path, man_dir, _finish,
                     cache=cache)
        return

    in_fp = (sys.stdin if args.input in (None, "-")
             else open(args.input, encoding="utf-8"))
    out_fp = (sys.stdout if args.output in (None, "-")
              else open(args.output, "w", encoding="utf-8"))
    try:
        summary = server.run(in_fp, out_fp, gulp=args.gulp, cache=cache)
    finally:
        if in_fp is not sys.stdin:
            in_fp.close()
        if out_fp is not sys.stdout:
            out_fp.close()
    _finish(summary, SERVE_MANIFEST_NAME, {})


def _serve_fleet(args, server, state_path, man_dir, _finish,
                 cache=None) -> None:
    """The fleet/coalescing serve paths: ``--replicas N`` dispatches
    batches to spawned worker subprocesses (each its own process and CUDA
    context on ``--device``), ``--workers host:port,...`` attaches to
    already-running TCP workers on any host (both may mix), ``--listen``
    accepts concurrent socket (or ``--http``) connections; each alone also
    works — ``--replicas`` over stdin is the deterministic drill mode, and
    ``--listen`` without workers coalesces into the local engine."""
    import signal
    import sys
    import threading

    from mfm_tpu_torch.data.artifacts import read_pointer
    from mfm_tpu_torch.obs.instrument import fleet_summary_from_registry
    from mfm_tpu_torch.serve.coalesce import Coalescer
    from mfm_tpu_torch.serve.frontend import SocketFrontend
    from mfm_tpu_torch.serve.replica import (
        FLEET_MANIFEST_NAME,
        FleetServer,
        Replica,
        build_fleet_manifest,
        replica_env,
        worker_cmd,
    )

    fleet = None
    replicas = []
    if args.replicas:
        policy_args = [
            "--queue-max", str(args.queue_max),
            "--batch-max", str(args.batch_max),
            "--deadline-s", str(args.deadline_s),
            "--breaker-failures", str(args.breaker_failures),
            "--breaker-cooldown-s", str(args.breaker_cooldown_s),
            "--weight-mad-k", str(args.weight_mad_k),
            "--warm-tol", str(args.warm_tol)]
        if args.benchmarks:
            policy_args += ["--benchmarks", args.benchmarks]
        if args.watch or args.rollout:
            policy_args += ["--watch"]
        if args.rollout:
            # rollout workers must NOT self-poll: generations move one
            # worker at a time on the front end's reload frames
            policy_args += ["--hold-fence"]
        if args.fsync_emits:
            policy_args += ["--fsync-emits"]
        # fork+exec (subprocess), never a fork of this process: it may
        # hold a CUDA context already
        replicas = [
            Replica(i, worker_cmd(state_path, worker_id=i,
                                  policy_args=policy_args,
                                  device=args.device),
                    env=replica_env(i),
                    io_timeout_s=args.worker_timeout_s)
            for i in range(args.replicas)]
    if args.workers:
        base = len(replicas)
        for j, spec in enumerate(p.strip() for p in args.workers.split(",")
                                 if p.strip()):
            whost, _, wport = spec.rpartition(":")
            try:
                replicas.append(Replica.connect(
                    base + j, (whost or "127.0.0.1", int(wport)),
                    io_timeout_s=args.worker_timeout_s,
                    attempts=args.connect_attempts,
                    backoff_s=args.connect_backoff_s))
            except OSError as e:
                raise SystemExit(
                    f"serve: cannot attach worker {spec}: {e} "
                    f"(phase={getattr(e, 'phase', 'connect')}, "
                    f"attempts={getattr(e, 'attempts', 1)}, "
                    f"backoff={getattr(e, 'total_backoff_s', 0.0):.3f}s)")

    def make_backend(deliver=None):
        if replicas:
            rollout_check = None
            if args.rollout:
                def rollout_check():
                    return (read_pointer(state_path)
                            or {}).get("generation")
            return FleetServer(server, replicas, linger_s=args.linger_s,
                               deliver=deliver, cache=cache,
                               heartbeat_s=args.heartbeat_s,
                               heartbeat_timeout_s=args.heartbeat_timeout_s,
                               rollout_check=rollout_check)
        return Coalescer(server, linger_s=args.linger_s, deliver=deliver,
                         cache=cache)

    if args.listen:
        host, _, port = args.listen.rpartition(":")
        fe = SocketFrontend(host or "127.0.0.1", int(port or 0),
                            http=args.http)
        backend = make_backend(deliver=fe.deliver)
        fe.backend = backend
        fleet = backend if replicas else None
        addr = fe.listen()
        print(json.dumps({"listening": f"{addr[0]}:{addr[1]}",
                          "replicas": len(replicas),
                          "http": bool(args.http)}),
              file=sys.stderr, flush=True)

        def _on_term(*_):
            # the operator's kill is a postmortem trigger too: dump the
            # flight recorder BEFORE the drain so the bundle shows what
            # was in flight when the signal landed
            from mfm_tpu_torch.obs import flightrec as _frec
            state = (backend._flightrec_state()
                     if hasattr(backend, "_flightrec_state") else None)
            _frec.trigger_dump("sigterm", state=state)
            fe.stop()

        # signal handlers can only be installed from the main thread (an
        # embedding caller on another thread stops the listener itself)
        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGINT, signal.SIGTERM):
                signal.signal(sig, _on_term)
        fe.serve(backend)   # blocks until stop(); drains the backend
    else:
        backend = make_backend()
        fleet = backend if replicas else None
        in_fp = (sys.stdin if args.input in (None, "-")
                 else open(args.input, encoding="utf-8"))
        out_fp = (sys.stdout if args.output in (None, "-")
                  else open(args.output, "w", encoding="utf-8"))

        def emit(pairs):
            for _origin, resp in pairs:
                out_fp.write(json.dumps(resp, sort_keys=True) + "\n")
            if pairs:
                out_fp.flush()
                if server.policy.fsync_emits:
                    try:
                        os.fsync(out_fp.fileno())
                    except (OSError, ValueError):
                        pass
        try:
            for line in in_fp:
                line = line.strip()
                if not line:
                    continue
                emit(backend.submit(line))
            emit(backend.stop())
        finally:
            if in_fp is not sys.stdin:
                in_fp.close()
            if out_fp is not sys.stdout:
                out_fp.close()

    summary = fleet_summary_from_registry()
    if fleet is not None:
        fleet.close_replicas()
        fm = build_fleet_manifest(summary, fleet, man_dir)
        _finish(summary, FLEET_MANIFEST_NAME, {"fleet": fm})
    else:
        _finish(summary, SERVE_MANIFEST_NAME, {})


# -- shared helpers of the compute subcommands ---------------------------------

def _parse_mesh_arg(spec, device):
    """``--mesh DxS`` -> a ('date', 'stock') mesh over the first D*S of
    the devices a mesh may draw on, or None.  The risk paths then compute
    sharded: panels shard-local, state replicated.  Too few devices
    refuse, naming the virtual-device variable."""
    if not spec:
        return None
    from mfm_tpu_torch._device import VIRTUAL_DEVICES_ENV, mesh_devices
    from mfm_tpu_torch.parallel.mesh import make_mesh

    d, _, s = str(spec).lower().partition("x")
    try:
        nd, ns = int(d), int(s) if s else 1
    except ValueError:
        raise SystemExit(f"--mesh: want DATExSTOCK (e.g. 2x4), got {spec!r}")
    devs = mesh_devices(device)
    need = nd * ns
    if need > len(devs):
        raise SystemExit(
            f"--mesh {spec}: needs {need} devices but only {len(devs)} are "
            f"up — set {VIRTUAL_DEVICES_ENV}={need} before launch for a "
            "virtual mesh")
    return make_mesh(nd, ns, devices=devs[:need])


@contextlib.contextmanager
def _profile_ctx(profile_dir, device):
    """``torch.profiler`` capture of the block into ``profile_dir`` — a
    Chrome trace (``trace.json``, Perfetto-viewable) and
    ``profile_summary.json`` (wall, summed device kernel time, their
    ratio, peak device memory) — or a no-op when no dir was asked for
    (shared by every ``--profile`` flag).  On the card it records the
    device's activity only: tracing the host's ~80,000 launches of a risk
    run as well costs tens of seconds."""
    if not profile_dir:
        yield
        return
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]
    os.makedirs(profile_dir, exist_ok=True)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        yield
        if cuda:
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    rows = [e for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    with open(os.path.join(profile_dir, "profile_summary.json"), "w") as fh:
        json.dump({"device": str(device), "wall_s": wall,
                   "device_s": busy if rows else None,
                   "busy_share": busy / wall if rows else None,
                   "device_kernels": sum(e.count for e in rows),
                   "peak_memory_bytes": (torch.cuda.max_memory_allocated(
                       device) if cuda else None)}, fh, indent=1)


def _require_matplotlib(flag: str):
    """Fail fast with the install hint instead of an ImportError traceback
    (shared by every plotting flag)."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as err:
        raise SystemExit(f"{flag} needs matplotlib "
                         "(pip install 'mfm-tpu[plot]')") from err


def _read_factor_table(path: str, date_col: str) -> dict:
    """``crosscheck``'s side: a csv (pandas-free) or a parquet file
    (through pandas), with the date column as datetime64 whatever it was
    stored as — int yyyymmdd, ISO strings or datetimes — so a csv side
    and a parquet side align."""
    if path.endswith(".parquet"):
        import pandas as pd

        from mfm_tpu_torch.data.columns import as_table

        table = as_table(pd.read_parquet(path))
    else:
        from mfm_tpu_torch.data.csvio import read_csv

        table = read_csv(path)
    if date_col in table:
        table[date_col] = _as_dates(table[date_col])
    return table


def _crosscheck(args):
    import sys

    from mfm_tpu_torch.utils.crosscheck import crosscheck_factors

    rep = crosscheck_factors(
        _read_factor_table(args.ours, args.date_col),
        _read_factor_table(args.external, args.date_col),
        factors=([f.strip() for f in args.factors.split(",")]
                 if args.factors else None),
        date_col=args.date_col, code_col=args.code_col,
    )
    if args.out:
        rep.to_csv(args.out)
    print(rep.to_json())
    if args.gate is not None:
        # CI-style agreement gate: a factor whose max |diff| over the
        # overlap exceeds the gate, or that has no overlap at all, fails the
        # run with a named verdict on stderr; so does a comparison of
        # nothing (no shared numeric factor column)
        if not len(rep):
            print("GATE FAIL: no shared numeric factor columns to compare",
                  file=sys.stderr)
            raise SystemExit(1)
        bad = [(name, row) for name, row in rep.rows.items()
               if row["n_overlap"] == 0
               or not row["max_abs_diff"] <= args.gate]
        if bad:
            for name, row in bad:
                print(f"GATE FAIL {name}: n_overlap={int(row['n_overlap'])} "
                      f"max_abs_diff={row['max_abs_diff']!r} > {args.gate}",
                      file=sys.stderr)
            raise SystemExit(1)


def _report(args):
    """Model-health report over a risk run's results directory: a JSON
    summary and, with --plot, a small-multiples PNG."""
    from mfm_tpu_torch.utils.report import (
        load_results,
        model_health_summary,
        plot_model_health,
    )

    if args.plot:
        _require_matplotlib("--plot")  # before any loading/summary work
    res = load_results(args.results)
    summary = model_health_summary(args.results, roll_window=args.roll_window,
                                   res=res)
    if args.plot:
        plot_model_health(args.results, os.path.join(args.results, args.plot),
                          top_k=args.top_k, roll_window=args.roll_window,
                          res=res)
        summary["plot"] = os.path.join(args.results, args.plot)
    if args.json:
        with open(os.path.join(args.results, args.json), "w") as fh:
            json.dump(summary, fh, indent=1)
    print(json.dumps(summary))


def _report_parsers(sub) -> None:
    c = sub.add_parser("crosscheck",
                       help="compare factor tables vs an external source "
                            "(beta.ipynb jqdatasdk check, generalized)")
    c.add_argument("--ours", required=True)
    c.add_argument("--external", required=True)
    c.add_argument("--factors", default=None, help="comma list; default: "
                   "all shared numeric columns")
    c.add_argument("--date-col", default="trade_date")
    c.add_argument("--code-col", default="ts_code")
    c.add_argument("--out", default=None, help="write report CSV here")
    c.add_argument("--gate", type=float, default=None, metavar="TOL",
                   help="exit 1 if any factor's max |diff| over the overlap "
                        "exceeds TOL or has no overlap (CI parity gate)")
    c.set_defaults(fn=_crosscheck)

    rp = sub.add_parser("report",
                        help="model-health summary + plots over a risk-run "
                             "results dir (the notebooks' QC eyeballing, "
                             "as one command)")
    rp.add_argument("--results", required=True,
                    help="directory a risk/pipeline run wrote its tables to")
    rp.add_argument("--plot", default=None, metavar="FILE.png",
                    help="render the 2x2 health plot into RESULTS "
                         "(needs matplotlib)")
    rp.add_argument("--json", default=None, metavar="FILE.json",
                    help="also write the summary JSON into RESULTS")
    rp.add_argument("--top-k", type=int, default=6,
                    help="factors direct-labelled in the cumulative panel")
    rp.add_argument("--roll-window", type=int, default=63,
                    help="rolling window (days) for the R² mean")
    rp.set_defaults(fn=_report)


def _maybe_portfolio_bias(res, args) -> None:
    """Run the USE4 random-portfolio acceptance test and write
    ``OUT/portfolio_bias.json`` when ``--portfolio-bias Q`` was given."""
    if not args.portfolio_bias:
        return
    rep = res.portfolio_bias(n_portfolios=args.portfolio_bias,
                             burn_in=args.bias_burn_in)
    with open(os.path.join(args.out, "portfolio_bias.json"), "w") as fh:
        json.dump(rep, fh, indent=1)


def _maybe_portfolio_risk(res, args) -> None:
    """Predicted portfolio risk + per-factor Euler attribution for a
    ``ts_code,weight`` csv, written to ``OUT/portfolio_risk.json`` when
    ``--portfolio FILE`` was given.

    Unknown ts_codes in the file are an error (a silent drop would change
    the portfolio); universe stocks absent from the file get weight 0."""
    if not args.portfolio:
        return
    import numpy as np

    from mfm_tpu_torch.data.csvio import read_csv

    pf = read_csv(args.portfolio)
    missing = {"ts_code", "weight"} - set(pf)
    if missing:
        raise SystemExit(f"--portfolio file lacks columns {sorted(missing)}")
    stocks = np.asarray(res.arrays.stocks).tolist()
    codes = pf["ts_code"].tolist()
    unknown = sorted(set(codes) - set(stocks))
    if unknown:
        raise SystemExit(f"--portfolio has ts_codes outside the panel: "
                         f"{unknown[:5]}{'...' if len(unknown) > 5 else ''}")
    seen, dup = set(), []
    for c in codes:
        if c in seen:
            dup.append(c)
        seen.add(c)
    if dup:
        # one weight per stock: collapsing repeated rows would compute
        # risk for a different portfolio
        raise SystemExit(f"--portfolio lists ts_codes more than once: "
                         f"{sorted(set(dup))[:5]}")
    pos = {s: i for i, s in enumerate(stocks)}
    w = np.zeros(len(stocks))
    w[[pos[c] for c in codes]] = np.asarray(pf["weight"], float)
    rep = res._portfolio_risk(w, args.portfolio_date, None, 42.0, 10, 1.0,
                              10)
    names = res.arrays.factor_names()
    rep = {k: ({n: float(x) for n, x in zip(names, v)}
               if isinstance(v, np.ndarray)
               else v if not isinstance(v, np.generic) else v.item())
           for k, v in rep.items()}
    rep["date"] = str(rep["date"])
    with open(os.path.join(args.out, "portfolio_risk.json"), "w") as fh:
        json.dump(rep, fh, indent=1)


def _save_outputs_npz(res, out: str, source) -> None:
    """Persist every stage output (incl. the full covariance series) as one
    identity-stamped artifact, the reference's schema (load with
    ``load_risk_outputs``)."""
    from mfm_tpu_torch.data.artifacts import save_risk_outputs
    from mfm_tpu_torch.pipeline import date_stamp

    save_risk_outputs(
        os.path.join(out, "risk_outputs.npz"), res.outputs,
        meta={"source": source,
              "dates": [date_stamp(res.arrays.dates[0]),
                        date_stamp(res.arrays.dates[-1])],
              "n_stocks": int(res.arrays.ret.shape[1])})


def _write_result_tables(res, out: str, specific_risk: bool) -> None:
    """The five demo.py result tables (``demo.py:60-94``) plus, when
    asked, the USE4 specific-risk panel (EWMA vol, Bayes-shrunk), with the
    csv module in ``DataFrame.to_csv``'s layout: the index column first,
    floats as the ``repr`` of their float64 value, NaN empty."""
    from mfm_tpu_torch.data.artifacts import _numpy
    from mfm_tpu_torch.data.csvio import write_csv

    os.makedirs(out, exist_ok=True)
    a, o = res.arrays, res.outputs
    names = a.factor_names()

    def table(fname, values, index, columns):
        values = _numpy(values).reshape(len(index), -1)
        write_csv(os.path.join(out, fname),
                  {str(c): values[:, j] for j, c in enumerate(columns)},
                  index=index)

    table("factor_returns.csv", o.factor_ret, a.dates, names)
    table("r_squared.csv", o.r2, a.dates, ["R2"])
    table("specific_returns.csv", o.specific_ret, a.dates, a.stocks)
    table("final_covariance.csv", o.vr_cov[-1], names, names)
    table("lambda.csv", o.lamb, a.dates, ["lambda"])
    if specific_risk:
        table("specific_risk.csv",
              res._specific_panels(42.0, 10, 1.0, 10)[1], a.dates, a.stocks)


def _report_json(res) -> dict:
    """JSON-ready quarantine summary of an append result's GuardReport."""
    import numpy as np

    from mfm_tpu_torch.data.artifacts import _numpy
    from mfm_tpu_torch.pipeline import date_stamp
    from mfm_tpu_torch.serve.guard import reason_names

    rep = res.report
    q = _numpy(rep.quarantined).astype(bool)
    reasons = _numpy(rep.reasons)
    stale = _numpy(rep.staleness)
    dates = [date_stamp(d) for d in res.arrays.dates[-len(q):]]
    return {
        "quarantined": [
            {"date": dates[i], "reasons": reason_names(int(reasons[i])),
             "staleness": int(stale[i])}
            for i in np.nonzero(q)[0]
        ],
        "quarantine_count_total": int(_numpy(
            res.state.quarantine_count)) if res.state is not None else None,
    }


def _write_manifest_beside(state_path: str, res, device,
                           trace_id=None) -> dict:
    """After a checkpoint save: the run manifest next to it (atomic),
    carrying the checkpoint's identity stamp, the guard verdict summary,
    the live metrics snapshot, the model-health verdict and this
    process's kernel launches.  Returns the health dict.  The health
    monitors launch kernels of their own, so they run here, at the CLI
    layer, never inside an update."""
    from mfm_tpu_torch.data.artifacts import _stamp_to_json
    from mfm_tpu_torch.obs.health import evaluate_health
    from mfm_tpu_torch.obs.instrument import guard_summary_from_registry
    from mfm_tpu_torch.obs.manifest import (
        build_run_manifest,
        manifest_path_for,
        write_run_manifest,
    )
    from mfm_tpu_torch.obs.metrics import REGISTRY

    guard = guard_summary_from_registry()
    health = evaluate_health(res.outputs, guard_summary=guard)
    extra = {"kernels": _kernel_block()}
    if trace_id:
        extra["trace_id"] = trace_id
    manifest = build_run_manifest(
        stamp_json=(_stamp_to_json(res.state.stamp)
                    if res.state is not None else None),
        checkpoint=state_path,
        backend=device.type,
        metrics_snapshot=REGISTRY.snapshot(),
        guard_summary=guard,
        health=health,
        extra=extra,
    )
    write_run_manifest(manifest_path_for(state_path), manifest)
    return health


# -- risk, demo, factors -------------------------------------------------------

def _risk(args):
    """The risk model over a barra-format csv (``demo.py``'s path): the
    full run, optionally checkpointed (``--save-state``), or one update
    step from a checkpoint over the table's new dates (``--update``)."""
    import time

    import numpy as np

    from mfm_tpu_torch._device import resolve_device
    from mfm_tpu_torch.data.artifacts import _numpy
    from mfm_tpu_torch.data.barra import barra_frame_to_arrays
    from mfm_tpu_torch.data.csvio import read_csv
    from mfm_tpu_torch.obs.instrument import record_stage_seconds, time_stage
    from mfm_tpu_torch.obs.trace import end_span
    from mfm_tpu_torch.pipeline import run_risk_pipeline

    if args.bias_plot:
        _require_matplotlib("--bias-plot")  # before the pipeline runs
    if args.update and args.save_state:
        raise SystemExit("--update advances its checkpoint FILE in place; "
                         "drop --save-state")
    if (args.update or args.save_state) and args.nw_method != "scan":
        raise SystemExit("the resumable state is the serial scan's carry; "
                         "--save-state/--update need --nw-method scan")
    if args.update and (args.bias_plot or args.portfolio_bias):
        # bias statistics need history; an appended slab has none
        raise SystemExit("--update serves new dates only — run the bias "
                         "acceptance tests on a full-history run instead")
    # the card unless the caller asked for the CPU; raises without a card
    device = resolve_device(args.device)
    mesh = _parse_mesh_arg(args.mesh, device)
    _metrics_init(args)
    root = _root_span(args)

    cfg = _risk_config(args)
    if args.barra_store:
        table, codes = _read_barra_store(args)
    else:
        with time_stage("read_barra_csv"):
            table = read_csv(args.barra)
            codes = (read_csv(args.industry_info)["code"]
                     if args.industry_info else None)

    def mean_r2(res) -> float:
        return float(np.nanmean(_numpy(res.outputs.r2)))

    if args.update:
        # incremental serving: one O(slab) update step from the checkpoint
        # instead of the O(T) full-history rebuild — same outputs, bitwise
        from mfm_tpu_torch.data.artifacts import (
            ArtifactCorruptError,
            ArtifactStaleError,
        )
        from mfm_tpu_torch.pipeline import (
            append_risk_pipeline,
            date_stamp,
            save_pipeline_state,
        )

        t0 = time.perf_counter()
        with _profile_ctx(args.profile or args.jax_profile, device):
            try:
                res = append_risk_pipeline(args.update, table, config=cfg,
                                           force=args.force, mesh=mesh,
                                           device=device)
            except (ValueError, ArtifactCorruptError,
                    ArtifactStaleError) as err:
                raise SystemExit(f"--update: {err}") from err
        with time_stage("write_result_tables"):
            _write_result_tables(res, args.out, args.specific_risk)
        save_pipeline_state(args.update, res)  # advance the checkpoint
        wall = time.perf_counter() - t0
        record_stage_seconds("update_total", wall)
        health = _write_manifest_beside(args.update, res, device,
                                        trace_id=root.trace_id)
        if args.save_outputs:
            _save_outputs_npz(res, args.out, args.barra or args.barra_store)
        _maybe_portfolio_risk(res, args)
        rec = {
            "appended_dates": [date_stamp(d) for d in res.arrays.dates],
            "stocks": int(res.arrays.ret.shape[1]),
            "factors": len(res.arrays.factor_names()),
            "update_wall_s": round(wall, 3),
            "mean_r2": mean_r2(res),
            "state": args.update,
            "health": health["status"],
            "trace_id": root.trace_id,
        }
        if res.report is not None:
            rec.update(_report_json(res))
        rec["kernels"] = _kernel_block()
        end_span(root, wall_s=round(wall, 3))
        _metrics_flush(args)
        print(json.dumps(rec))
        return

    arrays = barra_frame_to_arrays(table, industry_codes=codes)
    t0 = time.perf_counter()
    # the reported wall_s includes the profiler overhead when --profile is on
    with _profile_ctx(args.profile or args.jax_profile, device):
        res = run_risk_pipeline(arrays=arrays, config=cfg,
                                with_state=bool(args.save_state),
                                mesh=mesh, device=device)
    with time_stage("write_result_tables"):
        _write_result_tables(res, args.out, args.specific_risk)
    wall = time.perf_counter() - t0
    record_stage_seconds("risk_full", wall)
    if args.save_state:
        # checkpoint the resumable state (outside the timed region, like
        # the artifact and plot writes below); `risk --update FILE` serves
        # the next dates from it
        from mfm_tpu_torch.pipeline import save_pipeline_state

        save_pipeline_state(args.save_state, res)
        _write_manifest_beside(args.save_state, res, device,
                               trace_id=root.trace_id)
    if args.save_outputs:
        # the full (T, K, K) covariance series + every stage output as one
        # artifact (the csv tables carry only the last date's covariance)
        _save_outputs_npz(res, args.out, args.barra or args.barra_store)
    if args.bias_plot:
        from mfm_tpu_torch.models.bias import (
            bias_stats_summary,
            plot_bias_stats,
        )

        # the USE4 acceptance numbers + picture (utils.py:97-117): the eigen
        # adjustment must pull the bias statistic toward 1, most visibly at
        # the extreme eigenfactor ranks
        o = res.outputs
        summary = bias_stats_summary(o.nw_cov, o.nw_valid, o.eigen_cov,
                                     o.eigen_valid, o.factor_ret,
                                     burn_in=args.bias_burn_in)
        plot_bias_stats(
            {label: np.array([np.nan if v is None else v for v in d["bias"]])
             for label, d in summary["all_valid_dates"].items()},
            os.path.join(args.out, args.bias_plot),
        )
        summary["backend"] = device.type
        with open(os.path.join(args.out, "bias_stats.json"), "w") as fh:
            json.dump(summary, fh, indent=1)
    # USE4's headline acceptance test (random test portfolios)
    _maybe_portfolio_bias(res, args)
    _maybe_portfolio_risk(res, args)
    end_span(root, wall_s=round(wall, 3))
    _metrics_flush(args)
    print(json.dumps({
        "dates": int(arrays.ret.shape[0]), "stocks": int(arrays.ret.shape[1]),
        "factors": len(arrays.factor_names()), "wall_s": round(wall, 3),
        "mean_r2": mean_r2(res), "trace_id": root.trace_id,
        "kernels": _kernel_block(),
    }))


def _read_barra_store(args) -> tuple:
    """``risk --barra-store``: the barra table from the store's
    ``barra_factors`` collection (written by ``pipeline --to-store``) and
    the one-hot code order from ``sw_industry_info_for_factors``, or from
    ``--industry-info`` when given."""
    from mfm_tpu_torch.data.columns import nrows
    from mfm_tpu_torch.data.csvio import read_csv
    from mfm_tpu_torch.data.etl import PanelStore

    st = PanelStore(args.barra_store)
    table = st.read("barra_factors")
    if not nrows(table):
        raise SystemExit(f"{args.barra_store}: no barra_factors "
                         "collection (run `pipeline --to-store` first)")
    if args.industry_info:
        # an explicit file wins over the store's own collection (same
        # role as on the CSV path: fix the one-hot code order)
        return table, read_csv(args.industry_info)["code"]
    info = st.read("sw_industry_info_for_factors")
    if not nrows(info):
        # as strict as the barra_factors check: a data-derived one-hot
        # order would silently diverge from the pipeline's
        raise SystemExit(
            f"{args.barra_store}: no sw_industry_info_for_factors "
            "collection — rerun `pipeline --to-store`, or pass the "
            "code list explicitly with --industry-info")
    return table, info["code"]


#: the three artifacts `prepare` writes and `factors --prepared` consumes;
#: a directory the reference's `prepare` wrote holds panel.parquet instead
PREPARED_PANEL = "panel.npz"
PREPARED_PANEL_PARQUET = "panel.parquet"
PREPARED_INDEX = "index_prices.csv"
PREPARED_INDUSTRY = "industry_map.csv"


#: ``Series(values, index=keys).reindex(axis)`` on numpy
_reindex = reindex


def _factors(args):
    """Style-factor production (``main.py``'s path): a raw long panel, the
    index's prices and the industry map in, ``OUT/barra_data.csv`` out."""
    import numpy as np

    from mfm_tpu_torch._device import resolve_device
    from mfm_tpu_torch.config import PipelineConfig
    from mfm_tpu_torch.data.csvio import read_csv
    from mfm_tpu_torch.data.csvio import write_csv
    from mfm_tpu_torch.panel import Panel
    from mfm_tpu_torch.pipeline import run_factor_pipeline

    if args.prepared:
        # consume a `prepare` output directory directly (its three
        # artifacts have fixed names — no need to spell them out)
        for flag, val in (("--panel", args.panel), ("--index", args.index),
                          ("--industry", args.industry)):
            if val:
                raise SystemExit(f"--prepared already provides {flag}; "
                                 "drop one of the two")
        args.panel = os.path.join(args.prepared, PREPARED_PANEL)
        if not os.path.exists(args.panel):
            args.panel = os.path.join(args.prepared, PREPARED_PANEL_PARQUET)
        args.index = os.path.join(args.prepared, PREPARED_INDEX)
        args.industry = os.path.join(args.prepared, PREPARED_INDUSTRY)
        missing = [p for p in (args.panel, args.index, args.industry)
                   if not os.path.exists(p)]
        if missing:
            raise SystemExit(f"--prepared {args.prepared}: missing "
                             f"artifact(s) {missing} (run `prepare` first)")
    elif not (args.panel and args.index and args.industry):
        raise SystemExit("pass either --prepared DIR or all of "
                         "--panel/--index/--industry")
    device = resolve_device(args.device)
    panel = _read_long_table(args.panel)
    index = _read_long_table(args.index)
    ind = read_csv(args.industry)

    p = Panel.from_long(panel)
    idx_close = _reindex(index["trade_date"], index["close"], p.dates)
    # the first row of each ts_code (drop_duplicates keeps the first)
    _, first = np.unique(ind["ts_code"], return_index=True)
    first = np.sort(first)
    l1 = _reindex(ind["ts_code"][first], ind["l1_code"][first], p.stocks)
    # report id for TTM: rank-encode end_date per cell if provided
    if "end_date" in p.fields:
        ed = np.asarray(p.fields["end_date"])
        ok = np.isfinite(ed)
        codes = np.unique(ed[ok])
        rid = np.full(ed.shape, -1, np.int32)
        rid[ok] = np.searchsorted(codes, ed[ok]).astype(np.int32)
        p.fields["end_date_code"] = rid
        del p.fields["end_date"]
    barra, _ = run_factor_pipeline(
        p.fields, idx_close, l1, p.dates, p.stocks,
        PipelineConfig(dtype=args.dtype, block=args.block,
                       rolling_impl=args.rolling_impl),
        device=device,
    )
    os.makedirs(args.out, exist_ok=True)
    out_path = os.path.join(args.out, "barra_data.csv")
    write_csv(out_path, barra)
    print(json.dumps({"rows": len(barra["date"]), "out": out_path}))


# -- the store path: prepare, pipeline, etl-* ----------------------------------

def _prepare(args):
    """Store -> factor-input artifacts (the ``load_and_prepare_data``
    path): the master table as ``panel.npz`` (the store's part format,
    report and announcement dates encoded as yyyymmdd numbers, NaN for
    none — ``factors`` re-ranks end_date into the TTM report id), the
    index prices csv and the per-stock industry map csv, consumable by
    ``factors --prepared``."""
    from mfm_tpu_torch.data.columns import yyyymmdd_numbers
    from mfm_tpu_torch.data.csvio import write_csv
    from mfm_tpu_torch.data.etl import PanelStore, write_table
    from mfm_tpu_torch.data.prepare import load_and_prepare_data, sw_l1_map

    master, index_px, sw = load_and_prepare_data(
        PanelStore(args.store), index_code=args.index_code,
        start_date=args.start, end_date=args.end,
        fin_start_date=args.fin_start)
    os.makedirs(args.out, exist_ok=True)
    out = dict(master)
    for c in ("balance_sheet_f_ann_date", "financial_indicators_ann_date",
              "cashflow_f_ann_date", "end_date"):
        if c in out:
            out[c] = yyyymmdd_numbers(out[c])
    panel_path = os.path.join(args.out, PREPARED_PANEL)
    index_path = os.path.join(args.out, PREPARED_INDEX)
    industry_path = os.path.join(args.out, PREPARED_INDUSTRY)
    write_table(panel_path, out)
    write_csv(index_path, index_px)
    stocks = sorted(set(out["ts_code"].tolist()))
    write_csv(industry_path, {"ts_code": stocks,
                              "l1_code": sw_l1_map(sw, stocks)})
    print(json.dumps({"rows": len(out["ts_code"]), "stocks": len(stocks),
                      "panel": panel_path, "index": index_path,
                      "industry": industry_path}))


def _read_alpha_sources(path, llm=False):
    """Read + syntax-validate an ``--alphas`` expression file, fail-fast
    (before any expensive pipeline stage runs) with file:line context.
    ``llm=True`` switches to tolerant extraction from raw LLM output."""
    from mfm_tpu_torch.alpha.dsl import compile_alpha

    try:
        fh = open(path)
    except OSError as err:
        raise SystemExit(f"--alphas: {err}") from err
    sources = []
    with fh:
        if llm:
            sources, _ = _extract_llm_sources(fh.read(), path)
        else:
            for i, line in enumerate(fh, 1):
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                try:
                    compile_alpha(line)
                except (ValueError, SyntaxError) as err:
                    raise SystemExit(f"{path}:{i}: {err}") from err
                sources.append(line)
    if not sources:
        raise SystemExit(f"--alphas: {path} has no expressions")
    return sources


def _as_dates(col):
    """A date column (datetime64, or strings as the csv gives them) as
    datetime64[ns]."""
    import numpy as np

    from mfm_tpu_torch.pipeline import date_stamp

    col = np.asarray(col)
    if col.dtype.kind == "M":
        return col.astype("datetime64[ns]")
    uniq, inv = np.unique(col.astype(str), return_inverse=True)
    days = np.array([date_stamp(s) for s in uniq.tolist()],
                    "datetime64[ns]")
    return days[inv.reshape(-1)]


def _append_alpha_styles(args, sources, barra, prep, device):
    """Evaluate/select the ``--alphas`` expressions on the prepared raw
    panel and append the survivors as style columns of the barra table (in
    memory only — the resumable stage artifact stays the classic factor
    table)."""
    import sys

    import numpy as np

    from mfm_tpu_torch.alpha.dsl import compile_alpha
    from mfm_tpu_torch.alpha.integrate import alpha_style_columns
    from mfm_tpu_torch.data.barra import _index_of

    fields = {k: np.asarray(v, np.float32) for k, v in prep.fields.items()}
    if getattr(args, "alphas_llm", False):
        # llm mode is tolerant end to end: an extracted expression whose
        # fields the prepared panel lacks (a hallucinated name) is dropped
        # with a report, not a pipeline abort
        kept = []
        for s in sources:
            missing = [f for f in compile_alpha(s).fields if f not in fields]
            if missing:
                print(f"--alphas (llm): dropped {s!r}: unknown panel "
                      f"field(s) {missing}", file=sys.stderr)
            else:
                kept.append(s)
        if not kept:
            raise SystemExit("--alphas: no extracted expression references "
                             f"known panel fields (have: {sorted(fields)})")
        sources = kept

    # forward returns = the barra table's own t+1 ``ret`` column, densified
    # on the prepared (dates x stocks) grid
    ti = _index_of(_as_dates(prep.dates), _as_dates(barra["date"]))
    si = _index_of(np.asarray(prep.stocks).astype(str),
                   np.asarray(barra["stocknames"]).astype(str))
    if (ti < 0).any() or (si < 0).any():
        raise SystemExit("--alphas: the resumed barra table's dates/stocks "
                         "do not match the store's prepared panel — rerun "
                         "without --resume")
    T, N = len(prep.dates), len(prep.stocks)
    fwd = np.full((T, N), np.nan, np.float32)
    fwd[ti, si] = np.asarray(barra["ret"], np.float32)
    try:
        names, expo, report = alpha_style_columns(
            sources, fields, fwd, k=args.alpha_top,
            max_corr=args.alpha_max_corr, device=device)
    except ValueError as err:
        raise SystemExit(f"--alphas: {err}") from err
    barra = {c: v for c, v in barra.items() if not c.startswith("alpha_")}
    for j, name in enumerate(names):
        barra[name] = expo[ti, si, j]
    return barra, report


def _check_append_prefix_unrevised(prev_barra, barra, last_date, dtype):
    """Refuse an append whose refreshed factor table rewrote history.

    Compares the rows at or before the checkpoint's last date between the
    table the prior run persisted and the refreshed one, on the columns
    both have, AT THE RISK COMPUTE DTYPE (only what survives the cast ever
    reached the checkpointed scan).  Dates normalize to the checkpoint's
    'YYYY-MM-DD' stamps so string ordering is chronological."""
    import numpy as np

    from mfm_tpu_torch.data.columns import sort_order, take

    fdtype = np.dtype(dtype)
    if prev_barra is None:
        raise SystemExit("--append: the prior run's barra_data.csv is "
                         "missing — run the pipeline once without --append "
                         "first")

    def norm(t):
        t = dict(t)
        t["date"] = np.datetime_as_string(
            _as_dates(t["date"]).astype("datetime64[D]"), unit="D")
        t = take(t, t["date"] <= last_date)
        return take(t, sort_order(t, ["date", "stocknames"]))

    old, new = norm(prev_barra), norm(barra)
    cols = [c for c in old if c in new]
    bad = None
    if len(old["date"]) != len(new["date"]) or \
            not np.array_equal(old["date"], new["date"]) or \
            old["stocknames"].astype(str).tolist() != \
            new["stocknames"].astype(str).tolist():
        bad = "row set"
    else:
        for c in cols:
            oc, nc = np.asarray(old[c]), np.asarray(new[c])
            if oc.dtype.kind == "f" and nc.dtype.kind == "f":
                same = np.array_equal(oc.astype(fdtype), nc.astype(fdtype),
                                      equal_nan=True)
            else:
                same = [str(x) for x in oc.tolist()] == \
                    [str(x) for x in nc.tolist()]
            if not same:
                bad = f"column {c!r}"
                break
    if bad is not None:
        raise SystemExit(
            f"--append: the refreshed factor table revised history at or "
            f"before the checkpoint (last_date={last_date}, {bad} changed) "
            "— typically a next-traded-day return label filling in across "
            "a suspension gap.  The incremental path cannot reproduce a "
            "revised prefix; rerun without --append")


def _pipeline_append_stage(args, barra, cfg, prev_barra, device):
    """``--append``'s risk stage: prior outputs artifact + checkpoint + ONE
    update step over the dates past the checkpoint -> a full-history
    result, bitwise what a from-scratch rerun gives for the risk stage.

    The factor stage's rolling windows are causal, but the t+1 return
    label is the stock's *next traded day* return, so a suspension gap
    straddling the checkpoint fills a prefix label in once the stock
    trades again; ``prev_barra`` (the table the prior run wrote) detects
    that revision, and the append refuses rather than silently diverge."""
    import time

    import torch

    from mfm_tpu_torch.data.artifacts import (
        ArtifactCorruptError,
        ArtifactStaleError,
        load_artifact,
        load_risk_outputs,
    )
    from mfm_tpu_torch.data.barra import barra_frame_to_arrays
    from mfm_tpu_torch.models.risk_model import RiskModelOutputs
    from mfm_tpu_torch.pipeline import (
        RiskPipelineResult,
        append_risk_pipeline,
        date_stamp,
    )

    state_path = os.path.join(args.out, "risk_state.npz")
    prev_path = os.path.join(args.out, "risk_outputs.npz")
    for p in (state_path, prev_path):
        if not os.path.exists(p):
            raise SystemExit(f"--append: {p} not found — run the pipeline "
                             "once without --append first")
    prev, _ = load_risk_outputs(prev_path, device)
    _, smeta = load_artifact(state_path)
    _check_append_prefix_unrevised(prev_barra, barra, smeta["last_date"],
                                   cfg.dtype)
    t0 = time.perf_counter()
    try:
        app = append_risk_pipeline(
            state_path, barra, config=cfg, force=args.force,
            mesh=_parse_mesh_arg(args.mesh, device), device=device)
    except (ValueError, ArtifactCorruptError, ArtifactStaleError) as err:
        raise SystemExit(f"--append: {err}") from err
    update_wall = time.perf_counter() - t0
    # full-history arrays pinned to the checkpoint's axes, so the
    # concatenated outputs' rows/columns line up with the new table exactly
    full = barra_frame_to_arrays(
        barra, industry_codes=app.arrays.industry_codes,
        style_names=app.arrays.style_names, stocks=app.arrays.stocks)
    T_prev = int(prev.r2.shape[0])
    if T_prev + len(app.arrays.dates) != len(full.dates):
        raise SystemExit(
            f"--append: {prev_path} covers {T_prev} dates but the refreshed "
            f"table has {len(full.dates)} with {len(app.arrays.dates)} new "
            "— the history itself changed; rerun without --append")
    cat = RiskModelOutputs(*[torch.cat([p, n.to(p.device)], 0)
                             for p, n in zip(prev, app.outputs)])
    res = RiskPipelineResult(outputs=cat, arrays=full, state=app.state,
                             report=app.report)
    return res, [date_stamp(d) for d in app.arrays.dates], update_wall


def _risk_config(args):
    """The risk flags of ``risk`` and ``pipeline`` as a PipelineConfig."""
    from mfm_tpu_torch.config import (
        PipelineConfig,
        QuarantinePolicy,
        RiskModelConfig,
    )

    return PipelineConfig(
        risk=RiskModelConfig(
            nw_lags=args.nw_lags, nw_half_life=args.nw_half_life,
            nw_method=args.nw_method,
            eigen_n_sims=args.eigen_sims, eigen_scale_coef=args.eigen_scale,
            eigen_chunk=args.eigen_chunk,
            eigen_sim_length=args.eigen_sim_length,
            eigen_mc_dtype=args.eigen_mc_dtype,
            eigen_incremental=args.eigen_incremental,
            vol_regime_half_life=args.vr_half_life, seed=args.seed,
            quarantine=QuarantinePolicy(enabled=args.quarantine),
        ),
        dtype=args.dtype,
        **({"block": args.block, "rolling_impl": args.rolling_impl}
           if hasattr(args, "rolling_impl") else {}),
    )


def _industry_info(store, barra) -> dict:
    """industry_info: the code list fixing the one-hot order, from the
    store's SW table (first row per code), the codes the table uses, in
    code order."""
    import numpy as np

    from mfm_tpu_torch.data.columns import (
        drop_duplicates,
        isin,
        nrows,
        sort_order,
        take,
        unique,
    )

    sw = store.read("sw_industries")
    if not nrows(sw):
        return {"code": np.array([], str), "industry_names": np.array([], str)}
    info = drop_duplicates(sw, ["l1_code"])
    info = take(info, isin(info["l1_code"], set(unique(barra["industry"]))))
    out = {"code": info["l1_code"],
           "industry_names": info.get("l1_name", info["l1_code"])}
    return take(out, sort_order(out, ["code"]))


def _pipeline(args):
    """One-command end-to-end: raw store -> master panel -> factor table ->
    risk outputs (the reference's ``main.py`` + ``demo.py`` chain), with a
    stage artifact between the factor and risk stages for resume, and a
    risk-state checkpoint (``OUT/risk_state.npz``) for ``--append``'s
    O(new-dates) daily refresh."""
    import time

    import numpy as np

    from mfm_tpu_torch._device import resolve_device
    from mfm_tpu_torch.data.artifacts import _numpy
    from mfm_tpu_torch.data.csvio import read_csv, write_csv
    from mfm_tpu_torch.data.etl import PanelStore
    from mfm_tpu_torch.data.prepare import prepare_factor_inputs
    from mfm_tpu_torch.obs.instrument import record_stage_seconds, time_stage
    from mfm_tpu_torch.obs.trace import end_span
    from mfm_tpu_torch.pipeline import run_factor_pipeline, run_risk_pipeline

    if args.append and args.resume:
        raise SystemExit("--append re-runs the factor stage over the "
                         "refreshed store; drop --resume")
    if args.append and args.nw_method != "scan":
        raise SystemExit("the resumable state is the serial scan's carry; "
                         "--append needs --nw-method scan")
    # the card unless the caller asked for the CPU; raises without a card
    device = resolve_device(args.device)
    _metrics_init(args)
    root = _root_span(args)
    cfg = _risk_config(args)
    os.makedirs(args.out, exist_ok=True)
    barra_path = os.path.join(args.out, "barra_data.csv")
    industry_info_path = os.path.join(args.out, "industry_info.csv")
    t0 = time.perf_counter()

    # fail-fast on a bad --alphas path/expression BEFORE the factor stage
    alpha_sources = (_read_alpha_sources(args.alphas, llm=args.alphas_llm)
                     if args.alphas else None)
    prep = None
    # the factor stage below overwrites barra_data.csv; --append's history-
    # revision check needs the prior run's table, so read it first
    prev_barra = None
    if args.append and os.path.exists(barra_path):
        with time_stage("read_barra_csv"):
            prev_barra = read_csv(barra_path)
    with _profile_ctx(args.profile or args.jax_profile, device):
        if args.resume and os.path.exists(barra_path) \
                and os.path.exists(industry_info_path):
            with time_stage("read_barra_csv"):
                barra = read_csv(barra_path)
        else:
            store = PanelStore(args.store)
            prep = prepare_factor_inputs(
                store, index_code=args.index_code, start_date=args.start,
                end_date=args.end, fin_start_date=args.fin_start)
            barra, _ = run_factor_pipeline(
                prep.fields, prep.index_close, prep.industry_l1,
                prep.dates, prep.stocks, cfg, device=device)
            with time_stage("write_barra_csv"):
                write_csv(barra_path, barra)   # the stage artifact
            write_csv(industry_info_path, _industry_info(store, barra))
        factor_wall = time.perf_counter() - t0

        info = read_csv(industry_info_path)
        if args.to_store:
            # the factor table as the collections ``barra_factors`` +
            # ``sw_industry_info_for_factors`` (full refresh), consumable
            # by `risk --barra-store`
            out_store = PanelStore(args.to_store)
            out_store.replace("barra_factors", barra)
            out_store.replace("sw_industry_info_for_factors", info)

        n_alpha_styles = 0
        if args.alphas:
            # (LLM-)generated alpha expressions -> evaluate on the raw
            # panel -> IC-score + de-correlate -> the survivors join the
            # barra table as extra style columns
            if prep is None:  # --resume skipped the prepare stage
                prep = prepare_factor_inputs(
                    PanelStore(args.store), index_code=args.index_code,
                    start_date=args.start, end_date=args.end,
                    fin_start_date=args.fin_start)
            barra, report = _append_alpha_styles(args, alpha_sources,
                                                 barra, prep, device)
            n_alpha_styles = len(report)
            with open(os.path.join(args.out, "alpha_styles.json"), "w") as fh:
                json.dump(report, fh, indent=1)

        codes = np.asarray(info["code"])
        appended = update_wall = None
        if args.append:
            res, appended, update_wall = _pipeline_append_stage(
                args, barra, cfg, prev_barra, device)
        else:
            # the associative Newey-West has no serial carry to
            # checkpoint, so no state there
            res = run_risk_pipeline(
                barra_df=barra, config=cfg, industry_codes=codes,
                with_state=cfg.risk.nw_method == "scan", device=device)
    with time_stage("write_result_tables"):
        _write_result_tables(res, args.out, args.specific_risk)
    wall = time.perf_counter() - t0
    record_stage_seconds("factor", factor_wall)
    record_stage_seconds("pipeline_total", wall)
    _save_outputs_npz(res, args.out, args.store)  # outside the timed region
    health = None
    if res.state is not None:
        # the daily-serving checkpoint `pipeline --append` resumes from
        from mfm_tpu_torch.pipeline import save_pipeline_state

        state_path = os.path.join(args.out, "risk_state.npz")
        save_pipeline_state(state_path, res)
        health = _write_manifest_beside(state_path, res, device,
                                        trace_id=root.trace_id)
    # acceptance-test compute stays OUT of the reported wall
    _maybe_portfolio_bias(res, args)
    _maybe_portfolio_risk(res, args)
    rec = {
        "rows": int(len(barra["date"])),
        "dates": int(res.arrays.ret.shape[0]),
        "stocks": int(res.arrays.ret.shape[1]),
        "factors": len(res.arrays.factor_names()),
        "factor_stage_wall_s": round(factor_wall, 3),
        "wall_s": round(wall, 3),
        "mean_r2": float(np.nanmean(_numpy(res.outputs.r2))),
        "alpha_styles": n_alpha_styles,
        "out": args.out,
        "trace_id": root.trace_id,
    }
    if health is not None:
        rec["health"] = health["status"]
    if appended is not None:
        rec["appended_dates"] = appended
        rec["update_wall_s"] = round(update_wall, 3)
    if res.report is not None:
        rec.update(_report_json(res))
    rec["kernels"] = _kernel_block()
    end_span(root, wall_s=round(wall, 3))
    _metrics_flush(args)
    print(json.dumps(rec))


def _etl_xlsx(args):
    """Static-workbook ingestion: the index list and the Wind EDB
    industry-index workbook into store collections, with the same
    idempotent-insert discipline as the API collections."""
    from mfm_tpu_torch.data.etl import PanelStore
    from mfm_tpu_torch.data.xlsx import ingest_workbooks

    counts = ingest_workbooks(
        PanelStore(args.store), index_list=args.index_list,
        industry_index=args.industry_index,
        industry_sheets=tuple(int(s) for s in args.sheets.split(",")),
    )
    print(json.dumps(counts))


def _etl_steps(args) -> dict:
    return {"index_codes": [s.strip() for s in args.index_codes.split(",")],
            "statements": ([s.strip() for s in args.statements.split(",")]
                           if args.statements else ()),
            "components_date": args.components_date, "sw": not args.no_sw}


def _etl_update(args):
    """Calendar-driven refresh of every collection, with the watermark,
    rate-limit and retry behavior of the reference's daily job."""
    import time

    from mfm_tpu_torch.data.etl import (
        IncrementalUpdater,
        PanelStore,
        RateLimiter,
        plan_update,
    )

    end = args.end or time.strftime("%Y%m%d")
    if args.dry_run:
        # pre-flight plan from the store's watermarks alone: no token, no
        # API call, no rate-limit budget spent
        print(json.dumps(plan_update(PanelStore(args.store), args.start, end,
                                     **_etl_steps(args))))
        return
    from mfm_tpu_torch.data.tushare_source import TushareSource

    up = IncrementalUpdater(
        store=PanelStore(args.store),
        source=TushareSource(token=args.token),
        limiter=RateLimiter(args.calls_per_min),
    )
    print(json.dumps(up.run_all(args.start, end, **_etl_steps(args),
                                sw_csv=args.sw_csv)))


def _etl_verify(args):
    from mfm_tpu_torch.data.etl import PanelStore, verify_store

    store = PanelStore(args.store)
    if args.diagnose:
        # per-stock statement QC (the notebooks' bad-group hunt, vectorized)
        from mfm_tpu_torch.data.pit import diagnose_statements

        try:
            rep = diagnose_statements(store.read(args.name),
                                      by=args.code_col,
                                      ann_col=args.ann_col,
                                      end_col=args.end_col)
        except ValueError as err:
            # wrong-schema / empty / typo'd collection: a clean error, not a
            # KeyError traceback (--name defaults to daily_prices, which has
            # no announcement columns)
            raise SystemExit(f"--diagnose {args.name}: {err}") from err
        rep["collection"] = args.name
        print(json.dumps(rep))
        return
    print(json.dumps(verify_store(store, name=args.name,
                                  code_col=args.code_col,
                                  date_col=args.date_col)))


def _etl_missing(args):
    import time

    from mfm_tpu_torch.data.etl import (
        IncrementalUpdater,
        PanelStore,
        RateLimiter,
        find_missing_stocks,
    )

    store = PanelStore(args.store)
    if args.fix:
        # detect AND refetch.  The refill fetches daily_basic rows, so it
        # only makes sense for the default price collection — custom
        # --name/--code-col would insert wrong-schema rows
        if args.name != "daily_prices" or args.code_col != "ts_code":
            raise SystemExit("--fix only repairs the daily_prices "
                             "collection (it refetches daily_basic rows); "
                             "drop --name/--code-col")
        from mfm_tpu_torch.data.tushare_source import TushareSource

        up = IncrementalUpdater(
            store=store, source=TushareSource(token=args.token),
            limiter=RateLimiter(args.calls_per_min))
        rep = up.repair_missing_stocks(
            args.start, args.end or time.strftime("%Y%m%d"),
            universe_name=args.universe)
        print(json.dumps({"n_missing": len(rep["missing"]),
                          "missing": rep["missing"],
                          "rows_inserted": rep["rows_inserted"]}))
        return
    missing = find_missing_stocks(store, universe_name=args.universe,
                                  data_name=args.name,
                                  code_col=args.code_col)
    print(json.dumps({"n_missing": len(missing), "missing": missing}))


def _demo(args):
    """The synthetic end-to-end risk model: a seeded barra table through
    the pipeline, the five result tables out."""
    import time

    from mfm_tpu_torch._device import resolve_device
    from mfm_tpu_torch.config import PipelineConfig, RiskModelConfig
    from mfm_tpu_torch.data.synthetic import synthetic_barra_table
    from mfm_tpu_torch.pipeline import run_risk_pipeline

    device = resolve_device(args.device)
    table, _ = synthetic_barra_table(T=args.dates, N=args.stocks,
                                     P=args.industries, Q=args.styles, seed=0)
    cfg = PipelineConfig(risk=RiskModelConfig(eigen_n_sims=args.eigen_sims),
                         dtype=args.dtype)
    t0 = time.perf_counter()
    res = run_risk_pipeline(table, config=cfg, device=device)
    # all five demo.py result tables, like the risk subcommand
    _write_result_tables(res, args.out, specific_risk=False)
    rec = {"wall_s": round(time.perf_counter() - t0, 3), "out": args.out}
    if args.check_determinism:
        # the framework's sanitizer: same seed, same inputs -> bitwise-equal
        # outputs, twice over
        from mfm_tpu_torch.utils.obs import determinism_check

        rec["deterministic"] = determinism_check(
            lambda: run_risk_pipeline(table, config=cfg,
                                      device=device).outputs)
    print(json.dumps(rec))


# -- scenario, grad ------------------------------------------------------------

def _load_state_or_exit(args, cmd: str, device):
    """The guarded checkpoint of a scenario/grad run, or the reference's
    refusal."""
    from mfm_tpu_torch.data.artifacts import (
        ArtifactCorruptError,
        ArtifactStaleError,
        load_risk_state,
    )

    try:
        return load_risk_state(args.state, device=device)
    except (ArtifactCorruptError, ArtifactStaleError) as e:
        # same refusal as `serve`: a checkpoint past its fence audit is
        # not a world worth stressing (post-crash triage is `doctor`)
        raise SystemExit(f"{cmd}: checkpoint failed its fence audit: {e}")
    except OSError as e:
        raise SystemExit(f"{cmd}: cannot load {args.state}: {e}")


def _spec_list(args, cmd: str) -> list:
    """ScenarioSpecs off ``--preset`` names and ``--spec`` files, in that
    order (the ``scenario run`` and ``grad sensitivity`` assembly)."""
    from mfm_tpu_torch.scenario import ScenarioSpec, preset

    specs = []
    try:
        for name in args.preset:
            specs.append(preset(name))
    except KeyError as e:
        raise SystemExit(f"{cmd}: {e.args[0]}")
    for path in args.spec:
        try:
            with open(path, encoding="utf-8") as fh:
                obj = json.load(fh)
        except (OSError, ValueError) as e:
            raise SystemExit(f"{cmd}: cannot read spec file {path}: {e}")
        try:
            for d in (obj if isinstance(obj, list) else [obj]):
                specs.append(ScenarioSpec.from_dict(d))
        except (TypeError, ValueError, KeyError) as e:
            raise SystemExit(f"{cmd}: bad spec in {path}: {e}")
    return specs


def _scenario(args):
    """Batched stress tests over a guarded risk-state checkpoint: factor
    shocks, vol-regime multipliers, correlation stress, historical replay
    and quarantine counterfactuals, one batched call per S-bucket on
    ``--device``.  ``run`` writes an atomic ``scenario_manifest.json``
    beside the checkpoint, which ``doctor --scenarios`` audits; ``list``
    prints the preset catalog; ``sweep`` streams a sampled sweep."""
    import sys

    from mfm_tpu_torch.scenario import (
        PRESET_NOTES,
        PRESETS,
        ScenarioEngine,
        build_scenario_manifest,
        write_scenario_manifest,
    )

    if args.scmd == "list":
        catalog = [{"name": n, "note": PRESET_NOTES.get(n, ""),
                    "kinds": list(PRESETS[n].kinds),
                    "spec": PRESETS[n].to_dict()}
                   for n in sorted(PRESETS)]
        print(json.dumps({"presets": catalog}, indent=1))
        return
    if args.scmd == "sweep":
        _scenario_sweep(args)
        return

    from mfm_tpu_torch._device import resolve_device
    from mfm_tpu_torch.obs.instrument import scenario_summary_from_registry
    from mfm_tpu_torch.obs.trace import end_span

    device = resolve_device(args.device)
    _metrics_init(args)
    root = _root_span(args)
    state, meta = _load_state_or_exit(args, "scenario", device)
    specs = _spec_list(args, "scenario")
    if not specs:
        raise SystemExit("scenario run: no scenarios given — use --preset "
                         "and/or --spec (`mfm-tpu scenario list` shows the "
                         "catalog)")

    try:
        engine = ScenarioEngine.from_risk_state(state, meta, device=device)
        results = engine.run(specs, bucket=args.bucket)
    except ValueError as e:
        raise SystemExit(f"scenario: {e}")

    out_dir = args.out or (os.path.dirname(args.state) or ".")
    # a fresh --out must exist as a DIRECTORY before the manifest write:
    # write_scenario_manifest treats a non-dir path as the file itself
    os.makedirs(out_dir, exist_ok=True)
    # the root trace id rides in the summary block, the one volatile
    # manifest field
    summary = scenario_summary_from_registry()
    summary["trace_id"] = root.trace_id
    manifest = build_scenario_manifest(
        results, engine.factor_names, stamp_json=meta.get("stamp"),
        backend=device.type, summary=summary, staleness=engine.staleness)
    mpath = write_scenario_manifest(out_dir, manifest)
    for r in results:
        line = {"scenario": r.spec.name, "status": r.status,
                "problems": list(r.problems),
                "psd_projected": bool(r.psd_projected)}
        if r.ok:
            line["min_eig_stressed"] = float(r.min_eig_stressed)
        print(json.dumps(line, sort_keys=True))
    end_span(root)
    _metrics_flush(args)
    print(json.dumps({"manifest": mpath, "n_scenarios": len(results),
                      "n_ok": manifest["n_ok"],
                      "n_rejected": manifest["n_rejected"],
                      "n_psd_projected": manifest["n_psd_projected"],
                      "trace_id": root.trace_id,
                      "kernels": _kernel_block()},
                     indent=1), file=sys.stderr)
    if manifest["n_ok"] == 0:
        raise SystemExit(1)


def _scenario_sweep(args):
    """Streaming scenario sweep over a guarded checkpoint: a sampler
    generates shock lanes host-side, chunks stream through the aggregate
    carry on ``--device``, the coarse top-k seeds a reverse-stress
    refinement, and the fixed-size answer lands in an atomic
    ``sweep_manifest.json`` audited by ``doctor --scenarios``."""
    import sys

    import numpy as np

    from mfm_tpu_torch._device import resolve_device
    from mfm_tpu_torch.grad.engine import ShockBall
    from mfm_tpu_torch.obs.instrument import sweep_summary_from_registry
    from mfm_tpu_torch.obs.trace import end_span
    from mfm_tpu_torch.scenario import (
        GridSampler,
        SobolSampler,
        SweepEngine,
        UniformSampler,
        build_sweep_manifest,
        write_sweep_manifest,
    )

    device = resolve_device(args.device)
    _metrics_init(args)
    root = _root_span(args)
    state, meta = _load_state_or_exit(args, "scenario", device)
    try:
        engine = SweepEngine.from_risk_state(state, meta, device=device)
    except ValueError as e:
        raise SystemExit(f"scenario: {e}")
    W = _grad_portfolios(args, engine)

    if not (args.n >= 1):
        raise SystemExit("scenario sweep: --n must be >= 1")
    ball = ShockBall(shift_max=args.shift_max,
                     scale_range=args.scale_range,
                     vol_mult_hi=args.vol_mult_max,
                     corr_beta_hi=args.corr_beta_max)
    try:
        if args.sampler == "grid":
            side = max(int(np.sqrt(args.n)), 1)
            sampler = GridSampler(ball, engine.K, n_vol=side, n_corr=side)
        elif args.sampler == "sobol":
            sampler = SobolSampler(ball, engine.K, args.n, seed=args.seed)
        else:
            sampler = UniformSampler(ball, engine.K, args.n,
                                     seed=args.seed)
        refine = None if args.no_refine else {"seed": args.seed}
        result = engine.sweep(W, sampler, chunk=args.chunk,
                              top_k=args.top_k, bins=args.bins,
                              hist_span=args.hist_span, ball=ball,
                              refine=refine)
    except ValueError as e:
        raise SystemExit(f"scenario sweep: {e}")
    dominance = engine.preset_dominance(result, W)

    out_dir = args.out or (os.path.dirname(args.state) or ".")
    os.makedirs(out_dir, exist_ok=True)
    # the trace id rides in the summary block, the one volatile manifest
    # field, so seeded re-runs stay byte-equal modulo summary
    summary = sweep_summary_from_registry()
    summary["trace_id"] = root.trace_id
    manifest = build_sweep_manifest(
        result, stamp_json=meta.get("stamp"), backend=device.type,
        staleness=engine.staleness, dominance=dominance, summary=summary)
    mpath = write_sweep_manifest(out_dir, manifest)
    for book, dom in zip(result.books, dominance):
        top = book["top"][0] if book["top"] else None
        line = {"book": book["label"], "vol_base": book["vol_base"],
                "vol_worst": top["vol"] if top else None,
                "worst_spec_hash": top["spec_hash"] if top else None,
                "dominates_presets": dom["dominates_all"]}
        print(json.dumps(line, sort_keys=True))
    end_span(root)
    _metrics_flush(args)
    print(json.dumps({"manifest": mpath, "counts": result.counts,
                      "sampler": result.sampler,
                      "trace_id": root.trace_id,
                      "kernels": _kernel_block()},
                     indent=1), file=sys.stderr)
    if result.counts["n_ok"] == 0:
        raise SystemExit(1)


def _grad_portfolios(args, engine):
    """(P, K) portfolio rows off ``--portfolio`` JSON — one K-vector, a
    list of them, or factor-name-keyed dicts; default is ONE equal-weight
    portfolio over the engine's factors."""
    import numpy as np

    path = getattr(args, "portfolio", None)
    if path is None:
        return np.full((1, engine.K), 1.0 / engine.K)
    try:
        with open(path, encoding="utf-8") as fh:
            obj = json.load(fh)
    except (OSError, ValueError) as e:
        raise SystemExit(f"grad: cannot read portfolio file {path}: {e}")
    rows = obj if isinstance(obj, list) else [obj]
    if rows and isinstance(rows[0], (int, float)):
        rows = [rows]
    W = np.zeros((len(rows), engine.K))
    for i, row in enumerate(rows):
        if isinstance(row, dict):
            for k, v in row.items():
                if str(k) not in engine.factor_index:
                    raise SystemExit(f"grad: portfolio row {i} names "
                                     f"unknown factor {k!r}")
                try:
                    W[i, engine.factor_index[str(k)]] = float(v)
                except (TypeError, ValueError) as e:
                    raise SystemExit(f"grad: bad weight in row {i}: {e}")
        else:
            try:
                r = np.asarray(row, np.float64)
            except (TypeError, ValueError) as e:
                raise SystemExit(f"grad: bad portfolio row {i}: {e}")
            if r.shape != (engine.K,):
                raise SystemExit(f"grad: portfolio row {i} is {r.shape}, "
                                 f"need ({engine.K},)")
            W[i] = r
    if not np.isfinite(W).all():
        raise SystemExit(f"grad: non-finite weights in {path}")
    return W


def _grad(args):
    """Differentiable risk over a guarded checkpoint: ``reverse`` finds the
    worst admissible shock per portfolio, ``sensitivity`` stamps exact
    d vol/d shock + d vol/d exposure rows into the scenario manifest,
    ``construct`` runs the min-vol / risk-parity / hedge solvers.  Every
    subcommand writes an atomic ``grad_report.json`` beside the
    checkpoint."""
    import sys

    import numpy as np

    from mfm_tpu_torch._device import resolve_device
    from mfm_tpu_torch.grad import GradEngine, ShockBall, write_grad_report
    from mfm_tpu_torch.grad.report import build_grad_report
    from mfm_tpu_torch.obs.trace import end_span

    device = resolve_device(args.device)
    _metrics_init(args)
    root = _root_span(args)
    state, meta = _load_state_or_exit(args, "grad", device)
    try:
        engine = GradEngine.from_risk_state(state, meta, device=device)
    except ValueError as e:
        raise SystemExit(f"grad: {e}")
    W = _grad_portfolios(args, engine)
    out_dir = args.out or (os.path.dirname(args.state) or ".")
    os.makedirs(out_dir, exist_ok=True)

    if args.gcmd == "reverse":
        from mfm_tpu_torch.grad.engine import REVERSE_STEPS

        ball = ShockBall(vol_mult_hi=args.vol_mult_max,
                         corr_beta_hi=args.corr_beta_max)
        steps = REVERSE_STEPS if args.steps is None else args.steps
        try:
            entries = engine.reverse_stress(W, ball=ball, steps=steps,
                                            bucket=args.bucket)
        except ValueError as e:
            raise SystemExit(f"grad: {e}")
        kind = "reverse_stress"
        params = {"ball": ball.to_dict(), "steps": int(steps)}
        failed = sum(1 for e in entries if not e["admissible"])
    elif args.gcmd == "sensitivity":
        from mfm_tpu_torch.scenario import PRESETS, ScenarioSpec

        specs = _spec_list(args, "grad") or (
            [ScenarioSpec.identity()] + [PRESETS[n] for n in sorted(PRESETS)])
        try:
            entries = engine.sensitivities(specs, W[0], bucket=args.bucket)
        except ValueError as e:
            raise SystemExit(f"grad: {e}")
        # stamp the rows into the scenario manifest too: the forward batch
        # runs first (same specs, same bucket) and each ok entry gains a
        # "sensitivity" block
        from mfm_tpu_torch.obs.instrument import (
            scenario_summary_from_registry,
        )
        from mfm_tpu_torch.scenario import (
            ScenarioEngine,
            build_scenario_manifest,
            write_scenario_manifest,
        )
        scen = ScenarioEngine.from_risk_state(state, meta, device=device)
        try:
            results = scen.run(specs, bucket=args.bucket)
        except ValueError as e:
            raise SystemExit(f"grad: {e}")
        summary = scenario_summary_from_registry()
        summary["trace_id"] = root.trace_id
        manifest = build_scenario_manifest(
            results, scen.factor_names, stamp_json=meta.get("stamp"),
            backend=device.type, summary=summary, staleness=scen.staleness,
            sensitivities={e["name"]: e for e in entries})
        write_scenario_manifest(out_dir, manifest)
        kind = "sensitivity"
        params = {"portfolio": np.asarray(W[0], np.float64).tolist()}
        failed = sum(1 for e in entries if e["status"] != "ok")
    else:
        try:
            res = engine.construct_solve(args.solver, W, bucket=args.bucket)
        except ValueError as e:
            raise SystemExit(f"grad: {e}")
        entries = []
        for i in range(W.shape[0]):
            diag = np.asarray(res["diag"][i])
            entries.append({
                "label": f"p{i}",
                "solver": args.solver,
                "weights": {str(n): float(v) for n, v in
                            zip(engine.factor_names, res["weights"][i])},
                "total_vol": float(res["vols"][i]),
                "diag": diag.tolist() if diag.ndim else float(diag),
            })
        kind = "construct"
        params = {"solver": args.solver}
        failed = 0

    report = build_grad_report(kind, entries, stamp_json=meta.get("stamp"),
                               backend=device.type,
                               staleness=engine.staleness, params=params)
    rpath = write_grad_report(out_dir, report)
    for e in entries:
        print(json.dumps(e, sort_keys=True, default=str))
    end_span(root)
    _metrics_flush(args)
    print(json.dumps({"report": rpath, "grad_kind": kind,
                      "n_entries": len(entries), "n_failed": failed,
                      "trace_id": root.trace_id,
                      "kernels": _kernel_block()},
                     indent=1), file=sys.stderr)
    if entries and failed == len(entries):
        raise SystemExit(1)


# -- metrics --------------------------------------------------------------------

def _metrics_paths(path: str, filename: str) -> str:
    """Resolve a metrics artifact: PATH itself when it's a file, else
    PATH/<filename>."""
    p = os.path.join(path, filename) if os.path.isdir(path) else path
    if not os.path.exists(p):
        raise SystemExit(f"{p}: not found — run with --metrics-dir first")
    return p


def _load_metrics_snapshot(path: str) -> dict:
    p = _metrics_paths(path, "metrics.json")
    try:
        with open(p, encoding="utf-8") as fh:
            snap = json.load(fh)
    except ValueError as err:
        raise SystemExit(f"{p}: not valid JSON ({err})") from err
    if not isinstance(snap, dict) or snap.get("schema") != 1 \
            or not isinstance(snap.get("metrics"), dict):
        raise SystemExit(f"{p}: not a metrics snapshot (schema 1)")
    return snap


def _snapshot_scalars(snap: dict) -> dict:
    """Flatten a snapshot to {series key -> value} for diffing: counters/
    gauges by value, histograms by their _count and _sum."""
    out = {}
    for name, m in snap["metrics"].items():
        for s in m.get("series", []):
            lbl = ",".join(f"{k}={v}" for k, v in sorted(s["labels"].items()))
            key = f"{name}{{{lbl}}}" if lbl else name
            if m.get("type") == "histogram":
                out[key + ":count"] = s.get("count", 0)
                out[key + ":sum"] = s.get("sum", 0.0)
            else:
                out[key] = s.get("value")
    return out


def _fleet_manifest_scalars(man: dict) -> dict | None:
    """Flatten a merged fleet manifest (or the run manifest embedding
    one) into diffable series keys, or None when ``man`` is not one.
    Each replica shard contributes ``r{idx}:``-prefixed series (delivered
    outcomes + transport counters), so a diff of two fleet runs shows
    per-worker drift, not just the merged totals."""
    fm = man.get("fleet")
    if not isinstance(fm, dict):
        fm = man if {"replicas", "audit"} <= set(man) else None
    if fm is None:
        return None
    out = {}
    snap = man.get("metrics")
    if isinstance(snap, dict) and snap.get("schema") == 1 \
            and isinstance(snap.get("metrics"), dict):
        out.update(_snapshot_scalars(snap))
    out["fleet:accepted_total"] = fm.get("accepted_total")
    for k, v in (fm.get("transport") or {}).items():
        out[f"fleet:transport:{k}"] = v
    for k, v in ((fm.get("frontend_local") or {}).get("outcomes")
                 or {}).items():
        out[f"fleet:frontend_local:{k}"] = v
    for rep in fm.get("replicas") or []:
        i = rep.get("replica")
        out[f"r{i}:outcomes_total"] = rep.get("outcomes_total")
        for k, v in (rep.get("outcomes") or {}).items():
            out[f"r{i}:outcomes:{k}"] = v
        tp = rep.get("transport")
        if isinstance(tp, dict):
            for k, v in sorted(tp.items()):
                if isinstance(v, (int, float)):
                    out[f"r{i}:transport:{k}"] = v
    return out


def _metrics_diff_side(path: str) -> dict:
    """One side of ``metrics diff``: a metrics snapshot (file or
    --metrics-dir) or a merged ``fleet_manifest.json``."""
    p = os.path.join(path, "metrics.json") if os.path.isdir(path) else path
    if not os.path.exists(p):
        raise SystemExit(f"{p}: not found — run with --metrics-dir first")
    try:
        with open(p, encoding="utf-8") as fh:
            obj = json.load(fh)
    except ValueError as err:
        raise SystemExit(f"{p}: not valid JSON ({err})") from err
    if isinstance(obj, dict):
        fleet = _fleet_manifest_scalars(obj)
        if fleet is not None:
            return fleet
        if obj.get("schema") == 1 and isinstance(obj.get("metrics"), dict):
            return _snapshot_scalars(obj)
    raise SystemExit(f"{p}: neither a metrics snapshot (schema 1) nor a "
                     "merged fleet manifest")


def _metrics(args):
    """dump: print + parse-validate the Prometheus textfile; snapshot:
    print the validated snapshot JSON; diff: per-series deltas between two
    snapshots — either side may also be a merged fleet manifest, whose
    replica shards diff as ``r{idx}:``-prefixed series."""
    from mfm_tpu_torch.obs.exporters import parse_prometheus

    if args.action == "dump":
        p = _metrics_paths(args.path, "metrics.prom")
        with open(p, encoding="utf-8") as fh:
            text = fh.read()
        parse_prometheus(text)  # malformed exposition exits via ValueError
        print(text, end="")
        return
    if args.action == "snapshot":
        print(json.dumps(_load_metrics_snapshot(args.path), indent=1,
                         sort_keys=True))
        return
    a = _metrics_diff_side(args.a)
    b = _metrics_diff_side(args.b)
    delta = {}
    for key in sorted(set(a) | set(b)):
        va, vb = a.get(key), b.get(key)
        if va != vb:
            delta[key] = {"a": va, "b": vb,
                          "delta": (None if va is None or vb is None
                                    else round(vb - va, 9))}
    print(json.dumps({"changed": len(delta), "series": delta}, indent=1))


# -- argument parsing -------------------------------------------------------------

_METRICS_DIR_HELP = (
    "write telemetry here: events.jsonl (structured event stream), "
    "metrics.prom (Prometheus textfile exposition), metrics.json "
    "(snapshot, diffable with `metrics diff`) and trace.json (the Chrome "
    "trace, with the program's stage spans).  The run manifest is independent of this flag — it always "
    "lands beside the checkpoint.")

#: ``--nw-lags``; the limit is ``ops/newey_west_cuda.MAX_Q``, which a model on
#: the card checks when it is built
_NW_LAGS_HELP = (
    "Newey-West lags q (default 2).  On the card the serial scan takes "
    "q <= 8 (its kernel's limit) and refuses more before any stage runs; "
    "--nw-method associative and --device cpu take any q")

# -- alpha ----------------------------------------------------------------------

def _read_long_table(path):
    """A csv/npz/parquet long table as a dict of numpy columns,
    ``trade_date`` as datetime64 where it parses (the reference's
    ``parse_dates=["trade_date"]``).  A csv or an npz (``prepare``'s
    panel) needs no pandas (the card's machine has none); parquet reads
    through pandas."""
    if path.endswith(".parquet"):
        import pandas as pd

        df = pd.read_parquet(path)
        return {c: df[c].to_numpy() for c in df.columns}
    if path.endswith(".npz"):
        from mfm_tpu_torch.data.etl import read_table

        return read_table(path)
    from mfm_tpu_torch.data.csvio import read_csv

    try:
        return read_csv(path, parse_dates=("trade_date",))
    except ValueError as err:
        raise SystemExit(str(err)) from err


def _extract_llm_sources(text, path, known_fields=None):
    """``--llm`` ingestion: tolerant extraction with per-line rejection
    reasons on stderr — stdout stays the command's single JSON line.
    Returns ``(sources, count-only report)``."""
    import sys

    from mfm_tpu_torch.alpha.llm import extract_expressions

    sources, rep = extract_expressions(text, known_fields=known_fields)
    for no, cand, reason in rep.pop("rejected"):
        print(f"{path}:{no}: skipped: {reason}", file=sys.stderr)
    return sources, rep


def _write_scorecard(path, exprs, columns) -> None:
    """The scorecard csv: one row per expression, ``expression`` first,
    then each column (numpy arrays; NaN as an empty cell), as
    ``DataFrame.to_csv`` writes it."""
    import csv

    import numpy as np

    def cell(v):
        if isinstance(v, np.floating) and np.isnan(v):
            return ""
        return str(v)  # a float in its own dtype's shortest form

    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["expression", *columns])
        for i, e in enumerate(exprs):
            w.writerow([e, *(cell(col[i]) for col in columns.values())])


def _alpha(args):
    """Batch alpha evaluation + scorecard over a long panel (the config-5
    workload from the command line): expressions from a text file, one
    per line, scored against next-traded-day returns, on ``--device``.
    ``--metrics-dir``'s ``trace.json`` holds ``cli.alpha`` over the
    evaluation (``alpha.batch``, an ``alpha.eval`` a chunk) and the
    scoring (``alpha.score``)."""
    import contextlib
    import sys
    import time

    import numpy as np
    import torch

    from mfm_tpu_torch._device import resolve_device
    from mfm_tpu_torch.alpha.dsl import compile_alpha, compile_alpha_batch
    from mfm_tpu_torch.alpha.metrics import alpha_summary
    from mfm_tpu_torch.obs.trace import end_span, stage
    from mfm_tpu_torch.panel import Panel
    from mfm_tpu_torch.pipeline import shift_ret_next_period

    # the card unless the caller asked for the CPU; raises without a card
    device = resolve_device(args.device)
    _metrics_init(args)
    root = _root_span(args)
    p = Panel.from_long(_read_long_table(args.panel))
    fields = {k: torch.as_tensor(v, dtype=torch.float32, device=device)
              for k, v in p.fields.items()}
    if args.fwd_field not in fields:
        raise SystemExit(f"panel has no field {args.fwd_field!r} "
                         f"(have: {sorted(fields)})")

    exprs = []
    llm_report = None
    # `--exprs -` reads stdin (generator | ... alpha --exprs - --panel ...)
    src = (contextlib.nullcontext(sys.stdin) if args.exprs == "-"
           else open(args.exprs))
    with src as fh:
        if args.llm:
            # raw chat output: tolerant extraction instead of fail-fast
            exprs, llm_report = _extract_llm_sources(
                fh.read(), args.exprs, known_fields=fields)
        else:
            for i, line in enumerate(fh, 1):
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                try:
                    # ast raises SyntaxError, the validator ValueError
                    e = compile_alpha(line)
                except (ValueError, SyntaxError) as err:
                    raise SystemExit(f"{args.exprs}:{i}: {err}") from err
                missing = [f for f in e.fields if f not in fields]
                if missing:
                    raise SystemExit(
                        f"{args.exprs}:{i}: panel has no field(s) {missing} "
                        f"(have: {sorted(fields)})")
                exprs.append(line)
    if not exprs:
        raise SystemExit(f"{args.exprs}: no expressions")
    observed = np.isfinite(np.asarray(p.fields[args.fwd_field]))
    fwd = torch.as_tensor(shift_ret_next_period(
        np.asarray(p.fields[args.fwd_field]), observed),
        dtype=torch.float32, device=device)

    t0 = time.perf_counter()
    values = compile_alpha_batch(exprs, chunk=args.chunk)(fields)
    with stage("alpha.score", device, exprs=len(exprs)):
        scores = alpha_summary(values, fwd, spread_q=args.spread_q)
    summary = {k: v.cpu().numpy() for k, v in scores.items()}
    columns = dict(summary)
    report: dict = {
        "n_exprs": len(exprs),
        "dates": int(values.shape[1]), "stocks": int(values.shape[2]),
    }
    if llm_report is not None:
        report["llm_extraction"] = llm_report
    if args.select is not None:
        # greedy top-k under the PnL-correlation cap, ranked by |mean IC|
        # (the scorecard's own); the scorecard gains selection columns and
        # the chosen expressions land in --select-out, one per line
        from mfm_tpu_torch.alpha.select import select_alphas

        sel = select_alphas(values, fwd, args.select,
                            max_corr=args.max_corr, min_score=args.min_ic,
                            q=args.spread_q,
                            scores=np.abs(summary["mean_ic"]))
        columns["selected"] = np.zeros(len(exprs), bool)
        columns["select_rank"] = np.full(len(exprs), -1)
        columns["select_max_corr"] = np.full(len(exprs), np.nan)
        for rank, (i, c) in enumerate(
                zip(sel["indices"], sel["max_corr_to_selected"])):
            columns["selected"][i] = True
            columns["select_rank"][i] = rank
            columns["select_max_corr"][i] = c
        if args.select_out:
            with open(args.select_out, "w") as fh:
                fh.writelines(exprs[i] + "\n" for i in sel["indices"])
            report["select_out"] = args.select_out
        report["n_selected"] = len(sel["indices"])
        report["n_rejected_by_corr"] = len(sel["rejected"])
    if args.values_out:
        # the evaluated alpha panels as a long parquet table (trade_date,
        # ts_code, one column per expression), restricted to the selection
        # when --select ran; gathered on the device before the host copy
        keep = (list(sel["indices"]) if args.select is not None
                else list(range(len(exprs))))
        vals = (values[torch.as_tensor(keep, device=device)].cpu().numpy()
                if keep else np.empty((0,) + values.shape[1:], np.float32))
        out_panel = Panel(
            dates=p.dates, stocks=p.stocks,
            fields={f"alpha_{i:04d}": vals[j] for j, i in enumerate(keep)})
        out_panel.to_long(dropna=False).to_parquet(args.values_out,
                                                   index=False)
        with open(args.values_out + ".exprs.txt", "w") as fh:
            fh.writelines(f"alpha_{i:04d}\t{exprs[i]}\n" for i in keep)
        report["values_out"] = args.values_out
    wall = time.perf_counter() - t0
    _write_scorecard(args.out, exprs, columns)
    report.update({
        "wall_s": round(wall, 3), "out": args.out, "device": str(device),
        "best_mean_ic": float(np.nanmax(summary["mean_ic"])),
        "trace_id": root.trace_id,
    })
    end_span(root, wall_s=round(wall, 3))
    _metrics_flush(args)
    print(json.dumps(report))


def _positive_int(v):
    iv = int(v)
    if iv < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {v}")
    return iv


def _alpha_parser(sub) -> None:
    al = sub.add_parser("alpha",
                        help="batch alpha-expression evaluation + scorecard "
                             "(bench config 5)")
    al.add_argument("--exprs", required=True,
                    help="text file, one expression per line (# = comment); "
                         "'-' reads stdin (pipe an LLM's output straight in)")
    al.add_argument("--panel", required=True,
                    help="long csv/parquet with ts_code/trade_date + fields")
    al.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to compute: the CUDA card (default; raises "
                         "without one) or the CPU")
    al.add_argument("--out", default="alpha_scores.csv")
    al.add_argument("--fwd-field", default="ret",
                    help="field whose next-traded-day value is the target")
    al.add_argument("--spread-q", type=float, default=0.2)
    al.add_argument("--chunk", type=int, default=1000,
                    help="expressions evaluated per group")
    al.add_argument("--select", type=_positive_int, default=None, metavar="K",
                    help="greedily pick the K best expressions (by |mean "
                         "IC|) whose pairwise long-short-PnL correlation "
                         "stays under --max-corr")
    al.add_argument("--max-corr", type=float, default=0.7,
                    help="redundancy cap for --select")
    al.add_argument("--min-ic", type=float, default=0.0,
                    help="--select floor: candidates with |mean IC| below "
                         "this never join, even under k")
    al.add_argument("--select-out", default=None, metavar="FILE.txt",
                    help="write the selected expressions here, one per line")
    al.add_argument("--values-out", default=None, metavar="FILE.parquet",
                    help="write the evaluated alpha panels as a long table "
                         "(selected expressions when --select ran, else "
                         "all) + a FILE.exprs.txt column map (needs pandas)")
    al.add_argument("--llm", action="store_true",
                    help="treat --exprs as RAW LLM output (markdown fences, "
                         "numbered lists, `name = expr` labels, prose): "
                         "extract every valid DSL expression, dedup, and "
                         "report what was rejected instead of failing fast")
    al.add_argument("--metrics-dir", default=None, metavar="DIR",
                    help="write telemetry here: events.jsonl, metrics.prom, "
                         "metrics.json and trace.json (the Chrome trace: "
                         "the run's evaluation and scoring spans, on the "
                         "card with their seconds on the device)")
    al.set_defaults(fn=_alpha)


def _device_arg(p) -> None:
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where to compute: the CUDA card (default; raises "
                        "without one) or the CPU")


def _eigen_chunk(v):
    if v == "auto":
        return "auto"
    if v in ("none", "full"):
        return None
    return _positive_int(v)


def _risk_parser(sub) -> None:
    r = sub.add_parser("risk", help="risk model over a barra-format CSV "
                                    "(demo.py path)")
    rsrc = r.add_mutually_exclusive_group(required=True)
    rsrc.add_argument("--barra", help="barra-format CSV (demo.py:22)")
    rsrc.add_argument("--barra-store", metavar="STORE",
                      help="read the barra table from a store's "
                           "barra_factors collection (written by `pipeline "
                           "--to-store`) instead of a CSV")
    _device_arg(r)
    r.add_argument("--industry-info", default=None)
    r.add_argument("--out", default="results")
    r.add_argument("--nw-lags", type=int, default=2, help=_NW_LAGS_HELP)
    r.add_argument("--nw-half-life", type=float, default=252.0)
    r.add_argument("--nw-method", choices=["scan", "associative"],
                   default="scan",
                   help="expanding Newey-West evaluation: the serial scan "
                        "(the default) or the associative prefix scan "
                        "(O(log T) passes; no resumable state)")
    r.add_argument("--eigen-sims", type=int, default=100)
    r.add_argument("--eigen-scale", type=float, default=1.4)
    r.add_argument("--vr-half-life", type=float, default=42.0)
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--dtype", default="float32")
    r.add_argument("--bias-plot", default=None, metavar="FILE.png",
                   help="also render the USE4 bias-statistic plot into OUT "
                        "(needs matplotlib) and write the numbers to "
                        "OUT/bias_stats.json")
    r.add_argument("--bias-burn-in", type=int, default=252,
                   help="dates excluded from the burn-in-free bias variant")
    r.add_argument("--specific-risk", action="store_true",
                   help="also write specific_risk.csv (shrunk EWMA "
                        "specific vol per stock x date)")
    r.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a torch.profiler trace of the pipeline "
                        "run into DIR (trace.json, Perfetto-viewable; the "
                        "device's activity on the card) with "
                        "profile_summary.json (wall, device time, busy "
                        "share, peak memory)")
    r.add_argument("--jax-profile", default=None, metavar="DIR",
                   help="synonym of --profile (the reference's flag name)")
    r.add_argument("--eigen-chunk", type=_eigen_chunk, default="auto",
                   metavar="N|auto|none",
                   help="date-chunk size for the eigen Monte-Carlo stream "
                        "(bounds its (chunk, M, K, K) transient); 'auto' "
                        "(default) sizes it from free device memory, "
                        "'none' forces the single full batch, an int pins "
                        "it.  Results are identical either way")
    r.add_argument("--eigen-sim-length", type=_positive_int, default=None,
                   metavar="L",
                   help="draw length behind each simulated covariance "
                        "(default: the panel length T).  Pin it when "
                        "serving incrementally: a checkpoint freezes its "
                        "Monte-Carlo draws, and only a pinned length keeps "
                        "a from-scratch rerun on the same draws")
    r.add_argument("--eigen-mc-dtype", choices=["bfloat16"], default=None,
                   help="storage dtype for the eigen Monte-Carlo draws and "
                        "the scaled-covariance assembly (eigh and "
                        "accumulation stay float32); outputs change within "
                        "tools/parity_budget.json's eigen_mc_bf16 budget, "
                        "not bitwise")
    r.add_argument("--eigen-incremental", action="store_true",
                   help="causal incremental eigen: each date's Monte-Carlo "
                        "bias uses exactly the draw prefix available at "
                        "that date, and the raw draw moments ride the "
                        "checkpoint, so `--update` appends a date with one "
                        "simulated eigh batch.  Incompatible with "
                        "--eigen-sim-length")
    r.add_argument("--save-state", default=None, metavar="FILE.npz",
                   help="also checkpoint the resumable state (Newey-West/"
                        "vol-regime carries + frozen eigen draws) after the "
                        "last date, with run_manifest.json beside it; "
                        "`risk --update FILE.npz` then serves each new date "
                        "without an O(T) rebuild")
    r.add_argument("--update", default=None, metavar="FILE.npz",
                   help="incremental serve: load this checkpoint, run ONE "
                        "update step over the barra table's dates after the "
                        "checkpoint's last date, write tables for those "
                        "dates only, and advance FILE in place.  Outputs "
                        "are bitwise the full-history run's")
    r.add_argument("--save-outputs", action="store_true",
                   help="also write OUT/risk_outputs.npz (every stage "
                        "output incl. the full covariance series — the "
                        "CSVs carry only the last date's)")
    r.add_argument("--portfolio-bias", type=_positive_int, default=None,
                   metavar="Q",
                   help="also run the USE4 random-portfolio bias acceptance "
                        "test with Q portfolios and write "
                        "OUT/portfolio_bias.json")
    r.add_argument("--portfolio", default=None, metavar="CSV",
                   help="ts_code,weight table: write predicted portfolio "
                        "risk + per-factor Euler attribution to "
                        "OUT/portfolio_risk.json")
    r.add_argument("--portfolio-date", type=int, default=-1,
                   help="date index for --portfolio (default: last)")
    r.add_argument("--mesh", default=None, metavar="DxS",
                   help="compute on a DATExSTOCK device mesh (e.g. 2x2): "
                        "panels are built shard-local and the risk stack "
                        "runs sharded, bitwise the single-device run; with "
                        "--update the slab must divide the mesh exactly.  "
                        "On one device bring up a virtual mesh with "
                        "MFM_TORCH_VIRTUAL_DEVICES=N")
    r.add_argument("--quarantine", action="store_true",
                   help="guard appended dates (NaN density, universe "
                        "collapse, MAD outliers, bad caps, date order) and "
                        "serve quarantined dates in degraded mode: last "
                        "healthy covariance + staleness, carries frozen")
    r.add_argument("--force", action="store_true",
                   help="with --update: accept a checkpoint whose "
                        "generation is older than the latest.json pointer "
                        "(deliberate rollback; never bypasses the checksum)")
    r.add_argument("--metrics-dir", default=None, metavar="DIR",
                   help=_METRICS_DIR_HELP)
    r.set_defaults(fn=_risk)


def _risk_flags(p) -> None:
    """The risk-model flags ``pipeline`` shares with ``risk``."""
    p.add_argument("--nw-lags", type=int, default=2, help=_NW_LAGS_HELP)
    p.add_argument("--nw-half-life", type=float, default=252.0)
    p.add_argument("--nw-method", choices=["scan", "associative"],
                   default="scan",
                   help="expanding Newey-West evaluation: the serial scan "
                        "(the default) or the associative prefix scan "
                        "(O(log T) passes; no resumable state)")
    p.add_argument("--eigen-sims", type=int, default=100)
    p.add_argument("--eigen-scale", type=float, default=1.4)
    p.add_argument("--eigen-chunk", type=_eigen_chunk, default="auto",
                   metavar="N|auto|none",
                   help="date-chunk size for the eigen Monte-Carlo stream; "
                        "results are identical either way")
    p.add_argument("--eigen-sim-length", type=_positive_int, default=None,
                   metavar="L",
                   help="draw length behind each simulated covariance "
                        "(default: the panel length T); pin it when "
                        "appending, so a from-scratch rerun draws the same "
                        "sims")
    p.add_argument("--eigen-mc-dtype", choices=["bfloat16"], default=None,
                   help="storage dtype for the eigen Monte-Carlo draws")
    p.add_argument("--eigen-incremental", action="store_true",
                   help="causal incremental eigen (see `risk --help`)")
    p.add_argument("--vr-half-life", type=float, default=42.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", default="float32")


def _store_parsers(sub) -> None:
    from mfm_tpu_torch.ops.rolling import ROLLING_IMPLS

    pp = sub.add_parser("prepare",
                        help="store -> master-panel artifacts "
                             "(load_and_prepare_data path)")
    pp.add_argument("--store", required=True)
    pp.add_argument("--out", default="prepared")
    pp.add_argument("--index-code", default="000300.SH")
    pp.add_argument("--start", default="20200101")
    pp.add_argument("--end", default=None)
    pp.add_argument("--fin-start", default="20190101")
    pp.set_defaults(fn=_prepare)

    pl = sub.add_parser("pipeline",
                        help="one command: raw store -> factors -> risk "
                             "outputs (main.py + demo.py chain)")
    pl.add_argument("--store", required=True)
    pl.add_argument("--out", default="results")
    pl.add_argument("--index-code", default="000300.SH")
    pl.add_argument("--start", default="20200101")
    pl.add_argument("--end", default=None)
    pl.add_argument("--fin-start", default="20190101")
    _device_arg(pl)
    pl.add_argument("--resume", action="store_true",
                    help="reuse the barra_data.csv stage artifact if present")
    pl.add_argument("--append", action="store_true",
                    help="daily refresh: re-run the factor stage over the "
                         "(updated) store, then serve only the dates past "
                         "OUT/risk_state.npz's checkpoint with ONE update "
                         "step and splice them onto OUT's artifacts — OUT "
                         "ends up bitwise identical to a from-scratch risk "
                         "stage, in O(new dates) instead of O(history)")
    pl.add_argument("--to-store", default=None, metavar="STORE",
                    help="also save barra_factors + "
                         "sw_industry_info_for_factors collections into this "
                         "store, readable by `risk --barra-store`")
    pl.add_argument("--mesh", default=None, metavar="DxS",
                    help="run the --append update step on a DATExSTOCK "
                         "device mesh (slab sharded, state replicated; "
                         "bitwise the single-device update)")
    _risk_flags(pl)
    pl.add_argument("--block", type=int, default=None,
                    help="rolling-kernel date-block size; default: auto "
                         "from the panel width")
    pl.add_argument("--rolling-impl", choices=ROLLING_IMPLS, default="scan",
                    help="rolling-kernel implementation: O(T*N) two-level "
                         "scans (default) or the windowed-gather form")
    pl.add_argument("--specific-risk", action="store_true",
                    help="also write specific_risk.csv (shrunk EWMA "
                         "specific vol per stock x date)")
    pl.add_argument("--profile", default=None, metavar="DIR",
                    help="capture a torch.profiler trace spanning the "
                         "factor and risk stages into DIR, with "
                         "profile_summary.json (wall, device time, busy "
                         "share, peak memory)")
    pl.add_argument("--jax-profile", default=None, metavar="DIR",
                    help="synonym of --profile (the reference's flag name)")
    pl.add_argument("--portfolio-bias", type=_positive_int, default=None,
                    metavar="Q",
                    help="also run the USE4 random-portfolio bias acceptance "
                         "test with Q portfolios and write "
                         "OUT/portfolio_bias.json")
    pl.add_argument("--bias-burn-in", type=int, default=252,
                    help="dates excluded from the burn-in-free bias scope")
    pl.add_argument("--portfolio", default=None, metavar="CSV",
                    help="ts_code,weight table: write predicted portfolio "
                         "risk + per-factor Euler attribution to "
                         "OUT/portfolio_risk.json")
    pl.add_argument("--portfolio-date", type=int, default=-1,
                    help="date index for --portfolio (default: last)")
    pl.add_argument("--alphas", default=None, metavar="FILE",
                    help="alpha-DSL expressions (one per line): evaluate on "
                         "the raw panel, select the best de-correlated "
                         "--alpha-top, and price them as extra style "
                         "factors (report: OUT/alpha_styles.json)")
    pl.add_argument("--alphas-llm", action="store_true",
                    help="treat --alphas as raw LLM output (tolerant "
                         "extraction instead of one-expression-per-line)")
    pl.add_argument("--alpha-top", type=_positive_int, default=5,
                    help="max alpha styles to keep (default 5)")
    pl.add_argument("--alpha-max-corr", type=float, default=0.7,
                    help="pairwise PnL-correlation cap for alpha selection")
    pl.add_argument("--quarantine", action="store_true",
                    help="guard appended dates and serve quarantined ones "
                         "in degraded mode (last healthy covariance + "
                         "staleness, carries frozen)")
    pl.add_argument("--force", action="store_true",
                    help="with --append: accept a checkpoint whose "
                         "generation is older than the latest.json pointer "
                         "(deliberate rollback; never bypasses the checksum)")
    pl.add_argument("--metrics-dir", default=None, metavar="DIR",
                    help=_METRICS_DIR_HELP)
    pl.set_defaults(fn=_pipeline)

    ex = sub.add_parser("etl-xlsx",
                        help="ingest the shipped static workbooks "
                             "(index_list.xlsx / industry_index_data.xlsx "
                             "Wind EDB export) into store collections")
    ex.add_argument("--store", required=True)
    ex.add_argument("--index-list", default=None, metavar="XLSX")
    ex.add_argument("--industry-index", default=None, metavar="XLSX")
    ex.add_argument("--sheets", default="0,1",
                    help="industry workbook sheet indices (default: CITIC "
                         "and SW L1)")
    ex.set_defaults(fn=_etl_xlsx)

    eu = sub.add_parser("etl-update",
                        help="calendar-driven refresh of all collections "
                             "(update_mongo_db.py __main__ path)")
    eu.add_argument("--store", required=True)
    eu.add_argument("--start", required=True, help="yyyymmdd")
    eu.add_argument("--end", default=None, help="yyyymmdd (default: today)")
    eu.add_argument("--index-codes",
                    default="000300.SH,000016.SH,000903.SH",
                    help="comma list (CSI300/SSE50/CSI100)")
    eu.add_argument("--statements",
                    default="balancesheet,cashflow,income,"
                            "financial_indicators",
                    help="comma list of statement kinds; empty to skip")
    eu.add_argument("--components-date", default=None,
                    help="refresh index components at this yyyymmdd date")
    eu.add_argument("--no-sw", action="store_true",
                    help="skip the SW industry refresh")
    eu.add_argument("--sw-csv", default=None,
                    help="load SW industries from this CSV instead of the "
                         "per-stock API")
    eu.add_argument("--calls-per-min", type=int, default=480)
    eu.add_argument("--token", default=None,
                    help="tushare token (default: TUSHARE_TOKEN env)")
    eu.add_argument("--dry-run", action="store_true",
                    help="print the per-collection fetch plan (watermarks, "
                         "ranges, call counts) without touching the API")
    eu.set_defaults(fn=_etl_update)

    ev = sub.add_parser("etl-verify",
                        help="store sanity counters (verify_data.py path)")
    ev.add_argument("--store", required=True)
    ev.add_argument("--name", default="daily_prices")
    ev.add_argument("--code-col", default="ts_code")
    ev.add_argument("--date-col", default="trade_date")
    ev.add_argument("--diagnose", action="store_true",
                    help="per-stock statement QC on --name (missing/dup "
                         "announcement keys, ann-before-period-end)")
    ev.add_argument("--ann-col", default="f_ann_date")
    ev.add_argument("--end-col", default="end_date")
    ev.set_defaults(fn=_etl_verify)

    em = sub.add_parser("etl-missing",
                        help="stocks in the universe with no price rows "
                             "(fill_missing_data.py path)")
    em.add_argument("--store", required=True)
    em.add_argument("--universe", default="stock_info")
    em.add_argument("--name", default="daily_prices")
    em.add_argument("--code-col", default="ts_code")
    em.add_argument("--fix", action="store_true",
                    help="refetch the missing stocks' prices "
                         "(fill_missing_data.py's repair step)")
    em.add_argument("--start", default="20200101", help="repair range start")
    em.add_argument("--end", default=None, help="repair range end (today)")
    em.add_argument("--calls-per-min", type=int, default=480)
    em.add_argument("--token", default=None)
    em.set_defaults(fn=_etl_missing)


def _factors_demo_parsers(sub) -> None:
    from mfm_tpu_torch.ops.rolling import ROLLING_IMPLS

    f = sub.add_parser("factors",
                       help="style-factor production (main.py path)")
    f.add_argument("--prepared", default=None, metavar="DIR",
                   help="a `prepare` output directory (provides --panel/"
                        "--index/--industry in one flag; its panel.npz, or "
                        "a reference-written panel.parquet read through "
                        "pandas)")
    f.add_argument("--panel", default=None,
                   help="long csv/npz/parquet of raw fields")
    f.add_argument("--index", default=None,
                   help="index daily prices csv/parquet")
    f.add_argument("--industry", default=None, help="ts_code -> l1_code csv")
    _device_arg(f)
    f.add_argument("--out", default="results")
    f.add_argument("--dtype", default="float32")
    f.add_argument("--block", type=int, default=None,
                   help="rolling-kernel date-block size (memory = block x "
                        "window x stocks floats per input); default: auto "
                        "from the panel width")
    f.add_argument("--rolling-impl", choices=ROLLING_IMPLS, default="scan",
                   help="rolling-kernel implementation: O(T*N) two-level "
                        "scans (default) or the windowed-gather form")
    f.set_defaults(fn=_factors)

    d = sub.add_parser("demo", help="synthetic end-to-end risk model")
    d.add_argument("--dates", type=int, default=120)
    d.add_argument("--stocks", type=int, default=60)
    d.add_argument("--industries", type=int, default=6)
    d.add_argument("--styles", type=int, default=4)
    d.add_argument("--eigen-sims", type=int, default=16)
    d.add_argument("--out", default="results")
    d.add_argument("--dtype", default="float32")
    _device_arg(d)
    d.add_argument("--check-determinism", action="store_true",
                   help="run the pipeline twice more and report whether "
                        "outputs are bitwise identical (the same-seed "
                        "sanitizer)")
    d.set_defaults(fn=_demo)


def _scenario_grad_parsers(sub) -> None:
    sc = sub.add_parser(
        "scenario",
        help="batched stress tests over a guarded risk-state checkpoint: "
             "factor shocks, vol regimes, correlation stress, historical "
             "replay, quarantine counterfactuals — one batched call per "
             "S-bucket, atomic scenario_manifest.json beside the "
             "checkpoint")
    scs = sc.add_subparsers(dest="scmd", required=True)
    scs.add_parser("list", help="print the preset scenario catalog")
    scr = scs.add_parser(
        "run", help="run scenarios against a checkpoint and write "
                    "scenario_manifest.json beside it")
    scr.add_argument("state", help="risk-state .npz saved with quarantine "
                                   "enabled (scenarios shock its "
                                   "last_good_cov)")
    _device_arg(scr)
    scr.add_argument("--preset", action="append", default=[],
                     help="preset scenario name, repeatable "
                          "(`scenario list` shows the catalog)")
    scr.add_argument("--spec", action="append", default=[],
                     help="JSON ScenarioSpec file — one spec object or a "
                          "list of them (repeatable)")
    scr.add_argument("--out", default=None,
                     help="directory for scenario_manifest.json (default: "
                          "beside the checkpoint)")
    scr.add_argument("--bucket", type=int, default=None,
                     help="explicit pad bucket >= the number of scenarios "
                          "(default: the geometric bucket for S)")
    scr.add_argument("--metrics-dir", default=None, help=_METRICS_DIR_HELP)
    scw = scs.add_parser(
        "sweep", help="stream a sampler-generated scenario sweep through "
                      "fixed-size aggregates (top-k worst, quantile "
                      "sketch), refine with reverse-stress gradients, "
                      "write sweep_manifest.json beside the checkpoint")
    scw.add_argument("state", help="risk-state .npz saved with quarantine "
                                   "enabled (the sweep stresses its "
                                   "last_good_cov)")
    _device_arg(scw)
    scw.add_argument("--sampler", choices=("uniform", "sobol", "grid"),
                     default="uniform",
                     help="spec generator over the shock ball "
                          "(default: uniform)")
    scw.add_argument("--n", type=int, default=65536,
                     help="scenarios to stream (default: 65536; grid "
                          "rounds to a square)")
    scw.add_argument("--seed", type=int, default=0,
                     help="sampler + refinement seed (default: 0)")
    scw.add_argument("--chunk", type=int, default=8192,
                     help="scenarios per device call (default: 8192)")
    scw.add_argument("--top-k", type=int, default=16,
                     help="worst entries kept per book (default: 16)")
    scw.add_argument("--bins", type=int, default=64,
                     help="quantile-sketch histogram bins (default: 64)")
    scw.add_argument("--hist-span", type=float, default=8.0,
                     help="sketch upper edge as a multiple of each "
                          "book's base vol (default: 8.0)")
    scw.add_argument("--portfolio", default=None,
                     help="JSON portfolio file: one K-vector, a list of "
                          "them, or factor-name-keyed dicts (default: "
                          "one equal-weight portfolio)")
    scw.add_argument("--shift-max", type=float, default=0.01,
                     help="shock-ball |vol shift| cap (default: 0.01)")
    scw.add_argument("--scale-range", type=float, default=0.5,
                     help="shock-ball vol-scale half-range "
                          "(default: 0.5)")
    scw.add_argument("--vol-mult-max", type=float, default=3.5,
                     help="shock-ball vol_mult ceiling (default: 3.5)")
    scw.add_argument("--corr-beta-max", type=float, default=0.95,
                     help="shock-ball corr_beta ceiling (default: 0.95)")
    scw.add_argument("--no-refine", action="store_true",
                     help="skip the reverse-stress refinement loop")
    scw.add_argument("--out", default=None,
                     help="directory for sweep_manifest.json (default: "
                          "beside the checkpoint)")
    scw.add_argument("--metrics-dir", default=None, help=_METRICS_DIR_HELP)
    sc.set_defaults(fn=_scenario)

    gr = sub.add_parser(
        "grad",
        help="differentiable risk over a guarded checkpoint: reverse "
             "stress (worst admissible shock per portfolio), exact "
             "d vol/d shock sensitivity reports stamped into the scenario "
             "manifest, and gradient-based construction solvers — atomic "
             "grad_report.json beside the checkpoint")
    grs = gr.add_subparsers(dest="gcmd", required=True)

    def common(p):
        p.add_argument("state", help="risk-state .npz saved with "
                                     "quarantine enabled (grad runs "
                                     "against its last_good_cov)")
        _device_arg(p)
        p.add_argument("--portfolio", default=None,
                       help="JSON portfolio file: one K-vector of factor "
                            "weights, a list of them, or factor-name-"
                            "keyed dicts (default: one equal-weight "
                            "portfolio)")
        p.add_argument("--out", default=None,
                       help="directory for grad_report.json (default: "
                            "beside the checkpoint)")
        p.add_argument("--bucket", type=int, default=None,
                       help="explicit pad bucket >= the batch size "
                            "(default: the geometric bucket)")
        p.add_argument("--metrics-dir", default=None,
                       help=_METRICS_DIR_HELP)

    grr = grs.add_parser(
        "reverse", help="projected gradient ascent over the admissible "
                        "shock ball: the worst-case ScenarioSpec per "
                        "portfolio")
    common(grr)
    grr.add_argument("--steps", type=int, default=None,
                     help="ascent iterations (default: 200)")
    grr.add_argument("--vol-mult-max", type=float, default=3.5,
                     help="shock-ball vol_mult ceiling (default: 3.5)")
    grr.add_argument("--corr-beta-max", type=float, default=0.95,
                     help="shock-ball corr_beta ceiling (default: 0.95)")

    grn = grs.add_parser(
        "sensitivity", help="exact d vol/d shock and d vol/d exposure "
                            "rows per scenario, stamped into the "
                            "scenario manifest")
    common(grn)
    grn.add_argument("--preset", action="append", default=[],
                     help="preset scenario name, repeatable (default: "
                          "identity + the whole preset catalog)")
    grn.add_argument("--spec", action="append", default=[],
                     help="JSON ScenarioSpec file — one spec object or a "
                          "list of them (repeatable)")

    grc = grs.add_parser(
        "construct", help="gradient-based portfolio construction "
                          "against the served covariance")
    common(grc)
    grc.add_argument("solver", choices=("min_vol", "risk_parity", "hedge"),
                     help="which solver to run over the portfolio rows")
    gr.set_defaults(fn=_grad)


def _serve_parser(sub) -> None:
    sv = sub.add_parser(
        "serve",
        help="batched portfolio-query service over a guarded risk-state "
             "checkpoint: JSONL requests in, JSONL responses out, with "
             "request guards + dead-letter quarantine, bounded-queue "
             "admission control, deadlines, load shedding, and a circuit "
             "breaker; alone or as a fleet of worker replicas")
    sv.add_argument("state", help="risk-state .npz saved with quarantine "
                                  "enabled (serves its last_good_cov)")
    sv.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the service computes: the CUDA card "
                         "(default; raises without one) or the CPU; fleet "
                         "workers run on the front end's device")
    sv.add_argument("--input", default="-",
                    help="JSONL request file ('-' = stdin)")
    sv.add_argument("--output", default="-",
                    help="JSONL response file ('-' = stdout)")
    sv.add_argument("--dead-letter", default=None,
                    help="JSONL file collecting guarded-out requests "
                         "(default: discard)")
    sv.add_argument("--benchmarks", default=None,
                    help="JSON file {name: [factor exposures]} of served "
                         "benchmarks for active-risk/beta queries")
    sv.add_argument("--queue-max", type=int, default=4096,
                    help="admission bound; overflow sheds the OLDEST "
                         "queued request (default 4096)")
    sv.add_argument("--batch-max", type=int, default=1024,
                    help="max requests per device batch (default 1024)")
    sv.add_argument("--deadline-s", type=float, default=1.0,
                    help="default per-request deadline budget (default 1.0)")
    sv.add_argument("--breaker-failures", type=int, default=3,
                    help="consecutive batch failures that open the "
                         "circuit breaker (default 3)")
    sv.add_argument("--breaker-cooldown-s", type=float, default=5.0,
                    help="breaker open->half-open cooldown, also the "
                         "retry_after_s on rejections (default 5.0)")
    sv.add_argument("--weight-mad-k", type=float, default=0.0,
                    help="reject requests with a weight beyond K MADs of "
                         "the request's own median (0 = off)")
    sv.add_argument("--gulp", action="store_true",
                    help="read ALL input before the first drain — "
                         "deterministic overload mode (shedding depends "
                         "only on the input, not drain timing)")
    sv.add_argument("--watch", action="store_true",
                    help="poll latest.json between batches and hot-swap "
                         "the engine when the checkpoint generation moves; "
                         "a failed fence audit opens the breaker")
    sv.add_argument("--fsync-emits", action="store_true",
                    help="fsync the response stream after every emitted "
                         "batch — responses survive SIGKILL through the "
                         "OS page cache, not just the Python buffer")
    sv.add_argument("--replicas", type=int, default=0,
                    help="run N worker replica processes behind a "
                         "coalescing front end sharing the fenced "
                         "checkpoint store (0 = serve in-process); "
                         "writes fleet_manifest.json beside the checkpoint")
    sv.add_argument("--listen", default=None, metavar="HOST:PORT",
                    help="accept concurrent socket connections (JSONL "
                         "per connection) instead of reading --input; "
                         "port 0 binds ephemerally and the bound address "
                         "is printed to stderr")
    sv.add_argument("--http", action="store_true",
                    help="speak HTTP/1.1 on the --listen socket (POST / "
                         "with a JSONL body; GET /healthz, /metrics)")
    sv.add_argument("--linger-s", type=float, default=0.01,
                    help="coalescer max-linger budget: the oldest "
                         "admitted request flushes after this wait even "
                         "if its bucket has not filled (default 0.01)")
    sv.add_argument("--cache-entries", type=int, default=4096,
                    help="response-cache entry bound: repeated request "
                         "bodies answer from a content-addressed cache "
                         "fenced on checkpoint generation + scenario "
                         "spec hash (default 4096)")
    sv.add_argument("--cache-bytes", type=int, default=64 << 20,
                    help="response-cache resident-byte bound "
                         "(default 64 MiB; LRU evicts past either bound)")
    sv.add_argument("--no-cache", action="store_true",
                    help="kill switch: disable the response cache "
                         "entirely (every request computes)")
    sv.add_argument("--warm-tol", type=float, default=0.0,
                    help="construct warm-start tolerance: relative-L2 "
                         "exposure distance under which a solved book "
                         "seeds the next solve's warm-start blend "
                         "(0 = off; warmed responses carry a "
                         "warm_start parity stanza)")
    sv.add_argument("--workers", default=None, metavar="HOST:PORT,...",
                    help="attach to already-running TCP workers, each "
                         "started elsewhere with `serve STATE --worker "
                         "--listen HOST:PORT` against the same fenced "
                         "checkpoint; mixes with --replicas; dialing "
                         "retries with exponential backoff")
    sv.add_argument("--rollout", action="store_true",
                    help="rolling zero-downtime reload: when the "
                         "checkpoint generation moves, drain + re-fence "
                         "ONE worker at a time; the admission engine and "
                         "response-cache fence move only after the whole "
                         "fleet agrees (spawned workers run with "
                         "--hold-fence; TCP workers should be started "
                         "with it)")
    sv.add_argument("--hold-fence", action="store_true",
                    help="worker mode: do not self-poll the checkpoint "
                         "pointer between batches; re-fence only on the "
                         "front end's __fleet__ reload frame (the rolling "
                         "rollout protocol)")
    sv.add_argument("--worker-timeout-s", type=float, default=30.0,
                    help="per-I/O deadline on every worker read/write; "
                         "silence past this quarantines the worker as "
                         "wedged and re-dispatches its in-flight batch "
                         "(default 30)")
    sv.add_argument("--heartbeat-s", type=float, default=5.0,
                    help="ping a worker idle this long before handing it "
                         "a batch; a missed pong quarantines it "
                         "(default 5, 0 = off)")
    sv.add_argument("--heartbeat-timeout-s", type=float, default=2.0,
                    help="deadline on a heartbeat pong / live metrics "
                         "scrape (default 2)")
    sv.add_argument("--connect-attempts", type=int, default=5,
                    help="--workers dial attempts per worker, with "
                         "exponential backoff (default 5)")
    sv.add_argument("--connect-backoff-s", type=float, default=0.05,
                    help="base backoff between --workers dial attempts "
                         "(default 0.05, doubles per retry)")
    sv.add_argument("--worker", action="store_true",
                    help=argparse.SUPPRESS)   # internal: fleet replica
    sv.add_argument("--worker-id", type=int, default=0,
                    help=argparse.SUPPRESS)   # internal: replica index
    sv.add_argument("--load-attempts", type=int, default=3,
                    help="startup checkpoint-load retries (default 3)")
    sv.add_argument("--load-backoff-s", type=float, default=0.1,
                    help="backoff between startup load retries "
                         "(default 0.1)")
    sv.add_argument("--metrics-dir", default=None, metavar="DIR",
                    help=_METRICS_DIR_HELP)
    sv.set_defaults(fn=_serve)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="mfm_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    dr = sub.add_parser(
        "doctor",
        help="audit serving artifacts: payload checksums, fencing "
             "generations vs latest.json, risk-state schema/stamp, and "
             "the run manifest beside them (schema/stamp-match/health; "
             "exit 1 on any problem)")
    dr.add_argument("path", nargs="?", default=None,
                    help=".npz artifact or a directory of them (e.g. a "
                         "checkpoint dir)")
    dr.add_argument("--force", action="store_true",
                    help="audit past a stale-generation refusal (reported "
                         "as a warning instead of a failure)")
    dr.add_argument("--serve", action="store_true",
                    help="also audit the serve_manifest.json (or a fleet's "
                         "fleet_manifest.json) beside the artifacts: exit "
                         "non-zero if the query service's circuit breaker "
                         "was open at shutdown, an SLO was fast-burning, "
                         "the fleet's delivery audit is off or a "
                         "flight-recorder dump is torn; warn on load "
                         "shedding / degraded health")
    dr.add_argument("--scenarios", action="store_true",
                    help="also audit scenario_manifest.json (and a "
                         "sweep_manifest.json when present) beside the "
                         "artifacts: exit non-zero on a torn write, a spec "
                         "hash mismatch or inconsistent counts")
    dr.add_argument("--audit", nargs="?", const="latest", default=None,
                    metavar="FILE",
                    help="verify the committed IR-audit snapshot (default "
                         "the newest mfm_tpu_torch/tools/AUDIT_r*.json): "
                         "its seal, a strict-clean run, measurements equal "
                         "to audit_budgets.json, cells equal to the live "
                         "registry; warn on another torch version")
    dr.add_argument("--sync", action="store_true",
                    help="also run the lock-discipline pass (sync "
                         "--strict) against its committed baseline: exit "
                         "non-zero on new S1-S3 findings or stale baseline "
                         "entries; baselined findings surface as warnings")
    dr.set_defaults(fn=_doctor)

    _risk_parser(sub)
    _factors_demo_parsers(sub)
    _scenario_grad_parsers(sub)
    _serve_parser(sub)
    _alpha_parser(sub)
    _store_parsers(sub)
    _report_parsers(sub)

    mt = sub.add_parser(
        "metrics", help="read what --metrics-dir wrote: dump the "
                        "Prometheus textfile, print the snapshot, diff two "
                        "snapshots or fleet manifests")
    mts = mt.add_subparsers(dest="action", required=True)
    md = mts.add_parser("dump", help="print + validate metrics.prom")
    md.add_argument("path", help="--metrics-dir or the .prom file")
    msn = mts.add_parser("snapshot", help="print metrics.json")
    msn.add_argument("path", help="--metrics-dir or the .json file")
    mdf = mts.add_parser("diff", help="per-series deltas a -> b (each a "
                                      "snapshot or a fleet manifest)")
    mdf.add_argument("a")
    mdf.add_argument("b")
    mt.set_defaults(fn=_metrics)

    ln = sub.add_parser(
        "lint",
        help="the port's doctrine linter (R3 and R5 of R1-R7) over "
             "mfm_tpu_torch/ and chip_smoke.py")
    ln.add_argument("paths", nargs="*",
                    help="files/dirs to lint (default: mfm_tpu_torch "
                         "chip_smoke.py)")
    ln.add_argument("--baseline", default=None,
                    help="baseline JSON ('none' disables; default: "
                         "mfm_tpu_torch/tools/mfmlint_baseline.json)")
    ln.add_argument("--strict", action="store_true",
                    help="also fail on stale baseline entries")
    ln.add_argument("--json", action="store_true",
                    help="machine-readable output")
    ln.set_defaults(fn=_lint_cmd)

    sy = sub.add_parser(
        "sync",
        help="lock-discipline & shared-state static analysis for the "
             "serving fleet (rules S1-S3: guarded-field accesses, "
             "lock-order cycles, blocking under a lock)")
    sy.add_argument("paths", nargs="*",
                    help="files/dirs to analyze (default: mfm_tpu_torch)")
    sy.add_argument("--baseline", default=None,
                    help="baseline JSON ('none' disables; default: "
                         "mfm_tpu_torch/tools/mfmsync_baseline.json)")
    sy.add_argument("--strict", action="store_true",
                    help="also fail on stale baseline entries")
    sy.add_argument("--json", action="store_true",
                    help="machine-readable output")
    sy.set_defaults(fn=_sync_cmd)

    au = sub.add_parser(
        "audit",
        help="the IR audit of every registered entry point, each run once "
             "under probes: aliasing, dtype leaks and host reads, "
             "collectives, the recompile surface, and memory budgets on "
             "the card (passes A1-A5)")
    au.add_argument("--passes", default=None,
                    help="comma-separated subset of A1,A2,A3,A4,A5 "
                         "(default: all)")
    au.add_argument("--baseline", default=None,
                    help="baseline JSON of suppressed findings ('none' "
                         "disables; default: "
                         "mfm_tpu_torch/tools/mfmaudit_baseline.json)")
    au.add_argument("--budgets", default=None,
                    help="A5 budget file (default: "
                         "mfm_tpu_torch/tools/audit_budgets.json)")
    au.add_argument("--write-budgets", action="store_true",
                    help="freeze the measured memory numbers as the new "
                         "budget file instead of gating against them")
    au.add_argument("--json", default=None, metavar="FILE",
                    help="write the sealed report JSON to FILE "
                         "('-' for stdout)")
    au.add_argument("--strict", action="store_true",
                    help="also fail on stale baseline entries")
    au.add_argument("--device", default="cuda",
                    help="where the cells run: cuda (default) or cpu "
                         "(A1-A4; A5 measures on the card)")
    au.set_defaults(fn=_audit_cmd)

    args = ap.parse_args(argv)
    if getattr(args, "select_out", None) and args.select is None:
        ap.error("--select-out requires --select")
    from mfm_tpu_torch.obs import trace

    stages = trace.stage_tracing_enabled()
    try:
        args.fn(args)
    finally:
        root = getattr(args, "root_span", None)
        if root is not None:
            trace.pop_span(root)
        trace.set_stage_tracing(stages)


if __name__ == "__main__":
    main()
