"""Deterministic fault-injection harness for the port's serving loop
(counterpart of ``tools/faultinject.py``).

Drives the seeded recovery matrix (``mfm_tpu_torch/utils/chaos.py::
plan_suite``) against a real daily serving sequence — a synthetic barra
table's history -> fenced checkpoint -> per-slab guarded
``append_risk_pipeline`` updates — and the serving surfaces over its
checkpoints, and asserts the recovery contracts bitwise:

- **Torn / corrupt checkpoints** (truncate-*, corrupt-*): the fenced load
  refuses the damaged file with ``ArtifactCorruptError``; restoring the
  previous generation and replaying the append reproduces the fault-free
  run bitwise.
- **Crash mid-write** (kill-*): a real ``python -m mfm_tpu_torch.cli risk
  --update --quarantine`` subprocess is SIGKILLed at a named protocol
  point (``MFM_CHAOS_KILL``).  Killed after the tmp write: the old
  checkpoint still loads and the replay is bitwise the fault-free run.
  Killed after the rename (pointer not yet swapped): the new checkpoint
  loads, the pointer heals forward, its carries are bitwise the in-process
  ones and the next slab is bitwise the fault-free run.
- **Crash at the manifest write** (kill-at-manifest): the fenced checkpoint
  is untouched, no torn ``run_manifest.json`` is left, and the next run's
  manifest passes ``doctor``.
- **Crash mid sharded append** (shard-kill-mid-append): the same SIGKILL
  after the tmp write, while the ``risk --update --mesh 2x2`` subprocess
  ran its one update step on a virtual ('date', 'stock') mesh of the
  harness's device: the prior generation stays byte-identical, the
  fenced load is clean, and an unsharded in-process replay is bitwise the
  fault-free run (a sharded update is checkpoint-interchangeable with a
  single-device one).
- **Crash mid eigen-carry save** (eigen-kill-mid-update): the incremental
  eigen state rides the same fenced npz; the prior generation stays
  byte-identical, the reloaded eigen carry bitwise, the replay bitwise, and
  the directory doctor-green after the next CLI update.
- **Poisoned slabs** (nan-slab, outlier-slab, universe-collapse): the bad
  date is quarantined with a reported reason, and every healthy date's
  outputs and the final carries are bitwise a run that never saw the
  poisoned date (the carry-freeze contract).
- **Flaky transport** (flaky-store): ``with_retry`` over a ``FlakyStore``
  recovers on the documented backoff schedule and re-raises non-retryable
  errors at once.
- **Schedule drills** (sync-schedule-*): seeded interleavings
  (``utils/sched.py``) of the coalescer's and the response cache's locks,
  bitwise the sequential loop.
- **Steady state**: after a warmup, the guarded per-date update adds no
  event of the compile-contract counter (``utils/contracts.py``).
- **The query service** (query-*): a real ``serve`` subprocess SIGKILLed
  after a named batch leaves its durable responses a byte-equal prefix of
  the clean replay; poisoned request lines dead-letter with their reason
  bits while the healthy answers stay byte-equal; an overflow storm sheds
  exactly the oldest requests; a hot swap answers each batch bitwise from
  its own generation and a swap to a corrupt checkpoint force-opens the
  breaker (``fence_audit``); the steady-state query loop adds no
  compile-contract event after one warmup round per bucket, and a batch at
  a new bucket adds exactly one.
- **Scenarios, the sweep and grad** (scenario-*, sweep-*, grad-*): a
  ``scenario run``, ``scenario sweep`` or ``grad sensitivity`` subprocess
  SIGKILLed between its manifest's (report's) tmp write and rename leaves
  no torn file and the checkpoint's bytes unchanged; the clean re-run is
  doctor-green and byte-equal to a second one modulo the obs summary;
  poisoned scenario specs are rejected per lane, their batchmates
  byte-equal a run without them.
- **Tracing and the flight recorder** (trace-*, flightrec-*): a SIGKILL
  mid flush or mid dump leaves no torn ``trace.json`` / ``flightrec.json``
  and the checkpoint untouched; the re-run's trace parses and the
  re-trigger's dump reads back with its trigger and trace id.
- **The response cache** (cache-stale-generation): no body outlives its
  checkpoint generation across a hot swap, and a torn publish moves
  neither the cache's fence nor a byte of a cache-fronted ``--watch``
  serve against an uncached one.
- **The fleet** (fleet-*): a worker replica SIGKILLed mid-drain, a whole
  simulated host killed while another worker is SIGSTOPped, or one worker
  wedged: every request id is answered bitwise the single-process
  replay's, the fleet manifest counts the loss with a balanced audit, and
  ``doctor --serve`` stays green.

Every subprocess runs on the harness's device (``--device``); ``doctor``
runs in this process through ``cli.main`` over directories no process
still writes.  Each completed subprocess's kernel launches (its record's
or manifest's ``kernels`` block) go to the plan's record under
``subprocess_launches``.  Each slab is written once as a csv of its own
dates, which is what ``risk --update`` reads (it serves the rows past the
checkpoint's last date); the in-process appends read the same csv back,
so both sides see the same parsed bits.  Every plan of ``plan_suite`` is
ported: ``not_ported`` stays empty.

Everything is seeded; a failing plan replays exactly.  Exit 0 iff every
plan run passes; ``--out`` writes the JSON report.  The device is the card
unless ``--device cpu``:

    python -m mfm_tpu_torch.tools.faultinject --device cpu --out f.json
    python -m mfm_tpu_torch.tools.faultinject --plans nan-slab,kill-after-tmp
    python -m mfm_tpu_torch.tools.faultinject --device cpu \\
        --plans query-kill-mid-batch,fleet-kill-replica
    python -m mfm_tpu_torch.tools.faultinject --T 1390 --hist 1378 \\
        --N 300 --P 31 --Q 10 --sims 100          # CSI300 width
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import random
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: the reference's geometry: warmup history + three 4-date serving slabs
DEFAULTS = dict(T=44, hist=32, slab=4, N=20, P=3, Q=2, sims=8)

#: plans of plan_suite this harness does not run yet, by ROADMAP.md item
NOT_PORTED_KINDS: dict = {}

#: the plans of the serving surfaces (queries, scenarios, the sweep, grad,
#: tracing, the flight recorder, the response cache and the fleet); the
#: other ported plans drive the risk path's checkpoint
SERVICE_KINDS = frozenset({
    "query_kill", "query_poison", "query_overflow", "query_swap",
    "query_steady", "scenario_kill", "scenario_poison", "sweep_kill",
    "grad_kill", "trace_kill", "flightrec_kill", "cache_stale",
    "fleet_kill", "fleet_kill_host", "fleet_wedge"})

#: the crash-point variables a subprocess inherits only when asked to
_CHAOS_ENV = ("MFM_CHAOS_KILL", "MFM_CHAOS_KILL_MATCH",
              "MFM_CHAOS_KILL_REPLICA")


@dataclasses.dataclass(frozen=True)
class Geometry:
    T: int = DEFAULTS["T"]
    hist: int = DEFAULTS["hist"]
    slab: int = DEFAULTS["slab"]
    N: int = DEFAULTS["N"]
    P: int = DEFAULTS["P"]
    Q: int = DEFAULTS["Q"]
    sims: int = DEFAULTS["sims"]

    @property
    def n_slabs(self) -> int:
        return (self.T - self.hist) // self.slab


def _config(g: Geometry):
    from mfm_tpu_torch.config import (
        PipelineConfig,
        QuarantinePolicy,
        RiskModelConfig,
    )

    # eigen_sim_length pinned: a checkpoint freezes its Monte-Carlo draws,
    # and only a pinned length keeps the replay on the same draws
    return PipelineConfig(
        risk=RiskModelConfig(eigen_n_sims=g.sims, eigen_sim_length=g.T,
                             quarantine=QuarantinePolicy(enabled=True)),
        dtype="float32")


def _numpy_copy(x) -> np.ndarray:
    from mfm_tpu_torch.data.artifacts import _numpy

    return np.array(_numpy(x), copy=True)


def _carries(state) -> list:
    """The state's recursive carries as host copies, flattened as the
    reference flattens them: the Newey-West tuple, the vol-regime sums and
    (under ``eigen_incremental``) the eigen carry; absent leaves skipped."""
    leaves = []
    for leaf in (*state.nw_carry, state.vr_num, state.vr_den, state.eig_R,
                 state.eig_p, state.eig_n):
        if leaf is None:
            continue
        leaves.extend(leaf if isinstance(leaf, tuple) else (leaf,))
    return [_numpy_copy(x) for x in leaves]


def _outputs_by_date(res) -> dict:
    """{date -> {field -> (row,) array}} over the appended slab."""
    from mfm_tpu_torch.pipeline import date_stamp

    fields = {f: _numpy_copy(getattr(res.outputs, f))
              for f in res.outputs._fields}
    return {date_stamp(d): {f: v[i] for f, v in fields.items()}
            for i, d in enumerate(res.arrays.dates)}


def _assert_outputs_equal(got: dict, want: dict, dates, what: str):
    for d in dates:
        for f, w in want[d].items():
            g = got[d][f]
            if not np.array_equal(g, w, equal_nan=True):
                raise AssertionError(
                    f"{what}: output {f!r} at {d} diverged from the "
                    f"fault-free run (max |diff| "
                    f"{np.nanmax(np.abs(g.astype(np.float64) - w.astype(np.float64)))})")


def _assert_carries_equal(got, want, what: str):
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} carry leaves, the "
                             f"fault-free run has {len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        if not np.array_equal(g, w, equal_nan=True):
            raise AssertionError(
                f"{what}: carry leaf {i} diverged from the fault-free run")


def _launches() -> dict:
    from mfm_tpu_torch.ops.eigh_cuda import launch_counts

    return launch_counts()


def _diff(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


def _snapshot(workdir: str, tag: str) -> str:
    """Copy the checkpoint AND its fencing pointer as one consistent pair."""
    snap = os.path.join(workdir, f"snap_{tag}")
    os.makedirs(snap, exist_ok=True)
    for f in ("state.npz", "latest.json"):
        shutil.copy(os.path.join(workdir, f), os.path.join(snap, f))
    return snap


def _restore(workdir: str, snap: str, pointer: bool = True):
    shutil.copy(os.path.join(snap, "state.npz"),
                os.path.join(workdir, "state.npz"))
    if pointer:
        shutil.copy(os.path.join(snap, "latest.json"),
                    os.path.join(workdir, "latest.json"))


class Baseline:
    """The fault-free serving sequence, snapshotted after every stage so a
    plan can start from any point with a consistent (file, pointer) pair.

    ``slab_csv[i]`` holds slab i's dates only, written once; ``slabs[i]``
    is that csv read back (``data/csvio.py``, pandas' parse), the table
    every in-process append of slab i serves.  ``appends`` logs each
    in-process append's kernel launches."""

    def __init__(self, workdir: str, seed: int, g: Geometry, device):
        from mfm_tpu_torch.data.columns import isin, take
        from mfm_tpu_torch.data.csvio import read_csv, write_csv
        from mfm_tpu_torch.data.synthetic import synthetic_barra_table

        if g.n_slabs < 3 or g.hist < 2:
            raise SystemExit(f"faultinject: the geometry needs a history "
                             f"and at least three slabs (T={g.T}, "
                             f"hist={g.hist}, slab={g.slab})")
        self.g, self.device, self.cfg = g, device, _config(g)
        self.appends: list = []
        self.dir = os.path.join(workdir, "baseline")
        os.makedirs(self.dir)
        table, _ = synthetic_barra_table(T=g.T, N=g.N, P=g.P, Q=g.Q,
                                         seed=seed)
        dates = sorted(set(table["date"].tolist()))
        self.hist = take(table, table["date"] <= dates[g.hist - 1])
        self.hist_last = dates[g.hist - 1]
        self.slab_dates, self.slab_csv, self.slabs = [], [], []
        for i in range(g.n_slabs):
            ds = dates[g.hist + i * g.slab: g.hist + (i + 1) * g.slab]
            path = os.path.join(workdir, f"slab{i}.csv")
            write_csv(path, take(table, isin(table["date"], ds)))
            self.slab_dates.append(ds)
            self.slab_csv.append(path)
            self.slabs.append(read_csv(path))
        before = _launches()
        self.path = self.init_checkpoint(self.dir, self.cfg)
        self.init_launches = _diff(_launches(), before)
        self.snaps = [_snapshot(self.dir, "hist")]
        self.outputs, self.reports, self.carries = [], [], []
        for i, tab in enumerate(self.slabs):
            res = self.append(self.path, tab)
            q = _numpy_copy(res.report.quarantined)
            if q.any():
                raise AssertionError(
                    f"baseline slab {i} quarantined {int(q.sum())} clean "
                    "date(s) — guard thresholds are mis-tuned for the "
                    "synthetic panel")
            self.outputs.append(_outputs_by_date(res))
            self.reports.append(res.report)
            self.carries.append(_carries(res.state))
            self.snaps.append(_snapshot(self.dir, f"slab{i}"))
        self.baseline_appends = list(self.appends)

    def init_checkpoint(self, workdir: str, cfg) -> str:
        from mfm_tpu_torch.pipeline import (
            run_risk_pipeline,
            save_pipeline_state,
        )

        res = run_risk_pipeline(self.hist, config=cfg, with_state=True,
                                device=self.device)
        path = os.path.join(workdir, "state.npz")
        save_pipeline_state(path, res)
        return path

    def append(self, path: str, table, cfg=None):
        """One guarded append from the checkpoint at ``path``, saved back;
        its kernel launches go to :attr:`appends`."""
        from mfm_tpu_torch.pipeline import (
            append_risk_pipeline,
            save_pipeline_state,
        )

        before = _launches()
        res = append_risk_pipeline(path, table, config=cfg or self.cfg,
                                   device=self.device)
        self.appends.append(_diff(_launches(), before))
        save_pipeline_state(path, res)
        if res.report is None:
            raise AssertionError("a guarded append lost its guard report")
        return res

    def load(self, path: str):
        from mfm_tpu_torch.data.artifacts import load_risk_state

        return load_risk_state(path, self.device)

    def fresh(self, root: str, name: str, snap: str) -> str:
        d = os.path.join(root, name)
        os.makedirs(d)
        _restore(d, snap)
        return d

    # -- subprocesses of the port's CLI -----------------------------------
    def run(self, argv, kill_at: str | None = None, match: str | None = None,
            env: dict | None = None, timeout: float = 600):
        """One subprocess to its end, with the repo on its path and
        ``MFM_CHAOS_KILL`` (``_MATCH``) set only when asked."""
        return subprocess.run(list(map(str, argv)),
                              env=_sub_env(kill_at, match, env),
                              cwd=REPO_ROOT, capture_output=True, text=True,
                              timeout=timeout)

    def cli(self, argv, kill_at: str | None = None, match: str | None = None,
            env: dict | None = None, timeout: float = 600):
        return self.run([*_cli_argv(), *argv], kill_at, match, env, timeout)

    def update_cmd(self, slab: int, path: str, out: str,
                   incremental: bool = False, extra=()) -> list:
        length = (["--eigen-incremental"] if incremental
                  else ["--eigen-sim-length", self.g.T])
        return ["risk", "--barra", self.slab_csv[slab], "--update", path,
                "--quarantine", "--eigen-sims", self.g.sims, *length,
                "--out", out, "--device", self.device.type, *extra]

    def run_update(self, plan, slab: int, path: str, out: str,
                   kill_at: str | None = None, incremental: bool = False,
                   extra=(), env: dict | None = None):
        """``risk --update`` on slab ``slab``: with ``kill_at``, require
        death by SIGKILL; else success.  Returns the run's launches (None
        for a killed run)."""
        proc = self.cli(self.update_cmd(slab, path, out, incremental, extra),
                        kill_at=kill_at, env=env)
        if kill_at:
            _require_killed(plan, proc, kill_at)
            return None
        _require_ok(plan, proc, "post-crash update")
        return json.loads(proc.stdout.strip().splitlines()[-1])[
            "kernels"]["launches"]

    def doctor(self, plan, d: str, *flags):
        """``doctor d [flags]`` through ``cli.main`` in this process (it
        reads files only); non-zero exit fails the plan."""
        import contextlib
        import io

        from mfm_tpu_torch import cli

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            try:
                cli.main(["doctor", d, *flags])
                code = 0
            except SystemExit as e:
                code = e.code if isinstance(e.code, int) else 1
        if code != 0:
            raise AssertionError(f"{plan.name}: doctor {' '.join(flags)} "
                                 "rejects the post-crash state\n"
                                 f"{buf.getvalue()[-2000:]}")


def _cli_argv() -> list:
    """The command that starts the port's CLI in a subprocess."""
    return [sys.executable, "-m", "mfm_tpu_torch.cli"]


def _sub_env(kill_at: str | None = None, match: str | None = None,
             extra: dict | None = None) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in _CHAOS_ENV}
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO_ROOT, os.environ.get("PYTHONPATH")) if p)
    if kill_at:
        env["MFM_CHAOS_KILL"] = kill_at
    if match:
        env["MFM_CHAOS_KILL_MATCH"] = match
    env.update(extra or {})
    return env


def _require_killed(plan, proc, point: str) -> None:
    if proc.returncode != -signal.SIGKILL:
        raise AssertionError(
            f"{plan.name}: expected the subprocess to die by SIGKILL at "
            f"{point}, got rc={proc.returncode}\n{proc.stderr[-2000:]}")


def _require_ok(plan, proc, what: str) -> None:
    if proc.returncode != 0:
        raise AssertionError(f"{plan.name}: {what} failed "
                             f"rc={proc.returncode}\n{proc.stderr[-2000:]}")


def _last_json(text: str) -> dict:
    """The last JSON object a process printed, on one line or indented
    over several (the CLI's stderr records)."""
    lines = text.rstrip().splitlines()
    for i in range(len(lines) - 1, -1, -1):
        if lines[i].startswith("{"):
            try:
                return json.loads("\n".join(lines[i:]))
            except ValueError:
                continue
    raise ValueError(f"no JSON record in {text[-500:]!r}")


def _record_launches(plan, proc) -> dict:
    """The eigh launches a completed CLI subprocess reported in the
    ``kernels`` block of its stderr record."""
    try:
        return _last_json(proc.stderr)["kernels"]["launches"]
    except (ValueError, KeyError) as err:
        raise AssertionError(f"{plan.name}: the subprocess reported no "
                             f"kernel launches ({err})")


def _manifest_launches(path: str) -> dict:
    """The eigh launches a serve process wrote into its manifest."""
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)["kernels"]["launches"]


def _sha256(path: str) -> str:
    import hashlib

    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def _write_lines(path: str, lines) -> str:
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("\n".join(lines) + "\n")
    return path


def _read_lines(path: str) -> list:
    with open(path, encoding="utf-8") as fh:
        return [ln for ln in fh.read().splitlines() if ln]


# -- plan runners ----------------------------------------------------------------

def run_byte_fault(plan, base: Baseline, root: str) -> dict:
    """truncate-* / corrupt-*: damaged checkpoint refused, previous
    generation replays bitwise."""
    from mfm_tpu_torch.data.artifacts import ArtifactCorruptError
    from mfm_tpu_torch.utils.chaos import corrupt_file, truncate_file

    d = base.fresh(root, plan.name, base.snaps[1])  # state after slab 0
    path = os.path.join(d, "state.npz")
    if plan.kind == "truncate":
        frac = plan.param("frac")
        n = (int(frac * os.path.getsize(path)) if frac is not None
             else int(plan.param("n_bytes")))
        truncate_file(path, n)
    else:
        corrupt_file(path, int(plan.param("n_bytes")), plan.seed)
    try:
        base.load(path)
    except ArtifactCorruptError as err:
        detected = str(err)
    else:
        raise AssertionError(f"{plan.name}: corrupt checkpoint loaded clean")
    # recovery: the previous generation (slab 0's input) + replay
    _restore(d, base.snaps[0])
    res = base.append(path, base.slabs[0])
    _assert_outputs_equal(_outputs_by_date(res), base.outputs[0],
                          base.slab_dates[0], plan.name)
    _assert_carries_equal(_carries(res.state), base.carries[0], plan.name)
    return {"detected": detected.split(" — ")[0]}


def run_kill(plan, base: Baseline, root: str) -> dict:
    """kill-*: SIGKILL a real ``risk --update`` subprocess at a protocol
    point, then prove the recovery the fence promises."""
    from mfm_tpu_torch.data.artifacts import read_pointer

    point = plan.param("point")
    d = base.fresh(root, plan.name, base.snaps[0])  # state after history
    path = os.path.join(d, "state.npz")
    base.run_update(plan, 0, path, os.path.join(d, "tables"), kill_at=point)
    state, meta = base.load(path)   # fenced: must load clean
    ptr = read_pointer(path)
    if point == "save_artifact.after_tmp":
        # the old checkpoint intact and untouched; the replay bitwise
        if meta["last_date"] != base.hist_last:
            raise AssertionError(f"{plan.name}: checkpoint advanced past a "
                                 "write that never completed")
        res = base.append(path, base.slabs[0])
        _assert_outputs_equal(_outputs_by_date(res), base.outputs[0],
                              base.slab_dates[0], plan.name)
        _assert_carries_equal(_carries(res.state), base.carries[0],
                              plan.name)
        healed = False
    else:  # after_rename: new file live, pointer was stale -> healed forward
        if meta["last_date"] != base.slab_dates[0][-1]:
            raise AssertionError(f"{plan.name}: renamed checkpoint does not "
                                 "carry the appended dates")
        ptr = read_pointer(path)
        if ptr["generation"] != meta["generation"]:
            raise AssertionError(f"{plan.name}: pointer not healed forward")
        # the subprocess's checkpoint is interchangeable with the
        # in-process one: carries bitwise, and the NEXT slab bitwise
        _assert_carries_equal(_carries(state), base.carries[0],
                              f"{plan.name} (subprocess checkpoint)")
        res = base.append(path, base.slabs[1])
        _assert_outputs_equal(_outputs_by_date(res), base.outputs[1],
                              base.slab_dates[1], plan.name)
        healed = True
    return {"killed_at": point, "pointer": ptr, "pointer_healed": healed,
            "killed_subprocesses": 1}


def run_eigen_kill(plan, base: Baseline, root: str) -> dict:
    """eigen-kill-mid-update: SIGKILL between the checkpoint's tmp write
    and its rename while the state carries the incremental eigen leaves
    (``eigen_incremental=True``: the prefix moments and the frozen draws).
    The prior generation stays byte-identical, the fenced load hands back
    the same eigen carry bitwise, the replay lands on the fault-free
    outputs and carries bitwise, and a post-crash CLI update leaves a
    doctor-green directory."""
    point = plan.param("point")
    d = os.path.join(root, plan.name)
    os.makedirs(d)
    icfg = dataclasses.replace(base.cfg, risk=dataclasses.replace(
        base.cfg.risk, eigen_sim_length=None, eigen_incremental=True))
    before = _launches()
    path = base.init_checkpoint(d, icfg)
    init_launches = _diff(_launches(), before)
    state0, _ = base.load(path)
    if state0.eig_R is None or state0.eig_draws is None:
        raise AssertionError(f"{plan.name}: history checkpoint carries no "
                             "eigen carry — eigen_incremental did not engage")
    eig0 = [_numpy_copy(x) for x in
            (state0.eig_R, state0.eig_p, state0.eig_n)]
    del state0

    # fault-free reference for slab 0, then rewind to the history snapshot
    snap = _snapshot(d, "hist")
    ref = base.append(path, base.slabs[0], icfg)
    ref_outputs, ref_carries = _outputs_by_date(ref), _carries(ref.state)
    del ref
    _restore(d, snap)
    with open(path, "rb") as fh:
        pre_bytes = fh.read()

    tables = os.path.join(d, "tables")
    base.run_update(plan, 0, path, tables, kill_at=point, incremental=True)
    with open(path, "rb") as fh:
        if fh.read() != pre_bytes:
            raise AssertionError(f"{plan.name}: the checkpoint bytes changed "
                                 "under a write that never renamed")
    state, meta = base.load(path)   # fenced: must load clean
    if meta["last_date"] != base.hist_last:
        raise AssertionError(f"{plan.name}: checkpoint advanced past a "
                             "write that never completed")
    for got, want, name in zip((state.eig_R, state.eig_p, state.eig_n),
                               eig0, ("eig_R", "eig_p", "eig_n")):
        if _numpy_copy(got).tobytes() != want.tobytes():
            raise AssertionError(f"{plan.name}: reloaded eigen carry leaf "
                                 f"{name} is not bitwise the pre-crash one")
    del state
    # replay: bitwise the fault-free run, eigen carry included
    res = base.append(path, base.slabs[0], icfg)
    _assert_outputs_equal(_outputs_by_date(res), ref_outputs,
                          base.slab_dates[0], plan.name)
    _assert_carries_equal(_carries(res.state), ref_carries, plan.name)
    del res
    # the next slab through the real CLI, then doctor on the directory
    sub = base.run_update(plan, 1, path, tables, incremental=True)
    _, meta2 = base.load(path)
    if meta2["last_date"] != base.slab_dates[1][-1]:
        raise AssertionError(f"{plan.name}: post-crash CLI update did not "
                             "carry the appended dates")
    base.doctor(plan, d)
    return {"killed_at": point, "prior_state": "byte-identical",
            "replay": "bitwise", "doctor": "green",
            "init_launches": init_launches, "subprocess_launches": [sub],
            "killed_subprocesses": 1}


def run_shard_kill(plan, base: Baseline, root: str) -> dict:
    """shard-kill-mid-append: SIGKILL a ``risk --update --quarantine --mesh
    DxS`` subprocess between the checkpoint's tmp write and its rename —
    the one update step ran sharded over a virtual mesh of the harness's
    device (the slab's panels sharded, the state replicated).  Sharding
    changes nothing about the crash story: the prior generation stays
    byte-identical, the fenced load is clean, and an unsharded in-process
    replay lands bitwise on the fault-free outputs and carries.  The next
    slab then goes through the sharded CLI to its end: its checkpoint's
    carries are bitwise the fault-free run's, and doctor is green."""
    from mfm_tpu_torch._device import VIRTUAL_DEVICES_ENV

    point = plan.param("point")
    mesh = plan.param("mesh", "2x2")
    nd, _, ns = mesh.partition("x")
    n_dev = int(nd) * int(ns or 1)
    d = base.fresh(root, plan.name, base.snaps[0])  # state after history
    path = os.path.join(d, "state.npz")
    with open(path, "rb") as fh:
        pre_bytes = fh.read()
    env = {VIRTUAL_DEVICES_ENV: os.environ.get(VIRTUAL_DEVICES_ENV)
           or str(n_dev)}
    tables = os.path.join(d, "tables")
    base.run_update(plan, 0, path, tables, kill_at=point,
                    extra=("--mesh", mesh), env=env)
    with open(path, "rb") as fh:
        if fh.read() != pre_bytes:
            raise AssertionError(f"{plan.name}: checkpoint bytes changed "
                                 "under a sharded write that never renamed")
    _, meta = base.load(path)   # fenced: must load clean
    if meta["last_date"] != base.hist_last:
        raise AssertionError(f"{plan.name}: checkpoint advanced past a "
                             "sharded write that never completed")
    res = base.append(path, base.slabs[0])
    _assert_outputs_equal(_outputs_by_date(res), base.outputs[0],
                          base.slab_dates[0], plan.name)
    _assert_carries_equal(_carries(res.state), base.carries[0], plan.name)
    del res
    sub = base.run_update(plan, 1, path, tables, extra=("--mesh", mesh),
                          env=env)
    state, meta = base.load(path)
    if meta["last_date"] != base.slab_dates[1][-1]:
        raise AssertionError(f"{plan.name}: the sharded CLI update did not "
                             "carry the appended dates")
    _assert_carries_equal(_carries(state), base.carries[1],
                          f"{plan.name} (sharded subprocess checkpoint)")
    base.doctor(plan, d)
    return {"killed_at": point, "mesh": mesh, "virtual_devices": env[
        VIRTUAL_DEVICES_ENV], "prior_state": "byte-identical",
        "replay": "bitwise", "sharded_checkpoint": "bitwise",
        "doctor": "green", "subprocess_launches": [sub],
        "killed_subprocesses": 1}


def run_kill_manifest(plan, base: Baseline, root: str) -> dict:
    """kill-at-manifest: SIGKILL between the run manifest's tmp write and
    its rename.  The checkpoint (fenced before the manifest) carries the
    slab, no torn manifest exists, and the next run's manifest passes
    ``doctor``."""
    from mfm_tpu_torch.obs.manifest import read_run_manifest

    point = plan.param("point")
    d = base.fresh(root, plan.name, base.snaps[0])
    path = os.path.join(d, "state.npz")
    tables = os.path.join(d, "tables")
    base.run_update(plan, 0, path, tables, kill_at=point)
    man_path = os.path.join(d, "run_manifest.json")
    if os.path.exists(man_path):
        raise AssertionError(f"{plan.name}: a manifest exists despite the "
                             "kill before its rename — the write is not "
                             "tmp-then-rename atomic")
    state, meta = base.load(path)
    if meta["last_date"] != base.slab_dates[0][-1]:
        raise AssertionError(f"{plan.name}: checkpoint does not carry the "
                             "appended dates — manifest kill corrupted it")
    _assert_carries_equal(_carries(state), base.carries[0],
                          f"{plan.name} (subprocess checkpoint)")
    del state
    res = base.append(path, base.slabs[1])
    _assert_outputs_equal(_outputs_by_date(res), base.outputs[1],
                          base.slab_dates[1], plan.name)
    del res
    sub = base.run_update(plan, 2, path, tables)
    man = read_run_manifest(man_path)   # raises ManifestError if torn
    base.doctor(plan, d)
    return {"killed_at": point, "manifest_after_crash": "absent",
            "recovered_manifest_health": man["health"]["status"],
            "subprocess_launches": [sub], "killed_subprocesses": 1}


_POISON_OK_REASONS = {
    # NaN returns are dropped by the table->arrays conversion, so a
    # NaN-poisoned csv date manifests as universe collapse downstream
    "nan_slab": {"nan_density", "universe_collapse"},
    "outlier_slab": {"ret_outlier"},
    "universe_slab": {"universe_collapse"},
}


def run_poison(plan, base: Baseline, root: str) -> dict:
    """nan-slab / outlier-slab / universe-collapse: the poisoned date is
    quarantined with a reported reason; healthy dates and the final carries
    are bitwise a run that never saw it."""
    from mfm_tpu_torch.data.columns import isin, take, unique
    from mfm_tpu_torch.serve.guard import reason_names

    rng = np.random.default_rng(plan.seed)
    bad_date = base.slab_dates[0][2]
    table = {k: v.copy() for k, v in base.slabs[0].items()}
    mask = table["date"] == bad_date
    stocks = np.array(unique(table["stocknames"][mask]))
    if plan.kind == "nan_slab":
        # 60% of the date's stocks, not the plan's full frac: all-NaN rows
        # would drop the DATE itself in the table->arrays conversion and
        # the guard would never see it
        hit = rng.choice(stocks, size=max(1, int(round(0.6 * len(stocks)))),
                         replace=False)
        table["ret"][mask & isin(table["stocknames"], hit)] = np.nan
    elif plan.kind == "outlier_slab":
        k = max(1, int(round(float(plan.param("frac", 0.3)) * len(stocks))))
        hit = rng.choice(stocks, size=k, replace=False)
        sel = mask & isin(table["stocknames"], hit)
        table["ret"][sel] = 0.5 * rng.choice([-1.0, 1.0], size=int(sel.sum()))
    else:  # universe_slab
        keep = float(plan.param("keep_frac", 0.2))
        hit = rng.choice(stocks, size=int(round((1 - keep) * len(stocks))),
                         replace=False)
        table = take(table, ~(mask & isin(table["stocknames"], hit)))

    d = base.fresh(root, plan.name, base.snaps[0])
    res = base.append(os.path.join(d, "state.npz"), table)
    rep = res.report
    by_date = _outputs_by_date(res)
    dates = list(by_date)
    quar = _numpy_copy(rep.quarantined)
    q = {dt: bool(quar[i]) for i, dt in enumerate(dates)}
    if not q.get(bad_date):
        raise AssertionError(f"{plan.name}: poisoned date {bad_date} was "
                             "NOT quarantined")
    reasons = reason_names(int(_numpy_copy(rep.reasons)[
        dates.index(bad_date)]))
    if not set(reasons) & _POISON_OK_REASONS[plan.kind]:
        raise AssertionError(
            f"{plan.name}: expected a reason in "
            f"{sorted(_POISON_OK_REASONS[plan.kind])}, got {reasons}")
    healthy = [dt for dt in dates if not q[dt]]
    if [dt for dt in dates if q[dt]] != [bad_date]:
        raise AssertionError(f"{plan.name}: quarantined more than the "
                             f"poisoned date: {[x for x in dates if q[x]]}")
    # the carry-freeze contract: a run that NEVER saw the poisoned date
    d2 = base.fresh(root, plan.name + "-ref", base.snaps[0])
    clean = base.slabs[0]
    ref = base.append(os.path.join(d2, "state.npz"),
                      take(clean, clean["date"] != bad_date))
    _assert_outputs_equal(by_date, _outputs_by_date(ref), healthy, plan.name)
    _assert_carries_equal(_carries(res.state), _carries(ref.state),
                          plan.name)
    # served_cov at the quarantined date is the last healthy covariance
    served = _numpy_copy(rep.served_cov)
    if not np.array_equal(served[dates.index(bad_date)],
                          served[dates.index(healthy[1])]):
        raise AssertionError(f"{plan.name}: degraded serve is not the last "
                             "healthy covariance")
    stale = int(_numpy_copy(rep.staleness)[dates.index(bad_date)])
    return {"quarantined": bad_date, "reasons": reasons, "staleness": stale}


def run_flaky_store(plan, base: Baseline, root: str) -> dict:
    """flaky-store: ``with_retry`` + ``FlakyStore`` recover on the
    documented schedule; non-retryable errors surface immediately."""
    from mfm_tpu_torch.data.columns import nrows
    from mfm_tpu_torch.data.etl import PanelStore, with_retry
    from mfm_tpu_torch.utils.chaos import FlakyStore

    d = os.path.join(root, plan.name)
    os.makedirs(d)
    store = PanelStore(os.path.join(d, "store"))
    n_failures = int(plan.param("n_failures", 2))
    fs = FlakyStore(store, n_failures=n_failures, methods=("insert",))
    table = {"ts_code": np.array(["a", "b"]), "trade_date": np.array([1, 1]),
             "x": np.array([1.0, 2.0])}
    delays = []
    inserted = with_retry(
        lambda: fs.insert("t", table, unique=("ts_code", "trade_date")),
        attempts=n_failures + 1, backoff_s=0.25, sleep=delays.append,
        exponential=True, jitter=0.5, seed=plan.seed,
        retryable=(ConnectionError,))
    if inserted != 2 or nrows(store.read("t")) != 2:
        raise AssertionError(f"{plan.name}: retries did not complete the "
                             f"insert (inserted={inserted})")
    if len(delays) != n_failures:
        raise AssertionError(f"{plan.name}: expected {n_failures} backoff "
                             f"sleeps, saw {len(delays)}")
    for i, dl in enumerate(delays):
        lo, hi = 0.25 * 2 ** i * 0.5, 0.25 * 2 ** i * 1.5
        if not lo <= dl <= hi:
            raise AssertionError(f"{plan.name}: delay {i} = {dl} outside "
                                 f"the jittered exponential band [{lo}, {hi}]")
    # a non-retryable error passes through with zero sleeps
    bombs = FlakyStore(store, n_failures=1, methods=("insert",),
                       exc_factory=TypeError)
    hard_delays = []
    try:
        with_retry(lambda: bombs.insert("t", table), attempts=3,
                   backoff_s=0.25, sleep=hard_delays.append,
                   retryable=(ConnectionError,))
    except TypeError:
        pass
    else:
        raise AssertionError(f"{plan.name}: non-retryable error was retried")
    if hard_delays:
        raise AssertionError(f"{plan.name}: slept before re-raising a "
                             "non-retryable error")
    return {"injected_failures": n_failures,
            "backoff_schedule_s": [round(x, 4) for x in delays]}


def run_steady_state(base: Baseline, root: str) -> dict:
    """After a warmup, the guarded per-date serving loop adds no event of
    the compile-contract counter (no kernel build or load, no new eigh
    signature) across an arbitrary number of dates."""
    from mfm_tpu_torch.data.columns import take
    from mfm_tpu_torch.utils.contracts import (
        assert_max_compiles,
        count_compiles,
    )

    d = base.fresh(root, "steady-state", base.snaps[0])
    path = os.path.join(d, "state.npz")
    slab = base.slabs[0]
    days = base.slab_dates[0]
    # warmup: the first 1-date append records the (T=1)-shaped step's
    # signatures, as a JAX warmup compiles it
    with count_compiles() as warm:
        base.append(path, take(slab, slab["date"] == days[0]))
    with assert_max_compiles(0, "steady-state guarded serving loop") as c:
        for day in days[1:]:
            base.append(path, take(slab, slab["date"] == day))
    return {"dates_served": len(days) - 1, "warmup_compiles": warm.count,
            "compiles": c.count}


# -- schedule drills ----------------------------------------------------------------

def _query_engine(base: Baseline, path: str):
    """Factor-space engine over a guarded checkpoint (what ``serve``
    builds).  A fresh instance per call."""
    from mfm_tpu_torch.serve import QueryEngine

    state, meta = base.load(path)
    return QueryEngine.from_risk_state(state, meta, device=base.device)


def _query_requests(seed: int, n: int, k: int,
                    deadline_s: float = 600.0) -> list:
    """Seeded JSONL request lines (ids q0..q{n-1}, K factor exposures).
    Deadlines are generous: the drills assert determinism, not wall-clock
    behaviour."""
    rng = np.random.default_rng(seed)
    return [json.dumps({"id": f"q{i}",
                        "weights": np.round(rng.normal(0.0, 1.0, k),
                                            6).tolist(),
                        "deadline_s": deadline_s}, sort_keys=True)
            for i in range(n)]


def _resp_body(resp: dict) -> str:
    """Canonical response body with the identity keys stripped — the
    byte-identity unit every schedule drill compares on."""
    return json.dumps({f: v for f, v in resp.items()
                       if f not in ("id", "trace_id")}, sort_keys=True)


def _hammer(addr, lines_per_thread, timeout_s: float = 120.0) -> dict:
    """Closed-loop clients against a live socket front end: one TCP
    connection per thread, one request in flight each, so each thread
    requires its responses in the order it sent.  Returns
    ``{"responses": {id: line}}``; raises the first client's failure."""
    host, port = addr
    results, errors = {}, []

    def client(tix: int, lines) -> None:
        got = []
        try:
            with socket.create_connection((host, int(port)),
                                          timeout=timeout_s) as sk:
                rf = sk.makefile("r", encoding="utf-8")
                for line in lines:
                    sent = json.loads(line)["id"]
                    sk.sendall((line + "\n").encode("utf-8"))
                    resp_line = rf.readline()
                    if not resp_line:
                        raise AssertionError(
                            f"hammer thread {tix}: connection closed with "
                            f"{sent!r} in flight")
                    rid = json.loads(resp_line).get("id")
                    if rid != sent:
                        raise AssertionError(
                            f"hammer thread {tix}: response order violated "
                            f"— sent {sent!r}, got {rid!r}")
                    got.append((sent, resp_line.rstrip("\n")))
        except BaseException as exc:
            errors.append((tix, exc))
        results[tix] = got

    threads = [threading.Thread(target=client, args=(i, lines), daemon=True)
               for i, lines in enumerate(lines_per_thread)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        tix, exc = sorted(errors, key=lambda e: e[0])[0]
        raise AssertionError(f"hammer thread {tix} failed: {exc}")
    return {"responses": {rid: line for got in results.values()
                          for rid, line in got}}


def run_sync_schedule_coalescer(plan, base: Baseline, root: str) -> dict:
    """sync-schedule-coalescer: the coalescer's bitwise contract under
    adversarial flush/submit interleavings.  Phase 1: its RLock/Condition
    transplanted with ``DetScheduler`` primitives, a seed sweep of T
    submitter threads racing a flusher — every id answered exactly once,
    byte-equal the sequential loop.  Phase 2: a live ``SocketFrontend``
    under closed-loop clients, in-order per connection, bitwise per id."""
    from mfm_tpu_torch.serve import Coalescer, QueryServer, ServePolicy
    from mfm_tpu_torch.serve.frontend import SocketFrontend
    from mfm_tpu_torch.utils.sched import DetCondition, DetRLock, DetScheduler

    seeds = int(plan.param("seeds", 10))
    n_threads = int(plan.param("threads", 3))
    n = int(plan.param("n", 12))
    d = base.fresh(root, plan.name, base.snaps[0])
    path = os.path.join(d, "state.npz")
    k = _query_engine(base, path).K
    lines = _query_requests(plan.seed, n, k)

    def make_co(deliver=None):
        server = QueryServer(_query_engine(base, path),
                             ServePolicy(batch_max=4,
                                         default_deadline_s=600.0),
                             health="ok")
        # frozen clock + huge linger: flushes happen only at batch_max
        # and at explicit flush() calls, so a schedule fully determines
        # the batch shapes
        return Coalescer(server, linger_s=600.0, clock=lambda: 0.0,
                         deliver=deliver)

    def sequential(ls) -> dict:
        co = make_co()
        pairs = []
        for ln in ls:
            pairs += co.submit(ln)
        pairs += co.flush()
        out = {r["id"]: _resp_body(r) for _o, r in pairs}
        if len(out) != len(ls):
            raise AssertionError(f"{plan.name}: sequential reference "
                                 f"answered {len(out)}/{len(ls)}")
        return out

    ref = sequential(lines)
    for sd in range(seeds):
        s = DetScheduler(plan.seed + sd)
        co = make_co()
        co._lock = DetRLock(s, "coalesce")
        co._wake = DetCondition(s, co._lock)
        got: list = []

        def submitter(sl):
            for ln in sl:
                got.extend(co.submit(ln))

        def flusher():
            for _ in range(n):
                got.extend(co.flush())

        for i in range(n_threads):
            s.spawn(submitter, lines[i::n_threads], name=f"sub{i}")
        s.spawn(flusher, name="flusher")
        s.run()
        # final drain on this thread with real primitives (the
        # scheduler's are only usable from spawned workers)
        co._lock = threading.RLock()
        co._wake = threading.Condition(co._lock)
        got.extend(co.flush())
        by_id: dict = {}
        for _origin, r in got:
            if r["id"] in by_id:
                raise AssertionError(f"{plan.name}: seed {sd} answered "
                                     f"{r['id']} twice")
            by_id[r["id"]] = _resp_body(r)
        if set(by_id) != set(ref):
            missing = sorted(set(ref) - set(by_id))
            raise AssertionError(f"{plan.name}: seed {sd} dropped "
                                 f"{missing[:4]}")
        diverged = [i for i in sorted(ref) if by_id[i] != ref[i]]
        if diverged:
            raise AssertionError(f"{plan.name}: seed {sd}: "
                                 f"{len(diverged)} responses diverge "
                                 f"from the sequential loop under this "
                                 f"interleaving (first: {diverged[0]})")

    # -- phase 2: live socket front end under closed-loop clients ----------
    h_threads = int(plan.param("hammer_threads", 4))
    h_n = int(plan.param("hammer_n", 32))
    h_lines = _query_requests(plan.seed + 1, h_n, k)
    ref2 = sequential(h_lines)
    fe = SocketFrontend("127.0.0.1", 0)
    server = QueryServer(_query_engine(base, path),
                         ServePolicy(batch_max=4, default_deadline_s=600.0),
                         health="ok")
    fe.backend = Coalescer(server, linger_s=0.005, deliver=fe.deliver)
    host, port = fe.listen()
    accept_thread = fe.start()
    try:
        rep = _hammer((host, port), [h_lines[i::h_threads]
                                     for i in range(h_threads)])
    finally:
        fe.stop()
        accept_thread.join(timeout=10.0)
    if set(rep["responses"]) != set(ref2):
        raise AssertionError(f"{plan.name}: hammer answered "
                             f"{len(rep['responses'])}/{len(ref2)}")
    diverged = [i for i in sorted(ref2)
                if _resp_body(json.loads(rep["responses"][i])) != ref2[i]]
    if diverged:
        raise AssertionError(f"{plan.name}: {len(diverged)} hammered "
                             f"responses diverge from the sequential "
                             f"loop (first: {diverged[0]})")
    return {"det_seeds": seeds, "det_threads": n_threads, "requests": n,
            "hammer_threads": h_threads, "hammer_requests": h_n,
            "replay": "bitwise per id (both phases)"}


def run_sync_schedule_cache(plan, base: Baseline, root: str) -> dict:
    """sync-schedule-cache: a concurrent hit/miss/reload storm on the
    response cache under deterministic schedules.  T workers race
    lookup/put over a small repeat-heavy body pool while a fencer moves
    the generation fence mid-storm.  Every hit is byte-equal the cold body
    of its own generation, the LRU bounds (entries and resident bytes)
    hold at every step, each worker's observed generations are monotone,
    and the post-storm stream re-warms under the new fence."""
    from mfm_tpu_torch.serve import (
        Coalescer,
        QueryServer,
        ResponseCache,
        ServePolicy,
    )
    from mfm_tpu_torch.utils.sched import DetLock, DetScheduler

    seeds = int(plan.param("seeds", 10))
    n_threads = int(plan.param("threads", 3))
    ops = int(plan.param("ops", 10))
    n_bodies = int(plan.param("bodies", 6))
    max_entries = int(plan.param("max_entries", 4))
    max_bytes = int(plan.param("max_bytes", 4096))

    d_a = base.fresh(root, plan.name, base.snaps[0])       # gen 0
    d_b = base.fresh(root, plan.name + "-next", base.snaps[1])
    path_a = os.path.join(d_a, "state.npz")
    path_b = os.path.join(d_b, "state.npz")
    k = _query_engine(base, path_a).K
    rng = np.random.default_rng(plan.seed)
    bodies = [{"weights": np.round(rng.normal(0.0, 1.0, k), 6).tolist(),
               "deadline_s": 600.0} for _ in range(n_bodies)]

    def line_for(bi: int, rid: str) -> str:
        return json.dumps({"id": rid, **bodies[bi]}, sort_keys=True)

    def cold_bodies(path: str) -> list:
        server = QueryServer(_query_engine(base, path),
                             ServePolicy(batch_max=8,
                                         default_deadline_s=600.0),
                             health="ok")
        co = Coalescer(server, linger_s=600.0, clock=lambda: 0.0)
        out = []
        for i in range(n_bodies):
            pairs = co.submit(line_for(i, f"ref{i}")) + co.flush()
            if len(pairs) != 1 or pairs[0][1].get("outcome") != "ok":
                raise AssertionError(f"{plan.name}: cold ref {i} not ok")
            out.append(pairs[0][1])
        return out

    ref = {0: cold_bodies(path_a), 1: cold_bodies(path_b)}
    for i in range(n_bodies):
        if _resp_body(ref[0][i]) == _resp_body(ref[1][i]):
            raise AssertionError(f"{plan.name}: generations answer body "
                                 f"{i} identically — staleness would be "
                                 "invisible")

    hit_gens: dict = {0: 0, 1: 0}
    for sd in range(seeds):
        s = DetScheduler(plan.seed + sd)
        cache = ResponseCache(max_entries, max_bytes, generation=0)
        cache._lock = DetLock(s, "cache")
        events: list = []

        def worker(w: int):
            wrng = random.Random(str((plan.seed, sd, w)))
            last_gen = -1
            for j in range(ops):
                bi = wrng.randrange(n_bodies)
                line = line_for(bi, f"c{w}x{j}")
                resp, tok = cache.lookup(line)
                if tok is None:
                    raise AssertionError(f"{plan.name}: body {bi} "
                                         "uncacheable")
                gen = tok[1]        # the key carries its generation
                if gen < last_gen:
                    raise AssertionError(
                        f"{plan.name}: seed {sd} worker {w} went "
                        f"backwards across the fence ({last_gen} -> "
                        f"{gen}) — stale generation served")
                last_gen = gen
                if resp is None:
                    filled = dict(ref[gen][bi])
                    filled["id"] = f"c{w}x{j}"
                    cache.put(tok, filled)
                    events.append(("miss", gen))
                else:
                    if _resp_body(resp) != _resp_body(ref[gen][bi]):
                        raise AssertionError(
                            f"{plan.name}: seed {sd} worker {w}: hit on "
                            f"body {bi} is not byte-equal the gen-{gen} "
                            "cold response")
                    events.append(("hit", gen))
                if len(cache) > max_entries:
                    raise AssertionError(f"{plan.name}: entry bound "
                                         f"blown: {len(cache)}")
                if cache.resident_bytes > max_bytes:
                    raise AssertionError(f"{plan.name}: byte bound "
                                         f"blown: {cache.resident_bytes}")

        def fencer():
            # park mid-storm before fencing: the fencer has far fewer
            # scheduling points than the workers, so without the idle
            # yields it would almost always fence before the first repeat
            # hit and the gen-0 side would go untested
            for _ in range(ops * n_threads // 2):
                s.yield_point("fencer-idle")
            cache.set_fence(generation=1)
            events.append(("fence", 1))

        for w in range(n_threads):
            s.spawn(worker, w, name=f"w{w}")
        s.spawn(fencer, name="fencer")
        s.run()
        for kind, gen in events:
            if kind == "hit":
                hit_gens[gen] += 1
        # post-storm: the stream must re-warm under the new fence
        cache._lock = threading.Lock()
        r0, t0 = cache.lookup(line_for(0, "rewarm0"))
        if t0[1] != 1:
            raise AssertionError(f"{plan.name}: fence did not move")
        if r0 is not None and _resp_body(r0) != _resp_body(ref[1][0]):
            raise AssertionError(f"{plan.name}: post-storm hit served a "
                                 "stale body across the fence")
    if not hit_gens[0] or not hit_gens[1]:
        raise AssertionError(f"{plan.name}: storm produced no hits on "
                             f"one side of the fence ({hit_gens}) — the "
                             "byte-equality check proved nothing")
    return {"det_seeds": seeds, "workers": n_threads,
            "ops_per_worker": ops, "bodies": n_bodies,
            "hits_gen0": hit_gens[0], "hits_gen1": hit_gens[1],
            "bounds": f"entries<={max_entries}, bytes<={max_bytes}",
            "fence": "monotone per worker, re-warm confirmed"}


# -- the query service --------------------------------------------------------

def _still_clock() -> float:
    """The in-process servers' clock: deadlines never lapse and no wall
    time reaches a response, so two runs of a drill are byte-equal."""
    return 0.0


def run_query_kill(plan, base: Baseline, root: str) -> dict:
    """query-kill-mid-batch: SIGKILL a real ``serve`` subprocess at the end
    of a named batch.  The responses emitted before the kill are durable
    (flushed and fsynced per emit) and byte-equal the clean replay's
    prefix — same floats, same order."""
    point, match = plan.param("point"), plan.param("match")
    d = base.fresh(root, plan.name, base.snaps[0])
    path = os.path.join(d, "state.npz")
    k = _query_engine(base, path).K
    req = _write_lines(os.path.join(d, "req.jsonl"),
                       _query_requests(plan.seed, 24, k))

    def serve(out_name):
        return ["serve", path, "--input", req,
                "--output", os.path.join(d, out_name),
                "--dead-letter", os.path.join(d, "dead_letter.jsonl"),
                "--batch-max", 8, "--deadline-s", 600, "--gulp",
                # fsync per emit: the durable prefix below then covers
                # ServePolicy.fsync_emits, not just Python's flush
                "--fsync-emits", "--device", base.device.type]

    _require_killed(plan, base.cli(serve("resp_killed.jsonl"), kill_at=point,
                                   match=match), f"{point} ({match})")
    survivors = _read_lines(os.path.join(d, "resp_killed.jsonl"))
    # killed at the END of batch 1's drain: batch 0's 8 responses were
    # emitted and flushed, batch 1's computed but never written
    if len(survivors) != 8:
        raise AssertionError(f"{plan.name}: expected batch 0's 8 durable "
                             f"responses before the kill, found "
                             f"{len(survivors)}")
    _require_ok(plan, base.cli(serve("resp_clean.jsonl")), "clean replay")
    clean = _read_lines(os.path.join(d, "resp_clean.jsonl"))
    if len(clean) != 24:
        raise AssertionError(f"{plan.name}: clean replay answered "
                             f"{len(clean)}/24 requests")
    if survivors != clean[:len(survivors)]:
        raise AssertionError(f"{plan.name}: pre-kill responses diverge from "
                             "the clean replay's prefix — the query loop is "
                             "not deterministic across restarts")
    return {"killed_at": match, "durable_responses": len(survivors),
            "answered_on_replay": len(clean),
            "subprocess_launches": [_manifest_launches(
                os.path.join(d, "serve_manifest.json"))],
            "killed_subprocesses": 1}


def _poison_lines(k: int) -> list:
    """(line, id, reason) of the six malformed requests of
    query-poison-slab, one per request-guard reason."""
    return [
        ('{"id": "p-json", "weights": [0.1,', None, "schema"),
        (json.dumps({"id": "p-missing"}), "p-missing", "schema"),
        (json.dumps({"id": "p-nan", "weights": [float("nan")] * k}),
         "p-nan", "nan_weight"),
        (json.dumps({"id": "p-short", "weights": [0.5]}),
         "p-short", "short_weights"),
        (json.dumps({"id": "p-dtype", "weights": ["x"] * k}),
         "p-dtype", "dtype"),
        (json.dumps({"id": "p-bench", "weights": [0.1] * k,
                     "benchmark": "nope"}), "p-bench", "unknown_benchmark"),
    ]


def _interleave_poison(clean: list, poison: list) -> list:
    """One poisoned line before every third clean one: the dead-letter
    path must not disturb the batching of the requests around it."""
    lines = []
    for i, ln in enumerate(clean):
        if i % 3 == 0 and i // 3 < len(poison):
            lines.append(poison[i // 3][0])
        lines.append(ln)
    return lines


def run_query_poison(plan, base: Baseline, root: str) -> dict:
    """query-poison-slab: malformed requests dead-letter with the right
    reason bits and never reach the device; the healthy requests' answers
    are byte-for-byte the all-clean run's."""
    import io

    from mfm_tpu_torch.serve import QueryServer, ServePolicy

    d = base.fresh(root, plan.name, base.snaps[0])
    path = os.path.join(d, "state.npz")
    engine = _query_engine(base, path)
    clean = _query_requests(plan.seed, 18, engine.K)
    poison = _poison_lines(engine.K)
    if len(poison) != int(plan.param("n_poison", len(poison))):
        raise AssertionError(f"{plan.name}: plan expects "
                             f"{plan.param('n_poison')} poisoned requests, "
                             f"harness built {len(poison)}")
    policy = ServePolicy(batch_max=8, default_deadline_s=600.0)
    dl = os.path.join(d, "dead_letter.jsonl")
    buf = io.StringIO()
    QueryServer(engine, policy, health="ok", dead_letter_path=dl,
                clock=_still_clock).run(
        iter(_interleave_poison(clean, poison)), buf, gulp=True)
    resps = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    records = [json.loads(ln) for ln in _read_lines(dl)]
    got = sorted(((r["id"], tuple(r["reasons"])) for r in records), key=str)
    want = sorted(((rid, (reason,)) for _, rid, reason in poison), key=str)
    if got != want:
        raise AssertionError(f"{plan.name}: dead-letter records {got} != "
                             f"expected {want}")
    ok = {r["id"]: r for r in resps if r["outcome"] == "ok"}
    if set(ok) != {f"q{i}" for i in range(len(clean))}:
        raise AssertionError(f"{plan.name}: healthy requests not all "
                             f"answered ok: {sorted(ok)}")
    # reference: a run that never saw the poison — identical batches, so
    # identical bytes per healthy id
    buf2 = io.StringIO()
    QueryServer(_query_engine(base, path), policy, health="ok",
                clock=_still_clock).run(iter(clean), buf2, gulp=True)
    ref = {r["id"]: r for r in
           (json.loads(ln) for ln in buf2.getvalue().splitlines())}
    for rid, resp in ok.items():
        if resp != ref[rid]:
            raise AssertionError(f"{plan.name}: healthy response {rid} "
                                 "diverged from the poison-free run")
    return {"dead_lettered": len(records), "healthy_ok": len(ok)}


def run_query_overflow(plan, base: Baseline, root: str) -> dict:
    """query-overflow-storm: a storm past the admission bound sheds
    EXACTLY the oldest requests, in order, and the survivors' answers are
    bitwise the engine's own."""
    import io

    from mfm_tpu_torch.obs.instrument import serve_summary_from_registry
    from mfm_tpu_torch.serve import QueryServer, ServePolicy

    queue_max = int(plan.param("queue_max", 8))
    storm = int(plan.param("storm", 24))
    d = base.fresh(root, plan.name, base.snaps[0])
    path = os.path.join(d, "state.npz")
    engine = _query_engine(base, path)
    lines = _query_requests(plan.seed, storm, engine.K)
    policy = ServePolicy(queue_max=queue_max, batch_max=queue_max,
                         default_deadline_s=600.0)
    before = serve_summary_from_registry()
    buf = io.StringIO()
    summary = QueryServer(engine, policy, health="ok",
                          clock=_still_clock).run(iter(lines), buf,
                                                  gulp=True)
    resps = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    shed = [r["id"] for r in resps if r["outcome"] == "shed"]
    n_shed = storm - queue_max
    if shed != [f"q{i}" for i in range(n_shed)]:
        raise AssertionError(f"{plan.name}: shed set/order {shed} is not "
                             f"oldest-first q0..q{n_shed - 1}")
    ok = {r["id"]: r for r in resps if r["outcome"] == "ok"}
    if set(ok) != {f"q{i}" for i in range(n_shed, storm)}:
        raise AssertionError(f"{plan.name}: survivors {sorted(ok)} are not "
                             f"the newest {queue_max} requests")
    # the registry is cumulative across plans: assert the DELTA
    if summary["shed_total"] - before["shed_total"] != n_shed:
        raise AssertionError(f"{plan.name}: shed_total counted "
                             f"{summary['shed_total'] - before['shed_total']}"
                             f", expected {n_shed}")
    ref = _query_engine(base, path)
    W = np.array([json.loads(lines[i])["weights"]
                  for i in range(n_shed, storm)], ref.dtype)
    res = ref.query(W)
    for j, i in enumerate(range(n_shed, storm)):
        r = ok[f"q{i}"]
        if (r["total_vol"] != float(res.total_vol[j])
                or r["contribution"] != np.asarray(
                    res.contribution[j]).tolist()):
            raise AssertionError(f"{plan.name}: survivor q{i} diverged from "
                                 "the engine's own answer")
    return {"shed": n_shed, "served": queue_max, "shed_order": shed}


def run_query_swap(plan, base: Baseline, root: str) -> dict:
    """query-ckpt-swap: hot-swap the engine under load — each batch must
    answer bitwise from its OWN checkpoint generation; a swap to a corrupt
    checkpoint force-opens the breaker (``fence_audit``) and the queued
    work is rejected with a retry-after, never computed on the bad
    state."""
    import io

    from mfm_tpu_torch.data.artifacts import ArtifactCorruptError
    from mfm_tpu_torch.serve import QueryServer, ServePolicy
    from mfm_tpu_torch.utils.chaos import corrupt_file

    d = base.fresh(root, plan.name, base.snaps[0])             # gen A
    d2 = base.fresh(root, plan.name + "-next", base.snaps[1])  # gen B
    path_a = os.path.join(d, "state.npz")
    path_b = os.path.join(d2, "state.npz")
    engine_a = _query_engine(base, path_a)
    engine_b = _query_engine(base, path_b)
    # gen B again, corrupted: the swap that must NOT be served
    d3 = base.fresh(root, plan.name + "-corrupt", base.snaps[1])
    path_c = os.path.join(d3, "state.npz")
    corrupt_file(path_c, int(plan.param("corrupt_bytes", 8)), plan.seed)
    try:
        base.load(path_c)
    except ArtifactCorruptError as err:
        fence_err = err
    else:
        raise AssertionError(f"{plan.name}: corrupted swap target loaded "
                             "clean")

    steps = [None, {"engine": engine_b, "health": "ok"}, fence_err]

    def reload_fn():
        step = steps.pop(0) if steps else None
        if isinstance(step, Exception):
            raise step
        return step

    lines = _query_requests(plan.seed, 24, engine_a.K)
    policy = ServePolicy(batch_max=8, default_deadline_s=600.0)
    buf = io.StringIO()
    server = QueryServer(engine_a, policy, health="ok", reload_fn=reload_fn,
                         clock=_still_clock)
    server.run(iter(lines), buf, gulp=True)
    byid = {r["id"]: r for r in
            (json.loads(ln) for ln in buf.getvalue().splitlines())}
    W = np.array([json.loads(ln)["weights"] for ln in lines], np.float64)
    ref_a = _query_engine(base, path_a).query(W[:8].astype(engine_a.dtype))
    ref_b = _query_engine(base, path_b).query(W[8:16].astype(engine_b.dtype))
    # the reference must be discriminating: gen B answers these weights
    # differently than gen A would, so a silently-failed swap cannot pass
    decoy = _query_engine(base, path_a).query(
        W[8:16].astype(engine_a.dtype))
    if np.array_equal(np.asarray(ref_b.total_vol),
                      np.asarray(decoy.total_vol)):
        raise AssertionError(f"{plan.name}: generations A and B answer "
                             "identically — the swap check proves nothing")
    for start, ref, eng in ((0, ref_a, engine_a), (8, ref_b, engine_b)):
        for j in range(8):
            r = byid[f"q{start + j}"]
            if r["outcome"] != "ok":
                raise AssertionError(f"{plan.name}: q{start + j} answered "
                                     f"{r['outcome']}, expected ok")
            if (r["total_vol"] != float(ref.total_vol[j])
                    or r["staleness"] != int(eng.staleness)):
                raise AssertionError(
                    f"{plan.name}: q{start + j} not served bitwise from its "
                    "own checkpoint generation")
    for i in range(16, 24):
        r = byid[f"q{i}"]
        if r["outcome"] != "rejected" or r.get("breaker") != "fence_audit" \
                or not r.get("retry_after_s", 0) > 0:
            raise AssertionError(f"{plan.name}: q{i} after the corrupt swap "
                                 f"got {r}, expected a fence_audit rejection "
                                 "with retry-after")
    if server.breaker.state != "open" \
            or server.breaker.open_reason != "fence_audit":
        raise AssertionError(f"{plan.name}: breaker ended "
                             f"{server.breaker.state}/"
                             f"{server.breaker.open_reason}, expected "
                             "open/fence_audit")
    return {"swapped_at_batch": 1, "breaker": "fence_audit", "rejected": 8}


def _steady_sizes(r: int) -> tuple:
    """Round r's batch sizes: round 0 warms buckets 8 and 32 with 5 and 20
    requests; later rounds move the sizes inside those buckets, so a batch
    that escapes its bucket shows up as a new signature."""
    return 5 - r % 4, 20 + 3 * (r % 4)


def run_query_steady(plan, base: Baseline, root: str) -> dict:
    """query-steady-state: after one warmup round per bucket, an arbitrary
    number of same-bucket query batches adds NO compile-contract event
    (``QueryEngine``'s padded batch is one signature per bucket), and one
    batch at a bucket this process has not served adds exactly one — the
    counter sees the query path, which launches no eigh."""
    from mfm_tpu_torch.serve import QueryServer, ServePolicy, bucket_for
    from mfm_tpu_torch.utils import contracts

    d = base.fresh(root, plan.name, base.snaps[0])
    engine = _query_engine(base, os.path.join(d, "state.npz"))
    rounds = int(plan.param("rounds", 6))
    server = QueryServer(engine, ServePolicy(batch_max=64,
                                             default_deadline_s=600.0),
                         health="ok", clock=_still_clock)

    def serve(srv, n: int, seed: int, what: str):
        for ln in _query_requests(seed, n, engine.K):
            srv.submit_line(ln)
        out = srv.drain()
        if len(out) != n or any(x["outcome"] != "ok" for x in out):
            raise AssertionError(f"{plan.name}: {what} ({n} requests) "
                                 f"answered {[x['outcome'] for x in out]}")

    def run_round(r):
        for s in _steady_sizes(r):
            serve(server, s, plan.seed + 31 * r + s, f"round {r}")

    with contracts.count_compiles() as warm:
        run_round(0)
    with contracts.assert_max_compiles(0, "steady-state query loop") as c:
        for r in range(1, rounds):
            run_round(r)
    # a bucket of the ladder whose padded batch this process never saw
    b = 128
    while True:
        w, bidx, _, _ = engine.pad_batch(np.zeros((1, engine.K)), bucket=b)
        if contracts.signature_of(contracts.QUERY_BATCH, w, bidx) \
                not in contracts._SEEN:
            break
        b *= 4
    n = b // 4 + 1
    if bucket_for(n) != b:
        raise AssertionError(f"{plan.name}: {n} requests pad to "
                             f"{bucket_for(n)}, not {b}")
    probe = QueryServer(engine, ServePolicy(batch_max=n,
                                            default_deadline_s=600.0),
                        health="ok", clock=_still_clock)
    with contracts.count_compiles() as new:
        serve(probe, n, plan.seed + 7, f"the bucket-{b} probe")
    if new.count != 1:
        raise AssertionError(f"{plan.name}: a batch at the unseen bucket {b}"
                             f" added {new.count} compile-contract events "
                             f"(want 1): {new.events}")
    return {"rounds": rounds,
            "buckets": sorted({bucket_for(s) for r in range(rounds)
                               for s in _steady_sizes(r)}),
            "warmup_compiles": warm.count, "compiles": c.count,
            "new_bucket": b, "new_bucket_compiles": new.count}


# -- scenarios, the sweep and grad --------------------------------------------

def _manifest_modulo_summary(path: str) -> str:
    """Canonical JSON of a scenario or sweep manifest with its ONE
    volatile block (the obs summary) removed — the bitwise-replay
    comparison key."""
    with open(path, encoding="utf-8") as fh:
        m = json.load(fh)
    m.pop("summary", None)
    return json.dumps(m, sort_keys=True)


def _killed_manifest_drill(plan, base: Baseline, root: str, cmd, mpath_for,
                           read) -> dict:
    """The shared crash drill of a read-only command that writes one
    atomic manifest beside the checkpoint: SIGKILL between the manifest's
    tmp write and its rename, then prove no torn manifest, the
    checkpoint's bytes unchanged, a clean re-run doctor-green
    (``--scenarios``), and a second clean run byte-equal modulo the obs
    summary.  ``cmd(out_dir)`` is the CLI argv; returns the recovered
    manifest and the completed runs' launches."""
    point = plan.param("point")
    d = base.fresh(root, plan.name, base.snaps[0])
    path = os.path.join(d, "state.npz")
    ckpt = _sha256(path)
    _require_killed(plan, base.cli(cmd(path, d), kill_at=point), point)
    mpath = mpath_for(d)
    if os.path.exists(mpath):
        raise AssertionError(f"{plan.name}: a manifest exists despite the "
                             "kill before its rename — the write is not "
                             "tmp-then-rename atomic")
    if _sha256(path) != ckpt:
        raise AssertionError(f"{plan.name}: the crashed run mutated the "
                             "checkpoint — it must be read-only against "
                             "the fenced store")
    proc = base.cli(cmd(path, d))
    _require_ok(plan, proc, "post-crash run")
    man = read(mpath)      # raises on a torn manifest
    base.doctor(plan, d, "--scenarios")
    d2 = os.path.join(root, plan.name + "-replay")
    os.makedirs(d2)
    proc2 = base.cli(cmd(path, d2))
    _require_ok(plan, proc2, "replay run")
    if _manifest_modulo_summary(mpath) != _manifest_modulo_summary(
            mpath_for(d2)):
        raise AssertionError(f"{plan.name}: two clean runs diverge (modulo "
                             "the obs summary) — the run is not "
                             "bitwise-replayable")
    return man, [_record_launches(plan, proc), _record_launches(plan, proc2)]


def run_scenario_kill(plan, base: Baseline, root: str) -> dict:
    """scenario-kill-mid-batch: SIGKILL a real ``scenario run`` subprocess
    between the manifest's tmp write and its rename.  No torn
    ``scenario_manifest.json`` may exist, the clean re-run must write one
    ``doctor --scenarios`` accepts, and two clean runs must be byte-equal
    modulo the volatile obs summary block."""
    from mfm_tpu_torch.scenario.manifest import (
        read_scenario_manifest,
        scenario_manifest_path_for,
    )

    def cmd(path, out_dir):
        return ["scenario", "run", path, "--preset", "crash-2015-analog",
                "--preset", "corr-meltup", "--preset", "covid-2020-analog",
                "--out", out_dir, "--device", base.device.type]

    man, launches = _killed_manifest_drill(
        plan, base, root, cmd, scenario_manifest_path_for,
        read_scenario_manifest)
    if man["n_ok"] != 3 or man["n_rejected"] != 0:
        raise AssertionError(f"{plan.name}: recovered run answered "
                             f"n_ok={man['n_ok']}, expected 3")
    return {"killed_at": plan.param("point"),
            "manifest_after_crash": "absent",
            "checkpoint": "bytes untouched", "recovered_n_ok": man["n_ok"],
            "replay": "bitwise modulo summary", "doctor": "green",
            "subprocess_launches": launches, "killed_subprocesses": 1}


def run_sweep_kill(plan, base: Baseline, root: str) -> dict:
    """sweep-kill-mid-stream: SIGKILL a real ``scenario sweep`` subprocess
    between the sweep manifest's tmp write and its rename.  No torn
    ``sweep_manifest.json``, the checkpoint's bytes untouched, the clean
    seeded re-run doctor-green, and two clean runs byte-equal modulo the
    obs summary (the seeded-replay contract of the streaming sweep)."""
    from mfm_tpu_torch.scenario.sweep import (
        read_sweep_manifest,
        sweep_manifest_path_for,
    )

    def cmd(path, out_dir):
        # small bounded sweep, refinement off: the plan probes the write
        # protocol, not the throughput
        return ["scenario", "sweep", path, "--n", 512, "--chunk", 128,
                "--seed", 11, "--top-k", 4, "--no-refine", "--out", out_dir,
                "--device", base.device.type]

    man, launches = _killed_manifest_drill(
        plan, base, root, cmd, sweep_manifest_path_for, read_sweep_manifest)
    counts = man["sweep"]["counts"]
    if counts["n_ok"] < 512:
        raise AssertionError(f"{plan.name}: recovered sweep answered "
                             f"n_ok={counts['n_ok']}, expected >= 512")
    return {"killed_at": plan.param("point"),
            "manifest_after_crash": "absent",
            "checkpoint": "bytes untouched",
            "recovered_n_ok": int(counts["n_ok"]),
            "replay": "bitwise modulo summary", "doctor": "green",
            "subprocess_launches": launches, "killed_subprocesses": 1}


def run_scenario_poison(plan, base: Baseline, root: str) -> dict:
    """scenario-poison-spec: poisoned specs (NaN shock, corr stress past
    -1, negative vol regime) are rejected per lane with reported problems
    while their healthy batchmates' covariances stay byte-equal to a run
    that never saw the poison — the lane-isolation contract of the
    batched kernel."""
    from mfm_tpu_torch.scenario import ScenarioBuilder, ScenarioEngine, preset

    d = base.fresh(root, plan.name, base.snaps[0])
    path = os.path.join(d, "state.npz")
    engine = ScenarioEngine.from_risk_state(*base.load(path),
                                            device=base.device)
    f0 = engine.factor_names[0]
    healthy = [preset("crash-2015-analog"), preset("corr-meltup"),
               ScenarioBuilder("shock-one").shock(f0, add=1e-3).build(),
               ScenarioBuilder("identity").build()]
    poison = [
        ScenarioBuilder("p-nan").shock(f0, add=float("nan")).build(),
        ScenarioBuilder("p-corr").correlation(-1.5).build(),
        ScenarioBuilder("p-vol").vol_regime(-1.0).build(),
    ]
    if len(poison) != int(plan.param("n_poison", len(poison))):
        raise AssertionError(f"{plan.name}: plan expects "
                             f"{plan.param('n_poison')} poisoned specs, "
                             f"harness built {len(poison)}")
    # the poison interleaved through the batch: lane isolation must not
    # depend on where the bad lanes sit
    mixed = [poison[0], healthy[0], healthy[1], poison[1], healthy[2],
             poison[2], healthy[3]]
    results = {r.spec.name: r for r in engine.run(mixed)}
    for p in poison:
        r = results[p.name]
        if r.status != "rejected" or not r.problems:
            raise AssertionError(f"{plan.name}: poisoned spec {p.name} was "
                                 f"{r.status} with problems {r.problems}, "
                                 "expected a reported rejection")
        if r.cov is not None:
            raise AssertionError(f"{plan.name}: rejected spec {p.name} "
                                 "still produced a covariance")
    # reference: a fresh engine that never saw the poison
    ref_engine = ScenarioEngine.from_risk_state(*base.load(path),
                                                device=base.device)
    ref = {r.spec.name: r for r in ref_engine.run(healthy)}
    for h in healthy:
        got, want = results[h.name], ref[h.name]
        if not got.ok or not want.ok:
            raise AssertionError(f"{plan.name}: healthy spec {h.name} "
                                 f"answered {got.status}/{want.status}")
        if got.cov.tobytes() != want.cov.tobytes():
            raise AssertionError(f"{plan.name}: healthy spec {h.name}'s "
                                 "covariance diverged from the poison-free "
                                 "run — lanes are not isolated")
    return {"rejected": [p.name for p in poison],
            "healthy_bitwise": [h.name for h in healthy]}


def run_grad_kill(plan, base: Baseline, root: str) -> dict:
    """grad-kill-mid-solve: SIGKILL a real ``grad sensitivity`` subprocess
    between the grad report's tmp write and its rename.  No torn
    ``grad_report.json``, the checkpoint's bytes untouched (the grad path
    only READS the state), and a clean re-run writes a report
    ``read_grad_report`` accepts in a directory ``doctor --scenarios`` is
    green on."""
    from mfm_tpu_torch.grad.report import (
        grad_report_path_for,
        read_grad_report,
    )

    point = plan.param("point")
    d = base.fresh(root, plan.name, base.snaps[0])
    path = os.path.join(d, "state.npz")
    ckpt = _sha256(path)
    cmd = ["grad", "sensitivity", path, "--preset", "covid-2020-analog",
           "--out", d, "--device", base.device.type]
    _require_killed(plan, base.cli(cmd, kill_at=point), point)
    rpath = grad_report_path_for(d)
    if os.path.exists(rpath):
        raise AssertionError(f"{plan.name}: a grad report exists despite "
                             "the kill before its rename — the write is "
                             "not tmp-then-rename atomic")
    if _sha256(path) != ckpt:
        raise AssertionError(f"{plan.name}: the checkpoint's bytes "
                             "changed under a read-only grad run")
    proc = base.cli(cmd)
    _require_ok(plan, proc, "post-crash grad run")
    rep = read_grad_report(rpath)   # raises on a torn report
    if rep["grad_kind"] != "sensitivity" or rep["n_entries"] != 1:
        raise AssertionError(f"{plan.name}: recovered report answered "
                             f"kind={rep['grad_kind']} "
                             f"n_entries={rep['n_entries']}, expected one "
                             "sensitivity entry")
    base.doctor(plan, d, "--scenarios")
    return {"killed_at": point, "report_after_crash": "absent",
            "checkpoint": "bytes untouched",
            "recovered_entries": rep["n_entries"], "doctor": "green",
            "subprocess_launches": [_record_launches(plan, proc)],
            "killed_subprocesses": 1}


# -- tracing, the flight recorder and the response cache ----------------------

def run_trace_kill(plan, base: Baseline, root: str) -> dict:
    """trace-kill-mid-flush: SIGKILL between the Chrome trace's tmp write
    and its rename — the trace is the LAST artifact a ``--metrics-dir``
    run flushes, so the checkpoint and manifest (fenced before it) must be
    untouched (carries bitwise, next slab bitwise), no torn trace.json may
    exist, and a clean re-run must leave a parseable trace and a
    doctor-green directory."""
    from mfm_tpu_torch.obs.manifest import read_run_manifest
    from mfm_tpu_torch.obs.trace import parse_chrome_trace

    point = plan.param("point")
    d = base.fresh(root, plan.name, base.snaps[0])
    path = os.path.join(d, "state.npz")
    tables = os.path.join(d, "tables")
    mdir = os.path.join(d, "metrics")
    base.run_update(plan, 0, path, tables, kill_at=point,
                    extra=("--metrics-dir", mdir))
    trace_path = os.path.join(mdir, "trace.json")
    if os.path.exists(trace_path):
        raise AssertionError(f"{plan.name}: a trace.json exists despite the "
                             "kill before its rename — the flush is not "
                             "tmp-then-rename atomic")
    # the checkpoint and manifest were fenced BEFORE the trace flush: the
    # slab is carried, the replay bitwise, the manifest readable with its
    # root trace id
    state, meta = base.load(path)
    if meta["last_date"] != base.slab_dates[0][-1]:
        raise AssertionError(f"{plan.name}: checkpoint does not carry the "
                             "appended dates — trace kill corrupted it")
    _assert_carries_equal(_carries(state), base.carries[0],
                          f"{plan.name} (subprocess checkpoint)")
    del state
    man = read_run_manifest(os.path.join(d, "run_manifest.json"))
    if not man.get("trace_id"):
        raise AssertionError(f"{plan.name}: manifest fenced before the "
                             "trace flush carries no root trace_id")
    res = base.append(path, base.slabs[1])
    _assert_outputs_equal(_outputs_by_date(res), base.outputs[1],
                          base.slab_dates[1], plan.name)
    del res
    # a clean re-run flushes a parseable, Perfetto-loadable trace
    sub = base.run_update(plan, 2, path, tables,
                          extra=("--metrics-dir", mdir))
    with open(trace_path, encoding="utf-8") as fh:
        text = fh.read()
    try:
        events = parse_chrome_trace(text)
    except ValueError as err:
        raise AssertionError(f"{plan.name}: recovered trace.json fails the "
                             f"schema check: {err}")
    base.doctor(plan, d)
    return {"killed_at": point, "trace_after_crash": "absent",
            "recovered_trace_events": len(events),
            "manifest_trace_id": man["trace_id"], "doctor": "green",
            "subprocess_launches": [sub], "killed_subprocesses": 1}


#: the flight-recorder drill's driver: stage a failed batch and a breaker
#: trip, then dump (imports the port's recorder and launch counter only)
_FLIGHTREC_DRIVER = """\
import json
import sys

from mfm_tpu_torch.obs import flightrec as fr
from mfm_tpu_torch.ops.eigh_cuda import launch_counts

fr.arm(sys.argv[1])
fr.record_event("batch_error", trace_id="df" * 16, kind_of="query",
                scenario="base", n=4, detail="staged batch failure")
fr.record_event("breaker_open", reason="failures")
out = fr.trigger_dump("breaker_open",
                      state={"breaker": {"state": "open",
                                         "open_reason": "failures"}})
print(json.dumps({"dump": out, "kernels": {"launches": launch_counts()}}),
      flush=True)
"""


def run_flightrec_kill(plan, base: Baseline, root: str) -> dict:
    """flightrec-kill-mid-dump: SIGKILL between the flight recorder's tmp
    write and its rename.  The postmortem writer runs INSIDE the serving
    process next to the checkpoint, so the drill proves a crash mid-dump
    leaves no torn ``flightrec.json`` and the checkpoint's bytes
    unchanged, that a clean re-trigger writes a dump ``read_flightrec``
    accepts (the staged breaker trigger and the triggering request's
    trace id), and that the checkpoint still serves: a CLI update, its
    carries and the next slab bitwise, the directory doctor-green."""
    from mfm_tpu_torch.obs.flightrec import FLIGHTREC_NAME, read_flightrec

    point = plan.param("point")
    d = base.fresh(root, plan.name, base.snaps[0])
    path = os.path.join(d, "state.npz")
    frec_path = os.path.join(d, FLIGHTREC_NAME)
    before = _sha256(path)
    driver = os.path.join(d, "frec_driver.py")
    with open(driver, "w", encoding="utf-8") as fh:
        fh.write(_FLIGHTREC_DRIVER)
    cmd = [sys.executable, driver, frec_path]
    _require_killed(plan, base.run(cmd, kill_at=point), point)
    if os.path.exists(frec_path):
        raise AssertionError(f"{plan.name}: a flightrec.json exists despite "
                             "the kill before its rename — the dump is not "
                             "tmp-then-rename atomic")
    if _sha256(path) != before:
        raise AssertionError(f"{plan.name}: the flightrec dump touched the "
                             "checkpoint bytes")
    proc = base.run(cmd)
    _require_ok(plan, proc, "post-crash dump")
    try:
        rec = read_flightrec(frec_path)
    except ValueError as err:
        raise AssertionError(f"{plan.name}: recovered flightrec.json fails "
                             f"the schema check: {err}")
    if rec["trigger"] != "breaker_open":
        raise AssertionError(f"{plan.name}: dump trigger is "
                             f"{rec['trigger']!r}, wanted 'breaker_open'")
    if rec.get("trace_id") != "df" * 16:
        raise AssertionError(f"{plan.name}: dump lost the triggering "
                             f"request's trace id ({rec.get('trace_id')!r})")
    if len(rec["events"]) < 2:
        raise AssertionError(f"{plan.name}: dump carries "
                             f"{len(rec['events'])} events, wanted >= 2")
    # the checkpoint the recorder dumped beside must still be fully usable:
    # the CLI appends a slab, the carries and next slab replay bitwise
    sub = base.run_update(plan, 0, path, os.path.join(d, "tables"))
    state, meta = base.load(path)
    if meta["last_date"] != base.slab_dates[0][-1]:
        raise AssertionError(f"{plan.name}: checkpoint does not carry the "
                             "appended dates after the crash drill")
    _assert_carries_equal(_carries(state), base.carries[0],
                          f"{plan.name} (subprocess checkpoint)")
    del state
    res = base.append(path, base.slabs[1])
    _assert_outputs_equal(_outputs_by_date(res), base.outputs[1],
                          base.slab_dates[1], plan.name)
    del res
    base.doctor(plan, d)
    return {"killed_at": point, "flightrec_after_crash": "absent",
            "recovered_trigger": rec["trigger"],
            "recovered_events": len(rec["events"]),
            "recovered_trace_id": rec["trace_id"], "doctor": "green",
            "subprocess_launches": [_last_json(proc.stdout)["kernels"][
                "launches"], sub],
            "killed_subprocesses": 1}


def run_cache_stale(plan, base: Baseline, root: str) -> dict:
    """cache-stale-generation: the response cache never outlives its
    checkpoint generation.  Phase 1 (in process): a pure repeat stream is
    all hits — it never drains, so the fence can only move via the
    throttled hit-path reload poll.  After a hot swap to gen B no response
    body may equal the pre-reload cached body, and the stream re-warms on
    gen B (exactly one miss, then hits again under the new fence).
    Phase 2 (subprocesses): SIGKILL a real ``risk --update`` after the tmp
    write (a torn publish — the pointer never flipped), then a cache-ON
    ``serve --watch`` over a repeat stream must replay byte-for-byte per
    request id against a cache-OFF run: the torn tmp moves neither the
    fence nor a single float."""
    from mfm_tpu_torch.data.artifacts import read_pointer
    from mfm_tpu_torch.obs.manifest import (
        read_run_manifest,
        write_run_manifest,
    )
    from mfm_tpu_torch.serve import (
        Coalescer,
        QueryServer,
        ResponseCache,
        ServePolicy,
    )

    repeats = int(plan.param("repeats", 6))
    d = base.fresh(root, plan.name, base.snaps[0])             # gen A
    d2 = base.fresh(root, plan.name + "-next", base.snaps[1])  # gen B
    path_a = os.path.join(d, "state.npz")
    path_b = os.path.join(d2, "state.npz")
    engine_a = _query_engine(base, path_a)
    engine_b = _query_engine(base, path_b)
    k = engine_a.K
    w = np.round(np.random.default_rng(plan.seed).normal(0.0, 1.0, k), 6)
    ref_a = _query_engine(base, path_a).query(w[None].astype(engine_a.dtype))
    ref_b = _query_engine(base, path_b).query(w[None].astype(engine_b.dtype))
    # the reference must be discriminating: if both generations answer the
    # repeat body identically, a stale hit would be invisible
    if np.array_equal(np.asarray(ref_a.total_vol),
                      np.asarray(ref_b.total_vol)):
        raise AssertionError(f"{plan.name}: generations A and B answer "
                             "identically — the staleness check proves "
                             "nothing")

    gen_a = int((read_pointer(path_a) or {}).get("generation") or 0)
    cache = ResponseCache(64, 1 << 20, generation=gen_a)
    flips = {"armed": False, "done": False}

    def reload_fn():
        if not flips["armed"] or flips["done"]:
            return None
        flips["done"] = True
        # what the CLI's watch closure does: bump the fence BEFORE the
        # engine swap lands
        cache.set_fence(generation=gen_a + 1)
        return {"engine": engine_b, "health": "ok"}

    t = {"now": 0.0}
    server = QueryServer(engine_a,
                         ServePolicy(batch_max=8, default_deadline_s=600.0),
                         health="ok", reload_fn=reload_fn,
                         clock=lambda: t["now"])
    co = Coalescer(server, linger_s=1.0, clock=lambda: t["now"], cache=cache)
    wlist = w.tolist()

    def ask(tag, i):
        line = json.dumps({"id": f"{tag}{i}", "weights": wlist,
                           "deadline_s": 600.0}, sort_keys=True)
        pairs = co.submit(line) + co.flush()
        if len(pairs) != 1 or pairs[0][1].get("outcome") != "ok":
            raise AssertionError(f"{plan.name}: {tag}{i} answered "
                                 f"{[p[1] for p in pairs]}, expected one ok")
        return pairs[0][1]

    pre = [ask("pre", i) for i in range(repeats)]
    s0 = cache.stats()
    if (s0["misses"], s0["hits"]) != (1, repeats - 1):
        raise AssertionError(f"{plan.name}: pre-reload repeat stream was "
                             f"not 1 miss + {repeats - 1} hits: {s0}")
    for i, r in enumerate(pre):
        if r["total_vol"] != float(ref_a.total_vol[0]):
            raise AssertionError(f"{plan.name}: pre{i} not served bitwise "
                                 "from gen A")
    # arm the swap and move the clock past the linger budget: the FIRST
    # post submit's throttled hit-path poll must perform the reload (the
    # stream is all hits — nothing else ever drains)
    flips["armed"] = True
    t["now"] = 5.0
    post = [ask("post", i) for i in range(repeats)]
    if not flips["done"]:
        raise AssertionError(f"{plan.name}: the hit-path poll never ran "
                             "the reload — an all-hits stream would serve "
                             "a retired generation forever")
    stale = {_resp_body(r) for r in pre}
    for i, r in enumerate(post):
        if _resp_body(r) in stale:
            raise AssertionError(f"{plan.name}: post{i} served the "
                                 "pre-reload cached body after the "
                                 "generation fence moved")
        if r["total_vol"] != float(ref_b.total_vol[0]):
            raise AssertionError(f"{plan.name}: post{i} not served bitwise "
                                 "from gen B")
    s1 = cache.stats()
    if (s1["misses"] - s0["misses"],
            s1["hits"] - s0["hits"]) != (1, repeats - 1):
        raise AssertionError(f"{plan.name}: post-reload stream did not "
                             f"re-warm under the new fence (want 1 miss + "
                             f"{repeats - 1} hits): {s1} vs {s0}")

    # -- phase 2: torn publish under a cache-fronted --watch serve ---------
    point = plan.param("point")
    dk = base.fresh(root, plan.name + "-kill", base.snaps[0])
    path = os.path.join(dk, "state.npz")
    tables = os.path.join(dk, "tables")
    # a clean slab-0 update first: it leaves a run manifest beside the
    # checkpoint, so the serve below stamps its health (an "unknown"
    # verdict marks every response degraded, hence uncacheable)
    upd = base.run_update(plan, 0, path, tables)
    # the small synthetic panel may trip a health check that would stamp
    # every response degraded (uncacheable) and open the breaker: the
    # verdict is overwritten through the manifest API, so the serve sees
    # the healthy-shop precondition this plan is about
    rman = read_run_manifest(dk)
    rman["health"] = {"status": "ok", "checks": {}}
    write_run_manifest(dk, rman)
    state_bytes = _sha256(path)
    base.run_update(plan, 1, path, tables, kill_at=point)
    if _sha256(path) != state_bytes:
        raise AssertionError(f"{plan.name}: the torn publish mutated the "
                             "live checkpoint's bytes")
    rng = np.random.default_rng(plan.seed + 1)
    bodies = [np.round(rng.normal(0.0, 1.0, k), 6).tolist()
              for _ in range(4)]
    n = 4 * repeats
    req = _write_lines(os.path.join(dk, "req.jsonl"), [
        json.dumps({"id": f"r{i}", "weights": bodies[i % 4],
                    "deadline_s": 600.0}, sort_keys=True)
        for i in range(n)])

    def serve(out_name, *extra):
        # no --gulp: gulp admits ALL lines before the first drain, so
        # nothing would ever hit — batch-max 8 over 4 distinct bodies
        # computes the first two batches' worth and hits the rest
        proc = base.cli(["serve", path, "--input", req,
                         "--output", os.path.join(dk, out_name),
                         "--batch-max", 8, "--deadline-s", 600, "--watch",
                         "--device", base.device.type, *extra])
        _require_ok(plan, proc, f"serve {extra or ('cache on',)}")
        man = read_run_manifest(os.path.join(dk, "serve_manifest.json"))
        return ({json.loads(ln)["id"]: ln
                 for ln in _read_lines(os.path.join(dk, out_name))}, man)

    on, man_on = serve("resp_cache_on.jsonl")
    cb = (man_on.get("serve") or {}).get("cache") or {}
    if not cb.get("hits_total"):
        raise AssertionError(f"{plan.name}: the cache-on run recorded no "
                             "hits — the bitwise replay proves nothing")
    off, man_off = serve("resp_cache_off.jsonl", "--no-cache")
    ids = {f"r{i}" for i in range(n)}
    if set(on) != ids or set(off) != ids:
        raise AssertionError(f"{plan.name}: answered {len(on)} cached / "
                             f"{len(off)} uncached of {n} requests")
    diverged = [i for i in sorted(ids) if on[i] != off[i]]
    if diverged:
        raise AssertionError(f"{plan.name}: {len(diverged)} responses "
                             f"diverge between the cache-on and cache-off "
                             f"runs (first: {diverged[0]}) — the torn "
                             "publish perturbed the cache-fronted replay")
    return {"reload": "fence moved via hit-path poll",
            "pre_hits": repeats - 1, "rewarm_misses": 1,
            "killed_at": point, "cache_on_hits": int(cb["hits_total"]),
            "replay": "bitwise per id", "responses": n,
            "subprocess_launches": [upd, man_on["kernels"]["launches"],
                                    man_off["kernels"]["launches"]],
            "killed_subprocesses": 1}


# -- the fleet ----------------------------------------------------------------

def _fleet_launches(d: str, n_replicas: int) -> list:
    """The eigh launches of a fleet's completed processes: the front end
    (its manifest) and every worker that wrote its shard."""
    from mfm_tpu_torch.serve.replica import (
        FLEET_MANIFEST_NAME,
        WORKER_MANIFEST_FMT,
    )

    out = [_manifest_launches(os.path.join(d, FLEET_MANIFEST_NAME))]
    for i in range(n_replicas):
        shard = os.path.join(d, WORKER_MANIFEST_FMT.format(idx=i))
        if os.path.exists(shard):
            out.append(_manifest_launches(shard))
    return out


def _read_fleet(d: str) -> dict:
    from mfm_tpu_torch.serve.replica import FLEET_MANIFEST_NAME

    with open(os.path.join(d, FLEET_MANIFEST_NAME), encoding="utf-8") as fh:
        return json.load(fh)["fleet"]


def _require_audit(plan, fleet: dict) -> None:
    if not fleet["audit"]["consistent"]:
        raise AssertionError(
            f"{plan.name}: delivery audit broken — delivered "
            f"{fleet['audit']['delivered_total']} (replicas "
            f"{fleet['audit']['replica_outcomes_sum']} + frontend-local "
            f"{fleet['audit']['frontend_local_total']}) of "
            f"{fleet['audit']['accepted_total']} accepted requests")


class _FleetReplay:
    """The fault-free single-process ``serve --gulp`` replay of a fleet
    drill's request lines, in a directory of its own over the same
    checkpoint generation, started before the fleet so that its start
    overlaps the fleet's."""

    def __init__(self, plan, base: Baseline, root: str, lines: list):
        self.plan = plan
        self.d = base.fresh(root, plan.name + "-replay", base.snaps[0])
        req = _write_lines(os.path.join(self.d, "req.jsonl"), lines)
        self.out = os.path.join(self.d, "resp_clean.jsonl")
        self.proc = subprocess.Popen(
            [*_cli_argv(), "serve", os.path.join(self.d, "state.npz"),
             "--input", req, "--output", self.out, "--batch-max", "8",
             "--deadline-s", "600", "--gulp", "--device", base.device.type],
            env=_sub_env(), cwd=REPO_ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)

    def result(self):
        """(response lines, the replay's launches)."""
        try:
            _, err = self.proc.communicate(timeout=600)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
        if self.proc.returncode != 0:
            raise AssertionError(f"{self.plan.name}: single-process replay "
                                 f"failed rc={self.proc.returncode}\n"
                                 f"{err[-2000:]}")
        return _read_lines(self.out), _manifest_launches(
            os.path.join(self.d, "serve_manifest.json"))

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def run_fleet_kill(plan, base: Baseline, root: str) -> dict:
    """fleet-kill-replica: SIGKILL one of three worker replicas mid-drain
    (after it computed a batch, before its envelopes hit the pipe).  The
    survivors keep answering — the front end re-dispatches the dead
    replica's in-flight batch, every request id gets a response bitwise
    equal to the single-process replay, the merged fleet manifest counts
    the loss while its delivery audit still balances, the checkpoint's
    bytes are untouched, and ``doctor --serve`` stays green."""
    n_replicas = int(plan.param("replicas", 3))
    victim = int(plan.param("replica", 1))
    d = base.fresh(root, plan.name, base.snaps[0])
    path = os.path.join(d, "state.npz")
    k = _query_engine(base, path).K
    # 96 requests / batch-max 8 = 12 batches.  The EWMA router hands the
    # first cycle to each fresh replica in index order, then routes by
    # batch wall with a starve_rounds=4 starvation guard — so the victim
    # (replica 1) is GUARANTEED its second batch (the MATCH=batch1 kill
    # point) by dispatch ~6 at the latest, with batches still queued
    # behind it for the survivors to absorb
    lines = _query_requests(plan.seed, 96, k)
    req = _write_lines(os.path.join(d, "req.jsonl"), lines)
    state_bytes = _sha256(path)
    replay = _FleetReplay(plan, base, root, lines)
    try:
        fleet_resp, fleet, launches = _run_fleet_kill(plan, base, d, path,
                                                      req, n_replicas,
                                                      victim, state_bytes)
        clean, replay_launches = replay.result()
    finally:
        replay.stop()
    if len(fleet_resp) != 96:
        raise AssertionError(f"{plan.name}: fleet answered "
                             f"{len(fleet_resp)}/96 requests")
    if fleet_resp != clean:
        diverge = sum(1 for a, b in zip(fleet_resp, clean) if a != b)
        raise AssertionError(
            f"{plan.name}: {diverge} fleet responses diverge from the "
            "single-process replay — re-dispatch is not deterministic")
    base.doctor(plan, d, "--serve")
    return {"killed_replica": victim, "killed_at": plan.param("match"),
            "survivors": n_replicas - 1, "responses": len(fleet_resp),
            "redispatches": fleet["transport"]["redispatches"],
            "replay": "bitwise", "doctor": "green",
            "subprocess_launches": launches + [replay_launches],
            "killed_subprocesses": 1}


def _run_fleet_kill(plan, base: Baseline, d: str, path: str, req: str,
                    n_replicas: int, victim: int, state_bytes: str):
    """fleet-kill-replica's fleet: the run, and its manifest's checks.
    Returns (response lines, the fleet block, the processes' launches)."""
    proc = base.cli(["serve", path, "--input", req,
                     "--output", os.path.join(d, "resp_fleet.jsonl"),
                     "--replicas", n_replicas, "--batch-max", 8,
                     "--deadline-s", 600, "--device", base.device.type],
                    kill_at=plan.param("point"), match=plan.param("match"),
                    env={"MFM_CHAOS_KILL_REPLICA": str(victim)})
    _require_ok(plan, proc, "the front end (it must survive a replica's "
                            "death)")
    if _sha256(path) != state_bytes:
        raise AssertionError(f"{plan.name}: the checkpoint's bytes "
                             "changed under a read-only serving fleet")
    if os.path.exists(os.path.join(d, f"serve_manifest.r{victim}.json")):
        raise AssertionError(f"{plan.name}: the SIGKILLed replica left a "
                             "manifest shard — it was not killed mid-drain")
    fleet = _read_fleet(d)
    lost = [r["replica"] for r in fleet["replicas"] if r["lost"]]
    if lost != [victim]:
        raise AssertionError(f"{plan.name}: merged manifest counts lost "
                             f"replicas {lost}, expected [{victim}]")
    rc = {r["replica"]: r["exit_code"] for r in fleet["replicas"]}
    if rc[victim] != -signal.SIGKILL:
        raise AssertionError(f"{plan.name}: replica {victim} exited "
                             f"{rc[victim]}, not by SIGKILL at its point")
    _require_audit(plan, fleet)
    # the chaos point fires AFTER the victim computed its batch but
    # BEFORE the envelopes hit the pipe — so exactly that in-flight batch
    # (8 requests) MUST show up in the transport redispatch counters
    if fleet["transport"]["redispatches"] < 8:
        raise AssertionError(
            f"{plan.name}: transport counters show "
            f"{fleet['transport']['redispatches']} redispatched requests, "
            "expected the victim's full in-flight batch (8)")
    return (_read_lines(os.path.join(d, "resp_fleet.jsonl")), fleet,
            _fleet_launches(d, n_replicas))


def _worker_pids(fe_pid: int, n: int, deadline_s: float = 240.0) -> dict:
    """``{worker_id: pid}`` of a live front end's spawned worker children,
    read off /proc (the drill signals them directly, bypassing the front
    end — that is the point: the front end must DISCOVER the faults)."""
    pids: dict = {}
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline_s and len(pids) < n:
        try:
            with open(f"/proc/{fe_pid}/task/{fe_pid}/children") as fh:
                kids = fh.read().split()
        except OSError:
            kids = []
        for cpid in kids:
            try:
                with open(f"/proc/{cpid}/cmdline", "rb") as fh:
                    argv = fh.read().split(b"\0")
            except OSError:
                continue
            if b"--worker-id" in argv:
                wid = int(argv[argv.index(b"--worker-id") + 1])
                pids[wid] = int(cpid)
        if len(pids) < n:
            time.sleep(0.2)
    if len(pids) < n:
        raise AssertionError(f"found {len(pids)}/{n} worker children of "
                             f"frontend pid {fe_pid}")
    return pids


def _drive_fleet_storm(plan, base: Baseline, d: str, path: str, lines: list,
                       n_replicas: int, mid_storm) -> list:
    """Feed ``lines`` to a live ``serve --replicas N`` front end over its
    stdin in two halves, calling ``mid_storm(worker_pids)`` between them
    (after the first half's responses are durable, so no batch is in
    flight when the signals land).  Returns the response lines; the front
    end must exit 0 whatever ``mid_storm`` did to its workers."""
    out = os.path.join(d, "resp_fleet.jsonl")
    cmd = [*_cli_argv(), "serve", path, "--output", out,
           "--replicas", str(n_replicas), "--batch-max", "8",
           "--deadline-s", "600", "--device", base.device.type,
           # the SIGSTOP lands while every worker is idle (first half
           # durable), so the HEARTBEAT must detect it: idle workers are
           # pinged after 0.5 s and quarantined 1 s later.  The per-I/O
           # deadline stays generous — a worker's first batch pays its
           # start in silence
           "--worker-timeout-s", "60", "--heartbeat-s", "0.5",
           "--heartbeat-timeout-s", "1"]
    proc = subprocess.Popen(cmd, env=_sub_env(), cwd=REPO_ROOT,
                            stdin=subprocess.PIPE,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    pids: dict = {}
    try:
        pids = _worker_pids(proc.pid, n_replicas)
        half = len(lines) // 2
        proc.stdin.write("\n".join(lines[:half]) + "\n")
        proc.stdin.flush()
        t0 = time.monotonic()
        while time.monotonic() - t0 < 240.0:
            try:
                if len(_read_lines(out)) >= half:
                    break
            except OSError:
                pass
            if proc.poll() is not None:
                raise AssertionError(
                    f"{plan.name}: frontend died during the first half "
                    f"(rc={proc.returncode})\n{proc.stderr.read()[-2000:]}")
            time.sleep(0.2)
        else:
            raise AssertionError(f"{plan.name}: first {half} responses "
                                 "never became durable")
        mid_storm(pids)
        # idle past --heartbeat-s before releasing the second half: every
        # worker's last I/O goes stale, so the router PINGS each pick
        # before trusting it — the SIGSTOPped worker misses its pong
        # within --heartbeat-timeout-s instead of burning the full
        # --worker-timeout-s batch deadline
        time.sleep(1.0)
        proc.stdin.write("\n".join(lines[half:]) + "\n")
        proc.stdin.close()
        rc = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        # a SIGSTOPped worker never dies with its parent — kill any
        # straggler so the scratch tree can be reaped
        for pid in pids.values():
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass
    if rc != 0:
        raise AssertionError(
            f"{plan.name}: the frontend must survive the storm, got "
            f"rc={rc}\n{proc.stderr.read()[-2000:]}")
    return _read_lines(out)


def _assert_fleet_bitwise_by_id(plan, fleet_resp: list, clean: list,
                                n: int) -> None:
    """Live feeding makes batch boundaries timing-dependent, so the
    answers are compared BY REQUEST ID, not by line order — the per-id
    bytes are still the single-process replay's."""
    want = {json.loads(ln)["id"]: ln for ln in clean}
    got = {json.loads(ln)["id"]: ln for ln in fleet_resp}
    if len(got) != n:
        raise AssertionError(f"{plan.name}: fleet answered {len(got)}/{n} "
                             "request ids")
    diverged = [rid for rid, ln in got.items() if want.get(rid) != ln]
    if diverged:
        raise AssertionError(
            f"{plan.name}: {len(diverged)} responses diverge from the "
            f"fault-free replay (first: {sorted(diverged)[0]}) — "
            "re-dispatch after the storm is not deterministic")


def run_fleet_kill_host(plan, base: Baseline, root: str) -> dict:
    """fleet-kill-host: the multi-host drill.  2 simulated hosts x 2
    workers; mid-storm both of host 1's workers die by SIGKILL while
    worker ``wedge`` (on host 0) is SIGSTOPped — wedged, not dead.  The
    surviving worker answers everything (bitwise by id the fault-free
    replay's), the manifest counts 2 lost + 1 wedged with a balanced
    audit and the discovery in its transport block, the checkpoint's
    bytes stay untouched, and ``doctor --serve`` stays green."""
    hosts = int(plan.param("hosts", 2))
    wph = int(plan.param("workers_per_host", 2))
    kill_host = int(plan.param("kill_host", 1))
    wedge = int(plan.param("wedge", 1))
    n = int(plan.param("n", 64))
    n_replicas = hosts * wph
    victims = [j for j in range(n_replicas) if j // wph == kill_host]
    d = base.fresh(root, plan.name, base.snaps[0])
    path = os.path.join(d, "state.npz")
    lines = _query_requests(plan.seed, n, _query_engine(base, path).K)
    state_bytes = _sha256(path)

    def mid_storm(pids):
        os.kill(pids[wedge], signal.SIGSTOP)
        for j in victims:
            os.kill(pids[j], signal.SIGKILL)

    replay = _FleetReplay(plan, base, root, lines)
    try:
        fleet_resp = _drive_fleet_storm(plan, base, d, path, lines,
                                        n_replicas, mid_storm)
        clean, replay_launches = replay.result()
    finally:
        replay.stop()
    if _sha256(path) != state_bytes:
        raise AssertionError(f"{plan.name}: the checkpoint's bytes "
                             "changed under a read-only serving fleet")
    fleet = _read_fleet(d)
    launches = _fleet_launches(d, n_replicas)
    _assert_fleet_bitwise_by_id(plan, fleet_resp, clean, n)
    lost = sorted(r["replica"] for r in fleet["replicas"] if r["lost"])
    wedged = sorted(r["replica"] for r in fleet["replicas"] if r["wedged"])
    if not set(victims) <= set(lost):
        raise AssertionError(f"{plan.name}: manifest counts lost {lost}, "
                             f"expected at least {victims}")
    rc = {r["replica"]: r["exit_code"] for r in fleet["replicas"]}
    if any(rc[j] != -signal.SIGKILL for j in victims):
        raise AssertionError(f"{plan.name}: host {kill_host}'s workers "
                             f"exited {[rc[j] for j in victims]}, not by "
                             "SIGKILL")
    if wedged != [wedge]:
        raise AssertionError(f"{plan.name}: manifest counts wedged "
                             f"{wedged}, expected [{wedge}] — the "
                             "SIGSTOPped worker was not detected as such")
    tr = fleet["transport"]
    # whether dead workers cost a REDISPATCH (batch sent, EOF on the
    # reply) or are caught by the pre-dispatch heartbeat (no batch ever
    # sent) is a timing race this drill does not pin down —
    # fleet-kill-replica pins the guaranteed-redispatch case.  The wedge,
    # though, can only be discovered by a bounded mechanism, and that
    # discovery must be on the books
    if tr["heartbeat_misses"] + tr["io_timeouts"] < 1:
        raise AssertionError(f"{plan.name}: the wedge left no heartbeat "
                             "miss or I/O timeout in the counters")
    _require_audit(plan, fleet)
    base.doctor(plan, d, "--serve")
    return {"killed_host": kill_host, "killed_workers": victims,
            "wedged_worker": wedge, "lost": lost, "wedged": wedged,
            "responses": len(fleet_resp),
            "redispatches": tr["redispatches"],
            "heartbeat_misses": tr["heartbeat_misses"],
            "io_timeouts": tr["io_timeouts"],
            "replay": "bitwise by id", "doctor": "green",
            "subprocess_launches": launches + [replay_launches],
            "killed_subprocesses": len(victims)}


def run_fleet_wedge(plan, base: Baseline, root: str) -> dict:
    """fleet-wedge-worker: SIGSTOP one of three workers mid-storm —
    nothing killed, nothing closed, the failure an EOF check cannot see.
    The heartbeat ping must quarantine it, its batch re-dispatches like a
    death, every request is answered bitwise by id, and the wedge is
    visible in the manifest (wedged flag + heartbeat misses) with the
    audit intact."""
    n_replicas = int(plan.param("replicas", 3))
    wedge = int(plan.param("wedge", 1))
    n = int(plan.param("n", 48))
    d = base.fresh(root, plan.name, base.snaps[0])
    path = os.path.join(d, "state.npz")
    lines = _query_requests(plan.seed, n, _query_engine(base, path).K)

    def mid_storm(pids):
        os.kill(pids[wedge], signal.SIGSTOP)

    replay = _FleetReplay(plan, base, root, lines)
    try:
        fleet_resp = _drive_fleet_storm(plan, base, d, path, lines,
                                        n_replicas, mid_storm)
        clean, replay_launches = replay.result()
    finally:
        replay.stop()
    fleet = _read_fleet(d)
    launches = _fleet_launches(d, n_replicas)
    _assert_fleet_bitwise_by_id(plan, fleet_resp, clean, n)
    wedged = sorted(r["replica"] for r in fleet["replicas"] if r["wedged"])
    if wedged != [wedge]:
        raise AssertionError(f"{plan.name}: manifest counts wedged "
                             f"{wedged}, expected [{wedge}]")
    tr = fleet["transport"]
    # the storm driver idles past --heartbeat-s before the second half,
    # so discovery MUST come from the ping (fast path), never the 60 s
    # batch deadline
    if tr["heartbeat_misses"] < 1:
        raise AssertionError(f"{plan.name}: the wedge was not caught by "
                             "a heartbeat miss — detection fell through "
                             "to the batch I/O deadline")
    _require_audit(plan, fleet)
    base.doctor(plan, d, "--serve")
    return {"wedged_worker": wedge, "survivors": n_replicas - 1,
            "responses": len(fleet_resp),
            "heartbeat_misses": tr["heartbeat_misses"],
            "io_timeouts": tr["io_timeouts"],
            "replay": "bitwise by id", "doctor": "green",
            "subprocess_launches": launches + [replay_launches],
            "killed_subprocesses": 0}


RUNNERS = {"truncate": run_byte_fault, "corrupt": run_byte_fault,
           "kill": run_kill, "kill_manifest": run_kill_manifest,
           "nan_slab": run_poison, "outlier_slab": run_poison,
           "universe_slab": run_poison, "flaky_store": run_flaky_store,
           "eigen_kill": run_eigen_kill, "shard_kill": run_shard_kill,
           "sync_schedule_coalescer": run_sync_schedule_coalescer,
           "sync_schedule_cache": run_sync_schedule_cache,
           "query_kill": run_query_kill, "query_poison": run_query_poison,
           "query_overflow": run_query_overflow,
           "query_swap": run_query_swap, "query_steady": run_query_steady,
           "scenario_kill": run_scenario_kill,
           "scenario_poison": run_scenario_poison,
           "sweep_kill": run_sweep_kill, "grad_kill": run_grad_kill,
           "trace_kill": run_trace_kill,
           "flightrec_kill": run_flightrec_kill,
           "cache_stale": run_cache_stale, "fleet_kill": run_fleet_kill,
           "fleet_kill_host": run_fleet_kill_host,
           "fleet_wedge": run_fleet_wedge}


def _run_plan(fn, base, rec: dict) -> dict:
    """Run one plan, recording its status, wall and the kernel launches of
    the plan's own process (in-process appends and rebuilds)."""
    import torch

    t0 = time.perf_counter()
    before, n_appends = _launches(), len(base.appends)
    try:
        rec.update(fn())
        rec["status"] = "pass"
    except AssertionError as err:
        rec["status"] = "FAIL"
        rec["error"] = str(err)
    if torch.device(base.device).type == "cuda":
        torch.cuda.synchronize()   # the wall holds the plan's device work
    rec["wall_s"] = round(time.perf_counter() - t0, 3)
    rec["launches"] = _diff(_launches(), before)
    rec["append_launches"] = base.appends[n_appends:]
    return rec


def main(argv=None) -> int:
    from mfm_tpu_torch._device import resolve_device
    from mfm_tpu_torch.utils.chaos import plan_suite

    ap = argparse.ArgumentParser(
        prog="python -m mfm_tpu_torch.tools.faultinject",
        description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="master seed for the panel AND the fault plans")
    ap.add_argument("--plans", default=None,
                    help="comma-separated plan names (default: every "
                         "ported plan, plus the steady-state check)")
    ap.add_argument("--out", default=None, metavar="FILE.json",
                    help="write the full JSON report here too")
    ap.add_argument("--keep", action="store_true",
                    help="keep the scratch directory for post-mortems")
    for key, help_ in (("T", "dates in the synthetic table"),
                       ("hist", "dates of the history checkpoint"),
                       ("slab", "dates per serving slab"),
                       ("N", "stocks"), ("P", "industries"),
                       ("Q", "styles"), ("sims", "eigen Monte-Carlo draws")):
        ap.add_argument(f"--{key}", type=int, default=DEFAULTS[key],
                        help=f"{help_} (default {DEFAULTS[key]})")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the harness and its subprocesses compute "
                         "(default: the card)")
    args = ap.parse_args(argv)
    g = Geometry(T=args.T, hist=args.hist, slab=args.slab, N=args.N,
                 P=args.P, Q=args.Q, sims=args.sims)
    device = resolve_device(args.device)

    plans = plan_suite(args.seed)
    not_ported = [{"plan": p.name, "kind": p.kind,
                   "roadmap": NOT_PORTED_KINDS[p.kind]}
                  for p in plans if p.kind in NOT_PORTED_KINDS]
    want = None
    if args.plans:
        want = {w.strip() for w in args.plans.split(",") if w.strip()}
        unknown = want - {p.name for p in plans} - {"steady-state"}
        if unknown:
            raise SystemExit(f"unknown plan(s): {sorted(unknown)} "
                             f"(have: {[p.name for p in plans]})")
        asked = [r for r in not_ported if r["plan"] in want]
        if asked:
            raise SystemExit(
                "faultinject: not ported yet: " + ", ".join(
                    f"{r['plan']} (ROADMAP.md {r['roadmap']})"
                    for r in asked))
        plans = tuple(p for p in plans if p.name in want)
    plans = tuple(p for p in plans if p.kind not in NOT_PORTED_KINDS)

    root = tempfile.mkdtemp(prefix="mfm_torch_faultinject_")
    results = []
    try:
        t0 = time.perf_counter()
        base = Baseline(root, args.seed, g, device)
        carry_bytes = int(sum(c.nbytes for c in base.carries[-1]))
        baseline_s = time.perf_counter() - t0
        for plan in plans:
            rec = _run_plan(
                lambda: RUNNERS[plan.kind](plan, base, root), base,
                {"plan": plan.name, "kind": plan.kind, "seed": plan.seed})
            results.append(rec)
            print(json.dumps(rec), flush=True)
        if want is None or "steady-state" in want:
            rec = _run_plan(lambda: run_steady_state(base, root), base,
                            {"plan": "steady-state",
                             "kind": "compile_contract"})
            results.append(rec)
            print(json.dumps(rec), flush=True)
    finally:
        if args.keep:
            print(f"scratch kept at {root}", file=sys.stderr)
        else:
            shutil.rmtree(root, ignore_errors=True)

    failed = [r["plan"] for r in results if r["status"] != "pass"]
    summary = {"plans": len(results), "failed": failed,
               "not_ported": not_ported if want is None else [],
               "geometry": dataclasses.asdict(g), "device": device.type,
               "baseline_wall_s": round(baseline_s, 3),
               "baseline_carry_bytes": carry_bytes,
               "baseline_init_launches": base.init_launches,
               "baseline_append_launches": base.baseline_appends}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"summary": summary, "results": results}, fh, indent=1)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
