"""Deterministic fault-injection harness for the port's serving loop
(counterpart of ``tools/faultinject.py``).

Drives the seeded recovery matrix (``mfm_tpu_torch/utils/chaos.py::
plan_suite``) against a real daily serving sequence — a synthetic barra
table's history -> fenced checkpoint -> per-slab guarded
``append_risk_pipeline`` updates — and asserts the recovery contracts
bitwise:

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

Each slab is written once as a csv of its own dates, which is what
``risk --update`` reads (it serves the rows past the checkpoint's last
date); the in-process appends read the same csv back, so both sides see
the same parsed bits.  The plans of the query service, scenarios, grad,
tracing, the flight recorder, the cache and the fleet are not ported yet
(ROADMAP.md §A 20; ``shard-kill-mid-append`` §A 16): a run lists them
under ``not_ported``, and asking for one by name exits non-zero.

Everything is seeded; a failing plan replays exactly.  Exit 0 iff every
plan run passes; ``--out`` writes the JSON report.  The device is the card
unless ``--device cpu``:

    python -m mfm_tpu_torch.tools.faultinject --device cpu --out f.json
    python -m mfm_tpu_torch.tools.faultinject --plans nan-slab,kill-after-tmp
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
NOT_PORTED_KINDS = {
    "query_kill": "§A 20", "query_poison": "§A 20", "query_overflow": "§A 20",
    "query_swap": "§A 20", "query_steady": "§A 20",
    "scenario_kill": "§A 20", "scenario_poison": "§A 20",
    "sweep_kill": "§A 20", "grad_kill": "§A 20", "trace_kill": "§A 20",
    "flightrec_kill": "§A 20", "cache_stale": "§A 20",
    "fleet_kill": "§A 20", "fleet_kill_host": "§A 20",
    "fleet_wedge": "§A 20", "shard_kill": "§A 16",
}


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
    def cli(self, argv, kill_at: str | None = None, timeout: float = 600):
        env = {k: v for k, v in os.environ.items()
               if k not in ("MFM_CHAOS_KILL", "MFM_CHAOS_KILL_MATCH")}
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (REPO_ROOT, os.environ.get("PYTHONPATH")) if p)
        if kill_at:
            env["MFM_CHAOS_KILL"] = kill_at
        return subprocess.run([sys.executable, "-m", "mfm_tpu_torch.cli",
                               *map(str, argv)], env=env, cwd=REPO_ROOT,
                              capture_output=True, text=True,
                              timeout=timeout)

    def update_cmd(self, slab: int, path: str, out: str,
                   incremental: bool = False) -> list:
        length = (["--eigen-incremental"] if incremental
                  else ["--eigen-sim-length", self.g.T])
        return ["risk", "--barra", self.slab_csv[slab], "--update", path,
                "--quarantine", "--eigen-sims", self.g.sims, *length,
                "--out", out, "--device", self.device.type]

    def run_update(self, plan, slab: int, path: str, out: str,
                   kill_at: str | None = None, incremental: bool = False):
        """``risk --update`` on slab ``slab``: with ``kill_at``, require
        death by SIGKILL; else success.  Returns the run's launches (None
        for a killed run)."""
        proc = self.cli(self.update_cmd(slab, path, out, incremental),
                        kill_at=kill_at)
        if kill_at:
            if proc.returncode != -signal.SIGKILL:
                raise AssertionError(
                    f"{plan.name}: expected the subprocess to die by "
                    f"SIGKILL at {kill_at}, got rc={proc.returncode}\n"
                    f"{proc.stderr[-2000:]}")
            return None
        if proc.returncode != 0:
            raise AssertionError(f"{plan.name}: post-crash update failed "
                                 f"rc={proc.returncode}\n"
                                 f"{proc.stderr[-2000:]}")
        return json.loads(proc.stdout.strip().splitlines()[-1])[
            "kernels"]["launches"]

    def doctor(self, plan, d: str):
        doc = self.cli(["doctor", d])
        if doc.returncode != 0:
            raise AssertionError(f"{plan.name}: doctor rejects the "
                                 f"post-crash state\n{doc.stdout[-2000:]}")


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


RUNNERS = {"truncate": run_byte_fault, "corrupt": run_byte_fault,
           "kill": run_kill, "kill_manifest": run_kill_manifest,
           "nan_slab": run_poison, "outlier_slab": run_poison,
           "universe_slab": run_poison, "flaky_store": run_flaky_store,
           "eigen_kill": run_eigen_kill,
           "sync_schedule_coalescer": run_sync_schedule_coalescer,
           "sync_schedule_cache": run_sync_schedule_cache}


def _run_plan(fn, base, rec: dict) -> dict:
    """Run one plan, recording its status, wall and the kernel launches of
    the plan's own process (in-process appends and rebuilds)."""
    t0 = time.perf_counter()
    before, n_appends = _launches(), len(base.appends)
    try:
        rec.update(fn())
        rec["status"] = "pass"
    except AssertionError as err:
        rec["status"] = "FAIL"
        rec["error"] = str(err)
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
