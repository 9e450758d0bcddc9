"""Smoke run of the PyTorch/CUDA port (``mfm_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the port's CUDA kernels from
``mfm_tpu_torch/csrc/`` (``nvcc`` for sm_90a, into ``build/kernels/``) and
reports each kernel's registers and spills from ``-Xptxas -v``; holds each
kernel, in both designs (``warp``: one warp per matrix in registers, the
float32 route; ``block``: one block per matrix in shared memory, float64
and the other n), against its plain PyTorch version on the card; drives
``RiskModel.run_fused`` once at the CSI300 width (T=1390 dates, N=300
stocks, P=31 industries, Q=10 styles, K=42 factors, M=100 eigen
simulations, float32) and checks that the main path went through the warp
design of both kernels and the Newey-West scan kernel once, and agrees
with the same path run on the plain versions within the ``risk`` budgets
of ``tools/parity_budget.json``; then holds the Newey-West kernel's
covariances, ``valid`` and carry equal to its plain loop's on that run's
factor returns (phase ``nw_kernel_check``; again at all-A in
``alla_nw_kernel_check``) and times both beside the kernel's bound.
The IR audit's probes follow (``mfm_tpu_torch/analysis/``):
``audit_probes`` runs the audit's aliasing and dtype probes on that
CSI300 ``run_fused`` (no argument written or aliased, the dtypes of the
audit's ``risk.fused/base`` cell, its host reads counted) and
``audit_kernels`` runs the registry's ``risk.*`` cells at the audit's
(64, 48) shapes, counting each cell's launches by kernel and shape and
holding every launch against its plain version, timed beside its bound.
Then it drives the daily serving step at the same width — ``init_state``
on the first 1350 dates, the last 40 as one-date updates and as a slab —
in four phases (``serve_update``, ``serve_guarded``, ``serve_incremental``,
``serve_checkpoint``), each held against the full-history run and each
required to go through the warp design of both kernels and to be bitwise
the full run (``init_state``, each update and each guarded update launch
the Newey-West kernel once); one more (``serve_bitwise_ops``) requires
each op of the update to keep a date's bits at the batch sizes an update
gives it.  Then
the risk pipeline at the same width, in five phases: ``pipeline_ingest``
(the synthetic barra table, ~398,000 rows, densified),
``pipeline_run`` (``run_risk_pipeline``, bitwise ``run_fused`` on the
densified arrays), ``pipeline_analytics`` (specific risk, portfolio risk,
``portfolio_bias(100)`` and the eigenfactor bias statistics, held to the
same functions on the CPU; the statistics by scope, the all-dates one
against three times its own measured one-ulp response), ``pipeline_append`` (a checkpoint at 1350
dates appended to 1390, bitwise the full run; a guarded append
quarantining a collapsed date) and ``eigen_mc_bf16`` (the bfloat16
Monte-Carlo: its bias-stat gate, and its incremental mode bitwise and
through a checkpoint).  The pipeline needs no pandas.  Then factor
production from the raw panel (``factor_rolling``, ``factor_engine``,
``factor_pipeline``) and query serving, in three phases:
``query_engine`` (bench config 6's factor space at B = 1e3, 1e5, 1e6
against the CPU at float64, the pipeline's stock-space engine against
``portfolio_risk``, batch == singles bitwise at every bucket),
``query_server`` (config 6's overload storm; the serving entry from the
guarded checkpoint) and ``query_cache`` (config 10's Zipf stream through
a cache-fronted coalescer).  The query path launches no kernel.  Then
scenarios, in three phases: ``scenario_engine`` (bench config 7, S =
16, 256, 4,096 through ``ScenarioEngine.run``: the PSD gate's eigh is the
full kernel; a lane sample against the CPU at float64, the identity lane
and batch == singles bitwise at every bucket, the kernel route bitwise
its plain version, and the gate's eigh alone at (8,192, 42, 42) beside
its bound and ``torch.linalg.eigh``), ``scenario_served`` (presets, a
replay and two counterfactuals on the guarded checkpoint at CSI300
width, the manifest, the scenario table through ``QueryServer``) and
``scenario_sweep`` (bench config sweep: 1,007,616 scenarios streamed,
the materializing arm, the top-1 round trip, a ``sweep`` request).  Then
differentiable risk, in five phases: ``grad_construct`` (bench config 8's
min-vol at B = 100 and 10,000, risk parity and the hedge at 100, a lane
sample against the CPU at float64, batch == singles bitwise at every
bucket 8..32,768), ``grad_reverse`` (64 books, 200 steps of ascent whose
two eighs a step are the full kernel: every answer admissible and above
every preset drill, batch == singles bitwise, the kernel at the ascent's
(128, 42, 42) beside its bound and ``torch.linalg.eigh``),
``grad_sensitivity`` (a book against the presets and 4,096 specs; card
vs the CPU at float64 outside the eigen-gap band, the CPU vs central
differences), ``grad_served`` (bench config 9: 500 lines with
construct solves through the coalescer, bitwise the sequential loop;
a warm-started solve on the guarded checkpoint) and ``sweep_refine``
(the sweep config's refined leg).  Then the serving fleet, bench config
12 at CSI300 width, in four phases: ``fleet_checkpoint`` (the guarded
CSI300 pipeline on the card, saved with ``save_pipeline_state``),
``fleet_wire`` (a ``serve_worker_socket`` worker in a thread reached with
``Replica.connect``: every envelope byte for byte the in-process
``run_worker`` loop's), ``fleet_mh`` (four ``python -m mfm_tpu_torch.cli
serve --worker --listen`` processes on the card in two simulated hosts
behind a ``FleetServer``: 200 lines at 300 req/s, then 320 at 200 req/s
with one host SIGKILLed, every response the port CLI's ``--gulp``
replay, the delivery audit and the merged Chrome trace) and
``fleet_frontend`` (``serve --listen --replicas 2``: four concurrent JSONL
clients, the HTTP surface, SIGTERM and ``doctor --serve``); every fleet
process reports its kernel launches (none).  Then the CLI's compute
subcommands at CSI300 width, in six phases: ``cli_risk`` (the
398,228-row table written as a csv and run through ``python -m
mfm_tpu_torch.cli risk --save-state --quarantine --specific-risk
--save-outputs --portfolio-bias 100 --metrics-dir`` as a subprocess:
every table and artifact bit for bit ``run_risk_pipeline`` in this
process on the same csv and seed, the subprocess's launches the warp
design's, one weighted and two or more full; the run manifest beside the
checkpoint and ``doctor``; its csv read and write times; a second one
with ``--profile`` for the busy share and peak memory), ``cli_update``
(``--save-state`` on 1350 dates then ``--update`` to 1390, bitwise the
full run's last 40; again with
``--quarantine`` over a collapsed date: quarantined, counted in the
manifest's guard summary, ``health`` the verdict of ``evaluate_health``),
``cli_demo`` (``demo`` at CSI300 width with ``--check-determinism``,
bitwise ``run_risk_pipeline``), ``cli_factors`` (config 3's raw panel as
a long csv through ``factors``: bitwise ``run_factor_pipeline`` on the
same csv, within the ``factors`` budgets of float64), ``cli_scenario``
(``scenario run`` and ``scenario sweep --n 65536`` on the guarded
checkpoint, bitwise the in-process engines; ``doctor --scenarios``) and
``cli_grad`` (``grad reverse`` on 64 books, ``sensitivity``, ``construct
min_vol`` on 100 books, each report bitwise ``GradEngine``); all but the
headline ``risk`` go through ``cli.main`` in this process.  Then the
mesh, on virtual ('date', 'stock') meshes of the card
(``MFM_TORCH_VIRTUAL_DEVICES=8``: each shard a separate tensor on
cuda:0, computed one after another, so no scaling shows), in six phases,
each record stating its mesh, ``virtual`` and the shard devices, each
sharded run bitwise its unsharded one, each kernel launch held against
its plain version at its shard's shape and the launches counted by
kernel and batch: ``mesh_run_fused`` (config 1 on 2x2 and 4x2, which
pads 2 dates; walls beside the unsharded run's), ``mesh_serve``
(``init_state`` on 1378 dates, two guarded 4-date updates on 2x2, no
compile-contract event after the first), ``mesh_pipeline``
(``run_risk_pipeline(mesh=2x2)`` on the CSI300 table, its
``LazyBarraArrays`` undensified, and the append to 1390),
``mesh_cli`` (``risk --update --mesh 2x2`` as a subprocess, its tables
the in-process run's), ``mesh_sweep`` (``SweepEngine(mesh=2x2)``, 16
chunks) and ``distributed`` (``initialize`` over NCCL with one process,
``make_global_mesh``, one ``all_reduce`` and one ``all_gather``).  Then the host
data layer at CSI300 width, in three phases: ``store_build`` (the port's
``synthetic_collections`` at T = 1390, N = 300 + 1, 31 industries, about
403,000 price rows; each collection's read, the prepare path's walls;
``prepare``'s ``panel.npz`` bitwise the master table, densified bitwise
``PreparedData.fields``), ``store_etl`` (``etl-verify``, ``--diagnose``,
``etl-missing``, ``etl-update --dry-run``, each record checked) and
``store_pipeline`` (four subprocesses: ``pipeline --to-store`` on the
store cut 40 dates before its end, ``IncrementalUpdater`` bringing it up
to date a part a day, ``pipeline --append`` bitwise ``pipeline`` from
scratch, ``risk --barra-store`` bitwise the cut run; ``factors
--prepared`` bitwise ``run_factor_pipeline``; each process's launches).  Then the
faults, in two phases: ``fault_matrix`` (``python -m
mfm_tpu_torch.tools.faultinject``'s matrix at CSI300 width, all 29 plans
and steady-state: the plans bound by CLI subprocesses in four
concurrent harness processes, started with the CLI section and running
beside it, the mesh and the store — ``risk --update`` (one of them with
``--mesh 2x2``), ``serve``, ``scenario
run``, ``scenario sweep``, ``grad sensitivity``, trace and
flight-recorder processes SIGKILLed at their crash points, the cache's
generation fence across a torn publish — the rest in this process
after the store: the fenced checkpoint's byte faults, poisoned slabs under the
carry-freeze contract, the retry drill, the coalescer's and the cache's
lock schedules, the query plans, the scenario poison, steady-state on the
compile-contract counter for the update and per bucket for the query
loop; the three fleet drills in one more harness process once the
groups end; every plan bitwise, the launches of
each guarded append and completed subprocess) and
``report_crosscheck`` (``report`` over cli_risk's results against a
numpy recomputation, ``--plot``, ``crosscheck --gate 0`` over the store's
from-scratch and appended barra tables, and a copy with one value
moved) and ``audit`` (``python -m mfm_tpu_torch.cli audit --strict
--json`` as a subprocess on the card beside the harness, the mesh cells
on ``MFM_TORCH_VIRTUAL_DEVICES=8``: strict-clean on all 58 cells with
the committed baseline and budgets, then ``doctor --audit`` on the
committed snapshot).  Then the all-A universe (T=2500, N=5000, K=42,
M=100), in two phases:
``alla_risk`` (bench config 1 at ``--universe alla``: ``run_fused``, its
walls, busy share, peak
memory and launches; both kernels at the run's own (250,000, 42, 42) and
(2500, 42, 42) against their plain versions and timed; the outputs within
the ``risk`` budgets of the path at float64 through the plain versions on
the card) and ``alla_factors`` (bench config 4: ``FactorEngine(block=16)``
within the ``factors`` budgets of float64 on the card, the t+1 label, the
risk run within the ``risk`` budgets).  Then alpha, in three phases:
``alpha_engine`` (bench config 5: 1,000 expressions at CSI300 width
through ``compile_alpha_batch`` and ``alpha_summary``; chunked ==
unchunked bitwise; the fused scores; float32 against the CPU at float64
within ALPHA_TOL; ``select_alphas``'s picks at float64 as the CPU's;
``cs_neutralize`` bitwise over two runs), ``alpha_alla`` (``compile_alpha_scores`` in chunks of 50
at all-A; its peak memory) and ``alpha_cli`` (``python -m
mfm_tpu_torch.cli alpha`` on the card, ``--select`` and ``--llm``: each
scorecard is the in-process summary); the alpha path launches no kernel.
Last it times each kernel at the main path's shapes, the two designs in turns
(block, warp, warp, block), beside its plain version, its bound, the warp
design's ceiling and ``torch.linalg.eigh`` (for the weighted kernel the
library and the kernel on the same first 8,192 matrices of G, with their
ratio: one library call on all 139,000 takes about 72 s, more than this
run can spare), and, after holding it against
its plain version there, at the shapes a one-date update launches, and
samples the SM clock from ``nvidia-smi`` while each warp kernel runs.

Output: the card's name and power limit first; one JSON line per phase,
each with its seconds since the run began (``t_s``);
the ``{"kernels": [...]}`` line second to last; and last
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero before
the last line is printed.  Without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import atexit
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent

# published peaks of one H100 SXM (dense, no sparsity), used for the bounds
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12

# float32 orthogonality of V: 287 rounds of rotations leave ~1e-5 of
# rounding in V'V - I; the plain version reaches 1.09e-5 on the main path's
# F0 batch itself (the kernel is bitwise equal to it there)
ORTH_TOL_F32 = 2e-5
SOURCES = {"warp": "mfm_tpu_torch/csrc/jacobi_eigh_warp.cu",
           "block": "mfm_tpu_torch/csrc/jacobi_eigh.cu"}
_KERNEL_NAME = re.compile(
    r"(warp_eigh_kernel|warp_weighted_kernel|jacobi_eigh_kernel|"
    r"jacobi_eigh_weighted_kernel)I(?:Li(\d+)E|([fd]))E")
NW_SOURCE = "mfm_tpu_torch/csrc/newey_west_scan.cu"
_NW_KERNEL_NAME = re.compile(r"newey_west_scan_kernelI([fd])Li(\d+)E")
_NW_TYPES = {"f": "float", "d": "double"}


class SmokeFailure(RuntimeError):
    pass


def require(ok, what: str):
    if not ok:
        raise SmokeFailure(what)


#: the host clock when the run began; every phase line carries its seconds
#: since then (``t_s``), so a run's lines give its timeline
T_START = time.perf_counter()


def emit(tag: str, **fields):
    print(json.dumps({"phase": tag, **fields,
                      "t_s": time.perf_counter() - T_START}), flush=True)


def sync():
    torch.cuda.synchronize()


#: every subprocess :func:`start_cli` started; any still alive when the run
#: ends (a failed check) is killed then
_STARTED: list = []


def _kill_started() -> None:
    for proc in _STARTED:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


atexit.register(_kill_started)


def start_cli(argv, env=None) -> tuple:
    """``python -m mfm_tpu_torch.cli *argv`` started as a subprocess on the
    card (the CLI's default device), its output going to files so that it
    never waits on a pipe: (process, stdout, stderr, start).  It runs while
    this process does other work; :func:`finish_cli` collects it."""
    out = tempfile.TemporaryFile("w+")
    err = tempfile.TemporaryFile("w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "mfm_tpu_torch.cli", *map(str, argv)],
        cwd=str(ROOT), stdout=out, stderr=err, text=True, env=env)
    _STARTED.append(proc)
    return proc, out, err, time.perf_counter()


def finish_cli(started, what: str, timeout: float = 600,
               last_json: bool = True) -> tuple:
    """The subprocess :func:`start_cli` started, to its end: (its last
    standard-output line as JSON — its whole standard output as text
    without ``last_json`` — its wall from start to end, its standard
    error).  A non-zero exit fails ``what``."""
    proc, out, err, t0 = started
    try:
        proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    wall = time.perf_counter() - t0
    out.seek(0)
    err.seek(0)
    stdout, stderr = out.read(), err.read()
    out.close()
    err.close()
    require(proc.returncode == 0, f"{what}: exit {proc.returncode}: "
            f"{stdout[-2000:]} {stderr[-2000:]}")
    if not last_json:
        return stdout, wall, stderr
    return json.loads(stdout.strip().splitlines()[-1]), wall, stderr


def fill_bytecode_cache() -> subprocess.Popen:
    """Point every process this run starts at one bytecode cache in the
    checkout (``build/pycache``, with writing on) and start one process
    that imports the CLI, which compiles torch's modules into it once;
    the caller waits for it.  The outputs of no command change."""
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = str(ROOT / "build" / "pycache")
    return subprocess.Popen([sys.executable, "-c", "import mfm_tpu_torch.cli"],
                            cwd=ROOT, stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)


def time_ms(fn, reps: int, warmup: bool = True) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    if warmup:
        fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    sync()
    return start.elapsed_time(stop) / reps


def sm_clock_mhz(fn, reps: int) -> dict:
    """The SM clock while the card runs ``reps`` queued calls of ``fn``:
    ``nvidia-smi`` is read in a loop on a second thread from the first
    call on, and only readings that ended before the last call did are
    kept, so each was taken under this load."""
    fn()
    sync()
    done, samples = threading.Event(), []

    def read():
        while not done.is_set():
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                 "--format=csv,noheader,nounits"],
                capture_output=True, text=True, check=True, timeout=60)
            sm, top = out.stdout.strip().splitlines()[0].split(",")
            samples.append((time.perf_counter(), int(sm), int(top)))

    t0 = time.perf_counter()
    fn()
    reader = threading.Thread(target=read)
    reader.start()
    for _ in range(reps - 1):
        fn()
    sync()
    end = time.perf_counter()
    done.set()
    reader.join()
    under_load = [sm for t, sm, _ in samples if t < end]
    return {"sm_mhz": under_load, "max_sm_mhz": samples[0][2] if samples
            else None, "calls": reps, "seconds": end - t0}


def rel_per_matrix(x, ref):
    """max over the batch of max|x - ref| / max|ref| within each matrix;
    a matrix whose reference is all zero (a mesh's padded date) counts 0
    where ``x`` is all zero too, and inf where it is not."""
    flat = (x - ref).abs().flatten(1).amax(1)
    den = ref.abs().flatten(1).amax(1)
    rel = torch.where(den > 0, flat / torch.where(den > 0, den, 1.0),
                      torch.where(flat > 0, float("inf"), 0.0))
    return float(rel.max()) if rel.numel() else 0.0


def recon_orth(w, V, A):
    """max|V diag(w) V' - A| / max|A| and max|V'V - I|, in float64."""
    w, V, A = w.double(), V.double(), A.double()
    R = (V * w[:, None, :]) @ V.transpose(1, 2)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return (float((R - A).abs().max() / A.abs().max()),
            float((V.transpose(1, 2) @ V - eye).abs().max()))


def scaled_wishart(gen, B, n, L):
    """The eigen Monte-Carlo's G = diag(s) C diag(s), C the sample
    covariance of L standard-normal draws, s ~ |N(0.02, 0.01)|."""
    d = torch.randn((B, n, L), generator=gen, device="cuda")
    d = d - d.mean(-1, keepdim=True)
    C = d @ d.transpose(1, 2) / (L - 1)
    s = (0.02 + 0.01 * torch.randn((B, n), generator=gen, device="cuda")).abs()
    return (s[:, :, None] * C * s[:, None, :]).contiguous(), (s * s)


def ptxas_table(build):
    """Phase 1b: registers, stack and spill bytes of every kernel from
    ``-Xptxas -v``; the warp design must not spill at any n it takes."""
    rows = []

    def row(k, name, **size):
        rows.append({"kernel": name, **size, "registers": k.get("registers"),
                     "stack_bytes": k.get("stack_bytes"),
                     "spill_bytes": k.get("spill_store_bytes", 0)
                     + k.get("spill_load_bytes", 0)})

    for stem in ("jacobi_eigh_warp", "jacobi_eigh"):
        for k in build.ptxas_report(stem):
            m = _KERNEL_NAME.search(k["kernel"])
            row(k, f"{m.group(1)}<{m.group(2) or m.group(3)}>" if m
                else k["kernel"],
                n=int(m.group(2)) if m and m.group(2) else None)
    for k in build.ptxas_report("newey_west_scan"):
        m = _NW_KERNEL_NAME.search(k["kernel"])
        row(k, f"newey_west_scan_kernel<{_NW_TYPES[m.group(1)]}, "
               f"{m.group(2)}>" if m else k["kernel"],
            q=int(m.group(2)) if m else None)
    emit("ptxas", kernels=rows)
    warp = [r for r in rows if r["kernel"].startswith("warp_")]
    spilled = [r["kernel"] for r in warp
               if r["spill_bytes"] or r["stack_bytes"]]
    require(not spilled, f"warp kernels spill or use a stack: {spilled}")
    return {r["kernel"]: r for r in rows}


def check_kernels(gen):
    """Phase 2: each kernel, in each design, against its plain version on
    the card.  The warp design (float32) must give the plain version's w
    and V to the bit; the block design is held to tolerances."""
    from mfm_tpu_torch.ops import eigh as E
    from mfm_tpu_torch.ops.eigh_cuda import (
        WARP_N,
        _launch_eigh,
        _launch_weighted,
        design_for,
        launch_counts,
    )

    def one(label, A, d0, sweeps_full, sweeps_w):
        f64 = A.dtype == torch.float64
        wp, Vp = E.jacobi_eigh_slots(A, sweeps_full)
        wwp, hhp = E.jacobi_eigh_weighted_diag_slots(A, d0, sweeps_w)
        designs = ["block"] if f64 else ["warp", "block"]
        for design in designs:
            w, V = _launch_eigh(A, sweeps_full, design)
            ww, hh = _launch_weighted(A, d0, sweeps_w, design)
            sync()
            rec, orth = recon_orth(w, V, A)
            r = {"case": label, "design": design, "B": A.shape[0],
                 "n": A.shape[-1], "dtype": str(A.dtype).split(".")[-1],
                 "w_equal": bool(torch.equal(w, wp)),
                 "V_equal": bool(torch.equal(V, Vp)),
                 "weighted_w_equal": bool(torch.equal(ww, wwp)),
                 "w_rel": rel_per_matrix(w, wp), "recon": rec, "orth": orth,
                 "weighted_w_rel": rel_per_matrix(ww, wwp),
                 "weighted_h_rel": rel_per_matrix(hh, hhp)}
            emit("kernel_check", **r)
            if design == "warp":
                require(r["w_equal"] and r["V_equal"]
                        and r["weighted_w_equal"],
                        f"{label}: the warp design is not bitwise the plain "
                        "version")
            w_tol = 1e-12 if f64 else 1e-5
            require(r["w_rel"] <= w_tol and r["weighted_w_rel"] <= w_tol,
                    f"{label} ({design}): eigenvalues disagree with the "
                    "plain version")
            require(r["weighted_h_rel"] <= (1e-12 if f64 else 1e-4),
                    f"{label} ({design}): h disagrees with the plain version")
            rec_tol, orth_tol = (1e-12, 1e-12) if f64 else (5e-5, ORTH_TOL_F32)
            require(rec <= rec_tol and orth <= orth_tol,
                    f"{label} ({design}): V fails reconstruction/orthogonality")

    n = 42
    X = torch.randn((4096, n, n), generator=gen, device="cuda")
    A = X @ X.transpose(1, 2) / n
    d0 = torch.rand((4096, n), generator=gen, device="cuda")
    one("psd_n42", A.contiguous(), d0, 7, 4)
    G, g0 = scaled_wishart(gen, 4096, n, 1390)
    one("scaled_wishart_n42", G, g0, 7, 4)
    for m in (2, 8, max(WARP_N)):
        X = torch.randn((512, m, m), generator=gen, device="cuda")
        one(f"psd_n{m}", (X @ X.transpose(1, 2) / m).contiguous(),
            torch.rand((512, m), generator=gen, device="cuda"),
            E._sweeps_for(m, torch.float32), 4)
    X = torch.randn((64, n, n), generator=gen, device="cuda",
                    dtype=torch.float64)
    one("psd_n42_f64", (X @ X.transpose(1, 2) / n).contiguous(),
        torch.rand((64, n), generator=gen, device="cuda",
                   dtype=torch.float64), 10, 10)

    # odd n through pinv_psd's trace/n pad (the regression's 41x41 case)
    X = torch.randn((1390, 41, 300), generator=gen, device="cuda")
    N41 = X @ X.transpose(1, 2) / 300
    before = launch_counts()
    P1 = E.pinv_psd(N41)
    sync()
    P0 = E.pinv_psd(N41, kernels=False)
    pinv_rel = rel_per_matrix(P1, P0)
    emit("kernel_check", case="pinv_psd_n41", pinv_rel=pinv_rel)
    key = f"jacobi_eigh/{design_for(42, torch.float32)}"
    require(launch_counts()[key] == before[key] + 1,
            f"pinv_psd on a CUDA tensor did not launch {key}")
    require(pinv_rel <= 1e-4, "pinv_psd through the kernel disagrees")

    # slot contract: exact zero rows/columns 0 and 1 stay exact zeros at
    # slots 0 and 1, the other directions keep their own slots
    m = 16
    base = torch.diag(torch.tensor([0.0, 0.0] + [1.0 + i for i in range(m - 2)],
                                   device="cuda"))
    E2 = 1e-3 * torch.randn((m - 2, m - 2), generator=gen, device="cuda")
    base[2:, 2:] += (E2 + E2.T) / 2
    for design in ("warp", "block"):
        w0, _ = _launch_eigh(base[None].contiguous(), 10, design)
        ww0, _ = _launch_weighted(base[None].contiguous(),
                                  torch.ones((1, m), device="cuda"), 10,
                                  design)
        sync()
        for got in (w0[0], ww0[0]):
            require(bool(got[0] == 0) and bool(got[1] == 0)
                    and bool((got[2:] > 0.5).all()),
                    f"rank-deficient slot contract broken ({design})")
        require(bool(((w0[0, 2:] - torch.diagonal(base)[2:]).abs() < 0.1).all()),
                f"near-diagonal input: slot i does not track direction i "
                f"({design})")
    emit("kernel_check", case="rank_deficient_slots", ok=True)


def profile_run(fn, top: int = 6, hold: bool = False) -> dict:
    """Device busy time of one call of ``fn`` from ``torch.profiler``
    (CUDA activity only, to keep the tracer's host cost low): kernel
    launches, summed kernel time, its share of the call's wall, and the
    kernels that took the most device time.  ``busy_s`` is None when the
    tracer saw no device activity.  The device events are read from the
    trace as recorded (``kineto_results``) and counted as ``key_averages``
    counts them: by name, each event's duration its device self time,
    async and hidden events left out, names whose total is 0 dropped;
    without ``key_averages``' host-side event tree, which took ~25 s at
    the main path's ~84,000 kernels.  With ``hold``, ``key_averages`` of
    the same trace must give the same rows (a small call's)."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _rewrite_name
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != DeviceType.CUDA or e.is_async()
                or e.start_thread_id() != e.end_thread_id()
                or getattr(e, "is_hidden_event", bool)()):
            continue
        row = by_name.setdefault(e.name(), [0, 0])
        row[0] += 1
        row[1] += e.duration_ns()
    # the names as key_averages shows them (demangled), merged
    named = {}
    for k, (n, ns) in by_name.items():
        row = named.setdefault(_rewrite_name(k, with_wildcard=True), [0, 0])
        row[0] += n
        row[1] += ns
    rows = sorted(((k, n, ns) for k, (n, ns) in named.items() if ns > 0),
                  key=lambda r: r[2], reverse=True)
    if hold:
        want = {e.key: (e.count, e.self_device_time_total)
                for e in prof.key_averages()
                if e.device_type.name == "CUDA"
                and e.self_device_time_total > 0}
        require(sorted(want) == sorted(k for k, _, _ in rows) and all(
            want[k][0] == n and abs(want[k][1] - ns / 1e3) <= 1e-3 * n
            for k, n, ns in rows),
            f"profile_run: the trace's device rows are not key_averages': "
            f"{rows[:4]} against {sorted(want.items())[:4]}")
    busy = sum(ns for _, _, ns in rows) / 1e9
    return {"wall_s": wall,
            "busy_s": busy if rows else None,
            "busy_share": busy / wall if rows else None,
            "device_kernels": sum(n for _, n, _ in rows),
            "top": [{"kernel": k[:80], "count": n, "device_s": ns / 1e9}
                    for k, n, ns in rows[:top]]}


def bound(kernel, B, n, sweeps, in_bytes, out_bytes):
    """The least time the card could take for ``B`` Jacobi eighs of n x n
    over ``sweeps`` sweeps: the launch's operations
    (``obs/profile.kernel_flops``: 9 n^2 flop a matrix a round, plus
    3 n^2 for the weighted kernel's h) at the FP32 peak, and the bytes at
    the memory rate; the larger of the two bounds it."""
    from mfm_tpu_torch.obs.profile import kernel_flops

    ops = kernel_flops(kernel, B, n, sweeps)
    t_ops = ops / PEAK_FP32_PER_S
    t_bytes = (in_bytes + out_bytes) / PEAK_BYTES_PER_S
    # the warp design's ceiling: no FMA contraction (half the FP32
    # peak) and n/2 of a warp's 32 lanes at work
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                design_ceiling_ms=1e3 * t_ops * 2 * 32 / (n // 2),
                flops=ops, bytes=in_bytes + out_bytes)


def full_kernel_bound(B, n, sweeps):
    """:func:`bound` of the full kernel: A read, w and V written."""
    return bound("jacobi_eigh", B, n, sweeps, 4 * B * n * n,
                 4 * B * (n * n + n))


def weighted_kernel_bound(B, n, sweeps):
    """:func:`bound` of the weighted kernel: G and d0 read, w and h
    written."""
    return bound("jacobi_eigh_weighted", B, n, sweeps, 4 * B * (n * n + n),
                 4 * B * 2 * n)


def outputs_finite(out, valid):
    """Finite everywhere the outputs are defined."""
    nw, ev = out.nw_valid, out.eigen_valid
    checks = {
        "factor_ret": bool(torch.isfinite(out.factor_ret).all()),
        "r2": bool(torch.isfinite(out.r2).all()),
        "specific_ret": bool(torch.isfinite(out.specific_ret[valid]).all()),
        "nw_cov": bool(torch.isfinite(out.nw_cov[nw]).all()),
        "eigen_cov": bool(torch.isfinite(out.eigen_cov[ev]).all()),
        "vr_cov": bool(torch.isfinite(out.vr_cov[ev]).all()),
        "lamb": bool(torch.isfinite(out.lamb).all()),
        "some_valid": bool(ev.any()),
    }
    return checks


def require_launches(launches: dict, what: str, weighted: int, full: int):
    """A path launched the warp design of the weighted kernel at least
    ``weighted`` and of the full kernel at least ``full`` times, and the
    block design never (n=42, float32)."""
    require(launches["jacobi_eigh_weighted/warp"] >= weighted
            and launches["jacobi_eigh/warp"] >= full,
            f"{what}: the weighted kernel must launch >= {weighted} and the "
            f"full kernel >= {full} times: {launches}")
    require(launches["jacobi_eigh_weighted/block"] == 0
            and launches["jacobi_eigh/block"] == 0,
            f"{what} launched a block-design kernel: {launches}")


def kernel_inputs(out, sim_covs, T, K, M):
    """The two kernels' inputs as a run's eigen stage gave them: F0 (the
    Newey-West covariances, the identity at invalid dates), the simulated
    covariances in F0's eigenbasis G (T*M, K, K) with their weights d0,
    and the two sweep counts."""
    from mfm_tpu_torch.models.eigen import sim_sweeps_for
    from mfm_tpu_torch.ops import eigh as E

    eye = torch.eye(K, device="cuda")
    F0 = torch.where(out.nw_valid[:, None, None], out.nw_cov, eye).contiguous()
    D0, _ = E.batched_eigh(F0, canonical_signs=False)
    s = torch.sqrt(torch.clamp_min(D0, 0.0))
    G = (s[:, None, :, None] * sim_covs[None] * s[:, None, None, :]
         ).reshape(T * M, K, K).contiguous()
    d0 = D0[:, None, :].expand(T, M, K).reshape(T * M, K).contiguous()
    return (F0, G, d0, sim_sweeps_for(K, torch.float32, T),
            E._sweeps_for(K, torch.float32))


def hold_kernels(F0, G, d0, sw, sf, where: str) -> dict:
    """Each kernel against its plain version on a run's own inputs: the
    weighted kernel's w bitwise and h within 1e-4 per matrix, the full
    kernel's w and V bitwise (with reconstruction and orthogonality); the
    plain weighted call (seconds) timed by CUDA events.  Emits phase
    ``{where}_check``; returns it with both kernels' max |error| and that
    time."""
    from mfm_tpu_torch.ops import eigh as E
    from mfm_tpu_torch.ops.eigh_cuda import (
        jacobi_eigh_cuda,
        jacobi_eigh_weighted_diag_cuda,
    )

    ww, hh = jacobi_eigh_weighted_diag_cuda(G, d0, sweeps=sw)
    sync()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    wwp, hhp = E.jacobi_eigh_weighted_diag_slots(G, d0, sw)
    stop.record()
    sync()
    w_equal, h_rel = bool(torch.equal(ww, wwp)), rel_per_matrix(hh, hhp)
    weighted_err = float(max((ww - wwp).abs().max(), (hh - hhp).abs().max()))
    h_equal = bool(torch.equal(hh, hhp))
    del ww, hh, wwp, hhp
    wf, Vf = jacobi_eigh_cuda(F0, sweeps=sf, sort=False, canonical_signs=False)
    sync()
    wfp, Vfp = E.jacobi_eigh_slots(F0, sf)
    f_equal = bool(torch.equal(wf, wfp)) and bool(torch.equal(Vf, Vfp))
    full_err = float(max((wf - wfp).abs().max(), (Vf - Vfp).abs().max()))
    rec, orth = recon_orth(wf, Vf, F0)
    check = {"weighted_shape": list(G.shape), "weighted_w_equal": w_equal,
             "weighted_h_equal": h_equal, "weighted_h_rel": h_rel,
             "full_shape": list(F0.shape), "full_wV_equal": f_equal,
             "full_recon": rec, "full_orth": orth}
    emit(f"{where}_check", **check)
    require(w_equal and h_rel <= 1e-4,
            f"{where}: weighted kernel: w bitwise {w_equal}, h {h_rel}")
    require(f_equal and rec <= 5e-5 and orth <= ORTH_TOL_F32,
            f"{where}: full kernel: w, V bitwise {f_equal}, recon {rec} "
            f"orth {orth}")
    return {**check, "weighted_err": weighted_err, "full_err": full_err,
            "weighted_plain_ms": start.elapsed_time(stop)}


def reset_nw_launches() -> None:
    """Count the Newey-West kernel's launches from 0."""
    from mfm_tpu_torch.ops import newey_west_cuda

    newey_west_cuda.LAUNCHES["newey_west_scan"] = 0


def require_nw_launches(n: int, what: str) -> int:
    """The Newey-West kernel launched ``n`` times since
    :func:`reset_nw_launches`; returns the count."""
    from mfm_tpu_torch.ops.newey_west_cuda import launch_total

    got = launch_total()
    require(got == n, f"{what}: the Newey-West kernel must launch {n} "
                      f"times, launched {got}")
    return got


def nw_kernel_bound(T, K, q, itemsize) -> dict:
    """The least time the card could take for the Newey-West scan of a
    (T, K) series: the series read and the covariances written once at the
    memory rate, and K^2 (6 + 13 q) flops a date at the FP32 peak; the
    larger bounds it (the chain of T dependent date steps bounds it in
    fact)."""
    nbytes = (T * K + T * K * K) * itemsize
    flops = T * K * K * (6 + 13 * q)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_PER_S
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                flops=flops, bytes=nbytes)


def hold_nw_kernel(fr, cfg, where: str) -> dict:
    """The Newey-West kernel against its plain loop on a run's own factor
    returns ``fr`` (T, K): ``newey_west_expanding_resume`` as the model
    calls it, with the kernel and with ``models/newey_west._scan_loop`` in
    its place, on the same inputs; covs, valid and every carry tensor
    equal (:func:`same`).  Then the kernel's device time (the wrapper
    alone, 50 launches), the whole call's (20 calls, with its host reads),
    the loop's (one call) and the bound.  Emits phase ``{where}``; returns
    it."""
    from unittest import mock

    from mfm_tpu_torch.models import newey_west as NW
    from mfm_tpu_torch.ops.newey_west_cuda import newey_west_scan_cuda

    T, K = fr.shape
    q, half_life = cfg.nw_lags, cfg.nw_half_life

    def run():
        return NW.newey_west_expanding_resume(fr, q, half_life, min_valid=K)

    def leaves(result):
        covs, valid, (t, S, A, Z, *groups) = result
        return [covs, valid, t, S, A, Z, *(x for grp in groups for x in grp)]

    got = leaves(run())
    with mock.patch.object(NW, "newey_west_scan_cuda", NW._scan_loop):
        want = leaves(run())
        plain_ms = time_ms(run, 1, warmup=False)
    differ = [i for i, (a, b) in enumerate(zip(got, want)) if not same(a, b)]
    lam = torch.tensor(0.5, dtype=fr.dtype, device=fr.device) ** (
        1.0 / half_life)
    sums, skip = NW.nw_init_carry(K, q, fr.dtype, fr.device)[1:], [False] * T
    res = {"shape": [T, K], "q": q, "dtype": str(fr.dtype).split(".")[-1],
           "leaves": len(want), "leaves_differing": differ,
           "ms": time_ms(lambda: newey_west_scan_cuda(fr, lam, q, 0, sums,
                                                      skip), 50),
           "call_ms": time_ms(run, 20), "plain_ms": plain_ms,
           **nw_kernel_bound(T, K, q, fr.element_size())}
    emit(where, **res)
    require(not differ, f"{where}: the Newey-West kernel's leaves {differ} "
                        f"(0 covs, 1 valid, then the carry) are not its "
                        f"loop's")
    return res


# -- the daily serving step ---------------------------------------------------

#: the serving split: init on the first SERVE_T0 dates, then the rest one by
#: one.  In incremental mode the sweep cap of the simulated eighs moves from
#: 5 to 4 at 32*K = 1344 consumed draws, and update == suffix holds inside
#: one tier, so the init keeps at least 1344 dates.
SERVE_T0 = 1350


def max_abs_diff(got, want) -> float:
    """max |got - want| over entries finite in both (0 for bools that
    agree, inf for any disagreement in finiteness or in a bool)."""
    if not got.is_floating_point():
        return 0.0 if torch.equal(got, want) else float("inf")
    if not torch.equal(torch.isfinite(got), torch.isfinite(want)):
        return float("inf")
    m = torch.isfinite(want)
    return float((got[m].double() - want[m].double()).abs().max()) \
        if m.any() else 0.0


def same(got, want) -> bool:
    """Bitwise equality, NaN in the same places counting as equal."""
    if not got.is_floating_point():
        return torch.equal(got, want)
    return torch.equal(torch.isnan(got), torch.isnan(want)) and \
        torch.equal(got.nan_to_num(), want.nan_to_num())


def carry_leaves(state, guard=False) -> dict:
    """The named carry leaves of a ``RiskModelState``."""
    t, S, A, Z, Ps, hs, gs, Slags, xlags = state.nw_carry
    out = {"nw_t": t, "nw_S": S, "nw_A": A, "nw_Z": Z,
           **{f"nw_Ps{i}": x for i, x in enumerate(Ps)},
           **{f"nw_hs{i}": x for i, x in enumerate(hs)},
           **{f"nw_gs{i}": x for i, x in enumerate(gs)},
           **{f"nw_Slags{i}": x for i, x in enumerate(Slags)},
           **{f"nw_xlags{i}": x for i, x in enumerate(xlags)},
           "vr_num": state.vr_num, "vr_den": state.vr_den}
    if state.eig_R is not None:
        out.update(eig_R=state.eig_R, eig_p=state.eig_p, eig_n=state.eig_n)
    if guard:
        out.update(last_good_cov=state.last_good_cov,
                   staleness=state.staleness, guard_ring=state.guard_ring,
                   guard_ring_pos=state.guard_ring_pos)
    return out


def compare_carries(a, b, guard=False) -> dict:
    """Bitwise flag, each carry leaf's max |diff| and the largest relative
    difference over the leaves of two states."""
    la, lb = carry_leaves(a, guard), carry_leaves(b, guard)
    diff = {k: max_abs_diff(la[k], lb[k]) for k in lb}
    rel = max(diff[k] / (float(lb[k].abs().max()) or 1.0) for k in lb)
    return {"bitwise": all(same(la[k], lb[k]) for k in lb), "max_rel": rel,
            "max_abs_diff": diff}


def compare_rows(got, want) -> dict:
    """Per-field max |diff| and the bitwise flag of two RiskModelOutputs."""
    return {"bitwise": all(same(getattr(got, f), getattr(want, f))
                           for f in want._fields),
            "max_abs_diff": {f: max_abs_diff(getattr(got, f),
                                             getattr(want, f))
                             for f in want._fields}}


def cat_rows(rows):
    return type(rows[0])(*(torch.cat([getattr(r, f) for r in rows])
                           for f in rows[0]._fields))


def suffix(out, a, b=None):
    return type(out)(*(x[a:b] for x in out))


def suffix_rows(out, rows):
    return type(out)(*(x[rows] for x in out))


def serving_launches(n_updates: int, what: str) -> dict:
    """Launches per update of each kernel and design on a serving path,
    counted since the last reset; requires the warp design of both kernels
    and no block design."""
    from mfm_tpu_torch.ops.eigh_cuda import launch_counts

    counts = launch_counts()
    require(counts["jacobi_eigh/warp"] >= 1
            and counts["jacobi_eigh_weighted/warp"] >= 1,
            f"{what} did not launch the warp design of both kernels: {counts}")
    require(counts["jacobi_eigh/block"] == 0
            and counts["jacobi_eigh_weighted/block"] == 0,
            f"{what} launched a block-design kernel: {counts}")
    return {k: v / n_updates for k, v in counts.items()}


def timed(fn):
    """(result, seconds) of ``fn()`` on the host clock, ending in a
    device synchronise."""
    sync()
    t0 = time.perf_counter()
    r = fn()
    sync()
    return r, time.perf_counter() - t0


def wall_stats(walls) -> dict:
    s = sorted(walls)
    return {"median_ms": 1e3 * statistics.median(s),
            "p99_ms": 1e3 * s[min(len(s) - 1, int(0.99 * len(s)))],
            "max_ms": 1e3 * s[-1], "n": len(s)}


def serve_update(ctx) -> dict:
    """Phase serve_update: init_state on [0:T0], the remaining dates as
    single-date updates and as one slab, held against the full run."""
    from mfm_tpu_torch.convert import budget_check, outputs_to_numpy
    from mfm_tpu_torch.ops.eigh_cuda import reset_launches

    model, sim_covs, T, budget = (ctx["model"], ctx["sim_covs"], ctx["T"],
                                  ctx["budget"])
    T0 = SERVE_T0
    (full_out, full_state), init_full_s = timed(
        lambda: model(slice(0, T)).init_state(sim_covs=sim_covs,
                                              sim_length=T))
    fused = compare_rows(full_out, ctx["fused_out"])
    reset_nw_launches()
    (_, st0), init_s = timed(lambda: model(slice(0, T0)).init_state(
        sim_covs=sim_covs, sim_length=T))
    nw = {"init_state": require_nw_launches(1, "serve_update init_state")}

    st, rows, walls = st0, [], []
    reset_launches()
    reset_nw_launches()
    for t in range(T0, T):
        (o, st), dt = timed(lambda: model(slice(t, t + 1)).update(st))
        rows.append(o)
        walls.append(dt)
    per_update = serving_launches(T - T0, "serve_update")
    nw["per_update"] = require_nw_launches(T - T0, "serve_update") / (T - T0)
    seq_state = st
    reset_nw_launches()
    o_slab, st_slab = model(slice(T0, T)).update(st0)
    nw["slab"] = require_nw_launches(1, "serve_update slab")
    seq_rows = cat_rows(rows)
    want = suffix(full_out, T0)
    records, failed = budget_check(outputs_to_numpy(seq_rows),
                                   outputs_to_numpy(want), budget)
    _, failed_slab = budget_check(outputs_to_numpy(o_slab),
                                  outputs_to_numpy(want), budget)
    carries = {"singles_vs_slab": compare_carries(seq_state, st_slab),
               "slab_vs_full": compare_carries(st_slab, full_state),
               "singles_vs_full": compare_carries(seq_state, full_state)}
    differ = lambda a, b: [i for i in range(a.shape[0])
                           if not same(a[i], b[i])]
    res = {
        "T0": T0, "updates": T - T0,
        "singles_dates_differing": {
            f: differ(getattr(seq_rows, f), getattr(want, f))
            for f in ("factor_ret", "specific_ret", "r2")},
        "init_state_s": init_s, "init_state_full_s": init_full_s,
        "init_state_full_vs_run_fused": fused,
        "singles_vs_full": compare_rows(seq_rows, want),
        "slab_vs_full": compare_rows(o_slab, want),
        "singles_vs_slab": compare_rows(seq_rows, o_slab),
        "carries": carries, "budget_failed": failed + failed_slab,
        "budget_records": records,
        "update_wall": wall_stats(walls),
        "launches_per_update": per_update, "nw_launches": nw,
        # the one profile held against key_averages: ~300 kernels
        "profile_one_update": profile_run(
            lambda: model(slice(T - 1, T)).update(seq_state), hold=True),
    }
    emit("serve_update", **res)
    require(not failed and not failed_slab,
            f"serve_update rows outside the risk budgets: {failed + failed_slab}")
    require(all(c["bitwise"] for c in carries.values()),
            f"serve_update: singles, slab and full run carries differ: "
            f"{carries}")
    require(res["singles_vs_full"]["bitwise"]
            and res["slab_vs_full"]["bitwise"],
            "serve_update: the updates' rows are not bitwise the full run's")
    ctx["unguarded_init"] = st0
    return res


def nw_methods(fr, K, cfg, budget, reps: int) -> dict:
    """Both Newey-West methods on one run's factor returns ``fr`` (T, K):
    each method's walls over ``reps`` runs, each ending in a synchronize;
    the associative covariances held within the ``risk`` budgets'
    ``nw_cov`` entry (``valid`` exactly) against the serial scan's on the
    same device, and against the port's float64 associative run on the
    CPU; and ``compiled_memory`` of the associative run."""
    from mfm_tpu_torch.convert import budget_check
    from mfm_tpu_torch.models.newey_west import newey_west_expanding
    from mfm_tpu_torch.utils.obs import compiled_memory

    def run(x, method):
        return newey_west_expanding(x, q=cfg.nw_lags,
                                    half_life=cfg.nw_half_life, min_valid=K,
                                    method=method)

    outs, walls = {}, {}
    for method in ("scan", "associative"):
        runs = [timed(lambda: run(fr, method)) for _ in range(reps)]
        outs[method] = runs[-1][0]
        walls[method] = [s for _, s in runs]
    host = run(fr.double().cpu(), "associative")

    def held(got, want):
        return budget_check(
            {"nw_cov": got[0].cpu().numpy(), "nw_valid": got[1].cpu().numpy()},
            {"nw_cov": want[0].cpu().numpy(),
             "nw_valid": want[1].cpu().numpy()}, budget)

    vs_scan, failed_scan = held(outs["associative"], outs["scan"])
    vs_f64, failed_f64 = held(outs["associative"], host)
    memory = compiled_memory(lambda x: run(x, "associative"), fr)
    return {"shape": list(fr.shape), "reps": reps,
            "scan_median_s": statistics.median(walls["scan"]),
            "associative_median_s": statistics.median(walls["associative"]),
            "scan_runs_s": walls["scan"],
            "associative_runs_s": walls["associative"],
            "valid_equal": bool(torch.equal(outs["scan"][1],
                                            outs["associative"][1])),
            "vs_scan": vs_scan, "vs_float64_cpu": vs_f64,
            "associative_memory": memory,
            "failed": ([f"vs_scan:{f}" for f in failed_scan]
                       + [f"vs_float64_cpu:{f}" for f in failed_f64])}


def nw_associative_phase(ctx) -> dict:
    """Phase nw_associative: the associative Newey-West (a doubling prefix
    scan over the packed (T, 5421) state) at CSI300 width.  Both methods
    on the main path's factor returns (:func:`nw_methods`, median of 3
    each); then ``run_fused`` with ``nw_method="associative"`` on the same
    panel and ``sim_covs``: its nine outputs within the ``risk`` budgets
    of the scan run, its launches (counted from 0 before its first run:
    the weighted kernel once, the full kernel twice, as the scan path)
    and its e2e walls (median of 3)."""
    import dataclasses

    from mfm_tpu_torch import RiskModel
    from mfm_tpu_torch.convert import budget_check, outputs_to_numpy
    from mfm_tpu_torch.ops.eigh_cuda import launch_counts, reset_launches

    T, K, P = ctx["T"], ctx["K"], ctx["P"]
    cfg, scan_out = ctx["config"], ctx["fused_out"]
    nw = nw_methods(scan_out.factor_ret, K, cfg, ctx["budget"], 3)
    rm = RiskModel(*ctx["panel"], n_industries=P,
                   config=dataclasses.replace(cfg, nw_method="associative"),
                   device=ctx["device"])

    def run():
        return rm.run_fused(sim_covs=ctx["sim_covs"], sim_length=T)

    sync()
    reset_launches()
    out, first_s = timed(run)
    launches = launch_counts()
    walls = [timed(run)[1] for _ in range(3)]
    records, failed = budget_check(outputs_to_numpy(out),
                                   outputs_to_numpy(scan_out), ctx["budget"])
    res = {"newey_west": nw, "run_fused_launches": launches,
           "run_fused_first_s": first_s,
           "run_fused_e2e_median_s": statistics.median(walls),
           "run_fused_e2e_runs_s": walls, "run_fused_vs_scan": records,
           "run_fused_failed": failed}
    emit("nw_associative", **res)
    require(nw["valid_equal"] and not nw["failed"],
            f"nw_associative: the associative Newey-West is outside the "
            f"nw_cov budget: {nw['failed']}")
    require_launches(launches, "nw_associative run_fused", 1, 2)
    require(not failed, f"nw_associative: run_fused with the associative "
            f"method is outside the risk budgets of the scan run: {failed}")
    return res


def compile_profile_phase(ctx, build_walls) -> dict:
    """Phase compile_profile: the kernels' build walls (phase 1, captured
    by ``obs/profile.capture_compile_walls``); ``executable_profile`` of
    ``run_fused`` at CSI300 width with the panel and ``sim_covs`` as its
    arguments (counted flops at least the kernels' own operation count,
    ``peak_bytes`` at least ``argument_bytes``; its launches); and
    ``compiled_memory`` of the regression, Newey-West (both methods) and
    eigen stages, exported with ``record_compiled_memory`` and read back
    from the registry's ``mfm_compiled_bytes`` gauges."""
    from mfm_tpu_torch import RiskModel
    from mfm_tpu_torch.models.newey_west import newey_west_expanding
    from mfm_tpu_torch.obs import instrument
    from mfm_tpu_torch.obs.profile import executable_profile, kernel_flops
    from mfm_tpu_torch.ops.eigh_cuda import (
        launch_counts,
        launch_shapes,
        reset_launches,
    )
    from mfm_tpu_torch.utils.obs import compiled_memory

    T, K, P = ctx["T"], ctx["K"], ctx["P"]
    cfg, sim_covs, dev = ctx["config"], ctx["sim_covs"], ctx["device"]
    base = RiskModel(*ctx["panel"], n_industries=P, config=cfg, device=dev)
    panel = (base.ret, base.cap, base.styles, base.industry, base.valid)

    def model(*p):
        return RiskModel(*p, n_industries=P, config=cfg, device=dev)

    def fused(*a):
        return model(*a[:5]).run_fused(sim_covs=a[5], sim_length=T)

    sync()
    reset_launches()
    t0 = time.perf_counter()
    prof = executable_profile(fused, *panel, sim_covs)
    sync()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    kernel_ops = sum(n_launch * kernel_flops(k, B, n, sw)
                     for k, shapes in launch_shapes().items()
                     for (B, n, sw), n_launch in shapes.items())

    fr, _, _ = base.reg_by_time()
    nw_cov, nw_valid = base.newey_west_by_time(fr)

    def stage(fn):
        return lambda *a: fn(model(*a[:5]), *a[5:])

    stage_mem = {
        "regression": compiled_memory(stage(lambda m: m.reg_by_time()),
                                      *panel),
        "newey_west": compiled_memory(
            stage(lambda m, f: m.newey_west_by_time(f)), *panel, fr),
        "newey_west_associative": compiled_memory(
            stage(lambda m, f: newey_west_expanding(
                f, q=cfg.nw_lags, half_life=cfg.nw_half_life, min_valid=K,
                method="associative")), *panel, fr),
        "eigen": compiled_memory(
            stage(lambda m, c, v, s: m.eigen_risk_adj_by_time(
                c, v, sim_covs=s, sim_length=T)),
            *panel, nw_cov, nw_valid, sim_covs),
    }
    for name, mem in stage_mem.items():
        instrument.record_compiled_memory(name, mem)
    gauges = {name: {kind: instrument.COMPILED_BYTES.value(stage=name,
                                                          kind=kind)
                     for kind in mem}
              for name, mem in stage_mem.items()}
    flops = (prof["cost"] or {}).get("flops")
    mem = prof["memory"]
    res = {"build_walls_s": build_walls,
           "build_wall_s": round(sum(build_walls), 4) if build_walls else None,
           "profile": prof, "profile_wall_s": wall, "launches": launches,
           "kernel_flops": kernel_ops, "stage_memory": stage_mem,
           "gauges": gauges}
    emit("compile_profile", **res)
    require(flops is not None and flops >= kernel_ops > 0,
            f"compile_profile: counted flops {flops} below the kernels' own "
            f"{kernel_ops}")
    require(mem.get("peak_bytes", -1) >= mem["argument_bytes"] > 0,
            f"compile_profile: peak_bytes below argument_bytes: {mem}")
    require(all(gauges[n] == {k: float(v) for k, v in m.items()}
                for n, m in stage_mem.items()),
            f"compile_profile: the gauges do not read back: {gauges}")
    require_launches(launches, "compile_profile run_fused", 1, 2)
    return res


def doctrine_tools_phase(ctx) -> dict:
    """Phase doctrine_tools (host only): the port's ``lint --strict``,
    ``sync --strict`` and ``doctor --sync`` through ``cli.main`` on this
    checkout against the committed baselines; each exit code, its
    findings by rule, its baselined count and its wall."""
    res = {}
    for name, argv in (("lint", ["lint", "--strict", "--json"]),
                       ("sync", ["sync", "--strict", "--json"]),
                       ("doctor_sync", ["doctor", "--sync"])):
        t0 = time.perf_counter()
        code, out, _ = cli_call(argv)
        rec = {"rc": code, "wall_s": time.perf_counter() - t0}
        doc = json.loads(out)
        if name == "doctor_sync":
            (sync_rec,) = doc["records"]
            rec.update(problems=sync_rec["problems"],
                       baselined=sync_rec["baselined"])
        else:
            by_rule = {}
            for v in doc["new"]:
                by_rule[v["rule"]] = by_rule.get(v["rule"], 0) + 1
            rec.update(new_by_rule=by_rule, baselined=len(doc["baselined"]),
                       stale=len(doc["stale"]))
        res[name] = rec
    emit("doctrine_tools", **res)
    require(all(r["rc"] == 0 for r in res.values()),
            f"doctrine_tools: a pass is not clean: {res}")
    return res


def keep_layout(src, x):
    """``x`` (rows gathered from ``src``) laid out in memory in ``src``'s
    dimension order, so an op sees the strides it sees in the full run
    (a transposed operand takes another cuBLAS kernel)."""
    order = sorted(range(src.dim()), key=src.stride, reverse=True)
    inverse = sorted(range(src.dim()), key=order.__getitem__)
    return x.permute(order).contiguous().permute(inverse)


def serve_bitwise_ops(ctx) -> dict:
    """Phase serve_bitwise_ops: each op of the update path keeps a date's
    bits at the batch sizes an update gives it.  Each op of the regression
    (``ops/xreg.py``), of the eigen stage and of the vol-regime statistic
    runs on the full run's own inputs, once over all T dates and once over
    the rows of a serving slab: the 40 appended dates at once, and each of
    them as the copies a one-date update runs (``MIN_REGRESSION_DATES`` for
    the regression, ``MIN_EIGEN_DATES`` for the eigen stage, one for the
    vol-regime statistic).  ``mismatches`` counts the dates whose rows
    differ; an op with any breaks update == suffix and fails the run."""
    from mfm_tpu_torch.models.eigen import _bias_ratios, sim_sweeps_for
    from mfm_tpu_torch.models.risk_model import (
        MIN_EIGEN_DATES,
        MIN_REGRESSION_DATES,
    )
    from mfm_tpu_torch.ops import xreg
    from mfm_tpu_torch.ops.eigh import batched_eigh, pinv_psd
    from mfm_tpu_torch.ops.masked import masked_var

    m = ctx["model"](slice(0, ctx["T"]))
    T, P, K = m.T, m.n_industries, m.K
    X, valid, capz = xreg.regression_design(
        m.ret, m.cap, m.styles, m.industry, m.valid, n_industries=P)
    w = torch.sqrt(capz)
    ind_oh = X[..., 1:1 + P].transpose(-1, -2).contiguous()
    ind_cap = xreg._rowdot(ind_oh, capz[..., None, :])
    R = xreg._constraint_matrix(ind_cap, m.Q)
    Xr = X @ R
    XtW = Xr.transpose(-1, -2) * (w / w.sum(-1, keepdim=True))[..., None, :]
    G = xreg._gram(XtW, Xr)
    Ginv = pinv_psd(G)
    zero = torch.zeros((), device=X.device)
    retz = torch.where(valid, m.ret, zero)
    omega = R @ (Ginv @ XtW)
    fr = xreg._rowdot(omega, retz[..., None, :])
    spec = retz - xreg._rowdot(X, fr[..., None, :])
    out = ctx["fused_out"]
    eye = torch.eye(K, device=X.device)
    F0 = torch.where(out.nw_valid[:, None, None], out.nw_cov, eye)
    D0, U0 = batched_eigh(F0, canonical_signs=False)
    s = torch.sqrt(torch.clamp_min(D0, 0.0))
    sim = ctx["sim_covs"]
    sweeps = sim_sweeps_for(K, torch.float32, T)
    var = out.eigen_cov.diagonal(dim1=-2, dim2=-1)
    reg, eig = MIN_REGRESSION_DATES, MIN_EIGEN_DATES

    ops = {
        "regression_design": (
            lambda r, c, st, i, v: xreg.regression_design(
                r, c, st, i, v, n_industries=P)[0],
            (m.ret, m.cap, m.styles, m.industry, m.valid), reg),
        "sum over N, innermost (weights)": (
            lambda w: w / w.sum(-1, keepdim=True), (w,), reg),
        "rowdot X' capz (industry caps)": (
            lambda a, b: xreg._rowdot(a, b[..., None, :]), (ind_oh, capz),
            reg),
        "matmul X @ R": (lambda a, b: a @ b, (X, R), reg),
        "_gram XtW @ Xr (normal matrix)": (xreg._gram, (XtW, Xr), reg),
        "pinv_psd (jacobi_eigh kernel + matmul)": (pinv_psd, (G,), reg),
        "matmul R @ (Ginv @ XtW)": (lambda r, g, x: r @ (g @ x),
                                    (R, Ginv, XtW), reg),
        "rowdot omega ret (factor returns)": (
            lambda o, r: xreg._rowdot(o, r[..., None, :]), (omega, retz),
            reg),
        "rowdot X f (residuals)": (
            lambda x, f: xreg._rowdot(x, f[..., None, :]), (X, fr), reg),
        "masked_var over N, innermost (r2)": (
            lambda x, v: masked_var(x, v, dim=-1, ddof=0), (spec, valid),
            reg),
        "batched_eigh F0 (jacobi_eigh kernel)": (
            lambda a: batched_eigh(a, canonical_signs=False)[0], (F0,), eig),
        "_bias_ratios (weighted kernel, sort, mean over M)": (
            lambda sc, d: _bias_ratios(
                sc[:, None, :, None] * sim[None] * sc[:, None, None, :], d,
                sweeps, True), (s, D0), eig),
        "matmul U0 diag U0' (eigen rebuild)": (
            lambda u, d: (u * d[:, None, :]) @ u.transpose(-1, -2), (U0, D0),
            eig),
        "mean over K (vol-regime bias statistic)": (
            lambda f, v: (f ** 2 / v).mean(dim=-1), (out.factor_ret, var), 1),
    }
    dev = X.device
    res = {}
    for name, (fn, args, copies) in ops.items():
        full = fn(*args)

        def matches(rows):
            return same(fn(*(keep_layout(a, a[rows]) for a in args)),
                        full[rows])

        res[name] = {
            "slab": matches(torch.arange(SERVE_T0, T, device=dev)),
            "copies": copies,
            "mismatches": sum(
                not matches(torch.tensor([t] * copies, device=dev))
                for t in range(SERVE_T0, T))}
    emit("serve_bitwise_ops", dates=T - SERVE_T0, ops=res)
    moved = [k for k, r in res.items() if not r["slab"] or r["mismatches"]]
    require(not moved, f"serve_bitwise_ops: these ops give a date other bits "
            f"at an update's batch size: {moved}")
    return res


def serve_guarded(ctx) -> dict:
    """Phase serve_guarded: update_guarded over a slab with one
    NaN-poisoned date, against the same slab with the date cut out."""
    import numpy as np

    from mfm_tpu_torch import RiskModelConfig
    from mfm_tpu_torch.config import QuarantinePolicy
    from mfm_tpu_torch.convert import budget_check, outputs_to_numpy
    from mfm_tpu_torch.ops.eigh_cuda import reset_launches
    from mfm_tpu_torch.serve.guard import REASON_NAN_DENSITY

    model, panel, sim_covs, T = (ctx["model"], ctx["panel"],
                                 ctx["sim_covs"], ctx["T"])
    T0, off = SERVE_T0, 10
    gcfg = RiskModelConfig(quarantine=QuarantinePolicy(enabled=True))
    t_bad = T0 + off
    ret = panel[0].copy()
    universe = np.nonzero(panel[4][t_bad])[0]
    ret[t_bad, universe[: int(round(0.6 * len(universe)))]] = np.nan
    bad = (ret,) + tuple(panel[1:])

    (_, gst), init_s = timed(lambda: model(slice(0, T0), gcfg).init_state(
        sim_covs=sim_covs, sim_length=T))
    reset_launches()
    reset_nw_launches()
    (o_g, rep, st_g), slab_s = timed(
        lambda: model(slice(T0, T), gcfg, bad).update_guarded(gst))
    slab_launches = serving_launches(1, "serve_guarded slab")
    nw = {"slab": require_nw_launches(1, "serve_guarded slab")}
    q = rep.quarantined.cpu()
    reasons = rep.reasons.cpu()
    keep = np.r_[T0:t_bad, t_bad + 1:T]
    o_c, _, st_c = model(keep, gcfg).update_guarded(gst)
    healthy = np.r_[0:off, off + 1:T - T0]
    cut_rows = compare_rows(suffix_rows(o_g, healthy), o_c)
    cut_carries = compare_carries(st_g, st_c, guard=True)
    served_ok = same(rep.served_cov[off], o_g.vr_cov[off - 1]) and \
        bool(o_g.eigen_valid[off - 1])

    # a clean slab: the guards change nothing
    o_clean, rep_clean, _ = model(slice(T0, T), gcfg).update_guarded(gst)
    o_u, _ = model(slice(T0, T)).update(ctx["unguarded_init"])
    _, failed = budget_check(outputs_to_numpy(o_clean), outputs_to_numpy(o_u),
                             ctx["budget"])

    st, walls = gst, []
    reset_launches()
    reset_nw_launches()
    for t in range(T0, T):
        (_, _, st), dt = timed(
            lambda: model(slice(t, t + 1), gcfg, bad).update_guarded(st))
        walls.append(dt)
    per_update = serving_launches(T - T0, "serve_guarded")
    nw["per_update"] = require_nw_launches(T - T0, "serve_guarded") / (
        T - T0)
    singles_carries = compare_carries(st, st_g, guard=True)
    res = {
        "T0": T0, "poisoned_offset": off, "init_state_s": init_s,
        "slab_update_s": slab_s, "slab_launches": slab_launches,
        "quarantined": np.nonzero(q.numpy())[0].tolist(),
        "reasons_at_poisoned": int(reasons[off]),
        "staleness_at_poisoned": int(rep.staleness[off]),
        "served_is_last_healthy_vr_cov": served_ok,
        "cut_slab_rows": cut_rows, "cut_slab_carries": cut_carries,
        "clean_vs_unguarded": compare_rows(o_clean, o_u),
        "clean_quarantined": int(rep_clean.quarantined.sum()),
        "clean_budget_failed": failed,
        "quarantine_count": int(st.quarantine_count),
        "singles_vs_slab_carries": singles_carries,
        "update_wall": wall_stats(walls),
        "launches_per_update": per_update, "nw_launches": nw,
    }
    emit("serve_guarded", **res)
    require(res["quarantined"] == [off]
            and res["reasons_at_poisoned"] & REASON_NAN_DENSITY,
            "serve_guarded: the poisoned date, and only it, must quarantine "
            "with the nan_density bit")
    require(served_ok and res["staleness_at_poisoned"] == 1,
            "serve_guarded: the quarantined date must serve the last healthy "
            "vr_cov at staleness 1")
    require(cut_carries["bitwise"],
            f"serve_guarded: carries differ from the cut slab's: {cut_carries}")
    require(not failed and res["clean_quarantined"] == 0
            and res["clean_vs_unguarded"]["bitwise"],
            f"serve_guarded: a clean guarded slab is not the unguarded one: "
            f"{failed}")
    require(res["quarantine_count"] == 1 and singles_carries["bitwise"],
            "serve_guarded: the single-date loop must quarantine once and "
            "land on the slab's carries")
    ctx["guarded_init"], ctx["gcfg"], ctx["bad"] = gst, gcfg, bad
    ctx["poisoned_offset"] = off
    return res


def serve_incremental(ctx) -> dict:
    """Phase serve_incremental: the causal eigen mode, init on [0:T0] and
    the rest as single-date updates and as a slab, against the full
    incremental init."""
    from mfm_tpu_torch import RiskModelConfig
    from mfm_tpu_torch.convert import budget_check, outputs_to_numpy
    from mfm_tpu_torch.models.eigen import draw_bucket, simulated_eigen_draws
    from mfm_tpu_torch.ops.eigh_cuda import launch_counts, reset_launches

    model, T, K, M = ctx["model"], ctx["T"], ctx["K"], ctx["M"]
    T0 = SERVE_T0
    icfg = RiskModelConfig(eigen_incremental=True)
    bucket = draw_bucket(T)
    d_big = simulated_eigen_draws(icfg.seed, K, bucket, M,
                                  device=ctx["device"])
    d_half = simulated_eigen_draws(icfg.seed, K, bucket // 2, M,
                                   device=ctx["device"])
    prefix_ok = bool(torch.equal(d_big[..., : bucket // 2], d_half))
    del d_big, d_half

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    (_, st0), init_s = timed(lambda: model(slice(0, T0), icfg).init_state())
    init_launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    (full_out, full_state), init_full_s = timed(
        lambda: model(slice(0, T), icfg).init_state())

    st, rows, walls = st0, [], []
    reset_launches()
    for t in range(T0, T):
        (o, st), dt = timed(lambda: model(slice(t, t + 1), icfg).update(st))
        rows.append(o)
        walls.append(dt)
    per_update = serving_launches(T - T0, "serve_incremental")
    o_slab, st_slab = model(slice(T0, T), icfg).update(st0)
    seq_rows, want = cat_rows(rows), suffix(full_out, T0)
    _, failed = budget_check(outputs_to_numpy(seq_rows),
                             outputs_to_numpy(want), ctx["budget"])
    _, failed_slab = budget_check(outputs_to_numpy(o_slab),
                                  outputs_to_numpy(want), ctx["budget"])
    carries = {"singles_vs_slab": compare_carries(st, st_slab),
               "slab_vs_full": compare_carries(st_slab, full_state)}
    res = {
        "T0": T0, "bucket": bucket, "prefix_half_bucket_bitwise": prefix_ok,
        "init_bucket": st0.eig_draws.shape[-1],
        "init_state_s": init_s, "init_state_full_s": init_full_s,
        "init_launches": init_launches, "init_peak_mem_gb": peak_gb,
        "singles_vs_full": compare_rows(seq_rows, want),
        "slab_vs_full": compare_rows(o_slab, want),
        "carries": carries, "budget_failed": failed + failed_slab,
        "update_wall": wall_stats(walls),
        "launches_per_update": per_update,
    }
    emit("serve_incremental", **res)
    require(prefix_ok and full_state.eig_draws.shape[-1] == bucket,
            f"serve_incremental: the {bucket // 2} draw bucket is not the "
            f"prefix of the {bucket} one the full init uses")
    require(not failed and not failed_slab,
            f"serve_incremental rows outside the risk budgets: "
            f"{failed + failed_slab}")
    require(all(c["bitwise"] for c in carries.values()),
            f"serve_incremental: carries differ: {carries}")
    require(res["singles_vs_full"]["bitwise"]
            and res["slab_vs_full"]["bitwise"],
            "serve_incremental: the updates' rows are not bitwise the full "
            "init's")
    return res


def serve_checkpoint(ctx) -> dict:
    """Phase serve_checkpoint: the guarded state through save_risk_state /
    load_risk_state, the next update_guarded bitwise the in-memory one,
    and the torn and stale refusals.  The checkpoint stays in the run's
    scratch directory for phase query_server, beside a second one: the
    state stepped onto the poisoned date (one date stale)."""
    from mfm_tpu_torch.data.artifacts import (
        ArtifactCorruptError,
        ArtifactStaleError,
        load_risk_state,
        save_risk_state,
    )

    model, gcfg, bad, gst = (ctx["model"], ctx["gcfg"], ctx["bad"],
                             ctx["guarded_init"])
    T0, T = SERVE_T0, ctx["T"]
    tmp = ctx["tmp"]
    path = os.path.join(tmp, "state.npz")
    _, save_s = timed(lambda: save_risk_state(path, gst))
    (loaded, meta), load_s = timed(
        lambda: load_risk_state(path, ctx["device"]))
    size = os.path.getsize(path)
    on_card = all(x.device.type == ctx["device"]
                  for x in carry_leaves(loaded, True).values())
    mem = model(slice(T0, T), gcfg, bad).update_guarded(gst)
    dsk = model(slice(T0, T), gcfg, bad).update_guarded(loaded)
    rows = compare_rows(dsk[0], mem[0])
    report = all(same(a, b) for a, b in zip(dsk[1], mem[1]))
    carries = compare_carries(dsk[2], mem[2], guard=True)

    stale_path = os.path.join(tmp, "stale", "state.npz")
    save_risk_state(stale_path, gst)
    old = Path(stale_path).read_bytes()
    save_risk_state(stale_path, gst)
    Path(stale_path).write_bytes(old)
    try:
        load_risk_state(stale_path, ctx["device"])
        stale = False
    except ArtifactStaleError:
        stale = True
    torn = os.path.join(tmp, "torn.npz")
    save_risk_state(torn, gst)
    data = Path(torn).read_bytes()
    Path(torn).write_bytes(data[: len(data) // 2])
    try:
        load_risk_state(torn, ctx["device"])
        corrupt = False
    except ArtifactCorruptError:
        corrupt = True
    res = {"save_s": save_s, "load_s": load_s, "bytes": size,
           "generation": meta["generation"], "loaded_on_card": on_card,
           "rows": rows, "report_bitwise": report, "carries": carries,
           "stale_refused": stale, "torn_refused": corrupt}
    emit("serve_checkpoint", **res)
    require(on_card and rows["bitwise"] and report and carries["bitwise"],
            "serve_checkpoint: the loaded state does not continue bitwise")
    require(stale and corrupt,
            "serve_checkpoint: a stale or torn checkpoint was not refused")
    stepped = os.path.join(tmp, "stepped", "state.npz")
    off = ctx["poisoned_offset"]
    save_risk_state(stepped, model(slice(T0, T0 + off + 1), gcfg,
                                   bad).update_guarded(gst)[2])
    ctx["checkpoints"] = {"checkpoint": path,
                          "stepped_onto_poisoned_date": stepped}
    return res


# -- the risk pipeline ----------------------------------------------------------

def analytics_on(result):
    """The pandas-free analytics of a pipeline result, with their walls:
    the shrunk specific-risk panel, the portfolio-risk helper at the last
    date (equal weights on the first 50 stocks in its universe with a
    specific-vol estimate), ``portfolio_bias(100)`` and
    ``bias_stats_summary``."""
    import numpy as np

    from mfm_tpu_torch.models.bias import bias_stats_summary
    from mfm_tpu_torch.ops.eigh_cuda import launch_counts, reset_launches

    walls, launches = {}, {}
    (raw, shrunk), walls["specific_risk_s"] = timed(
        lambda: result._specific_panels(42.0, 10, 1.0, 10))
    design_valid = result._design(slice(-1, None))[1][0].cpu().numpy()
    held = np.nonzero(design_valid & np.isfinite(shrunk[-1]))[0][:50]
    w = np.zeros(shrunk.shape[1])
    w[held] = 1.0 / len(held)
    risk, walls["portfolio_risk_s"] = timed(
        lambda: result._portfolio_risk(w, -1, None, 42.0, 10, 1.0, 10))
    reset_launches()
    bias, walls["portfolio_bias_s"] = timed(
        lambda: result.portfolio_bias(n_portfolios=100))
    launches["portfolio_bias"] = launch_counts()
    o = result.outputs
    reset_launches()
    summary, walls["bias_stats_summary_s"] = timed(
        lambda: bias_stats_summary(o.nw_cov, o.nw_valid, o.eigen_cov,
                                   o.eigen_valid, o.factor_ret))
    launches["bias_stats_summary"] = launch_counts()
    return {"raw": raw, "shrunk": shrunk, "held": len(held), "risk": risk,
            "portfolio_bias": bias, "summary": summary, "walls": walls,
            "launches": launches}


def numbers(tree) -> list:
    """The numbers of a nested dict/list in a fixed order (None kept)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in numbers(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in numbers(v)]
    return [tree] if tree is None or isinstance(tree, (int, float)) else []


def max_rel_diff(got, want, floor=0.0) -> float:
    """max |got - want| / max(|want|, floor) over two equal-length number
    lists (NaN if any is NaN); inf where one is None and the other not."""
    worst = 0.0
    for a, b in zip(got, want, strict=True):
        if (a is None) != (b is None):
            return float("inf")
        if a is not None:
            d = abs(a - b) / max(abs(b), floor, 1e-300)
            worst = d if not d <= worst else worst  # a NaN sticks
    return worst


def pipeline_ingest(ctx) -> dict:
    """Phase pipeline_ingest: the CSI300 barra table, made and densified."""
    import numpy as np

    from mfm_tpu_torch.data.barra import barra_frame_to_arrays
    from mfm_tpu_torch.data.synthetic import synthetic_barra_table

    T, N, P, Q = ctx["shape"]
    (table, style_names), make_s = timed(
        lambda: synthetic_barra_table(T=T, N=N, P=P, Q=Q, seed=0))
    arrays, densify_s = timed(lambda: barra_frame_to_arrays(table))
    rows = len(table["date"])
    res = {"rows": rows, "columns": list(table), "make_s": make_s,
           "densify_s": densify_s, "dates": len(arrays.dates),
           "stocks": len(arrays.stocks), "industries": arrays.n_industries,
           "valid_cells": int(arrays.valid.sum())}
    emit("pipeline_ingest", **res)
    require((len(arrays.dates), len(arrays.stocks), arrays.n_industries,
             len(style_names)) == (T, N, P, Q)
            and res["valid_cells"] == rows,
            f"pipeline_ingest: the table densified to the wrong shape: {res}")
    require(0.94 * T * N < rows < 0.96 * T * N + T * P,
            f"pipeline_ingest: {rows} rows, not the table's ~5% missing")
    ctx["table"], ctx["arrays"] = table, arrays
    return res


def pipeline_run(ctx) -> dict:
    """Phase pipeline_run: run_risk_pipeline on the table, bitwise
    RiskModel.run_fused on the densified arrays, through the warp design
    of both kernels."""
    import numpy as np

    from mfm_tpu_torch import PipelineConfig, RiskModel, run_risk_pipeline
    from mfm_tpu_torch.ops.eigh_cuda import launch_counts, reset_launches

    table, arrays, sim_covs, T = (ctx["table"], ctx["arrays"],
                                  ctx["sim_covs"], ctx["T"])
    cfg = PipelineConfig()

    def run():
        return run_risk_pipeline(table, config=cfg, sim_covs=sim_covs,
                                 sim_length=T, device=ctx["device"])

    sync()
    reset_launches()
    result = run()
    sync()
    launches = serving_launches(1, "pipeline_run")
    f32 = [np.asarray(x, np.float32) for x in (arrays.ret, arrays.cap,
                                               arrays.styles)]
    direct = RiskModel(*f32, arrays.industry, arrays.valid,
                       n_industries=arrays.n_industries, config=cfg.risk,
                       device=ctx["device"]).run_fused(sim_covs=sim_covs,
                                                       sim_length=T)
    vs_direct = compare_rows(result.outputs, direct)
    finite = outputs_finite(result.outputs, result.model.valid)
    walls = [timed(run)[1] for _ in range(3)]
    res = {"launches": launches, "vs_run_fused": vs_direct,
           "finite": finite, "wall_median_s": statistics.median(walls),
           "walls_s": walls}
    emit("pipeline_run", **res)
    require(vs_direct["bitwise"],
            "pipeline_run: outputs are not bitwise run_fused's on the "
            "densified arrays")
    require(all(finite.values()), f"pipeline_run: non-finite outputs: "
            f"{finite}")
    ctx["pipeline"] = result
    return res


#: float32 tolerances of the analytics on the card against the same
#: functions on the CPU over the card's outputs.  The inputs are the same
#: bits, so only the order of sums differs (~1e-7 relative); the
#: eigen-portfolio weights of nearly equal eigenvalues amplify that, most
#: on the early, near-singular Newey-West dates (1e-7 relative noise on the
#: outputs moved a bias stat by 2.6e-3 relative at T=420 on the CPU).
#: ``bias_stats_summary`` is the floor of its ``all_valid_dates`` scope's
#: limit (see BIAS_ULP_FACTOR)
ANALYTICS_TOL = {"specific_vol": 1e-5, "portfolio_risk": 1e-5,
                 "portfolio_bias": 2e-3, "bias_stats_summary": 2e-2}
#: the bias statistics by scope.  After the 252-date burn-in the
#: Newey-West covariances are well conditioned and card vs CPU sits near
#: 1e-3: held at BIAS_BURN_IN_TOL.  Over all valid dates the statistic
#: includes the near-singular first dates and moves by ~2e-2 when its
#: inputs move by one ulp, so it is held at max(ANALYTICS_TOL's floor,
#: BIAS_ULP_FACTOR x that response measured in the same run)
BIAS_BURN_IN_TOL = 5e-3
BIAS_ULP_FACTOR = 3.0


def pipeline_analytics(ctx) -> dict:
    """Phase pipeline_analytics: the specific-risk panel, portfolio risk,
    portfolio_bias(100) and bias_stats_summary on the card, held to their
    identities and to the same functions on the CPU."""
    import numpy as np

    from mfm_tpu_torch.pipeline import RiskPipelineResult

    result = ctx["pipeline"]
    card = analytics_on(result)
    cpu_out = type(result.outputs)(*(x.cpu() for x in result.outputs))
    host = analytics_on(RiskPipelineResult(outputs=cpu_out,
                                           arrays=result.arrays))
    r = card["risk"]
    contrib_rel = abs(float(r["factor_risk_contribution"].sum())
                      - r["factor_var"]) / r["factor_var"]
    total_rel = abs(r["total_vol"] ** 2 - r["factor_var"]
                    - r["specific_var"]) / r["total_vol"] ** 2

    def panel_rel(a, b):
        both = np.isfinite(a) & np.isfinite(b)
        same_nan = bool((np.isfinite(a) == np.isfinite(b)).all())
        return (float(np.abs(a[both] - b[both]).max() / np.abs(b[both]).max())
                if same_nan else float("inf"))

    keys = ("factor_var", "specific_var", "total_vol")
    vs_cpu = {
        "specific_vol": max(panel_rel(card["raw"], host["raw"]),
                            panel_rel(card["shrunk"], host["shrunk"])),
        "portfolio_risk": max_rel_diff(
            [r[k] for k in keys] + r["factor_exposures"].tolist(),
            [host["risk"][k] for k in keys]
            + host["risk"]["factor_exposures"].tolist(),
            floor=float(np.abs(host["risk"]["factor_exposures"]).max())),
        "portfolio_bias": max_rel_diff(numbers(card["portfolio_bias"]),
                                       numbers(host["portfolio_bias"]),
                                       floor=1.0),
        "bias_stats_summary": max_rel_diff(numbers(card["summary"]),
                                           numbers(host["summary"]),
                                           floor=1.0),
    }
    bias = bias_by_scope(result.outputs, card["summary"], host["summary"])
    vs_cpu["bias_stats_summary"] = bias["card_vs_cpu"]
    bias_launches = card["launches"]["bias_stats_summary"]
    res = {"held_stocks": card["held"], "walls": card["walls"],
           "cpu_walls": host["walls"],
           "portfolio_risk": {k: r[k] for k in keys},
           "sum_contributions_rel": contrib_rel,
           "total_vol_identity_rel": total_rel,
           "vs_cpu": vs_cpu, "tolerance": ANALYTICS_TOL,
           "bias_stats_by_scope": bias,
           "launches": card["launches"],
           # the aggregates; the 100 per-portfolio values stay out
           "portfolio_bias": {
               scope: {k: v for k, v in agg.items() if k != "bias"}
               for scope, agg in card["portfolio_bias"].items()
               if isinstance(agg, dict)},
           "bias_stats_summary": card["summary"]}
    emit("pipeline_analytics", **res)
    require(card["held"] == 50, "pipeline_analytics: fewer than 50 stocks "
            "in the last date's universe with a specific vol")
    require(contrib_rel <= 1e-5 and total_rel <= 1e-5,
            f"pipeline_analytics: portfolio risk identities fail: "
            f"contributions {contrib_rel}, total {total_rel}")
    failed = [k for k, v in vs_cpu.items()
              if k != "bias_stats_summary" and not v <= ANALYTICS_TOL[k]]
    failed += [f"bias_stats_summary.{scope}"
               for scope, v in bias["card_vs_cpu"].items()
               if not v <= bias["limit"][scope]]
    require(not failed, f"pipeline_analytics: the card disagrees with the "
            f"CPU on {failed}: {vs_cpu}")
    require(bias_launches["jacobi_eigh/warp"] == 4
            and bias_launches["jacobi_eigh/block"] == 0
            and bias_launches["jacobi_eigh_weighted/warp"] == 0,
            f"pipeline_analytics: bias_stats_summary must launch the full "
            f"kernel's warp design 4 times: {bias_launches}")
    ctx["bias_launches"] = bias_launches
    return res


def bias_by_scope(outputs, card, host) -> dict:
    """``bias_stats_summary`` card vs CPU per scope, beside the limit each
    is held to: the burn-in scope at BIAS_BURN_IN_TOL; the all-dates scope
    at max(its ANALYTICS_TOL floor, BIAS_ULP_FACTOR x the statistic's
    response, on the card, to ``nw_cov``, ``eigen_cov`` and ``factor_ret``
    moved by one ulp — as ``tools/bias_conditioning.py`` measures it)."""
    from mfm_tpu_torch.models.bias import bias_stats_summary

    moved = ("nw_cov", "eigen_cov", "factor_ret")
    o = type(outputs)(*(
        torch.nextafter(x, torch.full_like(x, float("inf")))
        if f in moved else x for f, x in zip(outputs._fields, outputs)))
    nudged = bias_stats_summary(o.nw_cov, o.nw_valid, o.eigen_cov,
                                o.eigen_valid, o.factor_ret)
    diff = {scope: max_rel_diff(numbers(card[scope]), numbers(host[scope]),
                                floor=1.0) for scope in card}
    ulp = max_rel_diff(numbers(nudged["all_valid_dates"]),
                       numbers(card["all_valid_dates"]), floor=1.0)
    limit = {scope: (max(ANALYTICS_TOL["bias_stats_summary"],
                         BIAS_ULP_FACTOR * ulp)
                     if scope == "all_valid_dates" else BIAS_BURN_IN_TOL)
             for scope in card}
    return {"card_vs_cpu": diff, "one_ulp_response_all_valid_dates": ulp,
            "one_ulp_response": {
                scope: max_rel_diff(numbers(nudged[scope]),
                                    numbers(card[scope]), floor=1.0)
                for scope in card},
            "limit": limit}


def drop_rows_of_date(table, date, frac, seed=0):
    """``table`` without ``frac`` of the rows of ``date``, each industry's
    first member kept (the constraint needs every industry present)."""
    import numpy as np

    names, industry = table["stocknames"], table["industry"]
    codes, first_row = np.unique(industry, return_index=True)
    keep_stock = np.isin(names, names[first_row])
    on_date = np.nonzero(table["date"] == date)[0]
    droppable = on_date[~keep_stock[on_date]]
    drop = np.random.default_rng(seed).choice(
        droppable, int(round(frac * len(on_date))), replace=False)
    keep = np.ones(len(names), bool)
    keep[drop] = False
    return {k: v[keep] for k, v in table.items()}


def pipeline_append(ctx) -> dict:
    """Phase pipeline_append: with_state on the first 1350 dates, the
    checkpoint, append_risk_pipeline on the whole table, against
    with_state over all 1390; and a guarded append whose date 1360 lost
    60% of its rows."""
    import tempfile

    import numpy as np

    from mfm_tpu_torch import (
        PipelineConfig,
        RiskModelConfig,
        append_risk_pipeline,
        run_risk_pipeline,
        save_pipeline_state,
    )
    from mfm_tpu_torch.config import QuarantinePolicy
    from mfm_tpu_torch.ops.eigh_cuda import reset_launches
    from mfm_tpu_torch.serve.guard import REASON_UNIVERSE_COLLAPSE

    table, sim_covs, T = ctx["table"], ctx["sim_covs"], ctx["T"]
    T0 = SERVE_T0
    dates = np.unique(table["date"])
    head = {k: v[table["date"] < dates[T0]] for k, v in table.items()}
    inject = dict(sim_covs=sim_covs, sim_length=T, device=ctx["device"])
    cfg = PipelineConfig()
    gcfg = PipelineConfig(risk=RiskModelConfig(
        quarantine=QuarantinePolicy(enabled=True)))
    full, full_s = timed(lambda: run_risk_pipeline(
        table, config=cfg, with_state=True, **inject))
    first, head_s = timed(lambda: run_risk_pipeline(
        head, config=cfg, with_state=True, **inject))
    off = 10
    poisoned = drop_rows_of_date(table, dates[T0 + off], 0.6)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.npz")
        _, save_s = timed(lambda: save_pipeline_state(path, first))
        reset_launches()
        app, append_s = timed(lambda: append_risk_pipeline(
            path, table, config=cfg, device=ctx["device"]))
        launches = serving_launches(1, "pipeline_append")
        gfirst = run_risk_pipeline(head, config=gcfg, with_state=True,
                                   **inject)
        gpath = os.path.join(tmp, "guarded", "state.npz")
        save_pipeline_state(gpath, gfirst)
        gapp, guarded_s = timed(lambda: append_risk_pipeline(
            gpath, poisoned, config=gcfg, device=ctx["device"]))
    quarantined = np.nonzero(gapp.report.quarantined.cpu().numpy())[0]
    reasons = int(gapp.report.reasons[off])
    res = {"T0": T0, "appended": len(app.arrays.dates),
           "with_state_full_s": full_s, "with_state_head_s": head_s,
           "save_s": save_s, "append_s": append_s,
           "guarded_append_s": guarded_s, "launches": launches,
           "rows_vs_full": compare_rows(app.outputs, suffix(full.outputs, T0)),
           "carries_vs_full": compare_carries(app.state, full.state),
           "last_date": app.state.last_date,
           "guarded_rows_on_poisoned_date": int(
               (poisoned["date"] == dates[T0 + off]).sum()),
           "guarded_quarantined": quarantined.tolist(),
           "guarded_reasons_at_poisoned": reasons}
    emit("pipeline_append", **res)
    require(res["appended"] == T - T0
            and res["last_date"] == full.state.last_date,
            "pipeline_append: the append did not cover the new dates")
    require(res["rows_vs_full"]["bitwise"]
            and res["carries_vs_full"]["bitwise"],
            "pipeline_append: the append is not bitwise the full run's "
            "suffix")
    require(res["guarded_quarantined"] == [off]
            and reasons & REASON_UNIVERSE_COLLAPSE,
            "pipeline_append: the collapsed date, and only it, must "
            "quarantine with the universe bit")
    return res


def eigen_mc_bf16(ctx) -> dict:
    """Phase eigen_mc_bf16: the bfloat16 Monte-Carlo with its own draws at
    CSI300 width and at the parity budget's shape, and its incremental
    mode's bitwise suffix and checkpoint."""
    import json
    import tempfile

    import numpy as np

    from mfm_tpu_torch import (
        PipelineConfig,
        RiskModel,
        RiskModelConfig,
        run_risk_pipeline,
    )
    from mfm_tpu_torch.data.artifacts import load_risk_state, save_risk_state
    from mfm_tpu_torch.models.bias import eigenfactor_bias_stat
    from mfm_tpu_torch.ops.eigh_cuda import reset_launches

    def bias_delta(outs, burn_in=0):
        """max over ranks of | |b_bf16 - 1| - |b_f32 - 1| |, the gate of
        ``eigen_mc_bf16``, over the eigen-valid dates from ``burn_in``."""
        stats = {}
        for mc, o in outs.items():
            late = torch.arange(o.factor_ret.shape[0],
                                device=o.factor_ret.device) >= burn_in
            stats[mc] = eigenfactor_bias_stat(
                o.eigen_cov, o.eigen_valid & late, o.factor_ret).cpu().numpy()
        return float(np.max(np.abs(np.abs(stats["bfloat16"] - 1.0)
                                   - np.abs(stats[None] - 1.0))))

    csi, walls = {}, {}
    for mc in (None, "bfloat16"):
        cfg = PipelineConfig(risk=RiskModelConfig(eigen_mc_dtype=mc))
        reset_launches()
        res_mc, walls[str(mc)] = timed(lambda: run_risk_pipeline(
            arrays=ctx["arrays"], config=cfg, device=ctx["device"]))
        serving_launches(1, f"eigen_mc_bf16 CSI300 {mc}")
        csi[mc] = res_mc.outputs
    csi_delta = {"all_valid_dates": bias_delta(csi),
                 "after_burn_in_252": bias_delta(csi, burn_in=252)}
    csi_finite = outputs_finite(csi["bfloat16"], res_mc.model.valid)
    del csi

    entry = json.loads((ROOT / "tools" / "parity_budget.json").read_text())[
        "eigen_mc_bf16"]
    shp = entry["shape"]
    Tb, Nb = shp["T"], shp["N"]
    Pb, Qb, Mb = shp["n_industries"], shp["n_styles"], shp["n_sims"]
    rng = np.random.default_rng(entry["seed"])
    panels = (
        (rng.standard_normal((Tb, Nb)) * 0.02).astype(np.float32),
        rng.uniform(1.0, 5.0, (Tb, Nb)).astype(np.float32),
        rng.standard_normal((Tb, Nb, Qb)).astype(np.float32),
        rng.integers(0, Pb, (Tb, Nb)).astype(np.int32),
        rng.uniform(size=(Tb, Nb)) > 0.05,
    )
    budget = {mc: RiskModel(*panels, n_industries=Pb, device=ctx["device"],
                            config=RiskModelConfig(
                                eigen_n_sims=Mb, eigen_sim_length=Tb,
                                eigen_mc_dtype=mc)).run()
              for mc in (None, "bfloat16")}
    budget_delta = bias_delta(budget)

    model, T, T0 = ctx["model"], ctx["T"], SERVE_T0
    icfg = RiskModelConfig(eigen_incremental=True, eigen_mc_dtype="bfloat16")
    torch.cuda.reset_peak_memory_stats()
    (_, st0), init_s = timed(lambda: model(slice(0, T0), icfg).init_state())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    full_out, full_state = model(slice(0, T), icfg).init_state()
    st, rows, upd = st0, [], []
    reset_launches()
    for t in range(T0, T):
        (o, st), dt = timed(lambda: model(slice(t, t + 1), icfg).update(st))
        rows.append(o)
        upd.append(dt)
    per_update = serving_launches(T - T0, "eigen_mc_bf16 incremental")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.npz")
        save_risk_state(path, st0)
        loaded, meta = load_risk_state(path, ctx["device"])
    mem = model(slice(T0, T), icfg).update(st0)
    dsk = model(slice(T0, T), icfg).update(loaded)
    res = {
        "csi300": {"walls_s": walls, "bias_abs_delta": csi_delta,
                   "finite": csi_finite},
        "budget_shape": {"T": Tb, "N": Nb, "P": Pb, "Q": Qb, "M": Mb,
                         "seed": entry["seed"],
                         "bias_abs_delta": budget_delta,
                         "limit": entry["bias_abs_delta"]},
        "incremental": {
            "T0": T0, "draws_dtype": str(st0.eig_draws.dtype),
            "init_state_s": init_s, "init_peak_mem_gb": peak_gb,
            "update_wall": wall_stats(upd), "launches_per_update": per_update,
            "singles_vs_full": compare_rows(cat_rows(rows),
                                            suffix(full_out, T0)),
            "carries_vs_full": compare_carries(st, full_state),
            "checkpoint": {
                "meta_dtype": meta.get("eig_draws_dtype"),
                "draws_bitwise": bool(torch.equal(loaded.eig_draws,
                                                  st0.eig_draws)),
                "rows": compare_rows(dsk[0], mem[0]),
                "carries": compare_carries(dsk[1], mem[1])}},
    }
    emit("eigen_mc_bf16", **res)
    inc, ck = res["incremental"], res["incremental"]["checkpoint"]
    require(all(csi_finite.values()),
            f"eigen_mc_bf16: non-finite CSI300 outputs: {csi_finite}")
    require(budget_delta <= entry["bias_abs_delta"],
            f"eigen_mc_bf16: bias delta {budget_delta} over the budget")
    require(inc["draws_dtype"] == "torch.bfloat16"
            and inc["singles_vs_full"]["bitwise"]
            and inc["carries_vs_full"]["bitwise"],
            "eigen_mc_bf16: the bf16 incremental updates are not bitwise "
            "the full init's suffix")
    require(ck["meta_dtype"] == "bfloat16" and ck["draws_bitwise"]
            and ck["rows"]["bitwise"] and ck["carries"]["bitwise"],
            "eigen_mc_bf16: the bf16 checkpoint does not round-trip bitwise")
    return res


# -- factor production -----------------------------------------------------------

def _factor_records(got, want, budget) -> dict:
    """``budget_check`` of two dicts of (T, N) tensors or arrays against
    the ``factors`` budgets: per field the max and median |got - want| /
    max|want| over the entries finite in both, and the failed checks
    (a NaN-pattern difference included)."""
    from mfm_tpu_torch.convert import budget_check

    host = lambda d: {k: v.cpu().numpy() if torch.is_tensor(v) else v
                      for k, v in d.items()}
    records, failed = budget_check(host(got), host(want), budget)
    return {"max_rel": max(r["max_rel"] for r in records.values()),
            "fields": records, "failed": failed}


def factor_rolling(ctx) -> dict:
    """Phase factor_rolling: ``rolling_beta_hsigma`` at bench config 2's
    shape (T=1390, N=300, float32, 5% NaN, window 252, half-life 63, min
    42, block 32) on the card under both impls, each held against the same
    call at float64 on the CPU within the BETA / HSIGMA budgets, and scan
    against block on the card."""
    import numpy as np

    from mfm_tpu_torch.ops.rolling import ROLLING_IMPLS, rolling_beta_hsigma

    T, N = ctx["T"], ctx["shape"][1]
    rng = np.random.default_rng(0)
    ret = (0.01 * rng.standard_normal((T, N))).astype(np.float32)
    ret[rng.random((T, N)) < 0.05] = np.nan
    mkt = (0.008 * rng.standard_normal(T)).astype(np.float32)
    kw = dict(window=252, half_life=63, min_periods=42, block=32)
    card = [torch.from_numpy(x).to(ctx["device"]) for x in (ret, mkt)]
    host = [torch.from_numpy(x).double() for x in (ret, mkt)]
    res, outs = {"T": T, "N": N, **kw}, {}
    for impl in ROLLING_IMPLS:
        def call():
            return rolling_beta_hsigma(*card, impl=impl, **kw)

        out = dict(zip(("BETA", "HSIGMA"), call()))
        walls = [timed(call)[1] for _ in range(3)]
        prof = profile_run(call)
        want, cpu_s = timed(lambda: rolling_beta_hsigma(*host, impl=impl,
                                                        **kw))
        res[impl] = {"wall_median_s": statistics.median(walls),
                     "walls_s": walls,
                     "device_kernels": prof["device_kernels"],
                     "busy_share": prof["busy_share"],
                     "cpu_float64_s": cpu_s,
                     "vs_cpu_float64": _factor_records(
                         out, dict(zip(("BETA", "HSIGMA"), want)),
                         ctx["factor_budget"])}
        outs[impl] = out
    res["scan_vs_block"] = _factor_records(outs["scan"], outs["block"],
                                           ctx["factor_budget"])
    emit("factor_rolling", **res)
    failed = {k: res[k]["vs_cpu_float64"]["failed"] for k in ROLLING_IMPLS}
    failed["scan_vs_block"] = res["scan_vs_block"]["failed"]
    require(not any(failed.values()), f"factor_rolling outside the BETA / "
            f"HSIGMA budgets or NaN patterns differ: {failed}")
    return res


def _factor_panel(ctx):
    """Bench config 3's raw panel (``synthetic_market_panel(T=1390, N=300,
    n_industries=31, seed=0)``), made once."""
    from mfm_tpu_torch.data.synthetic import synthetic_market_panel

    if "factor_panel" not in ctx:
        T, N, P, _ = ctx["shape"]
        ctx["factor_panel"] = synthetic_market_panel(T=T, N=N,
                                                     n_industries=P, seed=0)
    return ctx["factor_panel"]


def factor_engine(ctx) -> dict:
    """Phase factor_engine: ``FactorEngine.run()`` on bench config 3's
    panel at float32, block 32, under both impls on the card; every output
    within its ``factors`` budget of the same run on the CPU at float32,
    with the same NaN pattern; the distance to the CPU at float64 as
    information."""
    from mfm_tpu_torch import FactorEngine
    from mfm_tpu_torch.data.synthetic import panel_to_engine_fields
    from mfm_tpu_torch.ops.rolling import ROLLING_IMPLS

    data = _factor_panel(ctx)

    def engine(impl, device, dtype):
        return FactorEngine(panel_to_engine_fields(data, dtype, device),
                            torch.tensor(data["index_close"], dtype=dtype),
                            block=32, rolling_impl=impl, device=device)

    f64, f64_s = timed(lambda: engine("scan", "cpu", torch.float64).run())
    res, outs = {"T": data["close"].shape[0], "N": data["close"].shape[1],
                 "cpu_float64_scan_s": f64_s}, {}
    for impl in ROLLING_IMPLS:
        eng = engine(impl, ctx["device"], torch.float32)
        out = eng.run()
        walls = [timed(eng.run)[1] for _ in range(3)]
        prof = profile_run(eng.run)
        cpu, cpu_s = timed(lambda: engine(impl, "cpu", torch.float32).run())
        res[impl] = {"outputs": len(out),
                     "wall_median_s": statistics.median(walls),
                     "walls_s": walls,
                     "device_kernels": prof["device_kernels"],
                     "busy_s": prof["busy_s"],
                     "busy_share": prof["busy_share"],
                     "top_kernels": prof["top"],
                     "cpu_float32_s": cpu_s,
                     "vs_cpu_float32": _factor_records(out, cpu,
                                                       ctx["factor_budget"]),
                     "vs_cpu_float64_max_rel": {
                         k: r["max_rel"] for k, r in _factor_records(
                             out, f64, ctx["factor_budget"])["fields"].items()}}
        outs[impl] = out
    res["scan_vs_block"] = _factor_records(outs["scan"], outs["block"],
                                           ctx["factor_budget"])
    emit("factor_engine", **res)
    require(res["scan"]["outputs"] == 2 + 18 + 5,
            "factor_engine: not every output came back")
    failed = {k: res[k]["vs_cpu_float32"]["failed"] for k in ROLLING_IMPLS}
    require(not any(failed.values()), f"factor_engine: the card disagrees "
            f"with the CPU at float32 beyond the factors budgets: {failed}")
    nan_pattern = [f for f in res["scan_vs_block"]["failed"]
                   if f.endswith(":finiteness")]
    require(not nan_pattern, f"factor_engine: scan and block NaN patterns "
            f"differ: {nan_pattern}")
    return res


def factor_pipeline(ctx) -> dict:
    """Phase factor_pipeline, the slice end to end: ``run_factor_pipeline``
    on bench config 3's panel gives the barra table (a dict of numpy
    columns), ``run_risk_pipeline`` runs it on the card; the stages timed
    apart, the launches counted, the outputs bitwise ``run_fused`` on the
    densified arrays.

    The table starts where the first stocks have every style (RSTR needs
    21 + 42 traded days), so its first dates hold few stocks.  A date on
    which an industry has no row leaves the industry-neutrality constraint
    undefined (it divides by the last industry's cap) and its NaN factor
    returns would reach every later date through the Newey-West sums, in
    the reference as here; the risk run starts at the first date on which
    every industry has a row, and only leading dates may lack one."""
    import numpy as np

    from mfm_tpu_torch import (
        FactorEngine,
        PipelineConfig,
        RiskModel,
        run_factor_pipeline,
        run_risk_pipeline,
    )
    from mfm_tpu_torch.data.barra import barra_frame_to_arrays
    from mfm_tpu_torch.data.synthetic import (
        PANEL_META_KEYS,
        panel_to_engine_fields,
    )
    from mfm_tpu_torch.models.eigen import simulated_eigen_covs
    from mfm_tpu_torch.ops.eigh_cuda import launch_counts, reset_launches
    from mfm_tpu_torch.pipeline import assemble_barra_table

    data, dev, M = _factor_panel(ctx), ctx["device"], ctx["M"]
    fields = {k: v for k, v in data.items()
              if k not in PANEL_META_KEYS or k == "end_date_code"}
    l1 = np.array([f"sw{c:02d}" for c in data["industry"]])
    cfg = PipelineConfig(block=32)
    args = (fields, data["index_close"], l1, data["dates"], data["stocks"],
            cfg)
    (table, factors), pipeline_s = timed(
        lambda: run_factor_pipeline(*args, device=dev))

    # the stages apart: the engine (and the outputs' copy to the host),
    # the table assembly, the ingest
    eng = FactorEngine(panel_to_engine_fields(fields, torch.float32, dev),
                       torch.tensor(data["index_close"], dtype=torch.float32),
                       block=32, device=dev)
    host, factors_s = timed(lambda: {k: v.cpu().numpy()
                                     for k, v in eng.run().items()})
    again, assembly_s = timed(lambda: assemble_barra_table(
        host, data["dates"], data["stocks"], l1, fields["circ_mv"],
        np.isfinite(fields["close"])))
    same_table = all(np.array_equal(again[k], v, equal_nan=v.dtype.kind == "f")
                     for k, v in table.items())
    arrays, ingest_s = timed(lambda: barra_frame_to_arrays(table))
    P, Q = arrays.n_industries, len(arrays.style_names)
    K = 1 + P + Q
    members = np.stack([np.bincount(arrays.industry[t][arrays.valid[t]],
                                    minlength=P)
                        for t in range(len(arrays.dates))])
    covered = (members > 0).all(1)
    lead = int(np.argmax(covered))
    start = arrays.dates[lead]
    risk_table = {k: v[table["date"] >= start] for k, v in table.items()}
    T1 = len(arrays.dates) - lead
    sim_covs = simulated_eigen_covs(torch.Generator(device=dev).manual_seed(0),
                                    K, T1, M)

    def risk():
        return run_risk_pipeline(risk_table, config=cfg, sim_covs=sim_covs,
                                 sim_length=T1, device=dev)

    sync()
    reset_launches()
    result, risk_pipeline_s = timed(risk)
    launches = launch_counts()
    a = result.arrays
    model = RiskModel(*(np.asarray(x, np.float32)
                        for x in (a.ret, a.cap, a.styles)),
                      a.industry, a.valid, n_industries=a.n_industries,
                      config=cfg.risk, device=dev)
    direct, risk_s = timed(lambda: model.run_fused(sim_covs=sim_covs,
                                                   sim_length=T1))
    vs_direct = compare_rows(result.outputs, direct)
    finite = outputs_finite(result.outputs, result.model.valid)
    res = {
        "rows": len(table["date"]), "dates": len(arrays.dates),
        "panel_dates": data["close"].shape[0],
        "first_date": str(arrays.dates[0]), "last_date": str(arrays.dates[-1]),
        "leading_dates_missing_an_industry": lead,
        "first_date_stocks": int(members[0].sum()),
        "first_date_industries": int((members[0] > 0).sum()),
        "risk_rows": len(risk_table["date"]), "risk_dates": T1,
        "stocks": len(arrays.stocks), "industries": P, "styles": Q, "K": K,
        "table_matches_stage_run": same_table,
        "walls_s": {"run_factor_pipeline": pipeline_s, "factors": factors_s,
                    "assembly": assembly_s, "ingest": ingest_s,
                    "risk_run_fused": risk_s,
                    "run_risk_pipeline": risk_pipeline_s,
                    "raw_to_risk": pipeline_s + risk_pipeline_s},
        "launches": launches, "vs_run_fused": vs_direct, "finite": finite,
    }
    emit("factor_pipeline", **res)
    require(K == 42 and (P, Q) == (31, 10),
            f"factor_pipeline: K = {K} (P={P}, Q={Q}), not 42")
    require(same_table, "factor_pipeline: the stage-by-stage table differs "
            "from run_factor_pipeline's")
    require(bool(covered[lead:].all()) and lead <= 5,
            f"factor_pipeline: dates past the leading {lead} lack an "
            "industry")
    require(launches["jacobi_eigh_weighted/warp"] == 1
            and launches["jacobi_eigh/warp"] == 2
            and launches["jacobi_eigh/block"] == 0
            and launches["jacobi_eigh_weighted/block"] == 0,
            f"factor_pipeline: the risk run must launch the weighted kernel "
            f"once and the full kernel twice, warp design only: {launches}")
    require(vs_direct["bitwise"], "factor_pipeline: outputs are not bitwise "
            "run_fused's on the densified arrays")
    require(all(finite.values()), f"factor_pipeline: non-finite outputs: "
            f"{finite}")
    return res


# -- query serving ---------------------------------------------------------------

#: relative tolerance, per row, of the query engine on the card (float32)
#: against the same engine on the CPU at float64, and of a single stock-space
#: query against ``_portfolio_risk`` (float64 over the float32 outputs): each
#: answer is a few sums of K = 42 or N = 300 float32 products, ~1e-7 of
#: rounding unless terms cancel
QUERY_TOL = 1e-5
#: bench config 6's batch sizes (bench.py:936)
QUERY_SIZES = (1_000, 100_000, 1_000_000)
#: rows of a batch held against the CPU at float64: a seeded sample above
#: this count (the CPU takes tens of seconds for 2,097,152 float64 rows)
CPU_ROWS = 100_000


def bench_factor_cov():
    """The factor covariance of bench configs 6 and 7 (bench.py:925-927,
    984-986): K = 42, float32, from ``default_rng(0)``.  Returns it and
    the generator."""
    import numpy as np

    K = 1 + 31 + 10
    rng = np.random.default_rng(0)
    A = (rng.standard_normal((K, K)) / np.sqrt(K)).astype(np.float32)
    return (A @ A.T + 1e-3 * np.eye(K, dtype=np.float32)) * 1e-4, rng


def config6_engine(device, dtype=None):
    """Bench config 6's factor space (bench.py:925-930): K = 42, its
    covariance and its benchmark ``idx``, from ``default_rng(0)``.
    Returns the engine, the float32 covariance and the generator."""
    from mfm_tpu_torch.serve import QueryEngine

    cov, rng = bench_factor_cov()
    K = cov.shape[0]
    bench = {"idx": 0.1 * rng.standard_normal(K)}
    return (QueryEngine(cov, benchmarks=bench, dtype=dtype, device=device),
            cov, rng)


def rel_err(got, want) -> float:
    """max |got - want| / |want| over the rows (inf where one is NaN and
    the other not)."""
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if not np.array_equal(np.isnan(got), np.isnan(want)):
        return float("inf")
    m = ~np.isnan(want)
    return float(np.max(np.abs(got[m] - want[m])
                        / np.maximum(np.abs(want[m]), 1e-300), initial=0.0))


def engine_walls(engine, W, bucket, bench=None) -> dict:
    """Median of 3 walls of one padded query after a warm-up (each ending
    in a synchronise), portfolios/s, the peak memory above what was
    allocated before, and the device busy share of one more call."""
    import numpy as np

    def step():
        return engine.query(W, bench=bench, bucket=bucket, trim=False)

    step()
    sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    walls = [timed(step)[1] for _ in range(3)]
    peak = torch.cuda.max_memory_allocated()
    prof = profile_run(step, top=3)
    wall = statistics.median(walls)
    return {"B": len(W), "bucket": bucket, "chunk": engine.chunk,
            "wall_median_s": wall, "walls_s": walls,
            "portfolios_per_s": len(W) / wall,
            "peak_mem_above_base_gb": (peak - base) / 1e9,
            "peak_mem_gb": peak / 1e9, "busy_share": prof["busy_share"],
            "busy_s": prof["busy_s"], "profile_wall_s": prof["wall_s"],
            "device_kernels": prof["device_kernels"], "top": prof["top"],
            "input_mb": np.asarray(W).nbytes / 1e6}


def batch_vs_singles(engine, top_bucket, rows_of, seed) -> dict:
    """For each ladder bucket from 8 to ``top_bucket``: a full batch at that
    bucket, and 13 of its rows (the first and last, those beside a chunk
    boundary, the rest seeded; all 8 of bucket 8) each queried alone
    (bucket 8), every field compared bitwise.  Returns the differing
    fields by bucket."""
    import numpy as np

    from mfm_tpu_torch.serve.query import BUCKET_BASE, BUCKET_GROWTH

    differ, b = {}, BUCKET_BASE
    bidx = engine.benchmark_index[next(iter(engine.benchmark_index))]
    while b <= top_bucket:
        rng = np.random.default_rng((seed, b))
        W = rows_of(b, rng)
        bench = np.where(rng.random(b) < 0.5, bidx, 0)
        out = engine.query(W, bench=bench, trim=False)
        pick = {0, b - 1} | ({engine.chunk - 1, engine.chunk}
                             if b > engine.chunk else set())
        while len(pick) < min(13, b):
            pick.add(int(rng.integers(b)))
        bad = set()
        for i in sorted(pick):
            one = engine.query(W[i], bench=[bench[i]])
            for f, got, want in zip(one._fields, out, one):
                if not np.array_equal(got[i].cpu().numpy(), want[0],
                                      equal_nan=True):
                    bad.add(f)
        differ[str(b)] = sorted(bad)
        b *= BUCKET_GROWTH
    return differ


def query_engine_phase(ctx) -> dict:
    """Phase query_engine: bench config 6's factor space at B = 1e3, 1e5,
    1e6 on the card (walls, portfolios/s, peak memory, busy share), held
    against the same engine on the CPU at float64; the stock-space engine
    of the pipeline run's last date (N=300, K=42) at B = 2,048 and
    100,000, each single query held against ``_portfolio_risk``; and batch
    == singles bitwise at every bucket in both spaces."""
    import numpy as np

    from mfm_tpu_torch.serve import bucket_for

    card, cov, rng = config6_engine(ctx["device"])
    cpu, _, _ = config6_engine("cpu", dtype="float64")
    fields = ("total_vol", "factor_var", "active_risk")
    factor = {}
    for b in QUERY_SIZES:
        W = (0.2 * rng.standard_normal((b, card.K))).astype(np.float32)
        bucket = bucket_for(b)
        res = engine_walls(card, W, bucket)
        bench = np.where(np.arange(b) % 3 == 0, 1, 0)
        got = card.query(W, bench=bench)
        rows = (np.arange(b) if b <= CPU_ROWS else np.sort(
            np.random.default_rng(1).choice(b, CPU_ROWS, replace=False)))
        want = cpu.query(W[rows], bench=bench[rows])
        res["vs_cpu_float64_rel"] = {f: rel_err(getattr(got, f)[rows],
                                                getattr(want, f))
                                     for f in fields}
        res["cpu_rows"] = len(rows)
        factor[str(b)] = res
        del W, got

    result = ctx["pipeline"]
    arrays = result.arrays
    N = len(arrays.stocks)
    cap = np.where(arrays.valid[-1], np.nan_to_num(arrays.cap[-1]), 0.0)
    stock = result.query_engine(t=-1, benchmarks={"cap": cap / cap.sum()})
    shrunk = result._specific_panels(42.0, 10, 1.0, 10)[1][-1]
    held = result._design(slice(-1, None))[1][0].cpu().numpy() \
        & np.isfinite(shrunk)

    def books(n, r):
        W = np.abs(r.standard_normal((n, N))) * held
        return (W / W.sum(1, keepdims=True)).astype(np.float32)

    stock_walls = {str(b): engine_walls(stock, books(b, np.random.default_rng(b)),
                                        bucket_for(b))
                   for b in (2_048, 100_000)}
    singles = books(16, np.random.default_rng(3))
    worst = 0.0
    for w in singles:
        one = stock.query(w)
        pr = result._portfolio_risk(w, -1, None, 42.0, 10, 1.0, 10)
        worst = max(worst, max_rel_diff(
            [float(one.total_vol[0]), float(one.factor_var[0]),
             float(one.specific_var[0])],
            [pr["total_vol"], pr["factor_var"], pr["specific_var"]]),
            max_rel_diff(one.contribution[0].tolist(),
                         pr["factor_risk_contribution"].tolist(),
                         floor=float(np.abs(
                             pr["factor_risk_contribution"]).max())))

    bits = {
        "factor": batch_vs_singles(
            card, bucket_for(max(QUERY_SIZES)),
            lambda b, r: (0.2 * r.standard_normal((b, card.K))).astype(
                np.float32), seed=4),
        "stock": batch_vs_singles(stock, bucket_for(100_000),
                                  books, seed=5),
    }
    res = {"tolerance": QUERY_TOL, "factor_space": factor,
           "stock_space": {"N": N, "K": stock.K,
                           "staleness": stock.staleness,
                           "walls": stock_walls,
                           "singles_vs_portfolio_risk_rel": worst,
                           "singles": len(singles)},
           "batch_vs_singles_differing": bits}
    emit("query_engine", **res)
    off = {b: r["vs_cpu_float64_rel"] for b, r in factor.items()
           if not max(r["vs_cpu_float64_rel"].values()) <= QUERY_TOL}
    require(not off, f"query_engine: the card disagrees with the CPU at "
            f"float64: {off}")
    require(worst <= QUERY_TOL, f"query_engine: a stock-space single query "
            f"disagrees with _portfolio_risk: {worst}")
    differing = {s: {b: f for b, f in d.items() if f}
                 for s, d in bits.items()}
    require(not any(differing.values()), f"query_engine: batch != singles "
            f"(bitwise): {differing}")
    return res


def query_server_phase(ctx) -> dict:
    """Phase query_server: bench config 6's overload storm (2,048 requests
    against a 512-deep queue, gulp mode) through ``QueryServer`` on the
    card; then ``QueryEngine.from_risk_state`` on the guarded checkpoints
    of phase serve_checkpoint (its state, and that state stepped onto the
    poisoned date), each answer stamped with its state's staleness."""
    import io

    import numpy as np

    from mfm_tpu_torch.data.artifacts import load_risk_state
    from mfm_tpu_torch.obs import instrument as obs
    from mfm_tpu_torch.serve import QueryEngine, QueryServer, ServePolicy

    engine, _, _ = config6_engine(ctx["device"])
    rng = np.random.default_rng(6)
    lines = [json.dumps({"id": f"q{i}", "weights": np.round(
        0.2 * rng.standard_normal(engine.K), 6).tolist()})
        for i in range(2048)]
    policy = ServePolicy(queue_max=512, batch_max=256, default_deadline_s=30.0)
    before = obs.serve_summary_from_registry()
    buf = io.StringIO()
    summary, wall = timed(lambda: QueryServer(engine, policy, health="ok").run(
        lines, buf, gulp=True))
    tally = {k: v - before["requests"].get(k, 0)
             for k, v in summary["requests"].items()
             if v != before["requests"].get(k, 0)}
    resps = [json.loads(x) for x in buf.getvalue().splitlines()]
    ok = [r for r in resps if r["outcome"] == "ok"]
    shed = tally.get("shed", 0) / max(sum(tally.values()), 1)
    # the survivors' answers are bitwise one batch of them on the engine
    W = np.array([json.loads(lines[int(r["id"][1:])])["weights"] for r in ok])
    direct = engine.query(W).total_vol
    survivors_bitwise = [r["total_vol"] for r in ok] == [float(v)
                                                         for v in direct]

    entry = {}
    for name, path in ctx["checkpoints"].items():
        st, meta = load_risk_state(path, ctx["device"])
        eng = QueryEngine.from_risk_state(st, meta, device=ctx["device"])
        srv = QueryServer(eng, ServePolicy(default_deadline_s=60.0),
                          health="ok")
        for i in range(3):
            srv.submit_line(json.dumps({"id": f"{name}{i}", "weights": (
                0.2 * rng.standard_normal(eng.K)).tolist()}))
        out = srv.drain()
        entry[name] = {
            "state_staleness": int(st.staleness),
            "engine_staleness": eng.staleness,
            "response_staleness": [r["staleness"] for r in out],
            "degraded": [r["degraded"] for r in out],
            "outcomes": [r["outcome"] for r in out],
            "cov_is_last_good_cov": bool(torch.equal(eng._cov,
                                                     st.last_good_cov)),
            "device": str(eng.device)}
    res = {"storm": {"requests": len(lines), "wall_s": wall,
                     "outcomes": tally, "shed_rate": shed,
                     "responses": len(resps),
                     "query_p50_latency_s": summary["query_p50_latency_s"],
                     "query_p99_latency_s": summary["query_p99_latency_s"],
                     "breaker_state": summary["breaker_state"],
                     "survivors_bitwise_one_batch": survivors_bitwise},
           "serving_entry": entry}
    emit("query_server", **res)
    require(tally == {"shed": 1536, "ok": 512} and shed == 0.75
            and len(resps) == 2048 and summary["breaker_state"] == "closed",
            f"query_server: the storm must shed 3/4 and answer the rest: "
            f"{tally}")
    require(survivors_bitwise and all(math.isfinite(r["total_vol"])
                                      for r in ok),
            "query_server: the storm's answers are not one batch's bits")
    for name, want in (("checkpoint", 0), ("stepped_onto_poisoned_date", 1)):
        e = entry[name]
        require(e["state_staleness"] == e["engine_staleness"] == want
                and e["response_staleness"] == [want] * 3
                and e["degraded"] == [want > 0] * 3
                and e["outcomes"] == ["ok"] * 3 and e["cov_is_last_good_cov"],
                f"query_server: answers off {name} do not carry its "
                f"staleness: {e}")
    return res


def zipf_lines(seed, n, k, distinct=150, alpha=1.0, mix=(0.65, 0.20, 0.15)):
    """Bench config 10's stream shape: ``n`` lines drawn Zipf(``alpha``)
    from ``distinct`` seeded bodies (plain, ``benchmark: idx`` and
    ``scenario: stress`` queries in ``mix``), each line with its own id."""
    import numpy as np

    rng = np.random.default_rng(seed)
    kinds = rng.choice(3, size=distinct, p=np.asarray(mix))
    pool = []
    for kind in kinds:
        body = {"weights": np.round(0.2 * rng.standard_normal(k), 6).tolist(),
                "deadline_s": 600.0}
        if kind == 1:
            body["benchmark"] = "idx"
        elif kind == 2:
            body["scenario"] = "stress"
        pool.append(body)
    p = np.arange(1, distinct + 1, dtype=np.float64) ** -float(alpha)
    draws = np.random.default_rng((seed, 0x21F)).choice(distinct, size=n,
                                                        p=p / p.sum())
    return [json.dumps({**pool[d], "id": f"t{i}"}, sort_keys=True)
            for i, d in enumerate(draws)]


def query_cache_phase(ctx) -> dict:
    """Phase query_cache: bench config 10's Zipf(1.0) stream (20,000 lines
    over 150 bodies, K = 42, scenario ``stress`` = F * 1.21) through a
    cache-fronted ``Coalescer`` with its linger flusher on the card: every
    answer byte-identical to a cache-off server's once the identity keys
    are stripped, delivered == computed + hits, and the stream coalesced
    without the cache bitwise the sequential loop."""
    import io

    import numpy as np

    from mfm_tpu_torch.obs import instrument as obs
    from mfm_tpu_torch.serve import (
        Coalescer,
        QueryServer,
        ResponseCache,
        ServePolicy,
    )

    engine, cov, _ = config6_engine(ctx["device"])
    scen = {"stress": engine.with_cov((cov * 1.21).astype(np.float32),
                                      scenario_id="stress")}

    def server():
        return QueryServer(engine, ServePolicy(batch_max=256, queue_max=65536,
                                               default_deadline_s=600.0),
                           health="ok", scenarios=scen)

    def strip(o):
        return json.dumps({k: v for k, v in o.items()
                           if k not in ("id", "trace_id")}, sort_keys=True)

    n = 20_000
    lines = zipf_lines(7, n, engine.K)
    keys = [strip(json.loads(x)) for x in lines]
    first = {}
    for ln, key in zip(lines, keys):
        first.setdefault(key, ln)
    buf = io.StringIO()
    server().run(list(first.values()), buf, gulp=True)
    key_of = {json.loads(ln)["id"]: key for key, ln in first.items()}
    cold = {key_of[o["id"]]: strip(o)
            for o in map(json.loads, buf.getvalue().splitlines())}

    cache = ResponseCache(8192, 64 << 20)
    delivered, lock, done = {}, threading.Lock(), threading.Event()

    def deliver(pairs):
        with lock:
            delivered.update(pairs)
            if len(delivered) >= n:
                done.set()

    before = obs.serve_summary_from_registry()
    co = Coalescer(server(), linger_s=0.05, deliver=deliver, cache=cache)
    co.start()
    t0 = time.perf_counter()
    for i, ln in enumerate(lines):
        co.submit(ln, origin=i)
    finished = done.wait(timeout=300)
    sync()
    wall = time.perf_counter() - t0
    co.stop()
    after = obs.serve_summary_from_registry()
    stats = cache.stats()
    computed = after["requests_total"] - before["requests_total"]
    n_delivered = (after["cache"]["delivered_total"]
                   - before["cache"]["delivered_total"])
    mismatched = [i for i, r in delivered.items() if strip(r) != cold[keys[i]]]

    seq = io.StringIO()
    server().run(lines, seq, gulp=True)
    sequential = {json.loads(x)["id"]: x for x in seq.getvalue().splitlines()}
    co2 = Coalescer(server(), linger_s=10.0)
    coalesced = dict(p for ln in lines for p in co2.submit(ln,
                                                           origin=ln))
    coalesced.update(co2.stop())
    differing = [json.loads(ln)["id"] for ln in lines
                 if json.dumps(coalesced[ln], sort_keys=True)
                 != sequential[json.loads(ln)["id"]]]
    res = {"lines": n, "distinct_bodies": len(first), "linger_s": 0.05,
           "wall_s": wall, "responses_per_s": len(delivered) / wall,
           "hit_rate": stats["hits"] / max(stats["hits"] + stats["misses"], 1),
           "cache": stats, "delivered": n_delivered, "computed": computed,
           "all_delivered": finished and len(delivered) == n,
           "differ_from_cache_off": len(mismatched),
           "coalesced_differ_from_sequential": len(differing)}
    emit("query_cache", **res)
    require(res["all_delivered"] and not mismatched,
            f"query_cache: {len(mismatched)} answers differ from the "
            f"cache-off server's (or not all {n} delivered)")
    require(n_delivered == n == computed + stats["hits"],
            f"query_cache: delivered {n_delivered} != computed {computed} + "
            f"hits {stats['hits']}")
    require(not differing, f"query_cache: coalesced != sequential for "
            f"{differing[:5]}")
    return res




# -- scenarios: bench configs 7 and sweep ------------------------------------

#: the card (float32) against the same engine on the CPU (float64), per
#: matrix: max |diff| / max |cpu|.  A lane the PSD gate leaves alone
#: carries only the stress's rounding (2.5e-7 in a CPU rehearsal at
#: float32); a projected lane carries the float32 eigendecomposition's
#: reconstruction error (1.7e-5 there at 7 sweeps; the main path's F0
#: check allows 5e-5)
SCENARIO_TOL = {"unprojected": 1e-5, "projected": 5e-5}
#: bench config 7's batch sizes (bench.py:1007)
SCENARIO_SIZES = (16, 256, 4096)
#: lanes of each size held against the CPU at float64 (the plain float64
#: Jacobi on the host takes about 40 ms a lane): the first 8, up to 8
#: projected ones and a seeded sample
SCENARIO_CPU_LANES = 16


def specs_for(S, names):
    """Bench config 7's spec mix (bench.py:991-1000): a vol shock on one
    factor, a regime multiplier, and a correlation stress on every third
    spec."""
    from mfm_tpu_torch.scenario import ScenarioBuilder

    K, out = len(names), []
    for i in range(S):
        b = ScenarioBuilder(f"s{i}")
        b.shock(names[i % K], add=1e-4 * (1 + i % 7))
        b.vol_regime(1.0 + 0.1 * (i % 5))
        if i % 3 == 0:
            b.correlation(0.2 + 0.1 * (i % 4))
        out.append(b.build())
    return out


def scenario_operands(engine, specs, bucket):
    """The padded operands ``ScenarioEngine.run`` hands ``scenario_batch``
    for shock-only specs on the engine's own base."""
    import numpy as np

    K, dt = engine.K, engine.dtype
    shift, scale = np.zeros((bucket, K), dt), np.ones((bucket, K), dt)
    vol_mult, corr_beta = np.ones(bucket, dt), np.zeros(bucket, dt)
    passthrough = np.ones(bucket, bool)
    for i, spec in enumerate(specs):
        shift[i], scale[i] = engine._shock_vectors(spec)
        vol_mult[i], corr_beta[i] = spec.vol_mult, spec.corr_beta
        passthrough[i] = spec.shocks_identity
    put = engine._put
    return (engine._cov.expand(bucket, K, K), put(shift), put(scale),
            put(vol_mult), put(corr_beta), put(passthrough))


def add_launches(ctx):
    """Add the launch counts since the last reset to the scenario path's."""
    from mfm_tpu_torch.ops.eigh_cuda import launch_counts

    for k, v in launch_counts().items():
        ctx["scenario_launches"][k] = ctx["scenario_launches"].get(k, 0) + v


def scenario_engine_phase(ctx) -> dict:
    """Phase scenario_engine: bench config 7 (K = 42, S = 16, 256, 4,096
    at buckets 32, 512, 8,192) through ``ScenarioEngine.run`` on the card:
    walls, scenarios/s, projected lanes, busy share, peak memory and
    launches per run; a lane sample held against the same engine on the
    CPU at float64; the identity lane bitwise the base; batch == singles
    bitwise at every bucket 8..8,192; every projected output PSD at
    float32; the kernel route bitwise ``kernels=False``; and the gate's
    eigh alone on the S = 4,096 stressed stack at (8,192, 42, 42): the
    full kernel, its plain version and ``torch.linalg.eigh`` timed beside
    the bound, with the reconstruction and orthogonality residuals."""
    import numpy as np

    from mfm_tpu_torch.ops import eigh as E
    from mfm_tpu_torch.ops.eigh_cuda import (
        _launch_eigh,
        launch_counts,
        reset_launches,
    )
    from mfm_tpu_torch.scenario import PRESETS, ScenarioEngine, ScenarioSpec
    from mfm_tpu_torch.scenario.kernel import scenario_batch, stress_cov
    from mfm_tpu_torch.serve import bucket_for
    from mfm_tpu_torch.serve.query import BUCKET_BASE, BUCKET_GROWTH

    cov, _ = bench_factor_cov()
    K = cov.shape[0]
    names = [f"f{i}" for i in range(K)]
    card = ScenarioEngine(cov, factor_names=names, device=ctx["device"])
    cpu = ScenarioEngine(cov.astype(np.float64), factor_names=names,
                         device="cpu")
    eps = float(np.finfo(np.float32).eps)

    sizes = {}
    for S in SCENARIO_SIZES:
        specs = specs_for(S, names)

        def run():
            return card.run(specs)

        run()
        sync()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        walls = [timed(run)[1] for _ in range(3)]
        launches = {k: v / 3 for k, v in launch_counts().items()}
        add_launches(ctx)
        peak = torch.cuda.max_memory_allocated()
        prof = profile_run(run, top=4)
        res = run()
        projected = [i for i, r in enumerate(res) if r.psd_projected]
        rng = np.random.default_rng(S)
        pick = set(range(min(8, S))) | set(projected[:8])
        rest = [i for i in range(S) if i not in pick]
        pick |= set(rng.choice(rest, min(len(rest), SCENARIO_CPU_LANES),
                               replace=False).tolist())
        pick = sorted(pick)
        want = cpu.run([specs[i] for i in pick])
        worst = {"unprojected": 0.0, "projected": 0.0}
        gate_differs, in_band = [], 0
        for i, w in zip(pick, want):
            g = res[i]
            key = ("projected" if g.psd_projected or w.psd_projected
                   else "unprojected")
            worst[key] = max(worst[key], float(
                np.abs(g.cov - w.cov).max() / np.abs(w.cov).max()))
            lam_max = float(np.linalg.eigvalsh(w.cov)[-1])
            if abs(w.min_eig_stressed) <= 1e3 * eps * lam_max:
                in_band += 1
            elif g.psd_projected != w.psd_projected:
                gate_differs.append(specs[i].name)
        proj_min_eig = (float(np.linalg.eigvalsh(np.stack(
            [res[i].cov for i in projected])).min()) if projected else None)
        wall = statistics.median(walls)
        sizes[str(S)] = {
            "bucket": bucket_for(S), "walls_s": walls,
            "wall_min_s": min(walls), "wall_median_s": wall,
            "scenarios_per_s": S / min(walls),
            "projected": len(projected), "rejected": sum(not r.ok
                                                          for r in res),
            "launches_per_run": launches,
            "peak_mem_above_base_gb": (peak - base) / 1e9,
            "busy_share": prof["busy_share"], "busy_s": prof["busy_s"],
            "device_kernels": prof["device_kernels"], "top": prof["top"],
            "cpu_lanes": len(pick), "vs_cpu_float64_rel": worst,
            "gate_differs_outside_band": gate_differs,
            "lanes_in_gate_band": in_band,
            "projected_min_eig_float32": proj_min_eig}

    # the identity lane is the base, alone and beside shocked lanes
    ident, = card.run([ScenarioSpec.identity()])
    beside = card.run(specs_for(15, names) + [ScenarioSpec.identity()])[-1]
    identity_bitwise = (ident.cov.tobytes() == card.cov.tobytes()
                        == beside.cov.tobytes())

    # batch == singles at every bucket; from 32 on the batch ends in the
    # three presets, so projected lanes are among the singles
    presets = [PRESETS[n] for n in sorted(PRESETS)]
    differ, b = {}, BUCKET_BASE
    while b <= bucket_for(max(SCENARIO_SIZES)):
        tail = presets if b > BUCKET_BASE else []
        specs = specs_for(b - len(tail), names) + tail
        batch = card.run(specs)
        rng = np.random.default_rng((7, b))
        pick = {0, b - 1} | set(range(b - len(tail), b))
        while len(pick) < min(13, b):
            pick.add(int(rng.integers(b)))
        bad = []
        for i in sorted(pick):
            one, = card.run([specs[i]])
            if not (one.cov.tobytes() == batch[i].cov.tobytes()
                    and one.psd_projected == batch[i].psd_projected
                    and one.min_eig_stressed == batch[i].min_eig_stressed):
                bad.append(specs[i].name)
        differ[str(b)] = {"lanes": len(pick), "projected": sum(
            batch[i].psd_projected for i in pick), "differing": bad}
        b *= BUCKET_GROWTH

    # the gate's eigh on config 7's own S = 4,096 stressed stack
    S = max(SCENARIO_SIZES)
    B = bucket_for(S)
    ops = scenario_operands(card, specs_for(S, names), B)
    got = scenario_batch(*ops)
    plain = scenario_batch(*ops, kernels=False)
    route_bitwise = all(same(g, p) for g, p in zip(got, plain))
    cov_s = stress_cov(*ops[:5]).contiguous()
    sf = E._sweeps_for(K, torch.float32)
    w, V = _launch_eigh(cov_s, sf, "warp")
    wp, Vp = E.jacobi_eigh_slots(cov_s, sf)
    eigh_bitwise = bool(torch.equal(w, wp) and torch.equal(V, Vp))
    eigh_err = float(max((w - wp).abs().max(), (V - Vp).abs().max()))
    rec, orth = recon_orth(w, V, cov_s)
    ms = time_ms(lambda: _launch_eigh(cov_s, sf, "warp"), 20)
    plain_ms = time_ms(lambda: E.jacobi_eigh_slots(cov_s, sf), 1)
    torch.linalg.eigh(cov_s[:16])   # the solver's set-up, at a small batch
    library_ms = time_ms(lambda: torch.linalg.eigh(cov_s), 1, warmup=False)
    gate = {"shape": [B, K, K], "sweeps": sf, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, **full_kernel_bound(B, K, sf),
            "kernel_vs_plain_bitwise": eigh_bitwise,
            "max_abs_err": eigh_err, "recon": rec, "orth": orth,
            "stressed_lanes_indefinite": int((w.amin(-1) < 0).sum())}
    ctx["scenario_gate"] = gate

    res = {"K": K, "tolerance": SCENARIO_TOL, "sizes": sizes,
           "identity_bitwise": identity_bitwise,
           "batch_vs_singles": differ,
           "kernel_route_bitwise_plain": route_bitwise, "gate_eigh": gate}
    emit("scenario_engine", **res)
    off = {S: r["vs_cpu_float64_rel"] for S, r in sizes.items()
           if any(r["vs_cpu_float64_rel"][k] > SCENARIO_TOL[k]
                  for k in SCENARIO_TOL)}
    require(not off, f"scenario_engine: the card disagrees with the CPU at "
            f"float64: {off}")
    gate_off = {S: r["gate_differs_outside_band"] for S, r in sizes.items()
                if r["gate_differs_outside_band"]}
    require(not gate_off, f"scenario_engine: the PSD gate decides otherwise "
            f"than the CPU outside the band: {gate_off}")
    require(all(r["rejected"] == 0 for r in sizes.values()),
            "scenario_engine: config 7 rejected a spec")
    require(all(r["projected_min_eig_float32"] is None
                or r["projected_min_eig_float32"] >= 0
                for r in sizes.values()),
            "scenario_engine: a projected covariance is not PSD at float32")
    require(identity_bitwise, "scenario_engine: the identity lane is not "
            "the base, bitwise")
    bad = {b: d["differing"] for b, d in differ.items() if d["differing"]}
    require(not bad, f"scenario_engine: batch != singles (bitwise): {bad}")
    require(route_bitwise and eigh_bitwise,
            "scenario_engine: the kernel route is not bitwise the plain one")
    require(rec <= 5e-5 and orth <= ORTH_TOL_F32,
            f"scenario_engine: the gate's eigh at {sf} sweeps: recon {rec} "
            f"orth {orth}")
    return res


def scenario_served_phase(ctx) -> dict:
    """Phase scenario_served: ``ScenarioEngine.from_risk_state`` on phase
    serve_checkpoint's guarded checkpoint at CSI300 width, running the
    three presets, a replay of a window of the pipeline run's history
    (``replay_lookup_from_result``) and two counterfactuals over the
    40-date serving slab (force-heal the poisoned date, force-quarantine a
    clean one), each held to a manual ``update_guarded``; the scenario
    manifest written, read back and audited; and the scenario table
    through ``QueryServer``, bitwise ``with_cov``."""
    import io

    import numpy as np

    from mfm_tpu_torch.data.artifacts import load_risk_state
    from mfm_tpu_torch.obs import instrument as obs
    from mfm_tpu_torch.ops.eigh_cuda import reset_launches
    from mfm_tpu_torch.pipeline import date_stamp
    from mfm_tpu_torch.scenario import (
        PRESETS,
        ScenarioBuilder,
        ScenarioEngine,
        audit_scenario_manifest,
        build_scenario_manifest,
        make_counterfactual_fn,
        read_scenario_manifest,
        replay_lookup_from_result,
        write_scenario_manifest,
    )
    from mfm_tpu_torch.serve import QueryEngine, QueryServer, ServePolicy
    from mfm_tpu_torch.serve.guard import REASON_FORCED

    dev = ctx["device"]
    st, meta = load_risk_state(ctx["checkpoints"]["checkpoint"], dev)
    pipe = ctx["pipeline"]
    lookup = replay_lookup_from_result(pipe)
    dates = [date_stamp(d) for d in pipe.arrays.dates]
    window = (dates[-30], dates[-11])
    model, gcfg, bad, gst = (ctx["model"], ctx["gcfg"], ctx["bad"],
                             ctx["guarded_init"])
    T0, T, off = SERVE_T0, ctx["T"], ctx["poisoned_offset"]
    clean = off + 7
    slab_dates = [str(d) for d in np.arange(
        "2024-01-01", "2024-03-31", dtype="datetime64[D]")[:T - T0]]
    cf = make_counterfactual_fn(model(slice(T0, T), gcfg, bad), gst,
                                slab_dates)
    engine = ScenarioEngine.from_risk_state(
        st, meta, replay_lookup=lookup, counterfactual_fn=cf, device=dev)
    specs = [PRESETS[n] for n in sorted(PRESETS)] + [
        ScenarioBuilder("replay").replay(*window).build(),
        ScenarioBuilder("cf-heal").flip(slab_dates[off], heal=True).build(),
        ScenarioBuilder("cf-quarantine").flip(slab_dates[clean]).build()]

    reset_launches()
    results, wall = timed(lambda: engine.run(specs))
    add_launches(ctx)
    by = {r.spec.name: r for r in results}

    want_replay = lookup(*window)
    hits = [i for i, d in enumerate(dates) if window[0] <= d <= window[1]
            and bool(pipe.outputs.eigen_valid[i])]
    replay_is_vr_cov = bool(torch.equal(torch.from_numpy(want_replay),
                                        pipe.outputs.vr_cov[hits[-1]].cpu()))
    replay_bitwise = by["replay"].cov.tobytes() == want_replay.tobytes()

    manual = {}
    for name, i, heal in (("cf-heal", off, True),
                          ("cf-quarantine", clean, False)):
        pre = np.zeros(T - T0, np.uint32)
        mask = np.zeros(T - T0, bool)
        if heal:
            mask[i] = True
        else:
            pre[i] = REASON_FORCED
        _, rep, _ = model(slice(T0, T), gcfg, bad).update_guarded(
            gst, pre_reasons=pre, heal_mask=mask)
        manual[name] = {
            "bitwise": by[name].cov.tobytes()
            == rep.served_cov[-1].cpu().numpy().tobytes(),
            "quarantined": np.nonzero(rep.quarantined.cpu().numpy())[0]
            .tolist()}

    mdir = os.path.join(ctx["tmp"], "scenarios")
    man = build_scenario_manifest(
        results, engine.factor_names, backend=torch.cuda.get_device_name(0),
        staleness=engine.staleness,
        summary=obs.scenario_summary_from_registry())
    path = write_scenario_manifest(mdir, man)
    back = read_scenario_manifest(mdir)
    problems, warnings = audit_scenario_manifest(path)

    template = QueryEngine.from_risk_state(st, meta, device=dev)
    table = engine.query_engines(results, template)
    rng = np.random.default_rng(8)
    W = (0.2 * rng.standard_normal((3, template.K))).round(6)
    lines = [json.dumps({"id": f"{n}/{j}", "weights": W[j].tolist(),
                         "scenario": n})
             for n in table for j in range(3)]
    buf = io.StringIO()
    QueryServer(template, ServePolicy(default_deadline_s=60.0), health="ok",
                scenarios=table).run(lines, buf)
    out = [json.loads(x) for x in buf.getvalue().splitlines()]
    served_bitwise = []
    for r in out:
        name, j = r["id"].rsplit("/", 1)
        want = template.with_cov(by[name].cov).query(W[int(j)])
        served_bitwise.append(
            r["outcome"] == "ok" and r["scenario_id"] == name
            and r["total_vol"] == float(want.total_vol[0])
            and r["contribution"] == want.contribution[0].tolist())

    res = {"wall_s": wall, "K": engine.K, "staleness": engine.staleness,
           "statuses": {n: r.status for n, r in by.items()},
           "projected": [n for n, r in by.items() if r.psd_projected],
           "min_eig_stressed": {n: r.min_eig_stressed for n, r in by.items()
                                if r.ok},
           "replay_window": list(window),
           "replay_bitwise_lookup": replay_bitwise,
           "lookup_is_pipeline_vr_cov": replay_is_vr_cov,
           "counterfactuals": manual,
           "manifest": {"n_ok": back["n_ok"], "n_psd_projected":
                        back["n_psd_projected"], "problems": problems,
                        "warnings": warnings},
           "served_lines": len(out),
           "served_bitwise_with_cov": all(served_bitwise)}
    emit("scenario_served", **res)
    require(all(r.ok for r in results), f"scenario_served: a scenario was "
            f"rejected: {[(r.spec.name, r.problems) for r in results]}")
    require(by["corr-meltup"].psd_projected,
            "scenario_served: corr-meltup did not project")
    require(replay_bitwise and replay_is_vr_cov,
            "scenario_served: the replay lane is not the window's covariance")
    require(all(m["bitwise"] for m in manual.values())
            and off not in manual["cf-heal"]["quarantined"]
            and clean in manual["cf-quarantine"]["quarantined"],
            f"scenario_served: a counterfactual is not its manual re-run: "
            f"{manual}")
    require(not problems and back["n_ok"] == len(specs),
            f"scenario_served: the manifest does not audit clean: {problems}")
    require(len(out) == len(lines) and all(served_bitwise),
            "scenario_served: a scenario-tagged answer is not with_cov's")
    return res


def sweep_case():
    """Bench config sweep's factor space (bench.py:1065-1079): the in-cone
    K = 42 covariance, the two books and the coarse ball."""
    import numpy as np

    from mfm_tpu_torch.grad import ShockBall

    K = 42
    rng = np.random.default_rng(0)
    F = rng.standard_normal((K, 6)) * 0.3
    corr_raw = F @ F.T + np.diag(rng.uniform(0.5, 1.5, K))
    d = np.sqrt(np.diagonal(corr_raw))
    corr = corr_raw / np.outer(d, d)
    sig = rng.uniform(0.01, 0.03, K)
    cov = (corr * np.outer(sig, sig)).astype(np.float32)
    xs = (rng.standard_normal((2, K)) / np.sqrt(K)).astype(np.float32)
    ball = ShockBall(shift_max=0.001, scale_range=0.3, vol_mult_lo=1.0,
                     vol_mult_hi=3.5, corr_beta_lo=0.0, corr_beta_hi=0.45)
    return cov, [f"f{i}" for i in range(K)], xs, ball


#: bench config sweep's chunk and chunk count (bench.py:1081-1082)
SWEEP_CHUNK = 8192
SWEEP_CHUNKS = 123


def scenario_sweep_phase(ctx) -> dict:
    """Phase scenario_sweep: bench config sweep on the card — 123 chunks
    of 8,192 (1,007,616 scenarios) streamed after a one-chunk warm-up:
    rate, offender fraction, busy share, launches; the materializing arm
    (``ScenarioEngine.run`` on one chunk's thetas) timed, and its top-k
    and histogram held bitwise to a one-chunk sweep; the top-1 spec of
    each book re-run to the identical vol; ``preset_dominance``; and one
    ``sweep`` request through ``QueryServer`` equal to a direct sweep."""
    import io

    import numpy as np

    from mfm_tpu_torch.grad import ShockBall
    from mfm_tpu_torch.ops.eigh_cuda import launch_counts, reset_launches
    from mfm_tpu_torch.scenario import (
        ScenarioSpec,
        SweepEngine,
        UniformSampler,
        theta_to_spec,
    )
    from mfm_tpu_torch.scenario.kernel import book_vols
    from mfm_tpu_torch.serve import QueryEngine, QueryServer, ServePolicy

    dev = ctx["device"]
    cov, names, xs, ball = sweep_case()
    K, chunk = len(names), SWEEP_CHUNK
    S = SWEEP_CHUNKS * chunk
    engine = SweepEngine(cov, factor_names=names, device=dev)
    scen = engine._scen
    xs_t = torch.from_numpy(xs).to(dev)

    def sampler(seed, n=S):
        return UniformSampler(ball, K, n, seed=seed)

    engine.sweep(xs, sampler(1, chunk), chunk=chunk)          # warm-up
    reset_launches()
    res, wall = timed(lambda: engine.sweep(xs, sampler(2), chunk=chunk))
    stream_launches = launch_counts()
    add_launches(ctx)
    prof = profile_run(lambda: engine.sweep(xs, sampler(3, 8 * chunk),
                                            chunk=chunk), top=5)

    # the materializing arm at one chunk's shape, and streaming ==
    # materializing on the same thetas
    th0 = next(iter(sampler(2, chunk).blocks(chunk)))[0]
    specs = [theta_to_spec(t, names, f"m{i}") for i, t in enumerate(th0)]
    scen.run(specs)                                            # warm-up
    reset_launches()
    mat_walls = [timed(lambda: scen.run(specs))[1] for _ in range(3)]
    add_launches(ctx)
    mat = scen.run(specs)
    one = engine.sweep(xs, sampler(2, chunk), chunk=chunk, top_k=16,
                       bins=64)
    covs = torch.from_numpy(np.stack([r.cov for r in mat])).to(dev)
    vols = book_vols(covs, xs_t).cpu().numpy()
    stream_vs_mat = {}
    for b, book in enumerate(one.books):
        order = sorted(range(chunk), key=lambda j: (-vols[b, j], j))[:16]
        want_top = [(float(vols[b, j]), j) for j in order]
        lo, w = np.float32(book["hist"]["lo"]), np.float32(
            book["hist"]["bin_width"])
        bi = np.clip(((vols[b] - lo) / w).astype(np.int32), 0, 63)
        stream_vs_mat[book["label"]] = {
            "top": [(e["vol"], e["src"]) for e in book["top"]] == want_top,
            "hist": book["hist"]["counts"] == np.bincount(
                bi, minlength=64).tolist()}

    round_trip = {}
    for b, book in enumerate(res.books):
        top = book["top"][0]
        r, = scen.run([ScenarioSpec.from_dict(top["spec"])])
        alone = float(book_vols(torch.from_numpy(r.cov[None]).to(dev),
                                xs_t[b:b + 1])[0, 0])
        beside = float(book_vols(torch.from_numpy(r.cov[None]).to(dev),
                                 xs_t)[b, 0])
        round_trip[book["label"]] = {"vol": top["vol"], "alone": alone,
                                     "beside": beside,
                                     "bitwise": alone == beside == top["vol"]}
    dominance = engine.preset_dominance(res, xs)

    # one sweep request through the serving loop
    qe = QueryEngine(cov, factor_names=names, device=dev)
    line = json.dumps({"id": "sweep0", "weights": xs[0].tolist(),
                       "deadline_s": 600.0,
                       "sweep": {"n": 8 * chunk, "chunk": chunk}})
    buf = io.StringIO()
    reset_launches()
    _, req_wall = timed(lambda: QueryServer(qe, ServePolicy(),
                                            health="ok").run([line], buf))
    add_launches(ctx)
    resp = json.loads(buf.getvalue())
    direct = engine.sweep(xs[:1], UniformSampler(ShockBall(), K, 8 * chunk,
                                                 seed=0),
                          chunk=chunk, top_k=8, bins=64)

    rate = S / res.seconds
    mat_rate = chunk / min(mat_walls)
    out = {"S": S, "chunk": chunk, "chunk_bucket": res.chunk_bucket,
           "counts": res.counts, "sweep_s": res.seconds, "wall_s": wall,
           "scenarios_per_s": rate,
           "offender_frac": res.counts["n_offenders"] / S,
           "launches": stream_launches,
           "busy_share_8_chunks": prof["busy_share"],
           "busy_s_8_chunks": prof["busy_s"],
           "profile_wall_s_8_chunks": prof["wall_s"],
           "device_kernels_8_chunks": prof["device_kernels"],
           "top": prof["top"],
           "materializing": {"walls_s": mat_walls,
                             "scenarios_per_s": mat_rate,
                             "projected": sum(r.psd_projected for r in mat)},
           "streaming_over_materializing": rate / mat_rate,
           "streaming_vs_materializing_bitwise": stream_vs_mat,
           "top1_round_trip": round_trip,
           "preset_dominance": dominance,
           "top1_vol": {b["label"]: b["top"][0]["vol"] for b in res.books},
           "request": {"wall_s": req_wall, "outcome": resp["outcome"],
                       "counts": resp.get("counts"),
                       "book_equals_direct_sweep":
                           resp.get("book") == direct.books[0]
                           and resp.get("counts") == direct.counts}}
    emit("scenario_sweep", **out)
    require(res.counts["n_ok"] == S and res.counts["n_rejected"] == 0,
            f"scenario_sweep: admission drift: {res.counts}")
    require(all(v["top"] and v["hist"] for v in stream_vs_mat.values()),
            f"scenario_sweep: streaming != materializing: {stream_vs_mat}")
    require(all(v["bitwise"] for v in round_trip.values()),
            f"scenario_sweep: the top-1 spec does not round-trip: "
            f"{round_trip}")
    require(out["request"]["book_equals_direct_sweep"],
            "scenario_sweep: the sweep request is not a direct sweep")
    return out


# -- the differentiable-risk subsystem (grad/) -------------------------------

#: bench config 8's sizes (bench.py:1167-1260): min-vol at B = 100 and
#: 10,000 (buckets 128 and 32,768), reverse stress of 64 books
GRAD_MINVOL_SIZES = (100, 10_000)
GRAD_REVERSE_BOOKS = 64
#: lanes of a construct solve held against the CPU at float64
GRAD_CPU_LANES = 8
#: card (float32) against the CPU (float64), each about 20x what an H100
#: (700 W) measured.  Construction: 2,000 float32 multiplicative-weight
#: steps land within float32 rounding of the float64 optimum (weights
#: 4.9e-7 absolute, vols 2.6e-7 relative).  Reverse stress: the vol at the
#: card's own worst shock, through the projection, whose float32
#: eigendecomposition reconstructs to ~1.2e-5 (6.5e-6; the scenario gate's
#: projected lanes are held to the same 5e-5).  Sensitivities: each row
#: relative to the lane's largest, outside the eigen-gap band, where the
#: eigh gradient divides the float32 eigenvectors' ~1e-5 orthogonality
#: error by the gaps (7.4e-6), and the vol as the reverse's (1.5e-5).
#: The hand backwards against autograd of the plain product on the same
#: float32 inputs: ~20x the 1.2e-6 an H100 (700 W) measured.
GRAD_TOL = {"construct_weights_abs": 1e-5, "construct_vol_rel": 1e-5,
            "reverse_vol_rel": 5e-5, "sensitivity_rows_rel": 1e-4,
            "sensitivity_vol_rel": 5e-5, "backward_rel": 2e-5}
#: a lane is inside the eigen-gap band when its stressed covariance has
#: two eigenvalues closer than this fraction of lambda_max (float64, on
#: the host), or a minimum eigenvalue within 1e3 * eps32 * lambda_max of 0
GRAD_GAP_BAND = 1e-4
#: config 9 as the bench runs it (bench.py:1283-1480)
FLEET_MIX = (0.45, 0.20, 0.15, 0.20, 0.0)
#: (cut from the bench's 10,000 lines to 3,000, and the closed loop's from
#: 2,000 to 1,000, to make room for the store section; then to 500, the
#: closed loop to 128 and the one-at-a-time baseline from 400 to 50 lines
#: for the faults section; PERF.md §4)
FLEET_LINES, FLEET_RATE, FLEET_LINGER = 500, 2400.0, 0.1
#: the one-at-a-time baseline's lines and the closed loop's: checks of the
#: answers, too short for a request rate (start-up dominates their walls),
#: so only their walls are reported
FLEET_BASELINE_LINES, FLEET_CLOSED_LINES = 50, 128
#: the sweep config's refined leg (bench.py:1116-1130): 50 coarse chunks
SWEEP_REFINE_CHUNKS = 50


def add_grad_launches(ctx):
    """Add the launch counts since the last reset to the grad path's."""
    from mfm_tpu_torch.ops.eigh_cuda import launch_counts

    for k, v in launch_counts().items():
        ctx["grad_launches"][k] = ctx["grad_launches"].get(k, 0) + v


def in_gap_band(cov_s, eps) -> bool:
    """Is a stressed covariance inside the eigen-gap band, on the host in
    float64?"""
    import numpy as np

    w = np.linalg.eigvalsh(np.asarray(cov_s, np.float64))
    scale = max(abs(w[0]), abs(w[-1]))
    return bool(np.diff(w).min() < GRAD_GAP_BAND * scale
                or abs(w[0]) <= 1e3 * eps * scale)


def grad_wrappers_check(stack) -> dict:
    """The grad path's wrappers at a stressed stack (S, K, K) of the
    ascent: ``eigh_diff`` with autograd (values and the gradient of random
    cotangents) bitwise the same call with ``kernels=False``; and each
    hand backward of the path (``_DiffEigh``'s, ``_Reconstruct``'s,
    ``_Outer``'s, ``_MatVec``'s) against torch autograd of the plain
    matrix product on the same inputs and cotangents, relative to the
    lane's largest entry.  The eigh runs as the PSD gate runs it, with a
    ``flat_below`` (here K * eps * the largest variance), so the exact
    ties of zeroed vols below it take their limit; lanes whose eigh
    gradient is still not finite are left out of the comparison and
    counted."""
    from mfm_tpu_torch.models.risk_model import _MatVec
    from mfm_tpu_torch.ops.eigh import eigh_diff
    from mfm_tpu_torch.scenario.kernel import _outer, _reconstruct

    S, K, _ = stack.shape
    gen = torch.Generator(device=stack.device).manual_seed(9)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, dtype=stack.dtype,
                           device=stack.device)

    def vjp(fn, inputs, cot):
        leaves = [x.detach().clone().requires_grad_(True) for x in inputs]
        with torch.enable_grad():
            out = fn(*leaves)
            outs = out if isinstance(out, tuple) else (out,)
            grads = torch.autograd.grad(outs, leaves, cot)
        return [o.detach() for o in outs] + list(grads)

    def rel(got, want):
        ok = torch.stack([torch.isfinite(t).flatten(1).all(1)
                          for t in (*got, *want)]).all(0)
        errs = [rel_per_matrix(g[ok].reshape(int(ok.sum()), -1),
                               w[ok].reshape(int(ok.sum()), -1))
                for g, w in zip(got, want)]
        return max(errs), S - int(ok.sum())

    w_bar, V_bar = randn(S, K), randn(S, K, K)
    eye = torch.eye(K, dtype=stack.dtype, device=stack.device)
    flat_below = stack.diagonal(dim1=-2, dim2=-1).amax(-1) * (
        K * torch.finfo(stack.dtype).eps)
    kern = vjp(lambda A: eigh_diff(A, flat_below=flat_below), [stack],
               (w_bar, V_bar))
    plain = vjp(lambda A: eigh_diff(A, kernels=False, flat_below=flat_below),
                [stack], (w_bar, V_bar))
    bitwise = all(same(a, b) for a, b in zip(kern, plain))
    w, V, A_bar = kern
    max_abs_err = float(max((a - b).abs().max() for a, b in zip(kern, plain)))

    Fmat = 1.0 / (eye + w[..., None, :] - w[..., :, None]) - eye
    flat = w < flat_below[:, None]
    tie = ((w[..., None, :] == w[..., :, None]) & (eye == 0)
           & flat[..., None, :] & flat[..., :, None])
    Fmat = torch.where(tie, torch.zeros_like(Fmat), Fmat)
    P = V @ (Fmat * (V.mT @ V_bar) + torch.diag_embed(w_bar)) @ V.mT
    eigh_rel, eigh_left_out = rel([A_bar], [0.5 * (P + P.mT)])

    w_cl = w.clamp_min(0)
    P_bar, sig, x = randn(S, K, K), stack.diagonal(dim1=-2, dim2=-1).sqrt(), \
        randn(S, K)
    checks = {
        "reconstruct": ((_reconstruct, lambda V, w: (V * w[..., None, :])
                         @ V.mT), [V, w_cl], P_bar),
        "outer": ((_outer, lambda v: v[..., :, None] * v[..., None, :]),
                  [sig], randn(S, K, K)),
        "matvec": ((_MatVec.apply, lambda A, v: (A @ v[..., None])[..., 0]),
                   [stack, x], randn(S, K)),
    }
    backward_rel = {"eigh": eigh_rel}
    for name, ((hand, ref), inputs, cot) in checks.items():
        backward_rel[name], _ = rel(vjp(hand, inputs, cot),
                                    vjp(ref, inputs, cot))
    return {"eigh_diff_bitwise_plain": bitwise, "max_abs_err": max_abs_err,
            "w": w, "V": V, "backward_rel": backward_rel,
            "eigh_grad_lanes_not_finite": eigh_left_out}


def grad_construct_phase(ctx) -> dict:
    """Phase grad_construct: bench config 8's construction (K = 42, its
    seeded covariance) on the card — min-vol at B = 100 and 10,000
    (buckets 128 and 32,768), 2,000 steps: walls, portfolios/s, the worst
    KKT residual, busy share; risk parity and the hedge overlay at
    B = 100; a lane sample of each solver against the CPU at float64;
    batch == singles bitwise on sampled lanes at every bucket 8..32,768
    (min-vol) and at 128 (risk parity, hedge)."""
    import numpy as np

    from mfm_tpu_torch.grad import GradEngine, minvol_batch
    from mfm_tpu_torch.grad.engine import MINVOL_ETA, MINVOL_STEPS, SOLVERS
    from mfm_tpu_torch.ops.eigh_cuda import reset_launches
    from mfm_tpu_torch.serve import bucket_for
    from mfm_tpu_torch.serve.query import BUCKET_BASE, BUCKET_GROWTH

    dev = ctx["device"]
    cov, _ = bench_factor_cov()
    K = cov.shape[0]
    names = [f"f{i}" for i in range(K)]
    card = GradEngine(cov, factor_names=names, device=dev)
    cpu = GradEngine(cov.astype(np.float64), factor_names=names,
                     device="cpu")
    cov_t = card._scen._cov
    f32 = dict(dtype=torch.float32, device=dev)
    lo, hi = torch.zeros(K, **f32), torch.ones(K, **f32)
    eta = torch.tensor(MINVOL_ETA, **f32)

    reset_launches()
    minvol, kkt_worst = {}, 0.0
    for b in GRAD_MINVOL_SIZES:
        bucket = bucket_for(b)
        # the bench's operands: every lane of the bucket starts uniform
        xs0 = torch.full((bucket, K), 1.0 / K, **f32)

        def solve():
            return minvol_batch(xs0, cov_t, lo, hi, eta, MINVOL_STEPS)

        solve()
        walls = [timed(solve)[1] for _ in range(3)]
        _, _, kkt = solve()
        kkt = float(kkt.max())
        kkt_worst = max(kkt_worst, kkt)
        prof = profile_run(solve, top=3)
        minvol[str(b)] = {
            "bucket": bucket, "walls_s": walls, "wall_min_s": min(walls),
            "portfolios_per_s": b / min(walls), "kkt_max": kkt,
            "busy_share": prof["busy_share"], "busy_s": prof["busy_s"],
            "device_kernels": prof["device_kernels"], "top": prof["top"]}

    rng = np.random.default_rng(8)
    W = np.abs(rng.standard_normal((100, K))).astype(np.float32)
    solvers, worst = {}, {"weights_abs": 0.0, "vol_rel": 0.0}
    for solver in SOLVERS:
        res, wall = timed(lambda: card.construct_solve(solver, W))
        want = cpu.construct_solve(solver, W[:GRAD_CPU_LANES])
        dw = float(np.abs(res["weights"][:GRAD_CPU_LANES]
                          - want["weights"]).max())
        dv = float((np.abs(res["vols"][:GRAD_CPU_LANES] - want["vols"])
                    / want["vols"]).max())
        worst["weights_abs"] = max(worst["weights_abs"], dw)
        worst["vol_rel"] = max(worst["vol_rel"], dv)
        solvers[solver] = {"B": 100, "bucket": bucket_for(100),
                           "wall_s": wall, "portfolios_per_s": 100 / wall,
                           "vs_cpu_float64": {"weights_abs": dw,
                                              "vol_rel": dv},
                           "finite": bool(np.isfinite(res["weights"]).all())}
    from mfm_tpu_torch.ops.eigh_cuda import launch_counts

    construct_launches = launch_counts()
    require(not any(construct_launches.values()),
            f"grad_construct: construction launched an eigh kernel: "
            f"{construct_launches}")

    def singles(solver, b, lanes):
        Wb = np.abs(np.random.default_rng((9, b)).standard_normal(
            (b, K))).astype(np.float32)
        batch = card.construct_solve(solver, Wb, bucket=b)
        bad = []
        for i in lanes:
            one = card.construct_solve(solver, Wb[i:i + 1], bucket=BUCKET_BASE)
            if not all(np.asarray(one[k][0]).tobytes()
                       == np.asarray(batch[k][i]).tobytes()
                       for k in ("weights", "vols", "diag")):
                bad.append(i)
        return {"lanes": len(lanes), "differing": bad}

    differ, b = {}, BUCKET_BASE
    while b <= bucket_for(max(GRAD_MINVOL_SIZES)):
        pick = sorted({0, b - 1, b // 2, b // 3})
        differ[f"min_vol@{b}"] = singles("min_vol", b, pick)
        b *= BUCKET_GROWTH
    for solver in ("risk_parity", "hedge"):
        differ[f"{solver}@128"] = singles(solver, 128, [0, 45, 127])

    res = {"K": K, "steps": MINVOL_STEPS, "tolerance": {
        k: GRAD_TOL[k] for k in ("construct_weights_abs",
                                 "construct_vol_rel")},
        "minvol": minvol, "kkt_worst": kkt_worst, "solvers": solvers,
        "vs_cpu_float64": worst, "batch_vs_singles": differ}
    emit("grad_construct", **res)
    require(all(s["finite"] for s in solvers.values()),
            "grad_construct: a solve returned non-finite weights")
    require(worst["weights_abs"] <= GRAD_TOL["construct_weights_abs"]
            and worst["vol_rel"] <= GRAD_TOL["construct_vol_rel"],
            f"grad_construct: the card disagrees with the CPU at float64: "
            f"{worst}")
    require(kkt_worst < 1e-3, f"grad_construct: min-vol KKT residual "
            f"{kkt_worst}")
    bad = {k: d["differing"] for k, d in differ.items() if d["differing"]}
    require(not bad, f"grad_construct: batch != singles (bitwise): {bad}")
    return res


def grad_reverse_phase(ctx) -> dict:
    """Phase grad_reverse: bench config 8's reverse stress on the card —
    64 books (bucket 128), 200 steps of projected ascent through the
    stress, the grad-safe PSD gate (two full-kernel eighs a step) and the
    portfolio vol, in the default ``ShockBall``: wall, busy share and the
    full kernel's launches; every answer admissible and at least every
    preset drill's vol (within 1e-5 relative); batch == singles bitwise
    across a bucket boundary; the vol at each answer against the CPU at
    float64; at the ascent's (128, 42, 42) stressed stack, ``eigh_diff``
    with autograd bitwise ``kernels=False`` and the hand backwards against
    autograd of the plain products (:func:`grad_wrappers_check`), and the
    full kernel alone beside its bound, its plain version and
    ``torch.linalg.eigh``."""
    import numpy as np

    from mfm_tpu_torch.grad import GradEngine, ShockBall
    from mfm_tpu_torch.grad.engine import REVERSE_STEPS
    from mfm_tpu_torch.grad.reverse import stressed_vol
    from mfm_tpu_torch.models.risk_model import portfolio_vol
    from mfm_tpu_torch.ops import eigh as E
    from mfm_tpu_torch.ops.eigh_cuda import (
        _launch_eigh,
        launch_counts,
        reset_launches,
    )
    from mfm_tpu_torch.scenario import PRESETS, ScenarioEngine
    from mfm_tpu_torch.scenario.kernel import stress_cov
    from mfm_tpu_torch.serve import bucket_for

    dev = ctx["device"]
    cov, _ = bench_factor_cov()
    K = cov.shape[0]
    names = [f"f{i}" for i in range(K)]
    P = GRAD_REVERSE_BOOKS
    W = (0.2 * np.random.default_rng(1).standard_normal((P, K))).astype(
        np.float32)
    ball = ShockBall()
    card = GradEngine(cov, factor_names=names, device=dev)

    card.reverse_stress(W[:1], steps=2)                       # warm-up
    reset_launches()
    entries, wall = timed(lambda: card.reverse_stress(W, ball=ball))
    run_launches = launch_counts()
    add_grad_launches(ctx)
    prof = profile_run(lambda: card.reverse_stress(W, ball=ball), top=5)

    scen = ScenarioEngine(cov, factor_names=names, device=dev)
    drills = scen.run([PRESETS[n] for n in sorted(PRESETS)])
    W_t = torch.from_numpy(W).to(dev)
    drill_vols = {r.spec.name: portfolio_vol(
        torch.from_numpy(r.cov).to(dev), W_t).cpu().numpy()
        for r in drills}
    worst = np.array([e["vol_worst"] for e in entries])
    losses = {n: int((worst < v * (1 - 1e-5)).sum())
              for n, v in drill_vols.items()}
    inadmissible = [e["label"] for e in entries if not e["admissible"]]

    # batch == singles across the bucket boundary: 64 books at bucket 128
    # against a sample of them alone at bucket 8
    differ = []
    for i in (0, 1, P // 3, P - 2, P - 1):
        one, = card.reverse_stress(W[i:i + 1], ball=ball, labels=[f"p{i}"])
        if one != entries[i]:
            differ.append(i)

    # the card's answers through the CPU at float64
    thetas = np.stack([[*(dict(e["spec"]["shift"]).get(f, 0.0)
                          for f in names),
                        *(dict(e["spec"]["scale"]).get(f, 1.0)
                          for f in names),
                        e["spec"]["vol_mult"], e["spec"]["corr_beta"]]
                       for e in entries])
    vol64 = stressed_vol(torch.from_numpy(thetas),
                         torch.from_numpy(cov.astype(np.float64)),
                         torch.from_numpy(W.astype(np.float64))).numpy()
    vol_rel = float(np.abs(worst - vol64).max() / vol64.max())
    eps = float(np.finfo(np.float32).eps)
    cov_s = stress_cov(torch.from_numpy(cov.astype(np.float64)),
                       *(torch.from_numpy(thetas[:, a:b]) for a, b in (
                           (0, K), (K, 2 * K))),
                       torch.from_numpy(thetas[:, 2 * K]),
                       torch.from_numpy(thetas[:, 2 * K + 1])).numpy()
    band = sum(in_gap_band(c, eps) for c in cov_s)

    # the full kernel on the ascent's own stressed stack at its bucket
    B = bucket_for(P)
    th_t = torch.from_numpy(np.concatenate(
        [thetas, np.tile(thetas[:1], (B - P, 1))]).astype(np.float32)).to(dev)
    stack = stress_cov(card._scen._cov, th_t[:, :K], th_t[:, K:2 * K],
                       th_t[:, 2 * K], th_t[:, 2 * K + 1]).contiguous()
    sf = E._sweeps_for(K, torch.float32)
    wrappers = grad_wrappers_check(stack)
    rec, orth = recon_orth(wrappers.pop("w"), wrappers.pop("V"), stack)
    kernel = {"shape": [B, K, K], "sweeps": sf,
              "ms": time_ms(lambda: _launch_eigh(stack, sf, "warp"), 50),
              "plain_ms": time_ms(lambda: E.jacobi_eigh_slots(stack, sf), 3),
              "library_ms": time_ms(lambda: torch.linalg.eigh(stack), 5),
              **full_kernel_bound(B, K, sf),
              "kernel_vs_plain_bitwise": wrappers["eigh_diff_bitwise_plain"],
              "max_abs_err": wrappers["max_abs_err"], "recon": rec,
              "orth": orth}
    ctx["grad_kernel"] = kernel

    res = {"K": K, "books": P, "bucket": B, "steps": REVERSE_STEPS,
           "ball": ball.to_dict(), "wall_s": wall,
           "books_per_s": P / wall, "launches": run_launches,
           "full_kernel_launches_per_step":
               run_launches["jacobi_eigh/warp"] / REVERSE_STEPS,
           "busy_share": prof["busy_share"], "busy_s": prof["busy_s"],
           "device_kernels": prof["device_kernels"], "top": prof["top"],
           "inadmissible": inadmissible, "preset_losses": losses,
           "vol_worst_over_base": {
               "min": float(min(e["vol_worst"] / e["vol_base"]
                                for e in entries)),
               "max": float(max(e["vol_worst"] / e["vol_base"]
                                for e in entries))},
           "batch_vs_singles_differing": differ,
           "vs_cpu_float64_vol_rel": vol_rel,
           "answers_in_gap_band": band, "kernel_at_grad_shape": kernel,
           "backward_vs_plain_rel": wrappers["backward_rel"],
           "backward_tolerance": GRAD_TOL["backward_rel"],
           "eigh_grad_lanes_not_finite":
               wrappers["eigh_grad_lanes_not_finite"]}
    emit("grad_reverse", **res)
    require(not inadmissible, f"grad_reverse: inadmissible answers: "
            f"{inadmissible}")
    require(not any(losses.values()), f"grad_reverse: answers below a "
            f"preset drill's vol: {losses}")
    require(not differ, f"grad_reverse: batch != singles (bitwise): "
            f"lanes {differ}")
    require(vol_rel <= GRAD_TOL["reverse_vol_rel"],
            f"grad_reverse: the card's worst vols disagree with the CPU at "
            f"float64: {vol_rel}")
    require(run_launches["jacobi_eigh/warp"] >= 2 * REVERSE_STEPS,
            f"grad_reverse: {run_launches} full-kernel launches for "
            f"{REVERSE_STEPS} steps")
    require(kernel["kernel_vs_plain_bitwise"] and rec <= 5e-5
            and orth <= ORTH_TOL_F32,
            f"grad_reverse: eigh_diff at {B}: bitwise kernels=False "
            f"{kernel['kernel_vs_plain_bitwise']} recon {rec} orth {orth}")
    require(max(wrappers["backward_rel"].values()) <= GRAD_TOL["backward_rel"],
            f"grad_reverse: a hand backward disagrees with autograd of the "
            f"plain product: {wrappers['backward_rel']}")
    return res


def grad_sensitivity_phase(ctx) -> dict:
    """Phase grad_sensitivity: one book's exact sensitivities on the card
    against the preset catalog and against S = 4,096 specs of config 7's
    mix (``specs_for``; bucket 8,192) — wall, launches; on a lane sample
    the card against the CPU at float64 outside the eigen-gap band (the
    ``nondifferentiable`` flags equal there; the lanes inside counted);
    the CPU at float64 against central differences on two lanes; and
    batch == singles bitwise on sampled lanes."""
    import numpy as np

    from mfm_tpu_torch.grad import GradEngine
    from mfm_tpu_torch.grad.reverse import stressed_vol
    from mfm_tpu_torch.ops.eigh_cuda import launch_counts, reset_launches
    from mfm_tpu_torch.scenario import PRESETS
    from mfm_tpu_torch.scenario.kernel import stress_cov

    dev = ctx["device"]
    cov, _ = bench_factor_cov()
    K = cov.shape[0]
    names = [f"f{i}" for i in range(K)]
    card = GradEngine(cov, factor_names=names, device=dev)
    cpu = GradEngine(cov.astype(np.float64), factor_names=names,
                     device="cpu")
    x = (0.2 * np.random.default_rng(3).standard_normal(K)).astype(
        np.float32)
    presets = [PRESETS[n] for n in sorted(PRESETS)]
    S = max(SCENARIO_SIZES)
    specs = specs_for(S, names)

    card.sensitivities(presets, x)                            # warm-up
    reset_launches()
    pre, pre_wall = timed(lambda: card.sensitivities(presets, x))
    big, big_wall = timed(lambda: card.sensitivities(specs, x))
    run_launches = launch_counts()
    add_grad_launches(ctx)
    prof = profile_run(lambda: card.sensitivities(specs, x), top=5)

    eps = float(np.finfo(np.float32).eps)
    rng = np.random.default_rng(4)
    pick = sorted(set(range(8)) | set(rng.choice(S, 24, replace=False)
                                       .tolist()))
    lanes = [(presets[i], pre[i]) for i in range(len(presets))] + \
        [(specs[i], big[i]) for i in pick]
    want = cpu.sensitivities([s for s, _ in lanes], x.astype(np.float64))
    worst = {"rows_rel": 0.0, "vol_rel": 0.0}
    in_band, flags_differ = 0, []
    for (spec, g), w in zip(lanes, want):
        shift, scale = cpu._scen._shock_vectors(spec)
        cov_s = stress_cov(torch.from_numpy(cpu.cov),
                           torch.from_numpy(shift)[None],
                           torch.from_numpy(scale)[None],
                           torch.tensor([spec.vol_mult], dtype=torch.float64),
                           torch.tensor([spec.corr_beta],
                                        dtype=torch.float64))[0].numpy()
        if in_gap_band(cov_s, eps):
            in_band += 1
            continue
        if g["nondifferentiable"] != w["nondifferentiable"]:
            flags_differ.append(spec.name)
            continue
        if w["nondifferentiable"]:
            continue
        rows = [(g[k], w[k]) for k in ("d_shift", "d_scale", "d_exposure")]
        gv = np.array([v for a, _ in rows for v in a.values()]
                      + [g["d_vol_mult"], g["d_corr_beta"]])
        wv = np.array([v for _, b in rows for v in b.values()]
                      + [w["d_vol_mult"], w["d_corr_beta"]])
        worst["rows_rel"] = max(worst["rows_rel"], float(
            np.abs(gv - wv).max() / np.abs(wv).max()))
        worst["vol_rel"] = max(worst["vol_rel"],
                               abs(g["vol"] - w["vol"]) / w["vol"])

    # the CPU at float64 against central differences of its own forward,
    # on a sample of the coordinates (each difference is two float64 Jacobi
    # eighs on the host)
    def vol_of(th):
        return float(stressed_vol(torch.from_numpy(th)[None],
                                  torch.from_numpy(cpu.cov),
                                  torch.from_numpy(x.astype(
                                      np.float64))[None])[0])

    fd_worst, h = 0.0, 1e-6
    for spec, w in zip([lanes[1][0], lanes[len(presets) + 3][0]],
                       [want[1], want[len(presets) + 3]]):
        shift, scale = cpu._scen._shock_vectors(spec)
        th = np.r_[shift, scale, spec.vol_mult, spec.corr_beta]
        exact = np.r_[list(w["d_shift"].values()),
                      list(w["d_scale"].values()),
                      w["d_vol_mult"], w["d_corr_beta"]]
        for j in (0, 1, K - 1, K, K + 1, 2 * K - 1, 2 * K, 2 * K + 1):
            e = np.zeros(len(th))
            e[j] = h
            fd = (vol_of(th + e) - vol_of(th - e)) / (2 * h)
            fd_worst = max(fd_worst, abs(fd - exact[j])
                           / max(abs(fd), 1e-3))

    # batch == singles on sampled lanes
    differ = []
    for i in (0, 1, S // 2, S - 1):
        one, = card.sensitivities([specs[i]], x)
        if one != big[i]:
            differ.append(specs[i].name)

    res = {"K": K, "S": S, "presets": len(presets),
           "presets_wall_s": pre_wall, "wall_s": big_wall,
           "lanes_per_s": S / big_wall, "launches": run_launches,
           "busy_share": prof["busy_share"], "busy_s": prof["busy_s"],
           "device_kernels": prof["device_kernels"], "top": prof["top"],
           "nondifferentiable": sum(e["nondifferentiable"] for e in big),
           "cpu_lanes": len(lanes), "lanes_in_gap_band": in_band,
           "gap_band": GRAD_GAP_BAND, "flags_differ": flags_differ,
           "vs_cpu_float64": worst, "tolerance": {
               k: GRAD_TOL[k] for k in ("sensitivity_rows_rel",
                                        "sensitivity_vol_rel")},
           "cpu_vs_central_differences_rel": fd_worst,
           "batch_vs_singles_differing": differ}
    emit("grad_sensitivity", **res)
    require(not flags_differ, f"grad_sensitivity: nondifferentiable flags "
            f"differ outside the band: {flags_differ}")
    require(worst["rows_rel"] <= GRAD_TOL["sensitivity_rows_rel"]
            and worst["vol_rel"] <= GRAD_TOL["sensitivity_vol_rel"],
            f"grad_sensitivity: the card disagrees with the CPU at float64: "
            f"{worst}")
    require(fd_worst <= 1e-6, f"grad_sensitivity: the CPU at float64 is "
            f"{fd_worst} from central differences")
    require(not differ, f"grad_sensitivity: batch != singles (bitwise): "
            f"{differ}")
    require(run_launches["jacobi_eigh/warp"] >= 2,
            "grad_sensitivity: the full kernel was not launched")
    return res


def grad_served_phase(ctx) -> dict:
    """Phase grad_served: bench config 9 as the bench runs it — K = 42, a
    stressed table (x1.21), ``batch_max`` 256, mix (0.45, 0.20, 0.15,
    0.20, 0.0): 500 lines (the bench's 10,000 cut) open loop at
    2,400 req/s through the
    ``Coalescer`` (linger 0.1 s), every response bitwise the sequential
    loop's per request id; the 50-line one-at-a-time baseline; the
    32-client closed loop of 128 lines, each answer bitwise the sequential
    loop's (these two are too short for a request rate: their walls are
    reported, no rate).  p50 / p99 and ``p99_within_linger_plus_batch``
    are reported, not gated.  Then one warm-started construct request on
    the serving split's guarded CSI300 checkpoint."""
    import io
    import threading

    import numpy as np

    from mfm_tpu_torch.data.artifacts import load_risk_state
    from mfm_tpu_torch.ops.eigh_cuda import reset_launches
    from mfm_tpu_torch.serve import (
        Coalescer,
        QueryEngine,
        QueryServer,
        ServePolicy,
    )
    from mfm_tpu_torch.serve.cache import WarmStartIndex

    sys.path.insert(0, str(ROOT / "tools"))
    import trafficgen

    dev = ctx["device"]
    cov, rng = bench_factor_cov()
    K = cov.shape[0]
    bench_map = {"idx": 0.1 * rng.standard_normal(K)}
    stressed = (cov * 1.21).astype(np.float32)

    def mk_server(batch_max=256):
        eng = QueryEngine(cov, benchmarks=bench_map, device=dev)
        scen = {"stress": QueryEngine(stressed, benchmarks=bench_map,
                                      device=dev)}
        return QueryServer(eng, ServePolicy(batch_max=batch_max,
                                            queue_max=65536,
                                            default_deadline_s=600.0),
                           health="ok", scenarios=scen)

    n = FLEET_LINES
    lines = trafficgen.gen_requests(7, n, K, scenario="stress",
                                    mix=FLEET_MIX)
    wrng = np.random.default_rng(99)

    def wline(kind, i):
        req = {"id": f"w{kind}{i}", "deadline_s": 600.0,
               "weights": np.round(0.2 * wrng.standard_normal(K),
                                   6).tolist()}
        if kind == "s":
            req["scenario"] = "stress"
        elif kind in ("mv", "rp"):
            req["construct"] = {"solver": "min_vol" if kind == "mv"
                                else "risk_parity"}
        return json.dumps(req, sort_keys=True)

    def warm(server, buckets):
        for kind in ("q", "s", "mv", "rp"):
            for b in buckets:
                for i in range(b):
                    server.submit_line_routed(wline(kind, b * 1000 + i))
                while server._queue:
                    server.drain_routed()

    reset_launches()
    # the one-line-at-a-time baseline
    bserver = mk_server(batch_max=1)
    warm(bserver, (1,))
    sink = io.StringIO()
    t0 = time.perf_counter()
    for ln in lines[:FLEET_BASELINE_LINES]:
        for r in bserver.submit_line(ln) + bserver.drain():
            sink.write(json.dumps(r, sort_keys=True))
    sync()
    base_wall = time.perf_counter() - t0

    # the sequential loop: the per-id reference
    ref_buf = io.StringIO()
    _, seq_wall = timed(lambda: mk_server().run(list(lines), ref_buf,
                                                gulp=True))
    ref = {json.loads(ln)["id"]: ln for ln in ref_buf.getvalue().splitlines()}

    # the coalesced open loop
    server = mk_server()
    warm(server, (8, 32, 128, 512))
    batch_walls = []
    drain = server.drain_routed

    def timed_drain():
        t = time.perf_counter()
        out = drain()
        batch_walls.append(time.perf_counter() - t)
        return out

    server.drain_routed = timed_drain
    completions, delivered = {}, {}
    done = threading.Event()

    def deliver(pairs):
        now = time.monotonic()
        for origin, resp in pairs:
            completions[origin] = now
            delivered[origin] = resp
        if len(delivered) >= n:
            done.set()

    co = Coalescer(server, linger_s=FLEET_LINGER, deliver=deliver)
    co.start()
    sched = trafficgen.open_loop(lambda line, i: co.submit(line, origin=i),
                                 lines, FLEET_RATE)
    done.wait(timeout=600.0)
    co.stop()
    open_wall = max(completions.values()) - sched["t0"] if completions \
        else None
    lat = trafficgen.latency_stats(sched["arrivals"], completions)
    mismatched = [resp.get("id") for resp in delivered.values()
                  if json.dumps(resp, sort_keys=True) != ref.get(
                      resp.get("id"))]
    max_batch = max(batch_walls) if batch_walls else 0.0

    # the closed loop: 32 clients, one request in flight each
    cserver = mk_server()
    warm(cserver, (8, 32))
    events, cresp = {}, {}

    def cdeliver(pairs):
        for origin, resp in pairs:
            cresp[origin] = resp
            ev = events.get(origin)
            if ev is not None:
                ev.set()

    cco = Coalescer(cserver, linger_s=0.002, deliver=cdeliver)
    cco.start()

    def submit_and_wait(line, i):
        events[i] = threading.Event()
        cco.submit(line, origin=i)
        events[i].wait(timeout=120.0)

    closed = trafficgen.closed_loop(submit_and_wait,
                                    lines[:FLEET_CLOSED_LINES], 32)
    cco.stop()
    closed_mismatched = sum(
        json.dumps(r, sort_keys=True) != ref.get(r.get("id"))
        for r in cresp.values())
    add_grad_launches(ctx)

    # one warm-started construct request on the guarded CSI300 checkpoint
    st, meta = load_risk_state(ctx["checkpoints"]["checkpoint"], dev)
    eng = QueryEngine.from_risk_state(st, meta, device=dev)
    warm_index = WarmStartIndex()
    srv = QueryServer(eng, ServePolicy(default_deadline_s=60.0),
                      health="ok", warm_index=warm_index)
    book = np.abs(0.2 * np.random.default_rng(5).standard_normal(eng.K))
    answers = []
    for rid, w in (("cold", book), ("near", book * 1.001)):
        srv.submit_line(json.dumps({"id": rid, "weights": w.tolist(),
                                    "construct": "min_vol"}))
        answers += srv.drain()
    cold, near = answers
    warm_entry = {"K": eng.K, "outcomes": [r["outcome"] for r in answers],
                  "cold_has_warm_start": "warm_start" in cold,
                  "warm_start": near.get("warm_start"),
                  "vol_cold": cold.get("total_vol"),
                  "vol_warm": near.get("total_vol"),
                  "index": warm_index.stats()}

    construct_share = sum('"construct"' in x for x in lines) / n
    res = {"K": K, "lines": n, "mix": FLEET_MIX, "construct_share":
           construct_share, "offered_rate_rps": FLEET_RATE,
           "linger_s": FLEET_LINGER, "batch_max": 256,
           "baseline_lines": FLEET_BASELINE_LINES,
           "baseline_wall_s": base_wall,
           "sequential_wall_s": seq_wall,
           "open_loop_qps": len(delivered) / open_wall if open_wall else 0.0,
           "open_loop_wall_s": open_wall, "latency": lat,
           "max_batch_wall_s": max_batch, "drains": len(batch_walls),
           "p99_within_linger_plus_batch": bool(
               lat.get("p99_s", float("inf")) <= FLEET_LINGER + max_batch),
           "bitwise_mismatches": len(mismatched),
           "unanswered": lat.get("unanswered"),
           "closed_loop_lines": FLEET_CLOSED_LINES, "closed_loop_wall_s":
           closed["wall_s"], "closed_loop_mismatches": closed_mismatched,
           "warm_start_on_checkpoint": warm_entry}
    emit("grad_served", **res)
    require(len(delivered) == n and not mismatched,
            f"grad_served: {n - len(delivered)} unanswered, "
            f"{len(mismatched)} responses differ from the sequential loop "
            f"(first: {mismatched[:3]})")
    require(len(cresp) == FLEET_CLOSED_LINES and closed_mismatched == 0,
            f"grad_served: the closed loop answered {len(cresp)} of "
            f"{FLEET_CLOSED_LINES}, "
            f"{closed_mismatched} differ from the sequential loop")
    require(warm_entry["outcomes"] == ["ok", "ok"]
            and not warm_entry["cold_has_warm_start"]
            and (warm_entry["warm_start"] or {}).get("used"),
            f"grad_served: the warm-started construct request: {warm_entry}")
    return res


def sweep_refine_phase(ctx) -> dict:
    """Phase sweep_refine: the sweep config's refined leg on the card — 50
    chunks of 8,192 in the coarse ball, then ``refine={"ball":
    ShockBall(), "seed": 4}`` (the ascent from each book's coarse top-16,
    its endpoints through the exact path, a 512-lane local re-sweep per
    book): for every book the refined worst case beats the coarse top-1
    and is admissible, and dominates every preset drill."""
    from mfm_tpu_torch.grad import ShockBall
    from mfm_tpu_torch.ops.eigh_cuda import launch_counts, reset_launches
    from mfm_tpu_torch.scenario import SweepEngine, UniformSampler

    dev = ctx["device"]
    cov, names, xs, ball = sweep_case()
    K, chunk = len(names), SWEEP_CHUNK
    S = SWEEP_REFINE_CHUNKS * chunk
    engine = SweepEngine(cov, factor_names=names, device=dev)
    reset_launches()
    res, wall = timed(lambda: engine.sweep(
        xs, UniformSampler(ball, K, S, seed=3), chunk=chunk,
        refine={"ball": ShockBall(), "seed": 4}))
    launches = launch_counts()
    add_grad_launches(ctx)
    dominance = engine.preset_dominance(res, xs)
    out = {"S_coarse": S, "chunk": chunk, "wall_s": wall,
           "counts": res.counts, "refined": res.refined,
           "launches": launches,
           "dominates_all_presets": [d["dominates_all"] for d in dominance]}
    emit("sweep_refine", **out)
    require(all(b["improved"] and b["admissible"] for b in res.refined),
            f"sweep_refine: a refined worst case did not improve on the "
            f"coarse top-1 or is inadmissible: {res.refined}")
    require(all(out["dominates_all_presets"]),
            f"sweep_refine: a book's worst case loses to a preset drill: "
            f"{dominance}")
    return out


# -- the serving fleet: bench config 12 at CSI300 width ------------------------

#: bench config 12 (``bench.py:1703-1990``): 2 simulated hosts x 2 TCP
#: workers, batch_max 32, linger 0.02 s, heartbeat off; tracing on with a
#: 65,536-span ring; the mix (plain, benchmark, scenario, construct, sweep)
FLEET_HOSTS, FLEET_WPH = 2, 2
FLEET_BATCH_MAX, FLEET_MH_LINGER = 32, 0.02
FLEET_MH_MIX = (0.55, 0.25, 0.0, 0.20, 0.0)
#: (lines, seed, offered req/s) of the warm-up, phase A and phase B
FLEET_WARM = (8 * FLEET_BATCH_MAX, 1, 4000.0)
#: (phase A cut from the bench's 800 lines to 200 for the faults section;
#: PERF.md §4)
FLEET_A = (200, 7, 300.0)
FLEET_B = (320, 8, 200.0)
#: how long a worker may take to announce its port, a phase to finish and
#: a per-I/O wait on a worker (generous: the card is shared by 4 workers)
FLEET_BOOT_S, FLEET_PHASE_S, FLEET_IO_S = 240.0, 600.0, 120.0


def fleet_serve_flags(bench_path: str) -> list:
    """The serve policy every fleet process of config 12 runs with."""
    return ["--batch-max", str(FLEET_BATCH_MAX), "--deadline-s", "600",
            "--benchmarks", bench_path]


def fleet_env() -> dict:
    """The environment of the spawned serve processes: the checkout on
    the import path, no crash point armed."""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    for k in ("MFM_CHAOS_KILL", "MFM_CHAOS_KILL_MATCH",
              "MFM_CHAOS_KILL_REPLICA"):
        env.pop(k, None)
    return env


def wait_for_line(path: str, key: str, proc, deadline_s: float):
    """The first JSON line of ``path`` (a process's stderr) holding ``key``,
    polled until ``deadline_s`` or the process exits; None if none came."""
    t_end = time.monotonic() + deadline_s
    while time.monotonic() < t_end:
        try:
            with open(path, encoding="utf-8") as fh:
                for ln in fh:
                    if f'"{key}"' in ln:
                        return json.loads(ln)
        except OSError:
            pass
        if proc.poll() is not None:
            return None
        time.sleep(0.1)
    return None


def gulp_replays(d: str, streams: dict, device: str) -> dict:
    """``python -m mfm_tpu_torch.cli serve --gulp`` on ``device`` over each
    ``{tag: lines}`` stream in directory ``d``, the processes run side by
    side (their solves are host-bound, one core each): {tag: {request id:
    response line}}."""
    procs = {}
    for tag, lines in streams.items():
        req = os.path.join(d, f"req_{tag}.jsonl")
        with open(req, "w", encoding="utf-8") as fh:
            fh.write("\n".join(lines) + "\n")
        procs[tag] = subprocess.Popen(
            [sys.executable, "-m", "mfm_tpu_torch.cli", "serve", "state.npz",
             "--input", req, "--output", f"gulp_{tag}.jsonl", "--gulp",
             "--device", device, *fleet_serve_flags("benchmarks.json")],
            stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True, cwd=d, env=fleet_env())
    out = {}
    for tag, proc in procs.items():
        _, err = proc.communicate(timeout=FLEET_PHASE_S)
        require(proc.returncode == 0, f"the --gulp replay {tag} failed "
                f"rc={proc.returncode}\n{err[-2000:]}")
        with open(os.path.join(d, f"gulp_{tag}.jsonl"),
                  encoding="utf-8") as fh:
            out[tag] = {json.loads(ln)["id"]: ln
                        for ln in fh.read().splitlines() if ln}
    return out


def fleet_checkpoint_phase(ctx) -> dict:
    """Phase fleet_checkpoint: the guarded CSI300 risk pipeline on the card
    (``with_state=True``, the smoke's injected draws), saved with
    ``save_pipeline_state`` into one directory per fleet phase beside a
    benchmarks file; both warp kernels launched."""
    import numpy as np

    from mfm_tpu_torch import (
        PipelineConfig,
        RiskModelConfig,
        run_risk_pipeline,
        save_pipeline_state,
    )
    from mfm_tpu_torch.config import QuarantinePolicy
    from mfm_tpu_torch.data.artifacts import load_risk_state
    from mfm_tpu_torch.ops.eigh_cuda import launch_counts, reset_launches
    from mfm_tpu_torch.serve import QueryEngine

    cfg = PipelineConfig(risk=RiskModelConfig(
        quarantine=QuarantinePolicy(enabled=True)))
    sync()
    reset_launches()
    res, wall = timed(lambda: run_risk_pipeline(
        ctx["table"], config=cfg, with_state=True, sim_covs=ctx["sim_covs"],
        sim_length=ctx["T"], device=ctx["device"]))
    launches = launch_counts()
    K = ctx["K"]
    bench = {"idx": np.round(
        0.1 * np.random.default_rng(3).standard_normal(K), 6).tolist()}
    dirs = {name: os.path.join(ctx["tmp"], "fleet", name)
            for name in ("wire", "mh", "frontend")}
    saves = {}
    for name, d in dirs.items():
        _, saves[name] = timed(lambda: save_pipeline_state(
            os.path.join(d, "state.npz"), res))
        with open(os.path.join(d, "benchmarks.json"), "w") as fh:
            json.dump(bench, fh)
    st, meta = load_risk_state(os.path.join(dirs["wire"], "state.npz"),
                               ctx["device"])
    eng = QueryEngine.from_risk_state(
        st, meta, benchmarks=bench, device=ctx["device"])
    out = {"wall_s": wall, "save_s": saves, "launches": launches,
           "K": eng.K, "guarded": bool(st.guarded),
           "staleness": eng.staleness, "last_date": st.last_date,
           "bytes": os.path.getsize(os.path.join(dirs["wire"],
                                                 "state.npz"))}
    emit("fleet_checkpoint", **out)
    require(eng.K == K and st.guarded,
            f"fleet_checkpoint: not a guarded K={K} checkpoint: {out}")
    require_launches(launches, "fleet_checkpoint's pipeline", 1, 1)
    ctx["fleet"] = {"dirs": dirs, "bench": bench}
    return out


def fleet_server(ctx, name: str):
    """The query server a fleet process builds over the fleet checkpoint
    of phase ``name`` on the card: the serve CLI's engine and policy."""
    from mfm_tpu_torch.data.artifacts import load_risk_state
    from mfm_tpu_torch.serve import QueryEngine, QueryServer, ServePolicy

    f = ctx["fleet"]
    st, meta = load_risk_state(os.path.join(f["dirs"][name], "state.npz"),
                               ctx["device"])
    eng = QueryEngine.from_risk_state(st, meta, benchmarks=f["bench"],
                                      device=ctx["device"])
    return QueryServer(eng, ServePolicy(batch_max=FLEET_BATCH_MAX,
                                        queue_max=65536,
                                        default_deadline_s=600.0),
                       health="unknown")


def fleet_wire_phase(ctx) -> dict:
    """Phase fleet_wire: a ``serve_worker_socket`` worker in a thread on
    the card, reached with ``Replica.connect``: two batches of 64 mixed
    lines with a ping and a live scrape between them.  Every envelope is
    byte for byte the in-process ``run_worker`` loop's over the same
    frames, and the path launches no kernel."""
    import io
    import threading

    sys.path.insert(0, str(ROOT / "tools"))
    import trafficgen

    from mfm_tpu_torch.obs import trace as _trace
    from mfm_tpu_torch.ops.eigh_cuda import launch_counts, reset_launches
    from mfm_tpu_torch.serve.replica import CONTROL_KEY, Replica, run_worker
    from mfm_tpu_torch.serve.transport import serve_worker_socket

    lines = trafficgen.gen_requests(5, 128, ctx["K"], mix=FLEET_MH_MIX)
    batches = [lines[:64], lines[64:]]
    flush = json.dumps({CONTROL_KEY: "flush"})
    probes = [json.dumps({CONTROL_KEY: k}) for k in ("ping", "metrics")]
    text = "\n".join(batches[0] + [flush] + probes + batches[1]
                     + [flush]) + "\n"
    out = io.StringIO()
    _, inproc_s = timed(lambda: run_worker(fleet_server(ctx, "wire"),
                                           io.StringIO(text), out))
    frames = [json.loads(ln) for ln in out.getvalue().splitlines()]
    want = [sorted(json.dumps(f, sort_keys=True) for f in frames[a:b]
                   if CONTROL_KEY not in f)
            for a, b in _batch_spans(frames, CONTROL_KEY)]

    addr, ready, summary = [], threading.Event(), []
    server = fleet_server(ctx, "wire")
    _trace.reset_tracing()
    sync()
    reset_launches()

    def announce(a):
        addr.append(a)
        ready.set()

    t = threading.Thread(target=lambda: summary.append(serve_worker_socket(
        server, "127.0.0.1", 0, announce=announce)), daemon=True)
    t.start()
    require(ready.wait(timeout=60), "fleet_wire: the worker never listened")
    rep = Replica.connect(0, addr[0], io_timeout_s=FLEET_IO_S)
    got, walls = [], []
    for i, batch in enumerate(batches):
        resps, wall = timed(lambda: rep.run_batch(batch))
        walls.append(wall)
        got.append(sorted(json.dumps({"seq": s, "resp": r}, sort_keys=True)
                          for s, r in resps.items()))
        if i == 0:
            rep.ping(FLEET_IO_S)
            shard = rep.scrape(FLEET_IO_S)
    rep.close()
    t.join(timeout=120)
    launches = launch_counts()
    merged = [s.name for s in _trace.spans() if "worker" in s.attrs]
    _trace.reset_tracing()
    res = {"lines": len(lines), "bitwise": got == want,
           "wire_batch_walls_s": walls, "in_process_s": inproc_s,
           "scrape_keys": sorted(shard), "launches": launches,
           "worker_done": not t.is_alive(),
           "transport": rep.transport_counters(),
           "clock_offset_us": rep.clock_offset_us,
           "clock_uncertainty_us": rep.clock_uncertainty_us,
           "merged_worker_spans": len(merged)}
    emit("fleet_wire", **res)
    require(res["bitwise"] and all(len(g) == 64 for g in got),
            "fleet_wire: the TCP worker's envelopes are not the in-process "
            "loop's bytes")
    require(res["worker_done"] and summary and shard.get(CONTROL_KEY)
            == "metrics", "fleet_wire: the worker did not drain out cleanly")
    require(not any(launches.values()),
            f"fleet_wire: the serve path launched a kernel: {launches}")
    return res


def _batch_spans(frames, key):
    """(start, end) frame ranges of each flushed batch's envelopes."""
    spans, start = [], 0
    for i, f in enumerate(frames):
        if f.get(key) == "flushed":
            spans.append((start, i))
        if key in f:
            start = i + 1
    return spans


def fleet_mh_phase(ctx) -> dict:
    """Phase fleet_mh: bench config 12 at CSI300 width.  Four
    ``python -m mfm_tpu_torch.cli serve state.npz --worker --listen
    127.0.0.1:0`` processes on the card, grouped into 2 simulated hosts,
    behind an in-process ``FleetServer`` (batch_max 32, linger 0.02 s,
    heartbeat off, tracing on, a 65,536-span ring).  A warm-up of 256
    lines at 4,000 req/s; phase A, 200 lines at 300 req/s open loop;
    phase B, 320 lines at 200 req/s with both workers of host1 SIGKILLed
    at half the stream.  Every response is held to the port CLI's
    ``--gulp`` replay on the card, byte for byte; the merged manifest's
    audit must hold with the redispatches counted; the merged trace must
    cover 95% of phase A's requests and round-trip as a Chrome trace."""
    import signal
    import threading

    sys.path.insert(0, str(ROOT / "tools"))
    import trafficgen

    from mfm_tpu_torch.obs import trace as _trace
    from mfm_tpu_torch.obs.instrument import fleet_summary_from_registry
    from mfm_tpu_torch.obs.manifest import read_run_manifest
    from mfm_tpu_torch.ops.eigh_cuda import launch_counts, reset_launches
    from mfm_tpu_torch.serve.replica import (
        FleetServer,
        Replica,
        build_fleet_manifest,
        worker_cmd,
    )

    d = ctx["fleet"]["dirs"]["mh"]
    K = ctx["K"]
    n_workers = FLEET_HOSTS * FLEET_WPH
    _trace.reset_tracing()
    _trace.set_ring_capacity(65536)
    torch.cuda.empty_cache()
    procs, replicas, boot_s, errs = [], [], [], []
    fleet = None
    try:
        t_spawn = time.monotonic()
        for j in range(n_workers):
            errs.append(os.path.join(d, f"worker{j}.err"))
            with open(errs[j], "w") as err:
                procs.append(subprocess.Popen(
                    worker_cmd("state.npz", worker_id=j, policy_args=[
                        *fleet_serve_flags("benchmarks.json"),
                        "--listen", "127.0.0.1:0"], device=ctx["device"]),
                    stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
                    stderr=err, cwd=d, env=fleet_env()))
        for j, proc in enumerate(procs):
            ann = wait_for_line(errs[j], "worker_listening", proc,
                                FLEET_BOOT_S)
            require(ann is not None, f"fleet_mh: worker {j} never announced "
                    f"its port (rc={proc.poll()}):\n"
                    + Path(errs[j]).read_text()[-2000:])
            boot_s.append(time.monotonic() - t_spawn)
            whost, _, wport = ann["worker_listening"].rpartition(":")
            rep = Replica.connect(j, (whost, int(wport)),
                                  io_timeout_s=FLEET_IO_S)
            rep.host = f"host{j // FLEET_WPH}"   # simulated-host grouping
            replicas.append(rep)

        comps = {"w": {}, "a": {}, "b": {}}
        resps = {"w": {}, "a": {}, "b": {}}
        done = threading.Event()
        target = {"phase": "w", "n": 0}

        def deliver(pairs):
            now = time.monotonic()
            for (tag, i), resp in pairs:
                comps[tag][i] = now
                resps[tag][i] = resp
            if len(resps[target["phase"]]) >= target["n"]:
                done.set()

        sync()
        reset_launches()
        # heartbeat off: dead workers are found at dispatch (EOF), and an
        # idle probe inside the timed window would perturb the QPS
        fleet = FleetServer(fleet_server(ctx, "mh"), replicas,
                            linger_s=FLEET_MH_LINGER, deliver=deliver,
                            heartbeat_s=0.0)
        fleet.start()

        def run_phase(tag, lines, rate):
            target["phase"], target["n"] = tag, len(lines)
            done.clear()
            sched = trafficgen.open_loop(
                lambda line, i: fleet.submit(line, origin=(tag, i)),
                lines, rate)
            done.wait(timeout=FLEET_PHASE_S)
            return sched

        warm = trafficgen.gen_requests(FLEET_WARM[1], FLEET_WARM[0], K,
                                       mix=FLEET_MH_MIX)
        run_phase("w", warm, FLEET_WARM[2])
        n_a, seed_a, rate_a = FLEET_A
        lines_a = trafficgen.gen_requests(seed_a, n_a, K, mix=FLEET_MH_MIX)
        sched_a = run_phase("a", lines_a, rate_a)
        wall_a = (max(comps["a"].values()) - sched_a["t0"]
                  if comps["a"] else float("inf"))
        lat_a = trafficgen.latency_stats(sched_a["arrivals"], comps["a"])
        by_host = trafficgen.per_host_latency(sched_a["arrivals"],
                                              comps["a"], FLEET_HOSTS)

        n_b, seed_b, rate_b = FLEET_B
        lines_b = trafficgen.gen_requests(seed_b, n_b, K, mix=FLEET_MH_MIX)
        victims = [j for j in range(n_workers) if j // FLEET_WPH == 1]

        def kill_host1():
            for j in victims:
                if procs[j].poll() is None:
                    procs[j].send_signal(signal.SIGKILL)

        killer = threading.Timer(0.5 * n_b / rate_b, kill_host1)
        killer.start()
        sched_b = run_phase("b", lines_b, rate_b)
        killer.cancel()
        kill_host1()                  # fire even if the stream outran it
        for j in victims:             # reap: no context lingers
            procs[j].wait(timeout=60)
        lat_b = trafficgen.latency_stats(sched_b["arrivals"], comps["b"])
        fleet.stop()
        launches = launch_counts()
        fm = build_fleet_manifest(fleet_summary_from_registry(), fleet, d)
        fleet.close_replicas()
        rcs = [p.wait(timeout=120) for p in procs]

        # one corrected timeline per request: a front-end span and a
        # worker span shipped over the wire, for 95% of phase A's ids
        front, worker, n_skew = set(), set(), 0
        merged = _trace.spans()
        for sp in merged:
            if "worker" in sp.attrs:
                worker.add(sp.trace_id)
                n_skew += sp.attrs.get("clock_skew") == "uncorrectable"
            else:
                front.add(sp.trace_id)
        a_tids = [r.get("trace_id") for r in resps["a"].values()
                  if r.get("trace_id")]
        coverage = (sum(t in front and t in worker for t in a_tids)
                    / max(1, len(a_tids)))
        trace_path = _trace.write_chrome_trace(os.path.join(
            d, "fleet_trace.json"))
        with open(trace_path, encoding="utf-8") as fh:
            n_events = len(_trace.parse_chrome_trace(fh.read()))
    finally:
        _trace.reset_tracing()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)

    ref, replay_s = timed(lambda: gulp_replays(
        d, {"a": lines_a, "b": lines_b}, ctx["device"]))
    mism = {tag: sum(json.dumps(r, sort_keys=True) != ref[tag].get(r["id"])
                     for r in resps[tag].values()) for tag in ("a", "b")}
    shards = {}
    for j in range(n_workers):
        path = os.path.join(d, f"serve_manifest.r{j}.json")
        if os.path.exists(path):
            shards[j] = read_run_manifest(path)["kernels"]
    res = {"hosts": FLEET_HOSTS, "workers_per_host": FLEET_WPH, "K": K,
           "batch_max": FLEET_BATCH_MAX, "linger_s": FLEET_MH_LINGER,
           "worker_boot_s": boot_s,
           "phase_a": {"n": n_a, "offered_rps": rate_a,
                       "answered": len(resps["a"]), "qps": len(resps["a"])
                       / wall_a, "wall_s": wall_a, **lat_a,
                       "per_host": by_host, "mismatches": mism["a"]},
           "phase_b": {"n": n_b, "offered_rps": rate_b,
                       "answered": len(resps["b"]), "killed": victims,
                       **lat_b, "mismatches": mism["b"],
                       "lost_replicas": [r["replica"] for r in fm["replicas"]
                                         if r["lost"]]},
           "audit": fm["audit"], "transport": fm["transport"],
           "transport_by_replica": {r["replica"]: r["transport"]
                                    for r in fm["replicas"]},
           "ewma_batch_wall_s": {r.idx: r.ewma_wall for r in replicas},
           "gulp_replays_s": replay_s,
           "worker_rcs": rcs, "front_end_launches": launches,
           "worker_kernels": shards,
           "trace": {"coverage": coverage, "requests": len(a_tids),
                     "merged_spans": len(merged), "chrome_events": n_events,
                     "uncorrectable_skew_spans": n_skew}}
    emit("fleet_mh", **res)
    require(mism["a"] == 0 and mism["b"] == 0
            and len(resps["a"]) == n_a and len(resps["w"]) == len(warm),
            f"fleet_mh: responses differ from the --gulp replay: {mism}")
    require(len(resps["b"]) == n_b and fm["audit"]["consistent"]
            and fm["transport"]["redispatches"] >= 1
            and res["phase_b"]["lost_replicas"] == victims,
            f"fleet_mh: the kill drill lost requests or its audit: "
            f"{res['phase_b']} {fm['audit']} {fm['transport']}")
    require(coverage >= 0.95 and n_events > 0,
            f"fleet_mh: trace coverage {coverage} < 0.95")
    require(not any(launches.values()) and len(shards) == FLEET_WPH
            and all(not any(s["launches"].values())
                    and s["libraries_loaded"] == 0 for s in shards.values()),
            f"fleet_mh: a fleet process launched or loaded a kernel: "
            f"{launches} {shards}")
    ctx["fleet"].update(lines_a=lines_a, ref_a=ref["a"])
    return res


def _front_end(d: str, tag: str, device: str, *flags):
    """Start ``python -m mfm_tpu_torch.cli serve state.npz --listen
    127.0.0.1:0 --replicas 2`` on ``device`` in ``d``; returns (process,
    (host, port), seconds until it listened, its stderr path)."""
    err = os.path.join(d, f"frontend_{tag}.err")
    t0 = time.monotonic()
    with open(err, "w") as fh:
        proc = subprocess.Popen(
            [sys.executable, "-m", "mfm_tpu_torch.cli", "serve", "state.npz",
             "--device", device, *fleet_serve_flags("benchmarks.json"),
             "--listen",
             "127.0.0.1:0", "--replicas", "2", "--linger-s",
             str(FLEET_MH_LINGER), "--worker-timeout-s", str(FLEET_IO_S),
             *flags],
            stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL, stderr=fh,
            cwd=d, env=fleet_env())
    ann = wait_for_line(err, "listening", proc, FLEET_BOOT_S)
    if ann is None:
        proc.kill()
        proc.wait(timeout=60)
        raise SmokeFailure(f"fleet_frontend: the front end never listened "
                           f"(rc={proc.poll()}):\n"
                           + Path(err).read_text()[-2000:])
    host, _, port = ann["listening"].rpartition(":")
    return proc, (host, int(port)), time.monotonic() - t0, err


def _stop_front_end(proc, err: str) -> int:
    """SIGTERM the front end and reap it (and so its workers)."""
    import signal

    proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(timeout=FLEET_PHASE_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=60)
        raise SmokeFailure("fleet_frontend: the front end did not drain "
                           "out on SIGTERM:\n" + Path(err).read_text()[-2000:])


def _jsonl_client(addr, lines, out: dict, key: int) -> None:
    """One raw JSONL client: send every line, half-close, read to EOF."""
    import socket

    with socket.create_connection(addr, timeout=FLEET_PHASE_S) as s:
        s.sendall(("\n".join(lines) + "\n").encode())
        s.shutdown(socket.SHUT_WR)
        buf = b""
        while chunk := s.recv(1 << 16):
            buf += chunk
    out[key] = buf.decode().splitlines()


def _http(addr, raw: bytes) -> tuple:
    import socket

    with socket.create_connection(addr, timeout=FLEET_PHASE_S) as s:
        s.sendall(raw)
        buf = b""
        while chunk := s.recv(1 << 16):
            buf += chunk
    head, _, body = buf.partition(b"\r\n\r\n")
    return head.split(b"\r\n")[0].decode(), body


def fleet_frontend_phase(ctx) -> dict:
    """Phase fleet_frontend: ``python -m mfm_tpu_torch.cli serve state.npz
    --listen 127.0.0.1:0 --replicas 2`` on the card.  Four concurrent raw
    JSONL clients send phase A's 200 lines (50 each), every response
    byte for byte the ``--gulp`` replay's; then the same front end with
    ``--http``: a POST of 64 lines, ``GET /healthz`` (its SLO block) and
    ``GET /metrics`` (both workers' live shards); then SIGTERM, the fleet
    manifest written and ``doctor --serve`` exiting 0 on it."""
    import threading

    f = ctx["fleet"]
    d, lines, ref = f["dirs"]["frontend"], f["lines_a"], f["ref_a"]
    torch.cuda.empty_cache()
    proc, addr, boot_s, err = _front_end(d, "jsonl", ctx["device"])
    try:
        per_client = [lines[c::4] for c in range(4)]
        got = {}
        ts = [threading.Thread(target=_jsonl_client,
                               args=(addr, per_client[c], got, c))
              for c in range(4)]
        t0 = time.monotonic()
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=FLEET_PHASE_S)
        wall = time.monotonic() - t0
    finally:
        rc_jsonl = _stop_front_end(proc, err)
    answered = sum(len(v) for v in got.values())
    mism = sum(ln != ref.get(json.loads(ln)["id"])
               for v in got.values() for ln in v)
    own = all(sorted(json.loads(ln)["id"] for ln in got.get(c, []))
              == sorted(json.loads(ln)["id"] for ln in per_client[c])
              for c in range(4))
    fm_jsonl = json.loads(Path(d, "fleet_manifest.json").read_text())

    proc, addr, boot_http_s, err = _front_end(d, "http", ctx["device"],
                                              "--http")
    try:
        body = ("\n".join(lines[:64]) + "\n").encode()
        post_status, payload = _http(
            addr, b"POST / HTTP/1.1\r\nHost: x\r\nContent-Length: "
            + str(len(body)).encode() + b"\r\nConnection: close\r\n\r\n"
            + body)
        posted = payload.decode().splitlines()
        post_mism = sum(ln != ref.get(json.loads(ln)["id"])
                        for ln in posted)
        hz_status, hz = _http(addr, b"GET /healthz HTTP/1.1\r\nHost: x\r\n"
                              b"Connection: close\r\n\r\n")
        hz = json.loads(hz)
        mt_status, mt = _http(addr, b"GET /metrics HTTP/1.1\r\nHost: x\r\n"
                              b"Connection: close\r\n\r\n")
        mt = json.loads(mt)
    finally:
        rc_http = _stop_front_end(proc, err)
    fm = json.loads(Path(d, "fleet_manifest.json").read_text())
    kernels = {"front_end": fm["kernels"], **{
        f"worker{j}": json.loads(Path(
            d, f"serve_manifest.r{j}.json").read_text())["kernels"]
        for j in range(2)}}
    doctor = subprocess.run(
        [sys.executable, "-m", "mfm_tpu_torch.cli", "doctor", d, "--serve"],
        capture_output=True, text=True, timeout=300, env=fleet_env())
    shards = [w for w in mt.get("workers", []) if w.get("metrics")]
    res = {"front_end_boot_s": boot_s, "clients": 4,
           "lines": len(lines), "answered": answered, "wall_s": wall,
           "qps": answered / wall, "mismatches": mism,
           "own_responses_per_client": own, "rc_jsonl": rc_jsonl,
           "audit_jsonl": fm_jsonl["fleet"]["audit"],
           "http": {"boot_s": boot_http_s, "post": post_status,
                    "posted": len(posted), "post_mismatches": post_mism,
                    "healthz": hz_status, "healthz_slo": "slo" in hz,
                    "slo_worst_state": hz.get("slo", {}).get("worst_state"),
                    "healthz_workers": len(hz.get("workers", [])),
                    "metrics": mt_status, "metrics_worker_shards":
                        sorted(w["replica"] for w in shards)},
           "rc_http": rc_http, "audit_http": fm["fleet"]["audit"],
           "kernels": kernels, "doctor_rc": doctor.returncode}
    emit("fleet_frontend", **res)
    require(answered == len(lines) and mism == 0 and own and rc_jsonl == 0
            and fm_jsonl["fleet"]["audit"]["consistent"],
            f"fleet_frontend: the JSONL clients' answers are not the "
            f"--gulp replay's: {answered} answered, {mism} differ")
    require(post_status.endswith("200 OK") and len(posted) == 64
            and post_mism == 0 and hz_status.endswith("200 OK")
            and "slo" in hz and mt_status.endswith("200 OK")
            and res["http"]["metrics_worker_shards"] == [0, 1],
            f"fleet_frontend: the HTTP surface failed: {res['http']}")
    require(rc_http == 0 and fm["fleet"]["audit"]["consistent"]
            and doctor.returncode == 0,
            f"fleet_frontend: SIGTERM left no clean manifest or doctor "
            f"--serve failed (rc {doctor.returncode}):\n"
            f"{doctor.stdout[-2000:]}")
    require(all(not any(k["launches"].values()) and k["libraries_loaded"] == 0
                for k in kernels.values()),
            f"fleet_frontend: a fleet process launched or loaded a kernel: "
            f"{kernels}")
    return res


# -- the CLI's compute subcommands at CSI300 width ----------------------------

def cli_call(argv) -> tuple:
    """``mfm_tpu_torch.cli.main(argv)`` in this process: (exit code,
    standard output, standard error).  The card is the CLI's default
    device."""
    import contextlib
    import io

    from mfm_tpu_torch import cli

    out, err, code = io.StringIO(), io.StringIO(), 0
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            cli.main(list(map(str, argv)))
        except SystemExit as e:
            code = e.code
    return code, out.getvalue(), err.getvalue()


def read_table_exact(path) -> tuple:
    """A result table the CLI wrote as (index, columns, float64 values),
    each cell parsed by Python's ``float``: the CLI writes the ``repr`` of
    a float64, which reads back bit for bit."""
    import csv

    import numpy as np

    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))
    vals = np.array([[float(c) if c else np.nan for c in r[1:]]
                     for r in rows[1:]])
    return [r[0] for r in rows[1:]], rows[0][1:], vals


def tables_equal(out_dir, outputs, arrays, rows=slice(None),
                 specific=None) -> dict:
    """Each result table in ``out_dir`` against ``outputs`` (at the dates
    ``rows``): the same index and bit for bit the same numbers."""
    import numpy as np

    from mfm_tpu_torch.data.artifacts import _numpy

    dates = [str(d) for d in np.asarray(arrays.dates)[rows]]
    names = arrays.factor_names()
    o = outputs
    want = {"factor_returns": (_numpy(o.factor_ret[rows]), dates),
            "r_squared": (_numpy(o.r2[rows])[:, None], dates),
            "specific_returns": (_numpy(o.specific_ret[rows]), dates),
            "final_covariance": (_numpy(o.vr_cov[-1]), names),
            "lambda": (_numpy(o.lamb[rows])[:, None], dates)}
    if specific is not None:
        want["specific_risk"] = (specific[rows], dates)
    res = {}
    for name, (vals, index) in want.items():
        got_index, _, got = read_table_exact(os.path.join(out_dir,
                                                          name + ".csv"))
        res[name] = (got_index == [str(x) for x in index]
                     and np.array_equal(got, vals.astype(np.float64),
                                        equal_nan=True))
    return res


def jit_compiles(metrics_dir) -> float:
    """``mfm_jit_compiles_total`` from a ``--metrics-dir``'s Prometheus
    textfile."""
    with open(os.path.join(metrics_dir, "metrics.prom")) as fh:
        m = re.search(r"^mfm_jit_compiles_total(?:\{\})? (\S+)$", fh.read(),
                      re.M)
    return float(m.group(1)) if m else float("nan")


def stage_seconds(metrics_dir) -> dict:
    """``mfm_stage_seconds`` by stage from a ``--metrics-dir`` snapshot."""
    with open(os.path.join(metrics_dir, "metrics.json")) as fh:
        snap = json.load(fh)["metrics"]
    return {s["labels"]["stage"]: s["value"]
            for s in snap.get("mfm_stage_seconds", {}).get("series", [])}


def cli_risk_phase(ctx) -> dict:
    """Phase cli_risk: the CSI300 barra table (398,228 rows) written as a
    csv and run through ``python -m mfm_tpu_torch.cli risk --save-state
    --quarantine --specific-risk --save-outputs --portfolio-bias 100
    --metrics-dir`` as a subprocess on the card (M = 100, float32, its own
    seeded draws); each table, ``portfolio_bias.json`` and
    ``risk_outputs.npz`` bit for bit ``run_risk_pipeline`` in this process
    on the same csv and seed; the subprocess's kernel launches (the warp
    design: one weighted launch, two or more full ones); the run manifest
    beside the checkpoint, and ``doctor`` on it.  A second subprocess with
    ``--profile``, for the busy share and peak memory, starts with the
    first and is collected by phase cli_risk_profile.  The csv is read
    here twice, by byte positions and through the ``csv`` module, each
    timed, the two bit for bit the same, while both subprocesses run."""
    import numpy as np

    from mfm_tpu_torch import PipelineConfig, RiskModelConfig
    from mfm_tpu_torch import run_risk_pipeline
    from mfm_tpu_torch.config import QuarantinePolicy
    from mfm_tpu_torch.data.artifacts import load_risk_outputs
    from mfm_tpu_torch.data.csvio import read_csv, write_csv

    dev, T = ctx["device"], ctx["T"]
    d = os.path.join(ctx["tmp"], "cli")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "barra.csv")
    _, write_s = timed(lambda: write_csv(path, ctx["table"]))
    out, ck = os.path.join(d, "risk_out"), os.path.join(d, "ck", "state.npz")
    mdir, pdir = os.path.join(d, "metrics"), os.path.join(d, "profile")

    # the profiler's post-processing of ~84,000 kernels lands in the
    # record's wall, so the busy share and peak come from a run of their
    # own; both processes run at once, while this one reads the csv
    started = start_cli(["risk", "--barra", path, "--out", out,
                         "--save-state", ck, "--quarantine", "--specific-risk",
                         "--save-outputs", "--portfolio-bias", "100",
                         "--metrics-dir", mdir])
    prof_started = start_cli(["risk", "--barra", path, "--out",
                              os.path.join(d, "risk_prof"), "--profile", pdir])

    parsed, read_s = timed(lambda: read_csv(path))
    # the same file through the csv module's reading (the byte-position
    # split declined), for the split's gain; every column the same bits
    from mfm_tpu_torch.data import csvio
    split = csvio._split_columns
    csvio._split_columns = lambda p: None
    try:
        by_module, module_read_s = timed(lambda: read_csv(path))
    finally:
        csvio._split_columns = split
    reads_bitwise = list(parsed) == list(by_module) and all(
        same_column(parsed[k], by_module[k]) for k in parsed)
    del by_module
    cfg = PipelineConfig(risk=RiskModelConfig(
        quarantine=QuarantinePolicy(enabled=True)))
    res, run_s = timed(lambda: run_risk_pipeline(parsed, config=cfg,
                                                 with_state=True, device=dev))
    spec = res._specific_panels(42.0, 10, 1.0, 10)[1]
    rec, process_s, _ = finish_cli(started, "cli_risk")
    equal = tables_equal(out, res.outputs, res.arrays, specific=spec)
    with open(os.path.join(out, "portfolio_bias.json")) as fh:
        equal["portfolio_bias"] = json.load(fh) == res.portfolio_bias(
            n_portfolios=100, burn_in=252)
    saved, _ = load_risk_outputs(os.path.join(out, "risk_outputs.npz"), dev)
    equal["risk_outputs"] = compare_rows(saved, res.outputs)["bitwise"]
    mpath = os.path.join(os.path.dirname(ck), "run_manifest.json")
    with open(mpath) as fh:
        man = json.load(fh)
    doctor_rc, _, _ = cli_call(["doctor", os.path.dirname(ck)])
    launches = rec["kernels"]["launches"]
    result = {"rows": len(parsed["date"]), "dates": rec["dates"],
              "stocks": rec["stocks"], "factors": rec["factors"],
              "cli_wall_s": rec["wall_s"], "process_s": process_s,
              "csv_write_s": write_s, "csv_read_in_process_s": read_s,
              "csv_read_csv_module_s": module_read_s,
              "csv_reads_bitwise": reads_bitwise,
              "stages_s": stage_seconds(mdir),
              "jit_compiles_total": jit_compiles(mdir),
              "in_process_run_s": run_s,
              "kernels": rec["kernels"], "tables_bitwise": equal,
              "manifest": {"backend": man["backend"],
                           "checkpoint": man["checkpoint"],
                           "health": man["health"]["status"],
                           "guard": man["guard"],
                           "kernels": man["kernels"]["launches"]},
              "doctor_rc": doctor_rc}
    emit("cli_risk", **result)
    require(rec["dates"] == T and rec["factors"] == ctx["K"],
            f"cli_risk: the run covered the wrong shape: {rec}")
    require(all(equal.values()), f"cli_risk: a table is not the in-process "
            f"pipeline's: {equal}")
    require(reads_bitwise, "cli_risk: the byte-position split and the csv "
            "module read the csv differently")
    require(launches["jacobi_eigh_weighted/warp"] == 1
            and launches["jacobi_eigh/warp"] >= 2
            and launches["jacobi_eigh/block"] == 0
            and launches["jacobi_eigh_weighted/block"] == 0,
            f"cli_risk: the subprocess must launch the warp design only, "
            f"the weighted kernel once: {launches}")
    require(man["backend"] == torch.device(dev).type
            and man["checkpoint"] == "state.npz" and doctor_rc == 0,
            f"cli_risk: the manifest or doctor: {result['manifest']}, "
            f"doctor {doctor_rc}")
    require(result["jit_compiles_total"] >= 1,
            "cli_risk: the --metrics-dir textfile counts no compile event "
            f"({result['jit_compiles_total']})")
    ctx["cli"] = {"dir": d, "csv": path, "ck": ck, "result": res,
                  "parsed": parsed, "out": out,
                  "profile": (prof_started, pdir)}
    return result


def cli_risk_profile_phase(ctx) -> dict:
    """Phase cli_risk_profile: the ``risk --profile`` subprocess phase
    cli_risk started beside its first, which ran on while the section's
    later phases did, to its end: its busy share and peak memory."""
    started, pdir = ctx["cli"].pop("profile")
    rec, process_s, _ = finish_cli(started, "cli_risk --profile")
    with open(os.path.join(pdir, "profile_summary.json")) as fh:
        prof = json.load(fh)
    res = {"profile": prof, "profiled_cli_wall_s": rec["wall_s"],
           "profiled_process_s": process_s}
    emit("cli_risk_profile", **res)
    require(prof["busy_share"] is not None,
            "cli_risk: the profiler saw no device time")
    return res


def cli_update_phase(ctx) -> dict:
    """Phase cli_update: ``risk --save-state`` on the first 1350 dates'
    rows of the csv, then ``risk --update`` with the whole csv (both
    through ``cli.main`` in this process, the draws' length pinned to
    1390): the appended 40 dates bit for bit the full run's last 40; then
    the same with ``--quarantine`` on a table whose date 1360 lost 60% of
    its rows: that date, and only it, quarantined; the manifest's guard
    summary counts it (the registry's counters moved by one quarantined
    date and 40 served ones); its health is ``evaluate_health`` of the
    appended outputs under that guard summary."""
    import shutil

    import numpy as np

    from mfm_tpu_torch.data.artifacts import load_risk_outputs
    from mfm_tpu_torch.obs.health import evaluate_health
    from mfm_tpu_torch.obs.instrument import guard_summary_from_registry
    from mfm_tpu_torch.obs.metrics import MetricsRegistry
    from mfm_tpu_torch.ops.eigh_cuda import launch_counts, reset_launches
    from mfm_tpu_torch.pipeline import date_stamp

    c, dev, T = ctx["cli"], ctx["device"], ctx["T"]
    T0, off = SERVE_T0, 10
    full, parsed, d = c["result"], c["parsed"], c["dir"]
    dates = np.unique(parsed["date"])
    with open(c["csv"]) as fh:
        header, *body = fh.read().splitlines()
    # the csv's own lines, so every number parses to the same bits
    head_rows = parsed["date"] < dates[T0]
    poisoned_date = dates[T0 + off]
    names, industry = parsed["stocknames"], parsed["industry"]
    _, first_row = np.unique(industry, return_index=True)
    on_date = np.nonzero(parsed["date"] == poisoned_date)[0]
    droppable = on_date[~np.isin(names[on_date], names[first_row])]
    drop = np.random.default_rng(0).choice(
        droppable, int(round(0.6 * len(on_date))), replace=False)
    keep = np.ones(len(body), bool)
    keep[drop] = False
    files = {}
    for name, mask in (("head", head_rows), ("poisoned", keep)):
        files[name] = os.path.join(d, f"{name}.csv")
        with open(files[name], "w") as fh:
            fh.write("\n".join([header, *(ln for ln, k in zip(body, mask)
                                          if k)]) + "\n")
    pin = ["--eigen-sim-length", T]
    res = {"T0": T0, "appended": T - T0}
    walls = {}
    for leg, flags, table in (("plain", [], c["csv"]),
                              ("guarded", ["--quarantine"],
                               files["poisoned"])):
        ck = os.path.join(d, f"ck_{leg}", "state.npz")
        (code, _, _), walls[f"{leg}_save_state_s"] = timed(lambda: cli_call(
            ["risk", "--barra", files["head"], "--out",
             os.path.join(d, f"head_{leg}"), "--save-state", ck, *flags,
             *pin]))
        require(code == 0, f"cli_update {leg}: --save-state exit {code}")
        if leg == "plain":
            # phase mesh_cli's --update --mesh starts from this checkpoint
            c["mesh_ck"] = os.path.join(d, "ck_mesh", "state.npz")
            shutil.copytree(os.path.dirname(ck), os.path.dirname(c["mesh_ck"]))
        before = guard_summary_from_registry()
        reset_launches()
        (code, txt, _), walls[f"{leg}_update_s"] = timed(lambda: cli_call(
            ["risk", "--barra", table, "--out", os.path.join(d, f"upd_{leg}"),
             "--update", ck, "--save-outputs", *flags, *pin]))
        launches = launch_counts()
        require(code == 0, f"cli_update {leg}: --update exit {code}")
        rec = json.loads(txt.splitlines()[-1])
        with open(os.path.join(os.path.dirname(ck), "run_manifest.json")) as f:
            man = json.load(f)
        outs, _ = load_risk_outputs(os.path.join(d, f"upd_{leg}",
                                                 "risk_outputs.npz"), dev)
        guard = man["guard"]
        res[leg] = {
            "record": {k: rec[k] for k in ("update_wall_s", "health",
                                           "stocks", "factors")},
            "appended_dates": [rec["appended_dates"][0],
                               rec["appended_dates"][-1],
                               len(rec["appended_dates"])],
            "launches": launches, "guard": guard,
            "guard_delta": {
                "served": guard["served_dates"] - before["served_dates"],
                "quarantined": (guard["quarantined_dates"]
                                - before["quarantined_dates"])},
            "health": man["health"]["status"],
            "health_recomputed": evaluate_health(
                outs, guard_summary=guard,
                registry=MetricsRegistry())["status"]}
        if leg == "plain":
            res[leg]["rows_vs_full"] = compare_rows(
                outs, suffix(full.outputs, T0))
            res[leg]["tables_vs_full"] = tables_equal(
                os.path.join(d, f"upd_{leg}"), full.outputs, full.arrays,
                rows=slice(T0, None))
        else:
            res[leg]["quarantined"] = rec["quarantined"]
    res["walls_s"] = walls
    emit("cli_update", **res)
    p, g = res["plain"], res["guarded"]
    require(p["appended_dates"][2] == T - T0 and p["rows_vs_full"]["bitwise"]
            and all(p["tables_vs_full"].values()),
            f"cli_update: the appended dates are not the full run's last "
            f"{T - T0}: {p['tables_vs_full']}")
    require(p["launches"]["jacobi_eigh_weighted/warp"] >= 1
            and p["launches"]["jacobi_eigh/warp"] >= 2
            and p["launches"]["jacobi_eigh/block"] == 0,
            f"cli_update: the update did not go through the warp design: "
            f"{p['launches']}")
    require([q["date"] for q in g["quarantined"]]
            == [date_stamp(poisoned_date)]
            and "universe_collapse" in g["quarantined"][0]["reasons"],
            f"cli_update: the collapsed date, and only it, must quarantine: "
            f"{g['quarantined']}")
    require(g["guard_delta"] == {"served": T - T0, "quarantined": 1},
            f"cli_update: the manifest's guard summary must count the one "
            f"quarantined date: {g['guard_delta']}")
    require(all(x["health"] == x["health_recomputed"] == x["record"]["health"]
                for x in (p, g)),
            f"cli_update: the health verdict is not evaluate_health's: "
            f"{[(x['health'], x['health_recomputed']) for x in (p, g)]}")
    return res


def cli_demo_phase(ctx) -> dict:
    """Phase cli_demo: ``demo --dates 1390 --stocks 300 --industries 31
    --styles 10 --eigen-sims 100 --check-determinism`` through
    ``cli.main``: deterministic, and its tables bit for bit
    ``run_risk_pipeline`` on ``synthetic_barra_table`` of the same
    arguments."""
    from mfm_tpu_torch import PipelineConfig, RiskModelConfig
    from mfm_tpu_torch import run_risk_pipeline
    from mfm_tpu_torch.data.synthetic import synthetic_barra_table
    from mfm_tpu_torch.ops.eigh_cuda import launch_counts, reset_launches

    T, N, P, Q = ctx["shape"]
    out = os.path.join(ctx["cli"]["dir"], "demo")
    reset_launches()
    (code, txt, _), wall = timed(lambda: cli_call(
        ["demo", "--dates", T, "--stocks", N, "--industries", P, "--styles",
         Q, "--eigen-sims", 100, "--check-determinism", "--out", out]))
    launches = launch_counts()
    require(code == 0, f"cli_demo: exit {code}")
    rec = json.loads(txt.splitlines()[-1])
    table, _ = synthetic_barra_table(T=T, N=N, P=P, Q=Q, seed=0)
    want = run_risk_pipeline(table, config=PipelineConfig(
        risk=RiskModelConfig(eigen_n_sims=100)), device=ctx["device"])
    equal = tables_equal(out, want.outputs, want.arrays)
    res = {"record": rec, "process_wall_s": wall, "launches": launches,
           "tables_bitwise": equal}
    emit("cli_demo", **res)
    require(rec["deterministic"] is True, "cli_demo: not deterministic")
    require(all(equal.values()), f"cli_demo: a table is not "
            f"run_risk_pipeline's: {equal}")
    require(launches["jacobi_eigh_weighted/warp"] == 3
            and launches["jacobi_eigh/block"] == 0,
            f"cli_demo: three runs, one weighted launch each: {launches}")
    return res


def cli_factors_phase(ctx) -> dict:
    """Phase cli_factors: bench config 3's raw panel written as a long csv
    (with its index prices and industry map) through ``factors --panel
    --index --industry`` (``cli.main``, float32): ``barra_data.csv`` bit
    for bit ``run_factor_pipeline`` on the panel read from the same csv,
    and its factors within the ``factors`` budgets of the float64 run."""
    import csv

    import numpy as np

    from mfm_tpu_torch import PipelineConfig, run_factor_pipeline
    from mfm_tpu_torch.cli import _read_long_table, _reindex
    from mfm_tpu_torch.data.csvio import read_csv, write_csv
    from mfm_tpu_torch.data.synthetic import PANEL_META_KEYS
    from mfm_tpu_torch.panel import Panel

    data, dev = _factor_panel(ctx), ctx["device"]
    d = os.path.join(ctx["cli"]["dir"], "factors")
    os.makedirs(d, exist_ok=True)
    T, N = data["close"].shape
    days = np.asarray(data["dates"]).astype("datetime64[D]")
    ed = data["end_date_code"].astype(np.float64)
    ed[ed < 0] = np.nan
    long = {"trade_date": np.repeat(days, N),
            "ts_code": np.tile(data["stocks"], T),
            **{k: np.asarray(v).reshape(-1) for k, v in data.items()
               if k not in PANEL_META_KEYS},
            "end_date": (20_000_000 + ed).reshape(-1)}
    paths = {k: os.path.join(d, f"{k}.csv") for k in ("panel", "index",
                                                      "industry")}
    _, write_s = timed(lambda: write_csv(paths["panel"], long))
    write_csv(paths["index"], {"trade_date": days,
                               "close": data["index_close"]})
    write_csv(paths["industry"], {
        "ts_code": data["stocks"],
        "l1_code": np.array([f"sw{c:02d}" for c in data["industry"]])})
    out = os.path.join(d, "out")
    (code, txt, _), cli_s = timed(lambda: cli_call(
        ["factors", "--panel", paths["panel"], "--index", paths["index"],
         "--industry", paths["industry"], "--out", out]))
    require(code == 0, f"cli_factors: exit {code}")
    rec = json.loads(txt.splitlines()[-1])

    p, read_s = timed(lambda: Panel.from_long(
        _read_long_table(paths["panel"])))
    index = read_csv(paths["index"], parse_dates=("trade_date",))
    ind = read_csv(paths["industry"])
    e = p.fields.pop("end_date")
    ok = np.isfinite(e)
    rid = np.full(e.shape, -1, np.int32)
    rid[ok] = np.searchsorted(np.unique(e[ok]), e[ok])
    p.fields["end_date_code"] = rid
    args = (p.fields, _reindex(index["trade_date"], index["close"], p.dates),
            _reindex(ind["ts_code"], ind["l1_code"], p.stocks), p.dates,
            p.stocks)
    table, factors = run_factor_pipeline(*args, PipelineConfig(), device=dev)
    _, f64 = run_factor_pipeline(*args, PipelineConfig(dtype="float64"),
                                 device=dev)
    budget = _factor_records(factors, {k: f64[k] for k in factors},
                             ctx["factor_budget"])
    with open(os.path.join(out, "barra_data.csv"), newline="") as fh:
        header, *rows = list(csv.reader(fh))
    text = ("date", "stocknames", "industry")
    got = {k: [r[j] for r in rows] for j, k in enumerate(header)}
    bitwise = (header == list(table)
               and got["date"] == [str(x) for x in np.asarray(
                   table["date"]).astype("datetime64[D]")]
               and got["stocknames"] == table["stocknames"].tolist()
               and got["industry"] == table["industry"].tolist()
               and all(np.array_equal(
                   np.array([float(c) if c else np.nan for c in got[k]]),
                   np.asarray(table[k], np.float64), equal_nan=True)
                   for k in header if k not in text))
    res = {"rows": rec["rows"], "panel_rows": T * N, "csv_write_s": write_s,
           "cli_wall_s": cli_s, "panel_read_in_process_s": read_s,
           "barra_bitwise": bitwise, "budget_max_rel": budget["max_rel"],
           "budget_failed": budget["failed"]}
    emit("cli_factors", **res)
    require(rec["rows"] == len(table["date"]) and bitwise,
            "cli_factors: barra_data.csv is not run_factor_pipeline's on "
            "the panel read from the same csv")
    require(not budget["failed"], f"cli_factors: outside the factors "
            f"budgets of float64: {budget['failed']}")
    return res


CLI_SPECS = [{"name": "replay-window", "replay": ["2024-01-02",
                                                  "2024-02-01"]},
             {"name": "cf-quarantine", "flip_quarantine": ["2024-03-01"]}]


def _without(obj, key):
    """``obj`` (a JSON tree) with every ``key`` entry dropped."""
    if isinstance(obj, dict):
        return {k: _without(v, key) for k, v in obj.items() if k != key}
    if isinstance(obj, list):
        return [_without(v, key) for v in obj]
    return obj


def cli_scenario_phase(ctx) -> dict:
    """Phase cli_scenario: on phase cli_risk's guarded checkpoint,
    ``scenario run`` with the three presets, a replay and a counterfactual
    (the CLI's engine holds no history, so those two are rejected, as the
    reference's are) and ``scenario sweep`` at its defaults (65,536
    uniform scenarios, chunks of 8,192, the refinement), through
    ``cli.main``: each manifest, its summary block aside, the in-process
    ``ScenarioEngine`` / ``SweepEngine`` on the same checkpoint bit for
    bit; ``doctor --scenarios`` exits 0; the PSD gate's launches."""
    import numpy as np

    from mfm_tpu_torch.data.artifacts import load_risk_state
    from mfm_tpu_torch.grad import ShockBall
    from mfm_tpu_torch.ops.eigh_cuda import launch_counts, reset_launches
    from mfm_tpu_torch.scenario import (
        PRESETS,
        ScenarioEngine,
        ScenarioSpec,
        SweepEngine,
        UniformSampler,
        build_scenario_manifest,
        build_sweep_manifest,
    )

    dev, ck = ctx["device"], ctx["cli"]["ck"]
    ckdir = os.path.dirname(ck)
    spec_path = os.path.join(ctx["cli"]["dir"], "specs.json")
    with open(spec_path, "w") as fh:
        json.dump(CLI_SPECS, fh)
    names = sorted(PRESETS)
    reset_launches()
    (code, _, _), run_s = timed(lambda: cli_call(
        ["scenario", "run", ck, *(a for n in names for a in ("--preset", n)),
         "--spec", spec_path]))
    run_launches = launch_counts()
    require(code == 0, f"cli_scenario run: exit {code}")
    reset_launches()
    (code, _, _), sweep_s = timed(lambda: cli_call(["scenario", "sweep", ck]))
    sweep_launches = launch_counts()
    require(code == 0, f"cli_scenario sweep: exit {code}")
    doctor_rc, _, _ = cli_call(["doctor", ckdir, "--scenarios"])

    st, meta = load_risk_state(ck, dev)
    eng = ScenarioEngine.from_risk_state(st, meta, device=dev)
    specs = [PRESETS[n] for n in names] + [ScenarioSpec.from_dict(s)
                                           for s in CLI_SPECS]
    results = eng.run(specs)
    want_run = build_scenario_manifest(
        results, eng.factor_names, stamp_json=meta.get("stamp"),
        backend=torch.device(dev).type, summary={}, staleness=eng.staleness)
    sw = SweepEngine.from_risk_state(st, meta, device=dev)
    W = np.full((1, sw.K), 1.0 / sw.K)
    ball = ShockBall(shift_max=0.01, scale_range=0.5, vol_mult_hi=3.5,
                     corr_beta_hi=0.95)
    result = sw.sweep(W, UniformSampler(ball, sw.K, 65536, seed=0),
                      chunk=8192, top_k=16, bins=64, hist_span=8.0,
                      ball=ball, refine={"seed": 0})
    want_sweep = build_sweep_manifest(
        result, stamp_json=meta.get("stamp"), backend=torch.device(dev).type,
        staleness=sw.staleness, dominance=sw.preset_dominance(result, W),
        summary={})
    got = {}
    for name in ("scenario_manifest.json", "sweep_manifest.json"):
        with open(os.path.join(ckdir, name)) as fh:
            got[name] = _without(json.load(fh), "summary")
    same_run = got["scenario_manifest.json"] == _without(
        json.loads(json.dumps(want_run)), "summary")
    same_sweep = got["sweep_manifest.json"] == _without(
        json.loads(json.dumps(want_sweep)), "summary")
    man = got["scenario_manifest.json"]
    res = {"run_wall_s": run_s, "sweep_wall_s": sweep_s,
           "n_ok": man["n_ok"], "n_rejected": man["n_rejected"],
           "n_psd_projected": man["n_psd_projected"],
           "sweep_counts": got["sweep_manifest.json"]["sweep"]["counts"],
           "run_bitwise": same_run, "sweep_bitwise": same_sweep,
           "doctor_scenarios_rc": doctor_rc,
           "run_launches": run_launches, "sweep_launches": sweep_launches}
    emit("cli_scenario", **res)
    require(same_run and same_sweep, "cli_scenario: a manifest is not the "
            "in-process engine's")
    require(man["n_ok"] == len(names) and man["n_rejected"] == 2,
            f"cli_scenario: the presets must run and the replay and "
            f"counterfactual be rejected: {man['n_ok']}, {man['n_rejected']}")
    require(doctor_rc == 0, "cli_scenario: doctor --scenarios failed")
    require(run_launches["jacobi_eigh/warp"] >= 1
            and run_launches["jacobi_eigh/block"] == 0,
            f"cli_scenario: the PSD gate did not run on the warp kernel: "
            f"{run_launches}")
    ctx["cli_launches"] = {"scenario_run": run_launches,
                           "scenario_sweep": sweep_launches}
    return res


def cli_grad_phase(ctx) -> dict:
    """Phase cli_grad: on the same checkpoint, ``grad reverse`` (64
    books), ``grad sensitivity`` (identity and the presets) and ``grad
    construct min_vol`` (100 books) through ``cli.main``: each
    ``grad_report.json`` the in-process ``GradEngine`` on the same inputs,
    bit for bit; the launches of each."""
    import numpy as np

    from mfm_tpu_torch.data.artifacts import load_risk_state
    from mfm_tpu_torch.grad import GradEngine, ShockBall
    from mfm_tpu_torch.grad.engine import REVERSE_STEPS
    from mfm_tpu_torch.grad.report import build_grad_report
    from mfm_tpu_torch.ops.eigh_cuda import launch_counts, reset_launches
    from mfm_tpu_torch.scenario import PRESETS, ScenarioSpec

    dev, ck, d = ctx["device"], ctx["cli"]["ck"], ctx["cli"]["dir"]
    st, meta = load_risk_state(ck, dev)
    ge = GradEngine.from_risk_state(st, meta, device=dev)
    K = ge.K
    rng = np.random.default_rng(12)
    books = {"reverse": (0.2 * rng.standard_normal((64, K))).round(6),
             "construct": np.abs(rng.standard_normal((100, K))).round(6)}
    for k, W in books.items():
        with open(os.path.join(d, f"books_{k}.json"), "w") as fh:
            json.dump(W.tolist(), fh)
    stamp = dict(stamp_json=meta.get("stamp"),
                 backend=torch.device(dev).type, staleness=ge.staleness)

    def want_reverse():
        ball = ShockBall(vol_mult_hi=3.5, corr_beta_hi=0.95)
        return build_grad_report(
            "reverse_stress", ge.reverse_stress(books["reverse"], ball=ball,
                                                steps=REVERSE_STEPS),
            params={"ball": ball.to_dict(), "steps": REVERSE_STEPS}, **stamp)

    def want_sensitivity():
        W = np.full(K, 1.0 / K)
        specs = [ScenarioSpec.identity()] + [PRESETS[n]
                                             for n in sorted(PRESETS)]
        return build_grad_report("sensitivity", ge.sensitivities(specs, W),
                                 params={"portfolio": W.tolist()}, **stamp)

    def want_construct():
        r = ge.construct_solve("min_vol", books["construct"])
        entries = [{"label": f"p{i}", "solver": "min_vol",
                    "weights": {str(n): float(v) for n, v in
                                zip(ge.factor_names, r["weights"][i])},
                    "total_vol": float(r["vols"][i]),
                    "diag": (np.asarray(r["diag"][i]).tolist()
                             if np.asarray(r["diag"][i]).ndim
                             else float(r["diag"][i]))}
                   for i in range(len(books["construct"]))]
        return build_grad_report("construct", entries,
                                 params={"solver": "min_vol"}, **stamp)

    res, launches = {}, {}
    for name, argv, want in (
            ("reverse", ["reverse", "--portfolio",
                         os.path.join(d, "books_reverse.json")],
             want_reverse),
            ("sensitivity", ["sensitivity"], want_sensitivity),
            ("construct", ["construct", "min_vol", "--portfolio",
                           os.path.join(d, "books_construct.json")],
             want_construct)):
        out = os.path.join(d, f"grad_{name}")
        reset_launches()
        (code, _, _), wall = timed(lambda: cli_call(["grad", argv[0], ck,
                                                  *argv[1:], "--out", out]))
        launches[name] = launch_counts()
        require(code == 0, f"cli_grad {name}: exit {code}")
        with open(os.path.join(out, "grad_report.json")) as fh:
            got = json.load(fh)
        res[name] = {"wall_s": wall, "entries": len(got["entries"]),
                     "bitwise": got == json.loads(json.dumps(want())),
                     "launches": launches[name]}
    emit("cli_grad", **res)
    require(all(r["bitwise"] for r in res.values()),
            f"cli_grad: a report is not the in-process GradEngine's: "
            f"{ {k: r['bitwise'] for k, r in res.items()} }")
    require(res["reverse"]["entries"] == 64
            and res["construct"]["entries"] == 100,
            "cli_grad: the reports hold the wrong number of books")
    require(launches["reverse"]["jacobi_eigh/warp"] >= 1
            and launches["reverse"]["jacobi_eigh/block"] == 0,
            f"cli_grad reverse: eigh_diff did not run on the warp kernel: "
            f"{launches['reverse']}")
    ctx["cli_launches"].update({f"grad_{k}": v for k, v in launches.items()})
    return res


# -- the mesh: virtual ('date', 'stock') meshes over the card ------------------

#: the devices the mesh section's meshes draw on: the card, repeated
#: (``MFM_TORCH_VIRTUAL_DEVICES``); every mesh here is virtual, its shards
#: separate tensors on cuda:0, computed one after another
MESH_DEVICES = 8
#: the meshes ``run_fused`` runs on (4x2 pads 2 dates, 1390 -> 1392) and
#: the timed repetitions of each, 2x2's in turns with the unsharded run;
#: 4x2's cut to one, the smoke's room
MESH_SHAPES = ((2, 2), (4, 2))
MESH_WALL_REPS = {(2, 2): 3, (4, 2): 1}
#: the serving split of ``mesh_serve``: the fault geometry's history, then
#: two 4-date slabs
MESH_SERVE_T0, MESH_SLAB = 1378, 4
#: the sharded sweep's chunks of SWEEP_CHUNK scenarios
MESH_SWEEP_CHUNKS = 16


class recorded_launches:
    """Within the block, every launch of either kernel's wrapper records a
    copy of its inputs (the dispatchers import the wrappers when they
    call them), so each launch can be held against its plain version at
    its own shape afterwards (:func:`hold_recorded`)."""

    def __enter__(self):
        from mfm_tpu_torch.ops import eigh_cuda

        self.mod, self.calls = eigh_cuda, []
        self.full = eigh_cuda.jacobi_eigh_cuda
        self.weighted = eigh_cuda.jacobi_eigh_weighted_diag_cuda

        def full(A, sweeps=None, canonical_signs=True, sort=True):
            self.calls.append(("full", A.clone(), None, sweeps))
            return self.full(A, sweeps=sweeps,
                             canonical_signs=canonical_signs, sort=sort)

        def weighted(A, d0, sweeps=None):
            self.calls.append(("weighted", A.clone(), d0.clone(), sweeps))
            return self.weighted(A, d0, sweeps=sweeps)

        eigh_cuda.jacobi_eigh_cuda = full
        eigh_cuda.jacobi_eigh_weighted_diag_cuda = weighted
        return self.calls

    def __exit__(self, *exc):
        self.mod.jacobi_eigh_cuda = self.full
        self.mod.jacobi_eigh_weighted_diag_cuda = self.weighted


def hold_recorded(calls, where: str) -> dict:
    """Every recorded launch held against the kernel's plain version on its
    own inputs, at its shard's shape: the weighted kernel's w bitwise and
    h within 1e-4 per matrix, the full kernel's w and V bitwise, NaN in
    the same places (a mesh-padded date has no stock, so its regression
    and Newey-West give NaN, which the kernels carry and the crop drops;
    errors are over finite entries).  The first launch of each shape is
    also timed (CUDA events, the warp design) beside its bound.  Emits
    ``{where}_check``."""
    from mfm_tpu_torch.ops import eigh as E
    from mfm_tpu_torch.ops.eigh_cuda import (
        _launch_eigh,
        _launch_weighted,
        jacobi_eigh_cuda,
        jacobi_eigh_weighted_diag_cuda,
    )

    held, shapes = [], {}
    for kind, A, d0, sweeps in calls:
        B, n = A.shape[0], A.shape[-1]
        sw = sweeps if sweeps is not None else E._sweeps_for(n, A.dtype)
        key = f"{kind} ({B}, {n}, {n}), {sw}"
        if kind == "weighted":
            w, h = jacobi_eigh_weighted_diag_cuda(A, d0, sweeps=sw)
            wp, hp = E.jacobi_eigh_weighted_diag_slots(A, d0, sw)
            rows = torch.isfinite(hp).all(dim=1)
            ok = same(w, wp) and torch.equal(torch.isfinite(h),
                                             torch.isfinite(hp)) \
                and rel_per_matrix(h[rows], hp[rows]) <= 1e-4
            err = max(max_abs_diff(w, wp), max_abs_diff(h, hp))
            if key not in shapes:
                b = weighted_kernel_bound(B, n, sw)
                shapes[key] = {"ms": time_ms(lambda: _launch_weighted(
                    A, d0, sw, "warp"), 3), "bound_ms": b["bound_ms"],
                    "bound_by": b["bound_by"]}
        else:
            w, V = jacobi_eigh_cuda(A, sweeps=sw, sort=False,
                                    canonical_signs=False)
            wp, Vp = E.jacobi_eigh_slots(A, sw)
            ok = same(w, wp) and same(V, Vp)
            err = max(max_abs_diff(w, wp), max_abs_diff(V, Vp))
            if key not in shapes:
                b = full_kernel_bound(B, n, sw)
                shapes[key] = {"ms": time_ms(lambda: _launch_eigh(
                    A, sw, "warp"), 10), "bound_ms": b["bound_ms"],
                    "bound_by": b["bound_by"]}
        held.append({"shape": key, "ok": ok, "max_abs_err": err})
        del w, wp
    calls.clear()
    res = {"launches_held": len(held), "all_ok": all(h["ok"] for h in held),
           "max_abs_err": {k: max(h["max_abs_err"] for h in held
                                  if h["shape"] == k) for k in shapes},
           "shard_shapes": shapes}
    emit(f"{where}_check", **res)
    require(res["all_ok"], f"{where}: a kernel launch disagrees with its "
            f"plain version at its shard's shape: {held}")
    return res


def shard_launches(what: str, want_weighted: dict, want_full: dict) -> dict:
    """The launches since the last reset, by kernel and batch: exactly
    ``want_weighted`` / ``want_full`` (``{B: launches}``), all of the warp
    design."""
    from mfm_tpu_torch.ops.eigh_cuda import launch_counts, launch_shapes

    counts, shapes = launch_counts(), launch_shapes()
    by_b = {k: {} for k in shapes}
    for kernel, per in shapes.items():
        for (B, _, _), c in per.items():
            by_b[kernel][B] = by_b[kernel].get(B, 0) + c
    got = {"jacobi_eigh_weighted": by_b["jacobi_eigh_weighted"],
           "jacobi_eigh": by_b["jacobi_eigh"]}
    require(got == {"jacobi_eigh_weighted": want_weighted,
                    "jacobi_eigh": want_full}
            and counts["jacobi_eigh/block"] == 0
            and counts["jacobi_eigh_weighted/block"] == 0,
            f"{what}: launches by batch {got}, want weighted "
            f"{want_weighted} and full {want_full}, the warp design only")
    return counts


def _merge(*pairs) -> dict:
    out = {}
    for B, c in pairs:
        out[B] = out.get(B, 0) + c
    return out


def mesh_expected(mesh, Tp: int, M: int) -> tuple:
    """The launches, by batch, of a sharded rebuild over Tp (mesh-padded)
    dates with the eigen stage unchunked: the weighted kernel once a shard
    on its contiguous date block (the dates padded to the mesh's size),
    the full kernel once a date row (the pseudo-inverse) and once for the
    F0 eigh over every date."""
    nd = mesh.shape["date"]
    Te = Tp + (-Tp) % mesh.size
    return ({Te // mesh.size * M: mesh.size},
            _merge((Tp // nd, nd), (Tp, 1)))


def mesh_run_fused_phase(ctx) -> dict:
    """Phase mesh_run_fused: config 1 at CSI300 width on virtual 2x2 and
    4x2 meshes of the card (4x2 pads 2 dates): the nine fields bitwise
    the unsharded run at the same shapes, and cropped, the main path's;
    the launches per kernel and batch as the sharding gives them (the
    weighted kernel once a shard, the full one once a date row and once
    for F0), each held against its plain version at its shard's shape;
    walls (median of 3 on 2x2, in turns with the unsharded run; one run
    on 4x2), recorded, not claimed."""
    from mfm_tpu_torch import RiskModel
    from mfm_tpu_torch.ops.eigh_cuda import reset_launches
    from mfm_tpu_torch.parallel.mesh import (
        make_mesh,
        pad_to_mesh,
        shard_panel,
        use_mesh,
    )

    sim_covs, T, M = ctx["sim_covs"], ctx["T"], ctx["M"]
    cfg, P, main = ctx["config"], ctx["P"], ctx["fused_out"]
    panel = tuple(torch.as_tensor(p).to(ctx["device"]) for p in ctx["panel"])

    def run(*panels):
        return RiskModel(*panels, n_industries=P, config=cfg).run_fused(
            sim_covs=sim_covs, sim_length=T)

    res, plain_walls = {}, []
    ctx["mesh_launches"] = {}
    for nd, ns in MESH_SHAPES:
        mesh = make_mesh(nd, ns, device=ctx["device"])
        tag = f"{nd}x{ns}"
        padded = tuple(pad_to_mesh(p, mesh) for p in panel)
        Tp = padded[0].shape[0]
        base = main if Tp == T else run(*padded)
        sharded = shard_panel(padded, mesh)

        def sharded_run():
            with use_mesh(mesh):
                return run(*sharded)

        sync()
        reset_launches()
        with recorded_launches() as calls:
            out = sharded_run()
        sync()
        launches = shard_launches(f"mesh_run_fused {tag}",
                                  *mesh_expected(mesh, Tp, M))
        ctx["mesh_launches"][f"run_fused_{tag}"] = launches
        held = hold_recorded(calls, f"mesh_run_fused_{tag}")
        walls = []
        for _ in range(MESH_WALL_REPS[(nd, ns)]):
            if (nd, ns) == MESH_SHAPES[0]:
                plain_walls.append(timed(lambda: run(*panel))[1])
            walls.append(timed(sharded_run)[1])
        rec = {**mesh.describe(), "padded_shape": list(padded[0].shape),
               "vs_unsharded": compare_rows(out, base),
               "cropped_vs_main_path": compare_rows(suffix(out, 0, T), main),
               "launches": launches, "held": held["launches_held"],
               "shard_shapes": held["shard_shapes"],
               "wall_median_s": statistics.median(walls), "walls_s": walls}
        res[tag] = rec
        require(rec["vs_unsharded"]["bitwise"]
                and rec["cropped_vs_main_path"]["bitwise"],
                f"mesh_run_fused {tag}: not bitwise the unsharded run: "
                f"{rec['vs_unsharded']}")
        del out, base, sharded, padded
        torch.cuda.empty_cache()
    res.update(unsharded_wall_median_s=statistics.median(plain_walls),
               unsharded_walls_s=plain_walls)
    emit("mesh_run_fused", **res)
    return res


def mesh_serve_phase(ctx) -> dict:
    """Phase mesh_serve: ``init_state`` over the first 1378 dates (guarded),
    then two 4-date slabs through ``update_guarded`` on a virtual 2x2
    mesh: outputs, guard report and every carry leaf bitwise the
    unsharded updates', each launch held at its shard's shape; after the
    first (warmup) update the second adds no compile-contract event."""
    from mfm_tpu_torch import RiskModel, RiskModelConfig
    from mfm_tpu_torch.config import QuarantinePolicy
    from mfm_tpu_torch.models.risk_model import MIN_REGRESSION_DATES
    from mfm_tpu_torch.ops.eigh_cuda import reset_launches
    from mfm_tpu_torch.parallel.mesh import make_mesh, shard_panel, use_mesh
    from mfm_tpu_torch.utils.contracts import count_compiles

    panel, T, M, P = ctx["panel"], ctx["T"], ctx["M"], ctx["P"]
    cfg = RiskModelConfig(eigen_sim_length=T,
                          quarantine=QuarantinePolicy(enabled=True))
    T0, S = MESH_SERVE_T0, MESH_SLAB
    mesh = make_mesh(2, 2, device=ctx["device"])

    def slab(k):
        return tuple(p[T0 + k * S:T0 + (k + 1) * S] for p in panel)

    _, state0 = RiskModel(*(p[:T0] for p in panel), n_industries=P,
                          config=cfg).init_state()
    plain, sharded, res = state0, state0, {**mesh.describe()}
    for k in range(2):
        b_out, b_rep, plain = RiskModel(
            *slab(k), n_industries=P, config=cfg).update_guarded(plain)
        sync()
        reset_launches()
        with count_compiles() as events, recorded_launches() as calls:
            with use_mesh(mesh):
                s_out, s_rep, sharded = RiskModel(
                    *shard_panel(slab(k), mesh), n_industries=P,
                    config=cfg).update_guarded(sharded)
            sync()
        # the regression pads a 2-date shard to 16 dates; the eigen stage
        # runs one date a shard
        launches = shard_launches(
            f"mesh_serve slab {k}", {M: 4},
            _merge((MIN_REGRESSION_DATES, 2), (S, 1)))
        ctx["mesh_launches"][f"serve_update_guarded_{k}"] = launches
        held = hold_recorded(calls, f"mesh_serve_{k}")
        rec = {"outputs": compare_rows(s_out, b_out),
               "report": all(same(getattr(s_rep, f), getattr(b_rep, f))
                             for f in b_rep._fields),
               "carries": compare_carries(sharded, plain, guard=True),
               "compile_events": events.count, "launches": launches,
               "shard_shapes": held["shard_shapes"]}
        res[f"slab{k}"] = rec
        require(rec["outputs"]["bitwise"] and rec["report"]
                and rec["carries"]["bitwise"],
                f"mesh_serve slab {k}: the sharded update is not bitwise "
                f"the unsharded one: {rec}")
    require(res["slab1"]["compile_events"] == 0,
            f"mesh_serve: {res['slab1']['compile_events']} compile-contract "
            "events after the warmup update")
    emit("mesh_serve", **res)
    return res


def mesh_pipeline_phase(ctx) -> dict:
    """Phase mesh_pipeline: ``run_risk_pipeline(mesh=2x2)`` on the
    398,228-row CSI300 table, each shard's block densified from the row
    space: bitwise the dense run (phase pipeline_run's), its
    ``LazyBarraArrays`` still undensified after it; then
    ``append_risk_pipeline(mesh=2x2)`` from a 1350-date checkpoint to
    1390, bitwise the unsharded append, outputs and carries; every launch
    held at its shard's shape."""
    import numpy as np

    from mfm_tpu_torch import (
        PipelineConfig,
        append_risk_pipeline,
        run_risk_pipeline,
        save_pipeline_state,
    )
    from mfm_tpu_torch.models.risk_model import MIN_REGRESSION_DATES
    from mfm_tpu_torch.ops.eigh_cuda import reset_launches
    from mfm_tpu_torch.parallel.mesh import make_mesh

    table, sim_covs, T, M = ctx["table"], ctx["sim_covs"], ctx["T"], ctx["M"]
    dense, cfg = ctx["pipeline"], PipelineConfig()
    mesh = make_mesh(2, 2, device=ctx["device"])
    inject = dict(sim_covs=sim_covs, sim_length=T, device=ctx["device"])
    sync()
    reset_launches()
    with recorded_launches() as calls:
        got, wall = timed(lambda: run_risk_pipeline(table, config=cfg,
                                                    mesh=mesh, **inject))
    launches = shard_launches("mesh_pipeline", *mesh_expected(mesh, T, M))
    ctx["mesh_launches"]["pipeline"] = launches
    res = {**mesh.describe(), "run": {
        "vs_dense": compare_rows(got.outputs, dense.outputs),
        "undensified": not got.arrays.densified, "wall_s": wall,
        "launches": launches,
        "shard_shapes": hold_recorded(calls, "mesh_pipeline_run")[
            "shard_shapes"]}}
    require(res["run"]["vs_dense"]["bitwise"] and res["run"]["undensified"],
            f"mesh_pipeline: the shard-local run is not bitwise the dense "
            f"one, or densified its table: {res['run']}")
    del got
    T0 = SERVE_T0
    dates = np.unique(table["date"])
    head = {k: v[table["date"] < dates[T0]] for k, v in table.items()}
    first = run_risk_pipeline(head, config=cfg, with_state=True, **inject)
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, d, "state.npz") for d in ("a", "b")]
        for p in paths:
            save_pipeline_state(p, first)
        plain = append_risk_pipeline(paths[0], table, config=cfg,
                                     device=ctx["device"])
        sync()
        reset_launches()
        with recorded_launches() as calls:
            app, wall = timed(lambda: append_risk_pipeline(
                paths[1], table, config=cfg, mesh=mesh))
    # 40 dates: two 20-date rows regress, each shard's eigen block is 10
    A = T - T0
    launches = shard_launches(
        "mesh_pipeline append", {(A + (-A) % 4) // 4 * M: 4},
        _merge((max(A // 2, MIN_REGRESSION_DATES), 2), (A, 1)))
    ctx["mesh_launches"]["append"] = launches
    res["append"] = {
        "appended": len(app.arrays.dates),
        "vs_unsharded": compare_rows(app.outputs, plain.outputs),
        "carries": compare_carries(app.state, plain.state),
        "wall_s": wall, "launches": launches,
        "shard_shapes": hold_recorded(calls, "mesh_pipeline_append")[
            "shard_shapes"]}
    emit("mesh_pipeline", **res)
    a = res["append"]
    require(a["appended"] == T - T0 and a["vs_unsharded"]["bitwise"]
            and a["carries"]["bitwise"],
            f"mesh_pipeline: the sharded append is not bitwise the "
            f"unsharded one: {a}")
    return res


def mesh_cli_start(ctx) -> tuple:
    """Start phase mesh_cli's subprocess, ``python -m mfm_tpu_torch.cli
    risk --update --mesh 2x2`` on the card (``MFM_TORCH_VIRTUAL_DEVICES=4``)
    from phase cli_update's 1350-date checkpoint over the whole csv; it
    runs while the section's later phases do.  Returns (process, start)."""
    from mfm_tpu_torch._device import VIRTUAL_DEVICES_ENV

    c = ctx["cli"]
    env = {**os.environ, VIRTUAL_DEVICES_ENV: "4"}
    cmd = [sys.executable, "-m", "mfm_tpu_torch.cli", "risk", "--barra",
           c["csv"], "--out", os.path.join(c["dir"], "upd_mesh"), "--update",
           c["mesh_ck"], "--mesh", "2x2", "--eigen-sim-length",
           str(ctx["T"])]
    return (subprocess.Popen(cmd, cwd=str(ROOT), stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True, env=env),
            time.perf_counter())


def mesh_cli_phase(ctx, started) -> dict:
    """Phase mesh_cli: the subprocess :func:`mesh_cli_start` started, to
    its end: each table bit for bit the in-process full run's last 40
    dates, its checkpoint's carries bitwise the unsharded ``--update``'s;
    its launches (the weighted kernel once a shard).  Its shard shapes are
    phase mesh_pipeline's append's, held there."""
    import numpy as np

    from mfm_tpu_torch.data.artifacts import load_artifact

    c, T = ctx["cli"], ctx["T"]
    d, full = c["dir"], c["result"]
    out, ck = os.path.join(d, "upd_mesh"), c["mesh_ck"]
    proc, t0 = started
    stdout, stderr = proc.communicate(timeout=600)
    process_s = time.perf_counter() - t0
    require(proc.returncode == 0, f"mesh_cli: exit {proc.returncode}: "
            f"{stderr[-2000:]}")
    rec = json.loads(stdout.strip().splitlines()[-1])
    launches = rec["kernels"]["launches"]
    ctx["mesh_launches"]["cli_update_subprocess"] = launches
    got, _ = load_artifact(ck)
    want, _ = load_artifact(os.path.join(d, "ck_plain", "state.npz"))
    res = {"mesh": "2x2", "virtual": True, "devices": ["cuda:0"] * 4,
           "process_s": process_s, "update_wall_s": rec["update_wall_s"],
           "appended": len(rec["appended_dates"]), "launches": launches,
           "tables_vs_full": tables_equal(out, full.outputs, full.arrays,
                                          rows=slice(SERVE_T0, None)),
           "checkpoint_vs_unsharded": sorted(got) == sorted(want) and all(
               np.array_equal(got[k], want[k], equal_nan=True)
               for k in want)}
    emit("mesh_cli", **res)
    require(res["appended"] == T - SERVE_T0
            and all(res["tables_vs_full"].values())
            and res["checkpoint_vs_unsharded"],
            f"mesh_cli: the sharded --update is not bitwise the in-process "
            f"run: {res}")
    require(launches["jacobi_eigh_weighted/warp"] == 4
            and launches["jacobi_eigh/warp"] >= 3
            and launches["jacobi_eigh/block"] == 0
            and launches["jacobi_eigh_weighted/block"] == 0,
            f"mesh_cli: the subprocess's launches {launches}, want the "
            "weighted kernel once a shard (4)")
    return res


def mesh_sweep_phase(ctx) -> dict:
    """Phase mesh_sweep: ``SweepEngine(mesh=2x2)`` on bench config
    sweep's case, 16 chunks of 8,192 scenarios, each chunk's lanes split
    over the four shards: the books, counts and histogram bitwise the
    unsharded sweep's; the offender flushes' launches (the full kernel,
    unsharded) held."""
    from mfm_tpu_torch.ops.eigh_cuda import launch_counts, reset_launches
    from mfm_tpu_torch.parallel.mesh import make_mesh
    from mfm_tpu_torch.scenario import SweepEngine, UniformSampler

    cov, names, xs, ball = sweep_case()
    K, chunk = len(names), SWEEP_CHUNK
    n = MESH_SWEEP_CHUNKS * chunk
    mesh = make_mesh(2, 2, device=ctx["device"])
    plain_eng = SweepEngine(cov, factor_names=names, device=ctx["device"])
    eng = SweepEngine(cov, factor_names=names, mesh=mesh)
    want, plain_s = timed(lambda: plain_eng.sweep(
        xs, UniformSampler(ball, K, n, seed=5), chunk=chunk))
    sync()
    reset_launches()
    with recorded_launches() as calls:
        got, wall = timed(lambda: eng.sweep(
            xs, UniformSampler(ball, K, n, seed=5), chunk=chunk))
    launches = launch_counts()
    ctx["mesh_launches"]["sweep"] = launches
    held = hold_recorded(calls, "mesh_sweep")
    res = {**mesh.describe(), "scenarios": n,
           "bitwise": json.dumps(got.to_dict(), sort_keys=True)
           == json.dumps(want.to_dict(), sort_keys=True),
           "counts": got.counts, "wall_s": wall, "unsharded_wall_s": plain_s,
           "launches": launches, "shard_shapes": held["shard_shapes"]}
    emit("mesh_sweep", **res)
    require(res["bitwise"], "mesh_sweep: the sharded sweep is not bitwise "
            "the unsharded one")
    require(launches["jacobi_eigh_weighted/warp"] == 0
            and launches["jacobi_eigh/block"] == 0,
            f"mesh_sweep: launches {launches}")
    return res


def distributed_phase(ctx) -> dict:
    """Phase distributed: ``parallel.distributed.initialize`` over NCCL
    with one process (TCP on 127.0.0.1 at a free port), then
    ``make_global_mesh`` (virtual, 4x2) and ``process_date_slice``; one
    ``all_reduce`` and one ``all_gather_into_tensor`` on the card, a
    date-sharded vector through the mesh's gather; the group destroyed."""
    import socket

    import torch.distributed as dist

    from mfm_tpu_torch.parallel.distributed import (
        initialize,
        make_global_mesh,
        process_date_slice,
    )
    from mfm_tpu_torch.parallel.mesh import P, NamedSharding, gather
    from mfm_tpu_torch.parallel.mesh import make_sharded

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    dev = ctx["device"]
    multi = initialize(f"127.0.0.1:{port}", num_processes=1, process_id=0,
                       device=dev, timeout_s=120)
    sync()
    init_s = time.perf_counter() - t0
    try:
        backend = dist.get_backend()
        mesh = make_global_mesh(n_stock=2, device=dev)
        sl = process_date_slice(ctx["T"])
        x = torch.arange(4, dtype=torch.float32, device=dev)
        dist.all_reduce(x)
        g = torch.empty(4, dtype=torch.float32, device=dev)
        dist.all_gather_into_tensor(g, torch.arange(4, dtype=torch.float32,
                                                    device=dev))
        v = make_sharded((8,), NamedSharding(mesh, P("date")),
                         lambda idx: torch.arange(8.0)[idx])
        total = float(gather(v).sum())
        sync()
    finally:
        dist.destroy_process_group()
    res = {"backend": backend, "multi_process": multi, "init_s": init_s,
           **mesh.describe(), "date_slice": [sl.start, sl.stop],
           "all_reduce": x.tolist(), "all_gather": g.tolist(),
           "gathered_sum": total}
    emit("distributed", **res)
    require(backend == ("nccl" if dev == "cuda" else "gloo")
            and multi is False
            and mesh.devices.shape == (4, 2) and mesh.virtual
            and res["date_slice"] == [0, ctx["T"]]
            and res["all_reduce"] == [0.0, 1.0, 2.0, 3.0]
            and res["all_gather"] == [0.0, 1.0, 2.0, 3.0]
            and total == 28.0,
            f"distributed: {res}")
    return res


def mesh_section(ctx) -> tuple:
    """The mesh section's phases, its meshes virtual over the card
    (``MFM_TORCH_VIRTUAL_DEVICES`` set for the section only).  Returns the
    launches of each path it drove and, by path, the warp ms and bound of
    each kernel at each shard shape it launched."""
    from mfm_tpu_torch._device import VIRTUAL_DEVICES_ENV

    prev = os.environ.get(VIRTUAL_DEVICES_ENV)
    os.environ[VIRTUAL_DEVICES_ENV] = str(MESH_DEVICES)
    cli = None
    try:
        fused = mesh_run_fused_phase(ctx)
        torch.cuda.empty_cache()
        # after the walls: the subprocess runs while the phases below do
        cli = mesh_cli_start(ctx)
        serve = mesh_serve_phase(ctx)
        pipe = mesh_pipeline_phase(ctx)
        torch.cuda.empty_cache()
        sweep = mesh_sweep_phase(ctx)
        distributed_phase(ctx)
        mesh_cli_phase(ctx, cli)
    finally:
        if cli is not None and cli[0].poll() is None:
            cli[0].kill()
            cli[0].communicate()
        if prev is None:
            os.environ.pop(VIRTUAL_DEVICES_ENV, None)
        else:
            os.environ[VIRTUAL_DEVICES_ENV] = prev
    launches = ctx.pop("mesh_launches")
    emit("mesh_launches", **launches)
    shard_ms = {**{f"run_fused_{a}x{b}": fused[f"{a}x{b}"]["shard_shapes"]
                   for a, b in MESH_SHAPES},
                "serve_update_guarded": serve["slab0"]["shard_shapes"],
                "pipeline": pipe["run"]["shard_shapes"],
                "append": pipe["append"]["shard_shapes"],
                "sweep": sweep["shard_shapes"]}
    return launches, shard_ms


# -- the IR audit: mfm_tpu_torch/analysis/ -----------------------------------

#: the registry: 15 entry points, 58 cells (17 primary, 11 mesh, 30
#: ladder), the reference's; the mesh cells on a virtual mesh of 8
AUDIT_CELLS = 58
AUDIT_DEVICES = 8


def audit_start(tmp: str) -> tuple:
    """``audit --strict --json`` as a subprocess on the card (A1–A5 against
    the committed baseline and budgets, every cell run once, the budgeted
    ones twice), its mesh cells on ``MFM_TORCH_VIRTUAL_DEVICES=8``; it runs
    while this process does other work, :func:`audit_phase` collects it.
    Returns (the started process, the report's path)."""
    from mfm_tpu_torch._device import VIRTUAL_DEVICES_ENV

    path = os.path.join(tmp, "audit.json")
    env = {**os.environ, VIRTUAL_DEVICES_ENV: str(AUDIT_DEVICES)}
    return start_cli(["audit", "--strict", "--json", path], env=env), path


def audit_phase(ctx, started) -> dict:
    """Phase audit: (a) the subprocess :func:`audit_start` started, to its
    end — exit 0, no stale baseline entry, all 58 registry cells present
    and every primary and mesh cell run (no ``mesh-skipped``), strict-clean
    with the budgets; its findings by pass, baselined count and walls; (b)
    ``doctor --audit`` on the committed snapshot through ``cli.main``,
    exit 0."""
    from mfm_tpu_torch.analysis.registry import registry

    proc_started, path = started
    stdout, wall, _ = finish_cli(proc_started, "audit --strict",
                                 last_json=False)
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    n_cells = sum(len(ep.cells()) for ep in registry())
    by_pass, baselined = {}, {}
    for f in doc["findings"]:
        key = f"{f['pass_id']} {f['severity']}"
        by_pass[key] = by_pass.get(key, 0) + 1
    for f in doc["baselined"]:
        baselined[f["pass_id"]] = baselined.get(f["pass_id"], 0) + 1
    skipped = [f for f in doc["findings"] if f["code"] == "mesh-skipped"]
    ran = sum(c["ran"] for c in doc["cells"].values())
    t0 = time.perf_counter()
    code, out, _ = cli_call(["doctor", "--audit"])
    doctor_wall = time.perf_counter() - t0
    (rec,) = json.loads(out)["records"]
    res = {"rc": 0, "strict_clean": doc["strict_clean"],
           "registry_cells": n_cells, "report_cells": len(doc["cells"]),
           "cells_ran": ran, "mesh_skipped": len(skipped),
           "findings_by_pass": by_pass, "baselined_by_pass": baselined,
           "baselined": len(doc["baselined"]),
           "stale_baseline": doc["stale_baseline"],
           "measured_cells": len(doc["measured"]),
           "process_wall_s": wall, "audit_wall_s": doc["wall_s"],
           "summary_line": stdout.strip().splitlines()[-1],
           "doctor_audit": {"rc": code, "status": rec["status"],
                            "problems": rec["problems"],
                            "warnings": rec["warnings"],
                            "wall_s": doctor_wall}}
    emit("audit", **res)
    require(doc["strict_clean"] and not doc["stale_baseline"]
            and n_cells == AUDIT_CELLS and not skipped
            and ran == len(doc["cells"]) == len(doc["measured"]),
            f"audit: not strict-clean on every cell: {res}")
    require(code == 0, f"doctor --audit: exit {code}: {rec}")
    return res


def audit_kernels_phase(ctx) -> dict:
    """Phase audit_kernels: the registry's ``risk.*`` cells (primary, and
    mesh on a virtual mesh of 8) run once each on the card as the audit
    runs them, with every launch of either kernel recorded (the update
    cells' history ``init_state`` too); each cell's launches counted from
    0 just before its call and read just after, by kernel and shape; every
    recorded launch held against its plain version at its own shape (w, V
    bitwise, h within 1e-4), each shape's warp launch timed against its
    bound (``obs/profile.kernel_flops``)."""
    from mfm_tpu_torch._device import VIRTUAL_DEVICES_ENV
    from mfm_tpu_torch.analysis.registry import registry
    from mfm_tpu_torch.analysis.run import bind_cell
    from mfm_tpu_torch.ops.eigh_cuda import launch_shapes, reset_launches
    from mfm_tpu_torch.parallel.mesh import make_mesh

    prev = os.environ.get(VIRTUAL_DEVICES_ENV)
    os.environ[VIRTUAL_DEVICES_ENV] = str(AUDIT_DEVICES)
    per_cell = {}
    try:
        with recorded_launches() as calls:
            for ep in registry():
                if not ep.name.startswith("risk."):
                    continue
                for cell in ep.cells():
                    if cell.role == "ladder":
                        continue
                    mesh = (make_mesh(*cell.mesh, device="cuda")
                            if cell.mesh else None)
                    _, call, _= bind_cell(ep, cell, "cuda", mesh)
                    sync()
                    reset_launches()
                    call()
                    sync()
                    per_cell[f"{ep.name}/{cell.name}"] = {
                        kernel: {f"({B}, {n}, {n}), {sw}": c
                                 for (B, n, sw), c in per.items()}
                        for kernel, per in launch_shapes().items()}
        held = hold_recorded(calls, "audit_kernels")
    finally:
        if prev is None:
            os.environ.pop(VIRTUAL_DEVICES_ENV, None)
        else:
            os.environ[VIRTUAL_DEVICES_ENV] = prev
    res = {"launches": per_cell, **held}
    emit("audit_kernels", launches=per_cell)
    require(all(sum(n for per in c.values() for n in per.values())
                for c in per_cell.values()),
            f"audit_kernels: a risk cell launched no kernel: {per_cell}")
    return res


def audit_probes_phase(ctx) -> dict:
    """Phase audit_probes: the audit's A1 and A2 probes, which are
    shape-generic, on the main path's CSI300 ``run_fused`` ((1390, 300),
    K = 42) through the registry's ``risk.fused`` entry point: no argument
    written or sharing its storage with an output, the run's dtype set
    that of the audit's ``risk.fused/base`` cell (run here under the same
    probe), its host reads and the card's sync count on the line; its
    launches counted from 0."""
    from mfm_tpu_torch.analysis import aliasing, ir
    from mfm_tpu_torch.analysis.registry import registry_by_name
    from mfm_tpu_torch.analysis.run import bind_cell
    from mfm_tpu_torch.ops.eigh_cuda import launch_counts, reset_launches

    ep = registry_by_name("risk.fused")
    ops = {n: torch.as_tensor(p).to("cuda") for n, p in zip(
        ("ret", "cap", "styles", "industry", "valid"), ctx["panel"])}
    ops["sim_covs"] = ctx["sim_covs"]
    before = aliasing.operand_versions(ops)
    sync()
    reset_launches()
    t0 = time.perf_counter()
    with ir.probe(on_card=True) as rec:
        out = ep.fn(**ops, n_industries=ctx["P"], config=ctx["config"],
                    sim_length=ctx["T"], device="cuda")
        sync()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    found = aliasing.check_aliasing(
        "risk.fused", "csi300", set(), before, aliasing.operand_versions(ops),
        aliasing.output_storages(out))
    base = next(c for c in ep.cells() if c.name == "base")
    _, call, _= bind_cell(ep, base, "cuda")
    with ir.probe(on_card=True) as rec_base:
        call()
        sync()
    reads = {op: rec["host_reads"].count(op)
             for op in sorted(set(rec["host_reads"]))}
    res = {"shape": [ctx["T"], ops["ret"].shape[1], ctx["K"]],
           "aliasing_findings": [f.to_dict() for f in found],
           "tensor_dtypes": sorted(rec["dtypes"]),
           "base_cell_dtypes": sorted(rec_base["dtypes"]),
           "host_callbacks": len(rec["host_reads"]), "host_reads": reads,
           "syncs": rec["syncs"], "launches": launches,
           "probed_wall_s": wall}
    emit("audit_probes", **res)
    require(not found, f"audit_probes: an argument of the CSI300 run_fused "
            f"was written or aliased: {found}")
    require(res["tensor_dtypes"] == res["base_cell_dtypes"],
            f"audit_probes: the CSI300 run's dtypes differ from the audit "
            f"cell's: {res}")
    require_launches(launches, "audit_probes run_fused", 1, 2)
    return res


# -- the host data layer: the store path at CSI300 width -----------------------

#: the CSI300 store: T dates x N constituents (+ the outsider), K = 42;
#: the generator's defaults but ``missing`` (see PERF.md §4)
STORE_SHAPE = dict(T=1390, N=300, n_industries=31, missing=0.001)
STORE_COLLECTIONS = ("stock_info", "daily_prices", "balancesheet",
                     "cashflow", "financial_indicators",
                     "index_daily_prices", "index_components",
                     "sw_industries")
#: dates the append serves: the cut is the last full-universe date at
#: least this many dates before the end
STORE_APPEND_DATES = 40
#: the pinned Monte-Carlo draw length of every store run (below the cut
#: run's date count, so runs of different lengths draw the same sims)
STORE_SIM_LENGTH = 1000
RESULT_TABLES = ("factor_returns", "r_squared", "specific_returns",
                 "final_covariance", "lambda")


def same_column(a, b) -> bool:
    """Two table columns hold the same cells bit for bit (NaN/NaT equal)."""
    import numpy as np

    a, b = np.asarray(a), np.asarray(b)
    if a.dtype != b.dtype:
        return False
    if a.dtype.kind in "fM":
        return np.array_equal(a, b, equal_nan=True)
    return a.tolist() == b.tolist()


def store_build_phase(ctx) -> dict:
    """Phase store_build: the CSI300 store built with the port's
    ``synthetic_collections`` (T = 1390, N = 300 + 1, 31 industries,
    ``missing`` 0.001), each collection read, ``load_and_prepare_data``
    and the densify step timed; ``prepare`` through ``cli.main``: its
    ``panel.npz`` is bitwise the master table (dates encoded as the
    reference's yyyymmdd numbers), and densified with ``Panel.from_long``
    it gives ``PreparedData.fields`` bitwise."""
    import numpy as np

    from mfm_tpu_torch.data.columns import nrows, yyyymmdd_numbers
    from mfm_tpu_torch.data.etl import PanelStore, read_table
    from mfm_tpu_torch.data.prepare import (
        DAILY_FIELDS,
        FILL_DATE_COLS,
        FILL_FIELDS,
        densify,
        load_and_prepare_data,
    )
    from mfm_tpu_torch.data.synthetic import synthetic_collections
    from mfm_tpu_torch.panel import Panel

    d = os.path.join(ctx["tmp"], "store")
    truth = os.path.join(d, "truth")
    meta, build_s = timed(lambda: synthetic_collections(PanelStore(truth),
                                                        **STORE_SHAPE))
    st = PanelStore(truth)
    read_s, rows = {}, {}
    for name in STORE_COLLECTIONS:
        t, read_s[name] = timed(lambda: st.read(name))
        rows[name] = nrows(t)
    (master, index_px, sw), load_s = timed(lambda: load_and_prepare_data(st))
    prep, densify_s = timed(lambda: densify(master, index_px, sw))
    prep_dir = os.path.join(d, "prepared")
    (code, txt, _), prepare_s = timed(lambda: cli_call(
        ["prepare", "--store", truth, "--out", prep_dir]))
    require(code == 0, f"store_build: prepare exited {code}")
    rec = json.loads(txt.splitlines()[-1])
    panel = read_table(rec["panel"])
    want = {k: (yyyymmdd_numbers(v) if k in FILL_DATE_COLS else v)
            for k, v in master.items()}
    panel_bitwise = list(panel) == list(want) and all(
        same_column(panel[k], want[k]) for k in want)
    p = Panel.from_long(panel, value_cols=[*dict.fromkeys(
        DAILY_FIELDS + FILL_FIELDS), "end_date"])
    ed = p.fields.pop("end_date")
    ok = np.isfinite(ed)
    rid = np.full(ed.shape, -1, np.int32)
    rid[ok] = np.searchsorted(np.unique(ed[ok]), ed[ok])
    fields_bitwise = (set(p.fields) | {"end_date_code"}) == set(prep.fields) \
        and all(np.array_equal(p.fields[k], prep.fields[k], equal_nan=True)
                for k in p.fields) \
        and np.array_equal(rid, prep.fields["end_date_code"])
    res = {"shape": STORE_SHAPE, "rows": rows, "build_s": build_s,
           "read_s": read_s, "load_and_prepare_s": load_s,
           "densify_s": densify_s, "prepare_cli_s": prepare_s,
           "prepare_rows": rec["rows"], "prepared_T": len(prep.dates),
           "prepared_N": len(prep.stocks),
           "panel_bitwise": panel_bitwise, "fields_bitwise": fields_bitwise}
    emit("store_build", **res)
    T, N = STORE_SHAPE["T"], STORE_SHAPE["N"]
    require(rows["daily_prices"] > 0.9 * T * (N + 1)
            and len(prep.stocks) == N and len(prep.dates) == T,
            f"store_build: the store is not CSI300-sized: {rows}")
    require(panel_bitwise and fields_bitwise,
            f"store_build: prepare's panel.npz is not the master table "
            f"({panel_bitwise}) or its densified fields "
            f"PreparedData's ({fields_bitwise})")
    ctx["store"] = {"dir": d, "truth": truth, "prep_dir": prep_dir,
                    "prep": prep, "meta": meta, "rows": rows}
    return res


def store_etl_phase(ctx) -> dict:
    """Phase store_etl: ``etl-verify``, ``etl-verify --diagnose --name
    balancesheet``, ``etl-missing`` and ``etl-update --dry-run`` through
    ``cli.main`` on the CSI300 store, each record checked."""
    import numpy as np

    from mfm_tpu_torch.data.etl import PanelStore

    s = ctx["store"]
    truth, dates = s["truth"], list(s["meta"]["dates"])
    recs, walls = {}, {}
    for key, argv in (
            ("verify", ["etl-verify", "--store", truth]),
            ("diagnose", ["etl-verify", "--store", truth, "--diagnose",
                          "--name", "balancesheet"]),
            ("missing", ["etl-missing", "--store", truth]),
            ("plan", ["etl-update", "--store", truth, "--start", dates[0],
                      "--end", dates[-1], "--dry-run",
                      "--index-codes", s["meta"]["index_code"]])):
        (code, txt, _), walls[key] = timed(lambda: cli_call(argv))
        require(code == 0, f"store_etl: {argv[0]} exited {code}")
        recs[key] = json.loads(txt.splitlines()[-1])
    v, dg, m, pl = (recs[k] for k in ("verify", "diagnose", "missing",
                                      "plan"))
    # the revised statements: every row of a (stock, period end) pair
    # announced more than once, counted here from the rows themselves
    bs = PanelStore(truth).read("balancesheet")
    _, inv, cnt = np.unique(np.char.add(bs["ts_code"], bs["end_date"]),
                            return_inverse=True, return_counts=True)
    revised = int((cnt[inv] > 1).sum())
    checks = {
        "verify": v == {"rows": s["rows"]["daily_prices"],
                        "stocks": STORE_SHAPE["N"] + 1,
                        "first_date": dates[0], "last_date": dates[-1]},
        # revisions share their period end (and two announcements can
        # fall on one day); no date is missing or before its period end
        "diagnose": dg["n_rows"] == s["rows"]["balancesheet"]
        and dg["issue_counts"].get("dup_end") == revised
        and set(dg["issue_counts"]) <= {"dup_end", "dup_ann"}
        and dg["collection"] == "balancesheet",
        "missing": m == {"n_missing": 0, "missing": []},
        "plan": pl["daily_prices"]["watermark"] == dates[-1]
        and pl["daily_prices"]["up_to_date"] is True
        and pl["stock_info"]["rows"] == STORE_SHAPE["N"] + 1
        and pl["index_daily_prices"][s["meta"]["index_code"]]["up_to_date"],
    }
    res = {"walls_s": walls, "checks": checks,
           "diagnose_issue_counts": dg["issue_counts"],
           "revised_rows": revised}
    emit("store_etl", **res)
    require(all(checks.values()), f"store_etl: a record is wrong: "
            f"{checks} {recs}")
    return res


class TruthSource:
    """The truth store through the fetch surface the daily ETL calls: a
    day's prices, an index's prices over a range."""

    def __init__(self, store):
        import numpy as np

        self.px = store.read("daily_prices")
        self.ix = store.read("index_daily_prices")
        days, inv = np.unique(self.px["trade_date"], return_inverse=True)
        order = np.argsort(inv, kind="stable")
        bounds = np.searchsorted(inv[order], np.arange(len(days) + 1))
        self.by_day = {d: order[bounds[i]:bounds[i + 1]]
                       for i, d in enumerate(days.tolist())}

    def fetch_daily_prices(self, trade_date):
        from mfm_tpu_torch.data.columns import take

        return take(self.px, self.by_day.get(trade_date, []))

    def fetch_daily_index_prices(self, ts_code, start_date=None,
                                 end_date=None):
        import numpy as np

        from mfm_tpu_torch.data.columns import take

        d = self.ix["trade_date"]
        keep = self.ix["ts_code"] == ts_code
        if start_date is not None:
            keep &= d >= start_date
        if end_date is not None:
            keep &= d <= end_date
        return take(self.ix, np.asarray(keep))


def store_pipeline_phase(ctx) -> dict:
    """Phase store_pipeline: four subprocesses on the card, (b)-(d) at
    once after (a).  (a)
    ``pipeline --store W --to-store F`` on a copy W of the store cut at
    CUT (the last full-universe date at least 40 before the end; prices
    and index prices past it removed); W brought up to date by
    ``IncrementalUpdater`` from the truth store, one part a day; (b)
    ``pipeline --append``: bitwise (c) ``pipeline`` from scratch on W (the
    tables, ``risk_outputs.npz``, ``risk_state.npz``); (d) ``risk
    --barra-store F``: bitwise (a).  In this process: ``factors
    --prepared`` over store_build's directory, bitwise
    ``run_factor_pipeline`` on the inputs it read; the factor and risk
    stages under the profiler for the busy share, bitwise (c)."""
    import shutil

    import numpy as np

    from mfm_tpu_torch import PipelineConfig, RiskModelConfig
    from mfm_tpu_torch import run_factor_pipeline, run_risk_pipeline
    from mfm_tpu_torch.cli import _read_long_table, _reindex
    from mfm_tpu_torch.data.artifacts import _numpy, load_artifact
    from mfm_tpu_torch.data.columns import take
    from mfm_tpu_torch.data.csvio import read_csv, write_csv
    from mfm_tpu_torch.data.etl import IncrementalUpdater, PanelStore
    from mfm_tpu_torch.panel import Panel

    s, dev = ctx["store"], ctx["device"]
    d, truth = s["dir"], s["truth"]
    st = PanelStore(truth)
    px = st.read("daily_prices")
    days, counts = np.unique(px["trade_date"], return_counts=True)
    n_all = len(np.unique(px["ts_code"]))
    full = np.nonzero(counts == n_all)[0]
    full = full[full <= len(days) - 1 - STORE_APPEND_DATES]
    require(len(full) > 0, "store_pipeline: no full-universe date to cut at")
    cut = str(days[full[-1]])
    W = os.path.join(d, "W")
    shutil.copytree(truth, W)
    ws = PanelStore(W)
    for name in ("daily_prices", "index_daily_prices"):
        t = st.read(name)
        ws.replace(name, take(t, t["trade_date"] <= cut))
    L = ["--eigen-sim-length", str(STORE_SIM_LENGTH)]
    out = {k: os.path.join(d, k) for k in ("A", "A0", "C", "D", "F")}
    mdirs = {k: os.path.join(d, f"metrics_{k}") for k in "abc"}

    def finish(started, argv):
        rec, wall, _ = finish_cli(started, f"store_pipeline: {argv[:2]}")
        return rec, wall

    argv_a = ("pipeline", "--store", W, "--out", out["A"], "--to-store",
              out["F"], *L, "--metrics-dir", mdirs["a"])
    rec_a, wall_a = finish(start_cli(argv_a), argv_a)
    shutil.copytree(out["A"], out["A0"])
    # the daily ETL's shape: one part a day past the cut
    src = TruthSource(st)
    up = IncrementalUpdater(store=ws, source=src, sleep=lambda s: None)
    (n_px, n_ix), refresh_s = timed(lambda: (
        up.update_daily_prices(days.tolist()),
        up.update_daily_index_prices([s["meta"]["index_code"]],
                                     end_date=str(days[-1]))))
    want_px = int((px["trade_date"] > cut).sum())
    parts = len(ws._parts("daily_prices"))
    # (b), (c) and (d) read what (a) and the refresh left and each writes
    # a directory of its own: they run at once, while this process runs
    # factors --prepared
    argv = {"b": ("pipeline", "--store", W, "--out", out["A"], "--append",
                  *L, "--metrics-dir", mdirs["b"]),
            "c": ("pipeline", "--store", W, "--out", out["C"], *L,
                  "--metrics-dir", mdirs["c"]),
            "d": ("risk", "--barra-store", out["F"], "--out", out["D"], *L,
                  "--save-outputs", "--save-state",
                  os.path.join(out["D"], "ck", "state.npz"))}
    started = {k: start_cli(a) for k, a in argv.items()}

    # factors --prepared, and run_factor_pipeline on the inputs it read
    fdir = os.path.join(d, "factors")
    (code, txt, _), factors_cli_s = timed(lambda: cli_call(
        ["factors", "--prepared", s["prep_dir"], "--out", fdir]))
    require(code == 0, f"store_pipeline: factors --prepared exited {code}")
    p = Panel.from_long(_read_long_table(os.path.join(s["prep_dir"],
                                                      "panel.npz")))
    e = p.fields.pop("end_date")
    ok = np.isfinite(e)
    rid = np.full(e.shape, -1, np.int32)
    rid[ok] = np.searchsorted(np.unique(e[ok]), e[ok])
    p.fields["end_date_code"] = rid
    index = read_csv(os.path.join(s["prep_dir"], "index_prices.csv"),
                     parse_dates=("trade_date",))
    ind = read_csv(os.path.join(s["prep_dir"], "industry_map.csv"))
    table, _ = run_factor_pipeline(
        p.fields, _reindex(index["trade_date"], index["close"], p.dates),
        _reindex(ind["ts_code"], ind["l1_code"], p.stocks), p.dates,
        p.stocks, PipelineConfig(), device=dev)
    mine = os.path.join(d, "barra_in_process.csv")
    write_csv(mine, table)
    factors_bitwise = open(mine, "rb").read() == open(
        os.path.join(fdir, "barra_data.csv"), "rb").read()

    (rec_b, wall_b), (rec_c, wall_c), (rec_d, wall_d) = (
        finish(started[k], argv[k]) for k in "bcd")

    def tables_same(x, y):
        return {n: open(os.path.join(x, f"{n}.csv"), "rb").read()
                == open(os.path.join(y, f"{n}.csv"), "rb").read()
                for n in RESULT_TABLES}

    def artifact_same(x, y, name):
        a, ma = load_artifact(os.path.join(x, name))
        b, mb = load_artifact(os.path.join(y, name))
        return set(a) == set(b) and all(
            np.array_equal(a[k], b[k], equal_nan=True) for k in b) and (
            ma.get("last_date") == mb.get("last_date"))

    append_eq = {**tables_same(out["A"], out["C"]),
                 "risk_outputs": artifact_same(out["A"], out["C"],
                                               "risk_outputs.npz"),
                 "risk_state": artifact_same(out["A"], out["C"],
                                             "risk_state.npz")}
    barra_store_eq = {**tables_same(out["D"], out["A0"]),
                      "risk_outputs": artifact_same(out["D"], out["A0"],
                                                    "risk_outputs.npz")}

    # the factor and risk stages of (c) in this process, profiled
    prep = s["prep"]
    cfg = PipelineConfig(risk=RiskModelConfig(
        eigen_sim_length=STORE_SIM_LENGTH))
    codes = read_csv(os.path.join(out["C"], "industry_info.csv"))["code"]
    box = {}

    def stages():
        barra, _ = run_factor_pipeline(prep.fields, prep.index_close,
                                       prep.industry_l1, prep.dates,
                                       prep.stocks, cfg, device=dev)
        box["res"] = run_risk_pipeline(barra, config=cfg,
                                       industry_codes=codes,
                                       with_state=True, device=dev)

    prof = profile_run(stages)
    saved, _ = load_artifact(os.path.join(out["C"], "risk_outputs.npz"))
    o = box["res"].outputs
    in_process_eq = all(np.array_equal(saved[f], _numpy(getattr(o, f)),
                                       equal_nan=True) for f in o._fields)
    finite = outputs_finite(o, torch.as_tensor(box["res"].arrays.valid,
                                               device=o.factor_ret.device))

    launches = {k: r["kernels"]["launches"] for k, r in
                (("pipeline_cut", rec_a), ("pipeline_append", rec_b),
                 ("pipeline_scratch", rec_c), ("risk_barra_store", rec_d))}
    res = {"cut": cut, "L": STORE_SIM_LENGTH,
           "process_s": {"a": wall_a, "b": wall_b, "c": wall_c, "d": wall_d},
           "wall_s": {"a": rec_a["wall_s"], "b": rec_b["wall_s"],
                      "c": rec_c["wall_s"], "d": rec_d["wall_s"]},
           "factor_stage_wall_s": {"a": rec_a["factor_stage_wall_s"],
                                   "b": rec_b["factor_stage_wall_s"],
                                   "c": rec_c["factor_stage_wall_s"]},
           "update_wall_s": rec_b.get("update_wall_s"),
           "appended_dates": len(rec_b.get("appended_dates", [])),
           "dates": {"a": rec_a["dates"], "c": rec_c["dates"],
                     "d": rec_d["dates"]},
           "rows": rec_c["rows"], "factors": rec_c["factors"],
           "stages_s": {k: stage_seconds(v) for k, v in mdirs.items()},
           "refresh": {"s": refresh_s, "price_rows": n_px,
                       "index_rows": n_ix, "daily_parts": parts},
           "append_bitwise": append_eq, "barra_store_bitwise":
           barra_store_eq, "factors_prepared_cli_s": factors_cli_s,
           "factors_prepared_bitwise": factors_bitwise,
           "in_process": {"profile": prof, "bitwise_c": in_process_eq,
                          "finite": finite},
           "launches": launches}
    emit("store_pipeline", **res)
    require(n_px == want_px and parts == 1 + len(days) - 1 - full[-1],
            f"store_pipeline: the refresh wrote {n_px} rows in {parts} parts "
            f"(want {want_px})")
    require(rec_a["dates"] > STORE_SIM_LENGTH and rec_c["factors"] == 42
            and res["appended_dates"] >= STORE_APPEND_DATES - 1,
            f"store_pipeline: shapes {res['dates']}, {rec_c['factors']} "
            f"factors, {res['appended_dates']} appended")
    require(all(append_eq.values()), f"store_pipeline: --append is not "
            f"the from-scratch run: {append_eq}")
    require(all(barra_store_eq.values()), f"store_pipeline: risk "
            f"--barra-store is not pipeline --to-store's run: "
            f"{barra_store_eq}")
    require(factors_bitwise, "store_pipeline: factors --prepared is not "
            "run_factor_pipeline on the inputs it read")
    require(in_process_eq and all(finite.values()),
            f"store_pipeline: the in-process stages differ from (c) "
            f"({in_process_eq}) or are not finite ({finite})")
    for key in ("pipeline_cut", "pipeline_scratch", "pipeline_append",
                "risk_barra_store"):
        require_launches(launches[key], f"store_pipeline {key}", 1, 2)
    require(prof["busy_share"] is not None,
            "store_pipeline: the profiler saw no device time")
    ctx["store_out"] = out
    return res


# -- faults: the recovery matrix, report and crosscheck -------------------------

#: the recovery matrix at CSI300 width: a 1378-date history, three 4-date
#: slabs, the reference demo's 100 draws
FAULT_GEOMETRY = dict(T=1390, hist=1378, slab=4, N=300, P=31, Q=10, sims=100)
FAULT_PORTED = 29
FAULT_NOT_PORTED = 0
#: the plans bound by CLI subprocesses, run as concurrent ``python -m
#: mfm_tpu_torch.tools.faultinject --plans <group>`` processes, each group
#: one plan after another inside, balanced by the plans' walls with four
#: groups on the card; six groups took longer (the host's throughput
#: bounds the sum of the walls, PERF.md §5)
FAULT_GROUPS = (
    ("eigen-kill-mid-update", "trace-kill-mid-flush", "kill-after-rename"),
    ("cache-stale-generation", "grad-kill-mid-solve", "kill-after-tmp"),
    ("sweep-kill-mid-stream", "flightrec-kill-mid-dump",
     "shard-kill-mid-append"),
    ("scenario-kill-mid-batch", "kill-at-manifest", "query-kill-mid-batch"),
)
#: the fleet drills, one harness process: alongside the groups only on a
#: host with the cores (their heartbeat timeout is 1 s, and a starved idle
#: worker would be falsely wedged), else after them, one drill after
#: another while this process runs ``meanwhile``
FAULT_FLEET = ("fleet-kill-replica", "fleet-kill-host", "fleet-wedge-worker")
#: processes of the fleet drills alive at once: the harness, the front
#: end, its four workers at most (fleet-kill-host) and the replay
FAULT_FLEET_PROCS = 7
#: the subprocesses each plan's runner SIGKILLs at a crash point
FAULT_KILLS = {
    "kill-after-tmp": 1, "kill-after-rename": 1, "kill-at-manifest": 1,
    "eigen-kill-mid-update": 1, "shard-kill-mid-append": 1,
    "query-kill-mid-batch": 1,
    "scenario-kill-mid-batch": 1, "sweep-kill-mid-stream": 1,
    "grad-kill-mid-solve": 1, "trace-kill-mid-flush": 1,
    "flightrec-kill-mid-dump": 1, "cache-stale-generation": 1,
    "fleet-kill-replica": 1, "fleet-kill-host": 2, "fleet-wedge-worker": 0}
#: the eigh launches each completed subprocess of a plan shows, in the
#: runner's order: "both" (a ``risk --update``: the weighted kernel and
#: the full one, for F0 and the pseudo-inverse), "full" (the PSD gate of
#: ``scenario run`` / ``sweep``, ``eigh_diff``'s forward in ``grad
#: sensitivity``), "mesh" (a ``risk --update --mesh 2x2`` over a 4-date
#: slab: the weighted kernel once a shard, the full one for each date
#: row's pseudo-inverse and F0), "none" (query serving, the
#: flight-recorder driver); a
#: fleet drill's processes (its front end, each worker that wrote its
#: shard, the single-process replay) all "none"
FAULT_SUBPROCESS_KERNELS = {
    "kill-at-manifest": ["both"], "eigen-kill-mid-update": ["both"],
    "shard-kill-mid-append": ["mesh"],
    "query-kill-mid-batch": ["none"],
    "scenario-kill-mid-batch": ["full", "full"],
    "sweep-kill-mid-stream": ["full", "full"],
    "grad-kill-mid-solve": ["full"], "trace-kill-mid-flush": ["both"],
    "flightrec-kill-mid-dump": ["none", "both"],
    "cache-stale-generation": ["both", "none", "none"]}


def _fault_argv(plans, out) -> list:
    argv = ["--device", "cuda", "--plans", ",".join(plans), "--out", out]
    for k, v in FAULT_GEOMETRY.items():
        argv += [f"--{k}", str(v)]
    return argv


def _fault_in_process(plans, out) -> tuple:
    """``faultinject.main`` over ``plans`` in this process: (rc, report,
    wall)."""
    import contextlib
    import io

    from mfm_tpu_torch.tools import faultinject as fi

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = fi.main(_fault_argv(plans, out))
    sync()
    wall = time.perf_counter() - t0
    with open(out) as fh:
        return rc, json.load(fh), wall


def _fault_subprocess_launch_check(name: str, launches: list) -> None:
    want = FAULT_SUBPROCESS_KERNELS.get(name)
    if want is None:   # a fleet drill: every process launches none
        require(len(launches) >= 2, f"fault_matrix {name}: "
                f"{len(launches)} completed processes reported launches")
        want = ["none"] * len(launches)
    require(len(launches) == len(want), f"fault_matrix {name}: "
            f"{len(launches)} completed subprocesses (want {len(want)})")
    for i, (got, kind) in enumerate(zip(launches, want)):
        what = f"fault_matrix {name} subprocess {i}"
        if kind == "both":
            require_launches(got, what, 1, 1)
        elif kind == "mesh":
            require_launches(got, what, 4, 3)
            require(got["jacobi_eigh_weighted/warp"] == 4,
                    f"{what}: the weighted kernel must launch once a shard "
                    f"(4): {got}")
        elif kind == "full":
            require_launches(got, what, 0, 1)
            require(got["jacobi_eigh_weighted/warp"] == 0,
                    f"{what}: the weighted kernel launched: {got}")
        else:
            require(not any(got.values()), f"{what} launched a kernel: "
                    f"{got}")


def fault_matrix_start(tmp: str) -> dict:
    """Start phase fault_matrix's harness processes, writing under
    ``tmp``: FAULT_GROUPS all at once, then, once every group has ended,
    the fleet drills in one more (alongside the groups only on a host with
    the cores).  They run while this process goes on with the sections
    before the phase, which collects them: the state it takes."""
    alive_groups = 2 * len(FAULT_GROUPS) + 1
    alive_with_fleet = alive_groups + FAULT_FLEET_PROCS
    cores = os.cpu_count() or 1
    state = {"tmp": tmp, "t0": time.perf_counter(), "group_s": None,
             "cores": cores, "alive_with_fleet": alive_with_fleet,
             "fleet_alongside": cores >= 4 * alive_with_fleet}
    # the environment now, for the fleet drills too: not that of whatever
    # section runs when the groups end
    env = dict(os.environ)

    def start(plans, tag):
        out = os.path.join(tmp, f"faults_{tag}.json")
        log = open(os.path.join(tmp, f"faults_{tag}.log"), "w")
        proc = subprocess.Popen(
            [sys.executable, "-m", "mfm_tpu_torch.tools.faultinject",
             *_fault_argv(plans, out)], cwd=ROOT, stdout=log,
            stderr=subprocess.STDOUT, text=True, env=env)
        _STARTED.append(proc)
        rec = {"tag": tag, "plans": list(plans), "out": out, "log": log.name,
               "proc": proc, "t0": time.perf_counter()}

        def wait():
            proc.wait()
            rec["wall_s"] = time.perf_counter() - rec["t0"]
            log.close()
        rec["waiter"] = threading.Thread(target=wait, daemon=True)
        rec["waiter"].start()
        return rec

    groups = [start(g, f"g{i}") for i, g in enumerate(FAULT_GROUPS)]
    state["groups"] = list(groups)
    if state["fleet_alongside"]:
        state["groups"].append(start(FAULT_FLEET, "fleet"))

    def chain():
        for g in groups:
            g["waiter"].join()
        state["group_s"] = time.perf_counter() - state["t0"]
        if not state["fleet_alongside"]:
            state["groups"].append(start(FAULT_FLEET, "fleet"))
    state["chain"] = threading.Thread(target=chain, daemon=True)
    state["chain"].start()
    return state


def fault_matrix_phase(ctx, started, meanwhile=None) -> dict:
    """Phase fault_matrix: ``python -m mfm_tpu_torch.tools.faultinject``
    on the card at CSI300 width (FAULT_GEOMETRY, float32, guarded): every
    plan of ``plan_suite`` (29, none left unported) and steady-state must
    pass.  The plans bound by CLI
    subprocesses run in FAULT_GROUPS, one harness process per group, all
    at once, started by :func:`fault_matrix_start` (``started``) sections
    before this phase: the ``risk --update`` processes SIGKILLed at the checkpoint's
    and the manifest's crash points with the fence's recovery bitwise (one
    of them sharded, ``--mesh 2x2`` on a virtual mesh of the card), the
    ``serve``, ``scenario run``, ``scenario sweep``, ``grad sensitivity``,
    trace and flight-recorder processes SIGKILLed at theirs with no torn
    file and the replay bitwise, the cache's generation fence across a
    torn publish.  Here this process runs the rest: the byte faults,
    the poisoned slabs under the carry-freeze contract, the retry drill,
    the schedule drills, both steady states, the query plans on the card
    (dead letters, the shed order, the hot swap's breaker) and the
    scenario poison's lane isolation; then ``meanwhile`` (phases
    report_crosscheck and doctrine_tools), and it waits for every harness.
    The three fleet drills run in one more harness process, started when
    the groups end unless the host has the cores to run them alongside: a
    replica SIGKILLed mid-drain, a simulated host
    killed with a worker wedged, a worker wedged — every id bitwise the
    single-process replay, the manifest's audit balanced.  Each plan's
    record goes on a line, each group's wall on one.  ``query-steady-state`` must add no
    compile-contract event after its warmup (printed) and one batch at a
    bucket the process has not served exactly one.  Launches: each
    harness process's own, counted from 0 (this process's just before its
    runs); the full kernel in every guarded append and each completed
    ``risk --update`` with the weighted one, the full kernel alone in each
    completed ``scenario run`` / ``sweep`` / ``grad sensitivity``, none in
    the query and fleet processes; each plan's go in the ``kernels``
    line."""
    from mfm_tpu_torch.ops.eigh_cuda import launch_counts, reset_launches
    from mfm_tpu_torch.tools import faultinject as fi
    from mfm_tpu_torch.utils.chaos import plan_suite

    suite = plan_suite(0)
    ported = [p.name for p in suite if p.kind not in fi.NOT_PORTED_KINDS]
    not_ported = [p.name for p in suite if p.kind in fi.NOT_PORTED_KINDS]
    grouped = {n for g in FAULT_GROUPS for n in g}
    local = [n for n in ported
             if n not in grouped and n not in FAULT_FLEET] + ["steady-state"]
    tmp, t0, groups = started["tmp"], started["t0"], started["groups"]
    cores, fleet_alongside = started["cores"], started["fleet_alongside"]
    alive_with_fleet = started["alive_with_fleet"]
    t_phase = time.perf_counter()
    reports = {}
    meanwhile_s = None
    try:
        reset_launches()
        rc, reports["in_process"], local_wall = _fault_in_process(
            local, os.path.join(tmp, "faults_local.json"))
        sync()
        launches = launch_counts()
        require(rc == 0, "fault_matrix: in-process plans failed: "
                f"{reports['in_process']['summary']['failed']}")
        if meanwhile is not None:
            t1 = time.perf_counter()
            meanwhile()
            meanwhile_s = time.perf_counter() - t1
        started["chain"].join(timeout=900)
        require(not started["chain"].is_alive(),
                "fault_matrix: the groups ran past 900 s")
        for g in groups:
            g["waiter"].join(timeout=900)
            require(not g["waiter"].is_alive(),
                    f"fault_matrix: group {g['tag']} ran past 900 s")
    finally:
        for g in groups:
            if g["proc"].poll() is None:
                g["proc"].kill()
                g["proc"].wait()
    group_s = started["group_s"]
    for g in groups:
        ok = g["proc"].returncode == 0 and os.path.exists(g["out"])
        if not ok:
            with open(g["log"]) as fh:
                tail = fh.read()[-3000:]
            require(False, f"fault_matrix: group {g['tag']} {g['plans']} "
                    f"exited {g['proc'].returncode}:\n{tail}")
        with open(g["out"]) as fh:
            reports[g["tag"]] = json.load(fh)
        emit("fault_group", group=g["tag"], plans=g["plans"],
             wall_s=g["wall_s"], rc=g["proc"].returncode,
             baseline_wall_s=reports[g["tag"]]["summary"]["baseline_wall_s"])
    wall = time.perf_counter() - t0

    results = [r for rep in reports.values() for r in rep["results"]]
    big = ("append_launches", "pointer", "error", "subprocess_launches")
    for r in results:
        emit("fault_plan", **{k: v for k, v in r.items() if k not in big},
             appends=len(r["append_launches"]),
             append_full_min=min((a["jacobi_eigh/warp"]
                                  for a in r["append_launches"]), default=None),
             subprocesses=len(r.get("subprocess_launches", [])),
             error=r.get("error", "")[:400])
    by = {r["plan"]: r for r in results}
    failed = [r["plan"] for r in results if r["status"] != "pass"]
    killed = {n: by[n].get("killed_subprocesses") for n in FAULT_KILLS
              if n in by}
    appends = [a for rep in reports.values()
               for a in rep["summary"]["baseline_append_launches"]] + [
        a for r in results for a in r["append_launches"]]
    subprocess_launches = {r["plan"]: r["subprocess_launches"]
                           for r in results if "subprocess_launches" in r}
    eigen = by["eigen-kill-mid-update"]
    qs = by["query-steady-state"]
    res = {"wall_s": wall, "groups_s": group_s,
           "phase_s": time.perf_counter() - t_phase,
           "in_process_s": local_wall, "meanwhile_s": meanwhile_s,
           "cpu_count": cores, "processes_alive_with_fleet": alive_with_fleet,
           "fleet_alongside": fleet_alongside,
           "group_wall_s": {g["tag"]: g["wall_s"] for g in groups},
           "geometry": {t: rep["summary"]["geometry"]
                        for t, rep in reports.items()},
           "plans": len(results), "failed": failed,
           "not_ported": not_ported,
           "baseline_wall_s": {t: rep["summary"]["baseline_wall_s"]
                               for t, rep in reports.items()},
           "plan_wall_s": {r["plan"]: r["wall_s"] for r in results},
           "killed_by_sigkill": killed,
           "steady_state_compiles": by["steady-state"].get("compiles"),
           "steady_state_warmup_compiles":
               by["steady-state"].get("warmup_compiles"),
           "query_steady_compiles": qs.get("compiles"),
           "query_steady_warmup_compiles": qs.get("warmup_compiles"),
           "query_new_bucket": qs.get("new_bucket"),
           "query_new_bucket_compiles": qs.get("new_bucket_compiles"),
           "launches": launches,
           "baseline_init_launches": {
               t: rep["summary"]["baseline_init_launches"]
               for t, rep in reports.items()},
           "guarded_appends": len(appends),
           "append_full_min": min(a["jacobi_eigh/warp"] for a in appends),
           "eigen_init_launches": eigen.get("init_launches"),
           "eigen_append_launches": eigen["append_launches"],
           "plan_launches": {r["plan"]: r["launches"] for r in results},
           "subprocess_launches": subprocess_launches}
    emit("fault_matrix", **res)
    require(not failed, f"fault_matrix: plans failed: {failed}")
    require(sorted(by) == sorted(ported + ["steady-state"])
            and len(results) == FAULT_PORTED + 1
            and len(not_ported) == FAULT_NOT_PORTED
            and all(g == FAULT_GEOMETRY for g in res["geometry"].values()),
            f"fault_matrix: ran {sorted(by)}, {len(not_ported)} not ported, "
            f"at {res['geometry']}")
    require(killed == FAULT_KILLS,
            f"fault_matrix: the plans' SIGKILLed subprocesses: {killed}")
    require(res["steady_state_compiles"] == 0,
            f"fault_matrix: steady state added "
            f"{res['steady_state_compiles']} compile-contract events")
    require(res["query_steady_compiles"] == 0
            and res["query_new_bucket_compiles"] == 1,
            f"fault_matrix: the query loop added "
            f"{res['query_steady_compiles']} events after its warmup, the "
            f"new bucket {res['query_new_bucket_compiles']} (want 0, 1)")
    for t, init in res["baseline_init_launches"].items():
        require_launches(init, f"fault_matrix {t} baseline rebuild", 1, 1)
    require_launches(eigen["init_launches"],
                     "fault_matrix eigen-kill rebuild", 1, 1)
    for a in eigen["append_launches"]:
        require_launches(a, "fault_matrix eigen-kill incremental update",
                         1, 1)
    for a in appends:
        require_launches(a, "fault_matrix guarded append", 0, 1)
    for name, subs in subprocess_launches.items():
        _fault_subprocess_launch_check(name, subs)
    for n in ("query-kill-mid-batch", "query-poison-slab",
              "query-overflow-storm", "query-ckpt-swap",
              "query-steady-state", *FAULT_FLEET):
        require(not any(by[n]["launches"].values()),
                f"fault_matrix: {n}'s harness launched a kernel: "
                f"{by[n]['launches']}")
    return res


def _rounding_straddle(raw: float, reported: float) -> bool:
    """``raw`` lies within 1e-9 of a 6-decimal rounding boundary and
    ``reported`` is its neighbour there."""
    frac = abs(raw) * 1e6 % 1.0
    return abs(frac - 0.5) < 1e-3 and abs(raw - reported) <= 1e-6


def report_numbers(rin: dict) -> dict:
    """``report``'s summary numbers recomputed with numpy from the
    in-process outputs, rounded as it rounds them (6 decimals)."""
    import numpy as np

    fr = rin["factor_ret"]
    keep = ~np.isnan(fr).all(axis=1)
    valid, dates = fr[keep], rin["dates"][keep]
    cum = np.nansum(valid, axis=0)
    vol = np.nanstd(valid, axis=0, ddof=1) * np.sqrt(252)
    r2 = rin["r2"][~np.isnan(rin["r2"])]
    lam = rin["lamb"][~np.isnan(rin["lamb"])]
    sp = rin["specific_ret"]
    n_obs = (~np.isnan(sp)).sum(axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        disp = np.nanstd(np.where(n_obs[:, None] > 1, sp, np.nan), axis=1,
                         ddof=1)
    disp = disp[~np.isnan(disp)]
    raw = {
        "dates": {"first": str(dates[0]), "last": str(dates[-1]),
                  "count": int(len(dates))},
        "factors": {rin["names"][j]: {"cum_return": float(cum[j]),
                                      "ann_vol": float(vol[j])}
                    for j in np.argsort(-cum, kind="stable")},
        "r2": {"mean": np.mean(r2), "median": np.median(r2),
               "p10": np.percentile(r2, 10), "p90": np.percentile(r2, 90),
               "last_63d_mean": np.mean(r2[-63:])},
        "lambda": {"last": lam[-1], "mean": np.mean(lam),
                   "min": np.min(lam), "max": np.max(lam)},
        "specific_dispersion": {"mean_xsec_std": np.mean(disp),
                                "last": disp[-1]},
    }
    return raw


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


def csv_finite_counts(path, names) -> tuple:
    """(data rows, {name: finite cells}) of a csv the CLI wrote, each
    cell parsed by numpy (the CLI writes NaN as an empty cell)."""
    import numpy as np

    with open(path) as fh:
        header = fh.readline().rstrip("\n").split(",")
        cols = list(zip(*(ln.rstrip("\n").split(",") for ln in fh
                          if ln.strip())))
    counts = {}
    for f in names:
        vals = np.array([c or "nan" for c in cols[header.index(f)]],
                        dtype=np.float64)
        counts[f] = int(np.isfinite(vals).sum())
    return len(cols[0]) if cols else 0, counts


def report_crosscheck_phase(ctx) -> dict:
    """Phase report_crosscheck: ``report --json`` over cli_risk's results
    directory, each number equal to the same statistic recomputed here with
    numpy from the in-process outputs after the same 6-decimal rounding (a
    value on the other side of a rounding boundary is listed with its raw
    difference), the factor order too; ``report --plot`` (without
    matplotlib: a non-zero exit naming the install; with it: a PNG);
    ``crosscheck --gate 0`` of store_pipeline's from-scratch
    ``barra_data.csv`` against the appended one, every factor passing with
    its full overlap (``n_overlap`` equal to the factor's count of finite
    cells in each table, both tables of the same row count); and again against a copy with one value of one
    factor moved by 1e-3, which must fail the gate naming that factor."""
    rin = ctx["report_inputs"]
    t0 = time.perf_counter()
    code, text, _ = cli_call(["report", "--results", rin["dir"], "--json",
                           "health.json"])
    report_s = time.perf_counter() - t0
    require(code == 0, f"report_crosscheck: report exited {code}")
    got = json.loads(text.strip().splitlines()[-1])
    raw = report_numbers(rin)
    g, w = _flat(got), _flat(raw)
    mismatched, straddles = {}, {}
    for key, want in w.items():
        have = g.get(key)
        if isinstance(want, str) or key.endswith("count"):
            if have != want:
                mismatched[key] = [have, want]
            continue
        if have == round(float(want), 6):
            continue
        if have is not None and _rounding_straddle(float(want), have):
            straddles[key] = {"reported": have, "raw": float(want),
                              "raw_minus_reported": float(want) - have}
        else:
            mismatched[key] = [have, float(want)]
    order_ok = list(got["factors"]) == list(raw["factors"])
    with open(os.path.join(rin["dir"], "portfolio_bias.json")) as fh:
        pb = json.load(fh)
    scope = next((k for k in pb if k.startswith("after_burn_in")),
                 "all_valid_dates")
    pb_ok = got["portfolio_bias"] == {
        "scope": scope, "n_portfolios": pb["n_portfolios"],
        **{k: pb[scope][k] for k in ("mean", "median",
                                     "mean_abs_dev_from_1")}}

    try:
        import matplotlib  # noqa: F401
        have_mpl = True
    except ImportError:
        have_mpl = False
    png = os.path.join(rin["dir"], "health.png")
    pcode, _, _ = cli_call(["report", "--results", rin["dir"], "--plot",
                               "health.png"])
    plot = {"matplotlib": have_mpl, "exit": pcode if isinstance(pcode, int)
            else str(pcode), "png_bytes": (os.path.getsize(png)
                                           if os.path.exists(png) else 0)}
    plot_ok = (pcode == 0 and plot["png_bytes"] > 1000 if have_mpl else
               isinstance(pcode, str) and "needs matplotlib" in pcode
               and "pip install" in pcode and not plot["png_bytes"])

    out = ctx["store_out"]
    scratch_csv = os.path.join(out["C"], "barra_data.csv")
    append_csv = os.path.join(out["A"], "barra_data.csv")
    flags = ["--date-col", "date", "--code-col", "stocknames", "--gate", "0"]
    t0 = time.perf_counter()
    ccode, ctext, cerr = cli_call(["crosscheck", "--ours", scratch_csv,
                                   "--external", append_csv, *flags])
    cross_s = time.perf_counter() - t0
    cc = json.loads(ctext.strip().splitlines()[-1])
    # full overlap: each factor's overlap is every finite value of either
    # table, counted here from the text (a factor's warm-up rows are NaN)
    rows, finite = csv_finite_counts(scratch_csv, list(cc))
    rows_ext, finite_ext = csv_finite_counts(append_csv, list(cc))
    full_overlap = {f: rows == rows_ext
                    and cc[f]["n_overlap"] == finite[f] == finite_ext[f]
                    for f in cc}
    # a copy with one value of one factor moved by 1e-3, edited in the
    # text so every other cell keeps its bytes
    with open(append_csv) as fh:
        lines = fh.read().split("\n")
    header = lines[0].split(",")
    factor = next(f for f in header[5:] if f in cc)
    col = header.index(factor)
    row = next(i for i in range(len(lines) // 2, len(lines))
               if lines[i] and lines[i].split(",")[col])
    cells = lines[row].split(",")
    cells[col] = repr(float(cells[col]) + 1e-3)
    lines[row] = ",".join(cells)
    moved_csv = os.path.join(ctx["tmp"], "barra_moved.csv")
    with open(moved_csv, "w") as fh:
        fh.write("\n".join(lines))
    mcode, _, merr = cli_call(["crosscheck", "--ours", scratch_csv,
                               "--external", moved_csv, *flags])
    failing = sorted(ln.split()[2].rstrip(":") for ln in merr.splitlines()
                     if ln.startswith("GATE FAIL "))
    res = {"report_s": report_s, "report_numbers": len(w),
           "mismatched": mismatched, "rounding_straddles": straddles,
           "factor_order_reference": order_ok, "portfolio_bias": pb_ok,
           "plot": plot, "crosscheck_s": cross_s, "rows": rows,
           "crosscheck_exit": ccode, "factors": len(cc),
           "n_overlap": {f: cc[f]["n_overlap"] for f in cc},
           "finite": finite, "rows_ext": rows_ext,
           "max_abs_diff": max(cc[f]["max_abs_diff"] for f in cc),
           "moved": {"factor": factor, "row": row, "exit": mcode,
                     "gate_fail": failing}}
    emit("report_crosscheck", **res)
    require(not mismatched and order_ok and pb_ok,
            f"report_crosscheck: report's numbers differ from the numpy "
            f"recomputation: {mismatched}, order {order_ok}, "
            f"portfolio_bias {pb_ok}")
    require(plot_ok, f"report_crosscheck: report --plot: {plot}")
    require(ccode == 0 and cc and all(full_overlap.values())
            and res["max_abs_diff"] == 0.0,
            f"report_crosscheck: crosscheck --gate 0 of the appended table "
            f"against the from-scratch one: exit {ccode}, {full_overlap}, "
            f"{cerr[-500:]}")
    require(mcode == 1 and failing == [factor],
            f"report_crosscheck: the moved copy must fail the gate naming "
            f"{factor} alone: exit {mcode}, {failing}")
    return res


# -- alpha ---------------------------------------------------------------------

#: bench config 5's expression templates (bench.py:842-849)
ALPHA_TEMPLATES = (
    "cs_rank(delta(close, {d}))",
    "-ts_corr(close, volume, {w})",
    "cs_zscore(ts_std(ret, {w}))",
    "decay_linear(cs_demean(ret), {w}) * {c}",
    "where(ret > 0, cs_rank(volume), -cs_rank(ts_mean(volume, {d})))",
    "ts_rank(close, {w}) - cs_rank(delta(volume, {d}))",
)


def alpha_workload(T: int, N: int, n_exprs: int = 1000):
    """Config 5's workload, a numpy copy of ``bench.py::_alpha_workload``
    (the same draws in the same order): a float32 close/volume/ret panel,
    ``n_exprs`` expressions from the six templates, and the forward
    returns.  Returns (panel dict, expressions, fwd)."""
    import numpy as np

    rng = np.random.default_rng(0)
    close = np.exp(np.cumsum(0.02 * rng.standard_normal((T, N)), axis=0))
    panel = {
        "close": close.astype(np.float32),
        "volume": np.exp(rng.normal(10, 1, (T, N))).astype(np.float32),
        "ret": np.vstack([np.full((1, N), np.nan),
                          close[1:] / close[:-1] - 1]).astype(np.float32),
    }
    exprs = [ALPHA_TEMPLATES[i % len(ALPHA_TEMPLATES)].format(
        d=2 + i % 9, w=5 + i % 20, c=round(0.5 + (i % 10) / 10, 2))
        for i in range(n_exprs)]
    fwd = np.concatenate([panel["ret"][1:],
                          np.full((1, N), np.nan, np.float32)], axis=0)
    return panel, exprs, fwd


#: the card's float32 ``alpha_summary`` against the CPU's float64, the
#: largest |difference| allowed per key.  No frozen budget exists for
#: alpha, so it is derived as ``tools/parity_budget.json``'s budgets were:
#: the reference's own float32-vs-float64 drift, measured with ``mfm_tpu``
#: on the CPU (``evaluate_alphas(..., jit=False)`` then ``alpha_summary``,
#: max |float32 - float64| over the expressions) on the six templates'
#: first instances at config 5's own panel, (T, N) = ALPHA_TOL_SHAPE (the
#: window sums' rounding grows with T; at N = 40 the drift of ic_ir is a
#: fifth of this) — read 1.17e-4 (mean_ic), 2.00e-3 (ic_ir), 4.94e-5
#: (mean_rank_ic), 1.98e-3 (coverage: ts_corr's variance products go
#: negative, and so NaN, in other cells at float32), 4.13e-4
#: (mean_turnover) and 1.18e-5 (mean_spread); each limit is 3x that,
#: rounded up to two digits.  ``tests/test_torch_alpha.py`` re-measures
#: the drift and holds each limit within 2.5-4x of it.
ALPHA_TOL_SHAPE = (1390, 300)
ALPHA_TOL = {"mean_ic": 3.6e-4, "ic_ir": 6.1e-3, "mean_rank_ic": 1.5e-4,
             "coverage": 6.0e-3, "mean_turnover": 1.3e-3,
             "mean_spread": 3.6e-5}
#: the same for phase alpha_alla, float32 against float64 on the card at
#: (2500, 5000), derived the same way at the all-A history and config 5's
#: width, ALPHA_ALLA_TOL_SHAPE (the reference at (2500, 5000) itself
#: takes minutes on the CPU; there it read coverage 1.03e-2 and
#: mean_turnover 1.09e-3, every other key below this shape's): 2.57e-4,
#: 4.44e-3, 1.66e-4, 8.92e-3, 1.03e-3 and 1.91e-5, times 3, rounded up
ALPHA_ALLA_TOL_SHAPE = (2500, 300)
ALPHA_ALLA_TOL = {"mean_ic": 7.8e-4, "ic_ir": 1.4e-2, "mean_rank_ic": 5.0e-4,
                  "coverage": 2.7e-2, "mean_turnover": 3.1e-3,
                  "mean_spread": 5.8e-5}


# -- the all-A universe: bench configs 1 (--universe alla) and 4 --------------

#: the all-A workload's simulated covariances: M and the generator's seed
ALLA_SIMS = 100
ALLA_SEED = 1


def f64_reference(panel, P, config, sim_covs, T, device):
    """The risk path at float64 on ``device`` through the kernels' plain
    versions (``kernels=False``), on the float32 run's own inputs: the
    reference the float32 path is held to within the ``risk`` budgets."""
    import numpy as np

    from mfm_tpu_torch import RiskModel

    ret, cap, styles, industry, valid = panel
    f64 = [torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
           .to(device=device, dtype=torch.float64) for x in (ret, cap, styles)]
    rm = RiskModel(*f64, industry, valid, n_industries=P, config=config,
                   device=device, kernels=False)
    return rm.run_fused(sim_covs=sim_covs.to(torch.float64), sim_length=T)


def alla_kernel_times(out, sim_covs, T, K, M) -> dict:
    """Both kernels at the all-A path's shapes, on the inputs this run's
    eigen stage gave them: the weighted kernel at (T*M, K, K), the full
    kernel at (T, K, K); each held against its plain version there first
    (:func:`hold_kernels`), then timed beside its plain version, its bound
    and ``torch.linalg.eigh`` — for the weighted kernel on the first
    8,192 matrices of G, beside the kernel on the same 8,192 (one library
    call on all T*M matrices takes minutes)."""
    from mfm_tpu_torch.ops import eigh as E
    from mfm_tpu_torch.ops.eigh_cuda import (
        jacobi_eigh_cuda,
        jacobi_eigh_weighted_diag_cuda,
    )

    F0, G, d0, sw, sf = kernel_inputs(out, sim_covs, T, K, M)
    held = hold_kernels(F0, G, d0, sw, sf, "alla_kernel")
    full = {
        "shape": list(F0.shape), "sweeps": sf, "max_abs_err": held["full_err"],
        "ms": time_ms(lambda: jacobi_eigh_cuda(F0, sweeps=sf, sort=False,
                                               canonical_signs=False), 20),
        "plain_ms": time_ms(lambda: E.jacobi_eigh_slots(F0, sf), 2),
        "library_ms": time_ms(lambda: torch.linalg.eigh(F0), 2),
        **full_kernel_bound(F0.shape[0], K, sf)}

    def lib_weighted(A, d):
        w, V = torch.linalg.eigh(A)
        return w, torch.einsum("bki,bk->bi", V * V, d)

    # the library was warmed up on the (T, K, K) batch just above
    B8 = 8192
    lib_8192 = time_ms(lambda: lib_weighted(G[:B8], d0[:B8]), 1,
                       warmup=False)
    ms_8192 = time_ms(lambda: jacobi_eigh_weighted_diag_cuda(
        G[:B8], d0[:B8], sweeps=sw), 20)
    weighted = {
        "shape": list(G.shape), "sweeps": sw,
        "max_abs_err": held["weighted_err"],
        "ms": time_ms(lambda: jacobi_eigh_weighted_diag_cuda(G, d0, sweeps=sw),
                      3),
        "plain_ms": held["weighted_plain_ms"],
        "library_ms": None, "library_ms_8192": lib_8192, "ms_8192": ms_8192,
        "library_over_kernel_8192": lib_8192 / ms_8192,
        **weighted_kernel_bound(G.shape[0], K, sw)}
    emit("alla_kernel_times", weighted=weighted, full=full)
    return {"weighted": weighted, "full": full}


def alla_risk_phase(ctx) -> dict:
    """Phase alla_risk: bench config 1 at ``--universe alla`` (bench.py
    170-184, on one device ``_bench_riskmodel_universe``):
    ``RiskModel.run_fused`` at (T, N, P, Q) = (2500, 5000, 31, 10), K = 42,
    M = 100, float32, ``sim_length=T`` (the production eigen path), on
    ``synthetic_risk_inputs`` and simulated covariances from a seeded
    generator.  The launches of the run, its walls (median of 3, as
    ``bench.py::_time3``), stage walls, busy share and peak memory; both
    kernels at the run's own all-A shapes against their plain versions;
    the outputs within the ``risk`` budgets of the same path at float64
    through the plain versions on the card."""
    from mfm_tpu_torch import RiskModel, RiskModelConfig
    from mfm_tpu_torch.convert import budget_check, outputs_to_numpy
    from mfm_tpu_torch.data.synthetic import (
        resolve_universe,
        synthetic_risk_inputs,
    )
    from mfm_tpu_torch.models.eigen import auto_eigen_chunk, simulated_eigen_covs
    from mfm_tpu_torch.ops.eigh_cuda import launch_counts, reset_launches

    u = resolve_universe(ctx["universe"], T=ctx.get("alla_T"))
    T, N, P, Q = u.T, u.N, u.P, u.Q
    K, M, dev = 1 + P + Q, ALLA_SIMS, ctx["device"]
    config = RiskModelConfig(eigen_n_sims=M)
    panel = synthetic_risk_inputs(T, N, P, Q, seed=0)
    sim_covs = simulated_eigen_covs(
        torch.Generator(device=dev).manual_seed(ALLA_SEED), K, T, M,
        dtype=torch.float32)
    rm = RiskModel(*panel, n_industries=P, config=config, device=dev)
    chunk = auto_eigen_chunk(T, M, K, 4, dev)
    sync()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9

    def run():
        return rm.run_fused(sim_covs=sim_covs, sim_length=T)

    reset_launches()
    reset_nw_launches()
    out, first_s = timed(run)
    launches = launch_counts()
    nw_launches = require_nw_launches(1, "alla_risk")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finite = outputs_finite(out, rm.valid)
    walls = [timed(run)[1] for _ in range(3)]
    stages = {}
    fr, _, _ = rm.reg_by_time()
    (nw_cov, nw_valid), stages["newey_west"] = timed(
        lambda: rm.newey_west_by_time(fr))
    nw_kernel = hold_nw_kernel(fr, config, "alla_nw_kernel_check")
    nw_assoc = nw_methods(fr, K, config, ctx["budget"], 1)
    emit("nw_associative_alla", **nw_assoc)
    require(nw_assoc["valid_equal"] and not nw_assoc["failed"],
            f"alla_risk: the associative Newey-West is outside the nw_cov "
            f"budget: {nw_assoc['failed']}")
    _, stages["regression"] = timed(rm.reg_by_time)
    (ecov, evalid), stages["eigen"] = timed(
        lambda: rm.eigen_risk_adj_by_time(nw_cov, nw_valid,
                                          sim_covs=sim_covs, sim_length=T))
    _, stages["vol_regime"] = timed(
        lambda: rm.vol_regime_adj_by_time(fr, ecov, evalid))
    del fr, nw_cov, nw_valid, ecov, evalid
    prof = profile_run(run)
    kernels = alla_kernel_times(out, sim_covs, T, K, M)
    ref, f64_s = timed(lambda: f64_reference(panel, P, config, sim_covs, T,
                                             dev))
    records, failed = budget_check(outputs_to_numpy(out),
                                   outputs_to_numpy(ref), ctx["budget"])
    res = {"universe": u.name, "T": T, "N": N, "P": P, "Q": Q, "K": K, "M": M,
           "eigen_chunk": chunk, "launches": launches,
           "nw_launches": nw_launches, "finite": finite,
           "first_run_s": first_s, "e2e_median_s": statistics.median(walls),
           "e2e_runs_s": walls, "stages_s": stages,
           "peak_mem_gb": peak_gb, "base_mem_gb": base_gb,
           "busy_s": prof["busy_s"], "busy_share": prof["busy_share"],
           "device_kernels": prof["device_kernels"], "top_kernels": prof["top"],
           "float64_plain_s": f64_s, "vs_float64": records,
           "failed": failed}
    emit("alla_risk", **res)
    require_launches(launches, "alla_risk", 1, 2)
    require(all(finite.values()), f"alla_risk: non-finite outputs: {finite}")
    require(not failed, f"alla_risk: the float32 path is outside the risk "
            f"budgets of float64: {failed}")
    return {**res, "kernel_times": kernels, "nw_kernel": nw_kernel}


def alla_factors_phase(ctx) -> dict:
    """Phase alla_factors: bench config 4 (bench.py:747-826).
    ``FactorEngine(block=16)`` on ``synthetic_market_panel(T=2500, N=5000,
    n_industries=31, seed=1)`` at float32, held to the same engine at
    float64 on the card within the ``factors`` budgets; then ``risk_fn``
    as the bench runs it: the t+1 label in row space, the valid mask,
    ``RiskModel.run(sim_covs=, sim_length=T)`` over every date and the sum
    of the finite outputs.  Walls are medians of 3; the launches are that
    risk run's.  Last, as a check and not timed, the same risk run from
    the first date on which every industry has a stock to the last with a
    label, held to that run at float64 through the plain versions within
    the ``risk`` budgets."""
    from mfm_tpu_torch import FactorEngine, RiskModel, RiskModelConfig
    from mfm_tpu_torch.convert import budget_check, outputs_to_numpy
    from mfm_tpu_torch.data.synthetic import (
        panel_to_engine_fields,
        resolve_universe,
        synthetic_market_panel,
    )
    from mfm_tpu_torch.factors.engine import (
        gather_rows,
        rowspace_index,
        scatter_rows,
    )
    from mfm_tpu_torch.models.eigen import simulated_eigen_covs
    from mfm_tpu_torch.ops.eigh_cuda import launch_counts, reset_launches
    from mfm_tpu_torch.pipeline import BARRA_OUTPUT_STYLES

    u = resolve_universe(ctx["universe"], T=ctx.get("alla_T"))
    T, N, P, Q = u.T, u.N, u.P, u.Q
    K, M, dev = 1 + P + Q, ALLA_SIMS, ctx["device"]
    data, panel_s = timed(lambda: synthetic_market_panel(
        T=T, N=N, n_industries=P, seed=1))

    def engine(dtype):
        return FactorEngine(panel_to_engine_fields(data, dtype, dev),
                            torch.tensor(data["index_close"], dtype=dtype),
                            block=16, device=dev)

    eng = engine(torch.float32)
    sync()
    torch.cuda.reset_peak_memory_stats()
    factors, first_s = timed(eng.run)
    fac_walls = [timed(eng.run)[1] for _ in range(3)]
    fac_prof = profile_run(eng.run)
    fac_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    f64, f64_s = timed(lambda: engine(torch.float64).run())
    vs_f64 = _factor_records(factors, f64, ctx["factor_budget"])
    del f64

    cap = eng.fields["circ_mv"]
    industry = torch.as_tensor(data["industry"], dtype=torch.int32,
                               device=dev)[None, :].expand(T, N)
    def risk_inputs():
        styles = torch.stack([factors[src] for src, _ in BARRA_OUTPUT_STYLES],
                             dim=-1)
        # t+1 return label in row space (main.py:99 groupby shift(-1))
        observed = torch.isfinite(factors["ret"]) | torch.isfinite(cap)
        idx = rowspace_index(observed)
        rs = gather_rows(factors["ret"], idx)
        nxt = scatter_rows(torch.cat(
            [rs[1:], torch.full((1, N), float("nan"), dtype=rs.dtype,
                                device=dev)]), idx)
        valid = (torch.isfinite(styles).all(dim=-1) & torch.isfinite(nxt)
                 & torch.isfinite(cap) & (cap > 0))
        return (torch.where(valid, nxt, float("nan")), cap, styles, industry,
                valid)

    # config 4's risk run, timed as risk_fn is: every date, sim_length=T,
    # and the sum of the finite outputs; its launches are the path's
    config = RiskModelConfig(eigen_n_sims=M, eigen_sim_length=T)
    sim_covs = simulated_eigen_covs(
        torch.Generator(device=dev).manual_seed(ALLA_SEED), K, T, M,
        dtype=torch.float32)

    def risk():
        rm = RiskModel(*risk_inputs(), n_industries=P, config=config,
                       device=dev)
        out = rm.run(sim_covs=sim_covs, sim_length=T)
        return (torch.where(torch.isfinite(out.factor_ret), out.factor_ret,
                            0.0).sum()
                + torch.where(torch.isfinite(out.vr_cov), out.vr_cov,
                              0.0).sum()
                + out.lamb.sum())

    sync()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    checksum, risk_first_s = timed(risk)
    launches = launch_counts()
    risk_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    risk_walls = [timed(risk)[1] for _ in range(3)]
    risk_prof = profile_run(risk)
    del sim_covs

    # the check against float64 runs from the first date on which every
    # industry has a valid stock to the last with a t+1 label: before it
    # few stocks have every style yet (RSTR), and those dates' NaN factor
    # returns reach every later date through the Newey-West sums, in the
    # reference as here (which is why risk_fn sums only the finite outputs)
    _, _, _, _, valid = risk_inputs()
    covered = torch.stack([(valid & (industry == p)).any(dim=1)
                           for p in range(P)], dim=1).all(dim=1)
    lead = int(torch.argmax(covered.to(torch.int32)))
    T1 = T - 1 - lead
    check_config = RiskModelConfig(eigen_n_sims=M, eigen_sim_length=T1)
    check_covs = simulated_eigen_covs(
        torch.Generator(device=dev).manual_seed(ALLA_SEED), K, T1, M,
        dtype=torch.float32)
    rm = RiskModel(*(x[lead:T - 1] for x in risk_inputs()), n_industries=P,
                   config=check_config, device=dev)
    out = rm.run(sim_covs=check_covs, sim_length=T1)
    finite = outputs_finite(out, rm.valid)
    panel = (rm.ret, rm.cap, rm.styles, rm.industry, rm.valid)
    ref, ref_s = timed(lambda: f64_reference(panel, P, check_config,
                                             check_covs, T1, dev))
    records, failed = budget_check(outputs_to_numpy(out),
                                   outputs_to_numpy(ref), ctx["budget"])
    fac_s, risk_s = statistics.median(fac_walls), statistics.median(risk_walls)
    res = {"universe": u.name, "T": T, "N": N, "K": K, "M": M,
           "panel_build_s": panel_s,
           "factors": {"outputs": len(factors), "first_run_s": first_s,
                       "wall_median_s": fac_s, "walls_s": fac_walls,
                       "busy_share": fac_prof["busy_share"],
                       "device_kernels": fac_prof["device_kernels"],
                       "peak_mem_gb": fac_peak_gb, "float64_s": f64_s,
                       "vs_float64": vs_f64},
           "risk": {"risk_dates": T, "first_run_s": risk_first_s,
                    "wall_median_s": risk_s, "walls_s": risk_walls,
                    "busy_share": risk_prof["busy_share"],
                    "device_kernels": risk_prof["device_kernels"],
                    "top_kernels": risk_prof["top"],
                    "peak_mem_gb": risk_peak_gb, "launches": launches,
                    "finite_output_sum": float(checksum)},
           "risk_check": {"leading_dates_missing_an_industry": lead,
                          "check_dates": T1, "finite": finite,
                          "valid_share": float(rm.valid.float().mean()),
                          "float64_plain_s": ref_s, "vs_float64": records,
                          "failed": failed},
           "e2e_s": fac_s + risk_s,
           "stocks_per_s": N * T / (fac_s + risk_s)}
    emit("alla_factors", **res)
    require(len(factors) == 2 + 18 + 5,
            "alla_factors: not every factor came back")
    require(not vs_f64["failed"], f"alla_factors: the float32 factors are "
            f"outside the factors budgets of float64: {vs_f64['failed']}")
    require(bool(covered[lead:T - 1].all()) and T1 >= T // 2,
            f"alla_factors: dates past the leading {lead} lack an industry")
    require_launches(launches, "alla_factors", 1, 2)
    require(bool(torch.isfinite(checksum)), "alla_factors: the risk run's "
            "sum of finite outputs is not finite")
    require(all(finite.values()), f"alla_factors: non-finite outputs on the "
            f"checked dates: {finite}")
    require(not failed, f"alla_factors: the float32 risk run on the checked "
            f"dates is outside the risk budgets of float64: {failed}")
    return res


# -- alpha: bench configs 5 and alpha_alla --------------------------------------

def alpha_tensors(panel_np, fwd_np, device, dtype=torch.float32):
    return ({k: torch.from_numpy(v).to(device=device, dtype=dtype)
             for k, v in panel_np.items()},
            torch.from_numpy(fwd_np).to(device=device, dtype=dtype))


def summary_diff(got: dict, want: dict, tol: dict | None = None) -> dict:
    """Per summary key: max |got - want| over the expressions, whether the
    NaN patterns agree, and (with ``tol``) whether it is within."""
    out = {}
    for k, w in want.items():
        g, w = got[k].double().cpu(), w.double().cpu()
        nan_same = bool(torch.equal(torch.isnan(g), torch.isnan(w)))
        m = torch.isfinite(g) & torch.isfinite(w)
        d = float((g[m] - w[m]).abs().max()) if m.any() else 0.0
        out[k] = {"max_abs": d, "nan_pattern_equal": nan_same}
        if tol is not None:
            out[k]["tol"] = tol[k]
            out[k]["ok"] = nan_same and d <= tol[k]
    return out


def neutralize_twice(panel, device) -> dict:
    """``cs_neutralize`` over a seeded 31-industry code field, twice on the
    card: bitwise equal (a scatter-add's atomics would not be)."""
    import numpy as np

    from mfm_tpu_torch.alpha.dsl import compile_alpha_batch

    T, N = panel["close"].shape
    codes = np.random.default_rng(3).integers(0, 31, N).astype(np.float32)
    p = {**panel, "ind": torch.from_numpy(codes).to(device)[None, :]
         .expand(T, N).contiguous()}
    batch = compile_alpha_batch(["cs_neutralize(ret, ind)",
                                 "cs_neutralize(close, ind, 31)",
                                 "cs_rank(cs_neutralize(volume, ind))"])
    a, b = batch(p), batch(p)
    sync()
    return {"bitwise": same(a, b), "finite_share": float(
        torch.isfinite(a).float().mean())}


def alpha_engine_phase(ctx) -> dict:
    """Phase alpha_engine: bench config 5 (bench.py:857-880), the 1,000
    template expressions of ``_alpha_workload(1390, 300)``:
    ``compile_alpha_batch`` then ``alpha_summary`` on the card, timed
    (median of 3) with its busy share, launches (none: the alpha path
    runs no eigh kernel) and peak memory; chunked (100) == unchunked
    bitwise, and every copy of a repeated expression scored bitwise
    alike; the fused ``compile_alpha_scores(chunk=50)`` against the
    summary of the whole batch at rtol 1e-6; the card's float32 summary
    against the CPU's float64 on the six templates and a seeded sample of
    100 expressions within ALPHA_TOL; ``select_alphas(k=10)`` over that
    sample on the card and on the CPU, both at float64, the same picks
    (the card's float32 picks recorded beside them);
    ``cs_neutralize`` bitwise over two runs."""
    import numpy as np

    from mfm_tpu_torch.alpha.dsl import compile_alpha_batch, compile_alpha_scores
    from mfm_tpu_torch.alpha.metrics import alpha_summary
    from mfm_tpu_torch.alpha.select import select_alphas
    from mfm_tpu_torch.ops.eigh_cuda import launch_counts, reset_launches

    T, N = ctx["alpha_shape"]
    dev = ctx["device"]
    panel_np, exprs, fwd_np = alpha_workload(T, N, ctx["alpha_exprs"])
    panel, fwd = alpha_tensors(panel_np, fwd_np, dev)
    batch = compile_alpha_batch(exprs)

    def run():
        return alpha_summary(batch(panel), fwd)

    sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    summ, first_s = timed(run)
    launches = launch_counts()
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    walls = [timed(run)[1] for _ in range(3)]
    prof = profile_run(run)

    # the workload repeats expressions (a template's parameters cycle):
    # every copy scores bitwise alike wherever it sits in the batch
    copies = {}
    for i, e in enumerate(exprs):
        copies.setdefault(e, []).append(i)
    copies = [torch.as_tensor(v, device=dev) for v in copies.values()
              if len(v) > 1]
    copies_bitwise = all(same(summ[k][v], summ[k][v[:1]].expand(len(v)))
                         for k in summ for v in copies)
    values = batch(panel)
    chunked = compile_alpha_batch(exprs, chunk=100)(panel)
    unchunked = compile_alpha_batch(exprs, chunk=None)(panel)
    chunk_bitwise = same(chunked, unchunked) and same(values, unchunked)
    del chunked, unchunked
    fused = compile_alpha_scores(exprs, chunk=50)(panel, fwd)
    fused_rel = {k: float(((fused[k] - summ[k]).abs() / summ[k].abs().clamp_min(
        1e-30)).nan_to_num().max()) for k in summ}
    fused_ok = all(torch.allclose(fused[k], summ[k], rtol=1e-6, atol=1e-7,
                                  equal_nan=True) for k in summ)
    fused_bitwise = all(same(fused[k], summ[k]) for k in summ)

    rng = np.random.default_rng(5)
    sample = sorted(set(range(len(ALPHA_TEMPLATES)))
                    | set(rng.choice(len(exprs), 100, replace=False).tolist()))
    sub = [exprs[i] for i in sample]
    idx = torch.as_tensor(sample, device=dev)
    panel64, fwd64 = alpha_tensors(panel_np, fwd_np, "cpu", torch.float64)
    cpu_vals, cpu_s = timed(lambda: compile_alpha_batch(sub)(panel64))
    cpu_summ = alpha_summary(cpu_vals, fwd64)
    vs_cpu = summary_diff({k: v[idx] for k, v in summ.items()}, cpu_summ,
                          ALPHA_TOL)
    # the picks at float64 on both; at float32 |mean IC| moves by up to
    # ALPHA_TOL["mean_ic"], more than the gaps between some candidates'
    # scores, so the card's float32 picks are recorded beside them
    panel64c, fwd64c = alpha_tensors(panel_np, fwd_np, dev, torch.float64)
    sel = select_alphas(compile_alpha_batch(sub)(panel64c), fwd64c, 10)
    sel_cpu = select_alphas(cpu_vals, fwd64, 10)
    sel32 = select_alphas(values[idx], fwd, 10)
    del values, cpu_vals, panel64c
    neutral = neutralize_twice(panel, dev)
    med = statistics.median(walls)
    res = {"T": T, "N": N, "exprs": len(exprs), "first_run_s": first_s,
           "wall_median_s": med, "walls_s": walls,
           "exprs_per_s": len(exprs) / med, "busy_share": prof["busy_share"],
           "busy_s": prof["busy_s"], "device_kernels": prof["device_kernels"],
           "top_kernels": prof["top"], "peak_mem_gb": peak_gb,
           "launches": launches, "chunked_bitwise": chunk_bitwise,
           "repeated_expressions": len(copies),
           "copies_bitwise": copies_bitwise,
           "fused_within_1e-6": fused_ok, "fused_bitwise": fused_bitwise,
           "fused_max_rel": fused_rel, "sample": len(sample),
           "cpu_float64_s": cpu_s, "vs_cpu_float64": vs_cpu,
           "select_card_float64": sel["indices"],
           "select_cpu_float64": sel_cpu["indices"],
           "select_card_float32": sel32["indices"],
           "float32_picks_the_same": sel32["indices"] == sel_cpu["indices"],
           "cs_neutralize": neutral}
    emit("alpha_engine", **res)
    require(not any(launches.values()),
            f"alpha_engine: the alpha path launched an eigh kernel: "
            f"{launches}")
    require(chunk_bitwise, "alpha_engine: chunked != unchunked")
    require(copies_bitwise, "alpha_engine: copies of one expression score "
            "apart at different places in the batch")
    require(fused_ok, f"alpha_engine: fused scores off the summary: "
            f"{fused_rel}")
    require(all(v["ok"] for v in vs_cpu.values()),
            f"alpha_engine: card float32 vs CPU float64 outside ALPHA_TOL: "
            f"{vs_cpu}")
    require(sel["indices"] == sel_cpu["indices"],
            f"alpha_engine: select_alphas picks {sel['indices']} on the "
            f"card, {sel_cpu['indices']} on the CPU (float64)")
    require(neutral["bitwise"], "alpha_engine: cs_neutralize moved between "
            "two runs")
    return res


def alpha_alla_phase(ctx) -> dict:
    """Phase alpha_alla: config 5 at all-A scale (bench.py:883-906):
    ``compile_alpha_scores(exprs, chunk=50)`` on ``_alpha_workload(2500,
    5000)`` — the (E, T, N) tensor would be 50 GB, so each chunk of 50 is
    reduced to its summary before the next runs.  Its wall and peak
    memory; the six templates' first instances within ALPHA_ALLA_TOL of
    the card at float64; ``cs_neutralize`` bitwise over two runs."""
    from mfm_tpu_torch.alpha.dsl import compile_alpha_scores
    from mfm_tpu_torch.ops.eigh_cuda import launch_counts, reset_launches

    T, N = ctx["alpha_alla_shape"]
    dev = ctx["device"]
    panel_np, exprs, fwd_np = alpha_workload(T, N, ctx["alpha_exprs"])
    panel, fwd = alpha_tensors(panel_np, fwd_np, dev)
    score = compile_alpha_scores(exprs, chunk=50)
    sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    summ, first_s = timed(lambda: score(panel, fwd))
    launches = launch_counts()
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    _, wall = timed(lambda: score(panel, fwd))
    # the device's busy share over one chunk of 50 expressions
    prof = profile_run(lambda: compile_alpha_scores(exprs[:50], chunk=50)(
        panel, fwd))
    six = len(ALPHA_TEMPLATES)
    panel64, fwd64 = alpha_tensors(panel_np, fwd_np, dev, torch.float64)
    ref, f64_s = timed(lambda: compile_alpha_scores(exprs[:six], chunk=50)(
        panel64, fwd64))
    del panel64, fwd64
    vs_f64 = summary_diff({k: v[:six] for k, v in summ.items()}, ref,
                          ALPHA_ALLA_TOL)
    neutral = neutralize_twice(panel, dev)
    res = {"T": T, "N": N, "exprs": len(exprs), "chunk": 50,
           "chunks": -(-len(exprs) // 50), "first_run_s": first_s,
           "wall_s": wall, "exprs_per_s": len(exprs) / wall,
           "chunk_profile_wall_s": prof["wall_s"],
           "busy_share": prof["busy_share"], "busy_s": prof["busy_s"],
           "device_kernels": prof["device_kernels"], "top_kernels": prof["top"],
           "peak_mem_gb": peak_gb, "panel_gb": 4 * T * N / 1e9,
           "launches": launches, "float64_s": f64_s,
           "vs_float64": vs_f64, "cs_neutralize": neutral,
           "finite_mean_ic": int(torch.isfinite(summ["mean_ic"]).sum())}
    emit("alpha_alla", **res)
    require(all(v.shape == (len(exprs),) for v in summ.values()),
            "alpha_alla: a summary is not one value per expression")
    require(not any(launches.values()),
            f"alpha_alla: the alpha path launched an eigh kernel: {launches}")
    require(all(v["ok"] for v in vs_f64.values()),
            f"alpha_alla: float32 vs float64 outside ALPHA_ALLA_TOL: "
            f"{vs_f64}")
    require(neutral["bitwise"], "alpha_alla: cs_neutralize moved between "
            "two runs")
    return res


#: a raw chat reply for ``alpha --llm``: fences, a numbered list, labels,
#: inline code, prose, a duplicate, a hallucinated field
ALPHA_CHAT = """\
Here are some alpha ideas for your panel:

1. `cs_rank(delta(close, 3))`
2. **Reversal**: -ts_corr(close, volume, 10)
3. alpha_vol = cs_zscore(ts_std(ret, 7))

```python
decay_linear(cs_demean(ret), 8) * 0.8
cs_rank(delta(close, 3))
ts_rank(close, 12) - cs_rank(delta(volume, 4))
```

Factor 2 is a classic price-volume divergence signal, and
`cs_rank(sentiment_score)` would need a field you do not have.
"""


def write_long_csv(path, panel_np, dates, stocks) -> None:
    """The panel as a long csv (trade_date, ts_code, one column per
    field), float32 values in their shortest round-trip form."""
    import csv

    import numpy as np

    T, N = panel_np["close"].shape
    names = list(panel_np)
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["trade_date", "ts_code", *names])
        for t in range(T):
            cols = [[("" if np.isnan(x) else str(x)) for x in panel_np[k][t]]
                    for k in names]
            for j in range(N):
                w.writerow([dates[t], stocks[j], *(c[j] for c in cols)])


def read_scorecard(path) -> dict:
    import csv

    import numpy as np

    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))
    head = rows[0]
    return {"expression": [r[0] for r in rows[1:]],
            **{k: np.array([r[j] or "nan" for r in rows[1:]],
                           dtype=np.float32)
               for j, k in enumerate(head) if k in ALPHA_TOL}}


def alpha_cli_phase(ctx) -> dict:
    """Phase alpha_cli: ``python -m mfm_tpu_torch.cli alpha --exprs FILE
    --panel LONG.csv --select 5`` as a subprocess on the card (its
    default device) over config 5's panel written as a long csv, and
    ``--llm`` on a raw chat reply; each scorecard equals, value for value,
    ``alpha_summary`` computed in this process the way the CLI does
    (the next-traded-day label of ``shift_ret_next_period``)."""
    import numpy as np

    from mfm_tpu_torch.alpha.dsl import compile_alpha_batch
    from mfm_tpu_torch.alpha.llm import extract_expressions
    from mfm_tpu_torch.alpha.metrics import alpha_summary
    from mfm_tpu_torch.pipeline import shift_ret_next_period

    T, N = ctx["alpha_shape"]
    dev, d = ctx["device"], ctx["tmp"]
    panel_np, exprs, _ = alpha_workload(T, N, ctx["alpha_exprs"])
    exprs = exprs[:ctx["alpha_cli_exprs"]]
    dates = [str(np.datetime64("2020-01-01") + t) for t in range(T)]
    stocks = [f"{600000 + j}.SH" for j in range(N)]
    panel_csv = os.path.join(d, "alpha_panel.csv")
    _, csv_s = timed(lambda: write_long_csv(panel_csv, panel_np, dates,
                                            stocks))
    with open(os.path.join(d, "exprs.txt"), "w") as fh:
        fh.write("# config 5's templates\n" + "\n".join(exprs) + "\n")
    with open(os.path.join(d, "chat.md"), "w") as fh:
        fh.write(ALPHA_CHAT)
    panel = {k: torch.from_numpy(v).to(dev) for k, v in panel_np.items()}
    ret = panel_np["ret"].astype(np.float64)
    fwd = torch.from_numpy(shift_ret_next_period(ret, np.isfinite(ret))).to(
        device=dev, dtype=torch.float32)
    llm_exprs, _ = extract_expressions(ALPHA_CHAT, known_fields=set(panel))

    res = {"T": T, "N": N, "csv_write_s": csv_s}
    # both subprocesses at once
    started = {name: start_cli(["alpha", "--exprs", os.path.join(d, src),
                                "--panel", panel_csv, "--out",
                                os.path.join(d, f"scores_{name}.csv"),
                                *extra])
               for name, src, extra in (
                   ("select", "exprs.txt",
                    ["--select", "5", "--select-out",
                     os.path.join(d, "selected.txt")]),
                   ("llm", "chat.md", ["--llm"]))}
    for name, run in started.items():
        out_csv = os.path.join(d, f"scores_{name}.csv")
        rec, wall, stderr = finish_cli(run, f"alpha_cli {name}")
        want_exprs = exprs if name == "select" else llm_exprs
        card = read_scorecard(out_csv)
        want = alpha_summary(compile_alpha_batch(want_exprs)(panel), fwd)
        equal = card["expression"] == want_exprs and all(
            np.array_equal(card[k], want[k].cpu().numpy(), equal_nan=True)
            for k in want)
        res[name] = {"wall_s": wall, "report": rec, "scorecard_equal": equal,
                     "skipped_lines": stderr.count("skipped")}
        require(rec["device"].startswith("cuda"),
                f"alpha_cli {name} did not run on the card: {rec}")
        require(equal, f"alpha_cli {name}: the scorecard is not the "
                "in-process alpha_summary")
    emit("alpha_cli", **res)
    require(res["select"]["report"]["n_selected"] == 5,
            "alpha_cli: --select 5 did not select 5")
    require(res["llm"]["report"]["llm_extraction"]["n_duplicates"] == 1
            and res["llm"]["skipped_lines"] >= 1,
            "alpha_cli --llm: the duplicate or the rejections went missing")
    return res


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from mfm_tpu_torch import RiskModel, RiskModelConfig
    from mfm_tpu_torch.convert import budget_check, outputs_to_numpy
    from mfm_tpu_torch.data.synthetic import (
        CSI300,
        UNIVERSES,
        synthetic_risk_inputs,
    )
    from mfm_tpu_torch.models.eigen import simulated_eigen_covs
    from mfm_tpu_torch.models.risk_model import (
        MIN_EIGEN_DATES,
        MIN_REGRESSION_DATES,
    )
    from mfm_tpu_torch.ops import _build
    from mfm_tpu_torch.ops import eigh as E
    from mfm_tpu_torch.ops.eigh_cuda import (
        _launch_eigh,
        _launch_weighted,
        launch_counts,
        reset_launches,
    )

    marks = [("start", time.perf_counter())]

    def mark(name):
        marks.append((name, time.perf_counter()))

    # -- phase 1: device and build --------------------------------------
    # every Python process this run starts shares one bytecode cache under
    # build/ (the card's host ships torch without bytecode and sets
    # PYTHONDONTWRITEBYTECODE: each process would compile torch's ~1,100
    # modules again, ~7 s, PERF.md §5); one process fills it while the
    # kernels build
    pycache = fill_bytecode_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    kind = torch.cuda.get_device_name(0)
    from mfm_tpu_torch.obs.profile import capture_compile_walls

    t0 = time.perf_counter()
    with capture_compile_walls() as build_walls:
        libs = _build.build_all()
    pycache.wait(timeout=600)
    emit("build", seconds=time.perf_counter() - t0,
         compile_walls_s=build_walls,
         bytecode_cache_rc=pycache.returncode,
         libraries=sorted(p.name for p in libs.values()),
         torch=torch.__version__, cuda=torch.version.cuda)
    ptxas = ptxas_table(_build)

    # -- phase 2: kernels against their plain versions --------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    check_kernels(gen)

    # -- phase 3: the main path at CSI300 width ---------------------------
    T, N, P, Q = CSI300
    K = 1 + P + Q
    config = RiskModelConfig()  # the reference demo's M=100 simulations
    M = config.eigen_n_sims
    panel = synthetic_risk_inputs(T, N, P, Q, seed=0)
    sim_covs = simulated_eigen_covs(
        torch.Generator(device="cuda").manual_seed(0), K, T, M,
        dtype=torch.float32)

    def model(kernels=True):
        return RiskModel(*panel, n_industries=P, config=config,
                         device="cuda", kernels=kernels)

    rm = model()
    sync()
    reset_launches()
    reset_nw_launches()
    out = rm.run_fused(sim_covs=sim_covs, sim_length=T)
    sync()
    launches = launch_counts()
    nw_launches = require_nw_launches(1, "the main path")
    emit("main_path_launches", **launches, newey_west_scan=nw_launches)
    require_launches(launches, "the main path", 1, 2)
    finite = outputs_finite(out, rm.valid)
    emit("main_path_finite", **finite)
    require(all(finite.values()), f"non-finite or empty outputs: {finite}")

    plain_model = model(kernels=False)
    t0 = time.perf_counter()
    plain = plain_model.run_fused(sim_covs=sim_covs, sim_length=T)
    sync()
    plain_wall = time.perf_counter() - t0
    budget = json.loads((ROOT / "tools" / "parity_budget.json").read_text())
    records, failed = budget_check(outputs_to_numpy(out),
                                   outputs_to_numpy(plain), budget["risk"])
    emit("main_path_vs_plain", failed=failed, **records)
    require(not failed, f"kernel path outside the risk budgets: {failed}")
    nw_kernel = hold_nw_kernel(out.factor_ret, config, "nw_kernel_check")

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        rm.run_fused(sim_covs=sim_covs, sim_length=T)
        sync()
        walls.append(time.perf_counter() - t0)
    stage_walls = {k: [] for k in ("regression", "newey_west", "eigen",
                                   "vol_regime")}
    for _ in range(3):
        t0 = time.perf_counter()
        fr, _, _ = rm.reg_by_time()
        sync()
        t1 = time.perf_counter()
        nw_cov, nw_valid = rm.newey_west_by_time(fr)
        sync()
        t2 = time.perf_counter()
        ecov, evalid = rm.eigen_risk_adj_by_time(nw_cov, nw_valid,
                                                 sim_covs=sim_covs,
                                                 sim_length=T)
        sync()
        t3 = time.perf_counter()
        rm.vol_regime_adj_by_time(fr, ecov, evalid)
        sync()
        t4 = time.perf_counter()
        for k, dt in zip(stage_walls, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            stage_walls[k].append(dt)
    emit("main_path_walls", e2e_median_s=statistics.median(walls),
         e2e_runs_s=walls, plain_e2e_s=plain_wall,
         stages_median_s={k: statistics.median(v)
                          for k, v in stage_walls.items()},
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    emit("main_path_profile", **profile_run(
        lambda: rm.run_fused(sim_covs=sim_covs, sim_length=T)))

    # -- phase 4b: the associative Newey-West, compile and memory profile --
    pctx = {"panel": panel, "sim_covs": sim_covs, "config": config, "T": T,
            "K": K, "P": P, "fused_out": out, "device": "cuda",
            "budget": budget["risk"]}
    nw_assoc = nw_associative_phase(pctx)
    profiled = compile_profile_phase(pctx, build_walls)
    # -- phase 4c: the IR audit's probes and kernels at the audit's shapes --
    audit_probes = audit_probes_phase(pctx)
    audit_kernels = audit_kernels_phase(pctx)
    del pctx
    torch.cuda.empty_cache()

    mark("build_checks_main_path")
    # -- phase 5: the daily serving step at CSI300 width -------------------
    def serve_model(sl, cfg=config, data=panel):
        return RiskModel(*(p[sl] for p in data), n_industries=P, config=cfg,
                         device="cuda")

    scratch = tempfile.TemporaryDirectory()
    ctx = {"model": serve_model, "panel": panel, "sim_covs": sim_covs,
           "T": T, "K": K, "M": M, "fused_out": out, "device": "cuda",
           "budget": budget["risk"], "tmp": scratch.name}
    serving = serve_update(ctx)
    serve_bitwise_ops(ctx)
    guarded = serve_guarded(ctx)
    serve_incremental(ctx)
    serve_checkpoint(ctx)

    mark("serving")
    # -- phase 6: the risk pipeline at CSI300 width ------------------------
    ctx["shape"] = CSI300
    pipeline_ingest(ctx)
    pipeline = pipeline_run(ctx)
    pipeline_analytics(ctx)
    pipeline_append(ctx)
    eigen_mc_bf16(ctx)
    bias_launches = ctx["bias_launches"]

    mark("pipeline")
    # -- phase 7: factor production at CSI300 width, raw panel to risk ------
    ctx["factor_budget"] = budget["factors"]
    factor_rolling(ctx)
    factor_engine(ctx)
    factor_launches = factor_pipeline(ctx)["launches"]

    mark("factors")
    # -- phase 8: query serving, bench configs 6 and 10 -----------------------
    # the query path runs no kernel of the port: plain tensor ops
    reset_launches()
    query_engine_phase(ctx)
    query_server_phase(ctx)
    query_cache_phase(ctx)
    query_launches = launch_counts()
    emit("query_launches", **query_launches)
    require(not any(query_launches.values()),
            f"the query path launched an eigh kernel: {query_launches}")

    mark("queries")
    # -- phase 9: scenarios, bench configs 7 and sweep -----------------------
    # each phase counts the launches of the runs that drive its path, not
    # those of its comparisons with plain versions or the CPU
    ctx["scenario_launches"] = {}
    scenario_engine_phase(ctx)
    scenario_served_phase(ctx)
    scenario_sweep_phase(ctx)
    scenario_launches = {k: ctx["scenario_launches"].get(k, 0)
                         for k in launch_counts()}
    emit("scenario_launches", **scenario_launches)
    require_launches(scenario_launches, "the scenario path", 0, 1)
    gate = ctx["scenario_gate"]

    mark("scenarios")
    # -- phase 10: differentiable risk, bench configs 8, 9 and sweep ----------
    # the runs that drive the grad path count their launches; comparisons
    # with plain versions or the CPU do not
    ctx["grad_launches"] = {}
    grad_construct_phase(ctx)
    grad_reverse_phase(ctx)
    grad_sensitivity_phase(ctx)
    grad_served_phase(ctx)
    sweep_refine_phase(ctx)
    grad_launches = {k: ctx["grad_launches"].get(k, 0)
                     for k in launch_counts()}
    emit("grad_launches", **grad_launches)
    require_launches(grad_launches, "the grad path", 0, 1)
    grad_kernel = ctx["grad_kernel"]

    mark("grad")
    # -- phase 11: the serving fleet, bench config 12 at CSI300 width ------
    # the pipeline that writes the fleet's checkpoint launches both
    # kernels; every fleet process after it (the in-process front ends
    # and wire worker, the spawned workers and CLI front ends, each of
    # which reports its own launches in its manifest) launches none
    fleet_ckpt = fleet_checkpoint_phase(ctx)
    fleet_wire = fleet_wire_phase(ctx)
    fleet_mh = fleet_mh_phase(ctx)
    fleet_fe = fleet_frontend_phase(ctx)
    fleet_launches = {
        "checkpoint_pipeline": fleet_ckpt["launches"],
        "wire_worker_in_process": fleet_wire["launches"],
        "mh_front_end_in_process": fleet_mh["front_end_launches"],
        **{f"mh_worker{j}": k["launches"]
           for j, k in fleet_mh["worker_kernels"].items()},
        **{f"frontend_{name}": k["launches"]
           for name, k in fleet_fe["kernels"].items()}}
    emit("fleet_launches", **fleet_launches)

    mark("fleet")
    # the faults section's harness processes (phase fault_matrix) start
    # here and run while this process goes on with the CLI, the mesh and
    # the store: they are bound by process starts, this process by its own
    # host work, and the host has the cores for both
    fault_scratch = tempfile.TemporaryDirectory()
    fault_started = fault_matrix_start(fault_scratch.name)
    # -- phase 11b: the CLI's compute subcommands at CSI300 width -------------
    # the headline `risk` run is a subprocess on the card; the others go
    # through cli.main in this process, each launch count read around the
    # CLI call alone
    cli_risk = cli_risk_phase(ctx)
    cli_update = cli_update_phase(ctx)
    cli_demo = cli_demo_phase(ctx)
    cli_factors_phase(ctx)
    cli_scenario_phase(ctx)
    cli_grad_phase(ctx)
    cli_risk_profile_phase(ctx)
    cli_launches = {"risk_subprocess": cli_risk["kernels"]["launches"],
                    "risk_update": cli_update["plain"]["launches"],
                    "risk_update_guarded": cli_update["guarded"]["launches"],
                    "demo": cli_demo["launches"], **ctx["cli_launches"]}
    emit("cli_launches", **cli_launches)
    mark("cli")
    # -- phase 11e: the mesh: virtual ('date', 'stock') meshes over the card,
    # each sharded path bitwise its unsharded run (the CSI300 table and
    # the checkpoint of the CLI section, still here, feed it) -------------
    ctx.update(config=config, P=P)
    mesh_launches, mesh_shard_ms = mesh_section(ctx)
    # the faults section reads cli_risk's results directory against these
    # host copies of the in-process outputs, so that scratch stays until then
    import numpy as np

    from mfm_tpu_torch.data.artifacts import _numpy

    cres = ctx["cli"]["result"]
    report_inputs = {
        "dir": ctx["cli"]["out"],
        "dates": np.asarray(cres.arrays.dates).astype("datetime64[D]"),
        "names": cres.arrays.factor_names(),
        **{k: _numpy(getattr(cres.outputs, f)).astype(np.float64)
           for k, f in (("factor_ret", "factor_ret"), ("r2", "r2"),
                        ("specific_ret", "specific_ret"),
                        ("lamb", "lamb"))}}
    cli_scratch = scratch
    del ctx, cres
    torch.cuda.empty_cache()

    mark("mesh")
    # -- phase 11c: the host data layer, the store path at CSI300 width -----
    # the store's commands run as subprocesses on the card (each reports
    # its own launches) or through cli.main here; the in-process runs
    # compare and profile
    scratch = tempfile.TemporaryDirectory()
    sctx = {"device": "cuda", "tmp": scratch.name}
    store_build_phase(sctx)
    store_etl_phase(sctx)
    store_launches = store_pipeline_phase(sctx)["launches"]

    mark("store")
    # -- phase 11d: faults — the recovery matrix at CSI300 width, report and
    # crosscheck over the results the CLI and store sections left ------------
    sctx["report_inputs"] = report_inputs
    # the IR audit's subprocess (phase audit), report_crosscheck and the
    # doctrine passes run in this process while the harness processes end
    audit_started = audit_start(scratch.name)
    fault = fault_matrix_phase(
        sctx, fault_started,
        meanwhile=lambda: (report_crosscheck_phase(sctx),
                           doctrine_tools_phase(sctx),
                           audit_phase(sctx, audit_started)))
    torch.cuda.empty_cache()
    fault_scratch.cleanup()
    scratch.cleanup()
    cli_scratch.cleanup()
    del sctx, report_inputs
    torch.cuda.empty_cache()

    mark("faults")
    # -- phase 12: the all-A universe, bench configs 1 (--universe alla), 4 --
    # each path's launches are counted from 0 just before its run and read
    # just after; its comparisons with plain versions come after that
    actx = {"device": "cuda", "universe": "alla", "budget": budget["risk"],
            "factor_budget": budget["factors"]}
    alla = alla_risk_phase(actx)
    torch.cuda.empty_cache()
    alla_factors = alla_factors_phase(actx)
    torch.cuda.empty_cache()

    mark("all_a")
    # -- phase 13: alpha, bench configs 5 and alpha_alla ----------------------
    # the alpha path runs no eigh kernel
    scratch = tempfile.TemporaryDirectory()
    actx.update(alpha_shape=CSI300[:2], alpha_alla_shape=UNIVERSES["alla"][:2],
                alpha_exprs=1000, alpha_cli_exprs=60, tmp=scratch.name)
    alpha_launches = [alpha_engine_phase(actx)["launches"]]
    torch.cuda.empty_cache()
    alpha_launches.append(alpha_alla_phase(actx)["launches"])
    torch.cuda.empty_cache()
    alpha_cli_phase(actx)
    scratch.cleanup()

    mark("alpha")
    # -- phase 4: each kernel at the main path's shapes --------------------
    # the inputs are the ones this run's eigen stage gave the kernels
    F0, G, d0, sw, sf = kernel_inputs(out, sim_covs, T, K, M)
    held = hold_kernels(F0, G, d0, sw, sf, "main_shape")
    weighted_err, full_err = held["weighted_err"], held["full_err"]

    def lib_weighted(A, d):
        w, V = torch.linalg.eigh(A)
        return w, torch.einsum("bki,bk->bi", V * V, d)

    calls = {
        "weighted": (lambda design: _launch_weighted(G, d0, sw, design), 5),
        "full": (lambda design: _launch_eigh(F0, sf, design), 20),
    }
    turns = {k: {"block": [], "warp": []} for k in calls}
    for design in ("block", "warp", "warp", "block"):
        for k, (fn, reps) in calls.items():
            turns[k][design].append(time_ms(lambda: fn(design), reps))
    emit("design_turns", order=["block", "warp", "warp", "block"], **turns)
    # about 3 s of each warp kernel
    emit("sm_clock", **{k: sm_clock_mhz(lambda: calls[k][0]("warp"), reps)
                        for k, reps in (("weighted", 100), ("full", 4000))})
    timings = {
        k: dict(ms=statistics.mean(turns[k]["warp"]),
                prev_design_ms=statistics.mean(turns[k]["block"]))
        for k in calls}
    timings["weighted"]["plain_ms"] = held["weighted_plain_ms"]
    timings["full"]["plain_ms"] = time_ms(lambda: E.jacobi_eigh_slots(F0, sf), 3)
    timings["full"]["library_ms"] = time_ms(lambda: torch.linalg.eigh(F0), 2)
    # one call of the library eigh on all 139,000 matrices of G takes about
    # 72 s, so the library and the warp kernel are timed on the same first
    # 8,192 of them; the library was warmed up on the (1390, 42, 42) batch
    # just above
    B8 = 8192
    lib_8192 = time_ms(lambda: lib_weighted(G[:B8], d0[:B8]), 1,
                       warmup=False)
    warp_8192 = time_ms(lambda: _launch_weighted(G[:B8], d0[:B8], sw,
                                                 "warp"), 20)
    timings["weighted"].update(
        library_ms=None, library_ms_8192=lib_8192, ms_8192=warp_8192,
        library_over_kernel_8192=lib_8192 / warp_8192)

    bound_of = {
        "weighted": lambda b: weighted_kernel_bound(b, K, sw),
        "full": lambda b: full_kernel_bound(b, K, sf),
    }
    B, Bf = G.shape[0], F0.shape[0]
    bounds = {"weighted": bound_of["weighted"](B), "full": bound_of["full"](Bf)}
    emit("kernel_bounds", **bounds)

    # each kernel at the shapes a one-date update launches, held against
    # its plain version there first: the regression runs
    # MIN_REGRESSION_DATES copies of the date (the pinv's normal matrices,
    # n=41 padded to 42), the eigen stage MIN_EIGEN_DATES copies (the F0s,
    # and M simulated matrices each); and at one copy's, 1 and M
    serve_calls = {
        "weighted": lambda b: _launch_weighted(G[-b:], d0[-b:], sw, "warp"),
        "full": lambda b: _launch_eigh(F0[-b:], sf, "warp"),
    }
    serve_batches = {"weighted": [MIN_EIGEN_DATES * M],
                     "full": [MIN_EIGEN_DATES, MIN_REGRESSION_DATES]}
    one_copy = {"weighted": M, "full": 1}
    checks = {}
    for key, batches in serve_batches.items():
        for b in batches + [one_copy[key]]:
            got = serve_calls[key](b)
            sync()
            if key == "full":
                want = E.jacobi_eigh_slots(F0[-b:], sf)
                ok = all(map(torch.equal, got, want))
            else:
                want = E.jacobi_eigh_weighted_diag_slots(G[-b:], d0[-b:], sw)
                ok = (torch.equal(got[0], want[0])
                      and rel_per_matrix(got[1], want[1]) <= 1e-4)
            checks[f"{key}@{b}"] = bool(ok)
    A41 = F0[-MIN_REGRESSION_DATES:, :K - 1, :K - 1].contiguous()
    pinv_rel = rel_per_matrix(E.pinv_psd(A41), E.pinv_psd(A41, kernels=False))
    checks[f"pinv_psd@{MIN_REGRESSION_DATES}"] = pinv_rel <= 1e-4
    serve = {
        key: {"serve_shapes": [[b, K, K] for b in batches],
              "serve_ms": [time_ms(lambda: serve_calls[key](b), 200)
                           for b in batches],
              "serve_one_copy_ms": time_ms(
                  lambda: serve_calls[key](one_copy[key]), 200)}
        for key, batches in serve_batches.items()}
    emit("serve_kernel_times", checks=checks, pinv_rel=pinv_rel, **{
        key: {**serve[key], "serve_bound_ms": [
            bound_of[key](b)["bound_ms"] for b in serve_batches[key]]}
        for key in serve})
    require(all(checks.values()),
            f"a kernel disagrees with its plain version at an update's "
            f"shape: {checks}")

    def alla_entry(name, key):
        kt = alla["kernel_times"][key]
        return {"alla_shape": kt["shape"], "alla_sweeps": kt["sweeps"],
                "alla_launches": alla["launches"][f"{name}/warp"],
                "alla_factors_launches":
                    alla_factors["risk"]["launches"][f"{name}/warp"],
                "alla_ms": kt["ms"], "alla_plain_ms": kt["plain_ms"],
                "alla_bound_ms": kt["bound_ms"],
                "alla_bound_by": kt["bound_by"],
                "alla_library_ms": kt["library_ms"],
                "alla_library_ms_8192": kt.get("library_ms_8192"),
                "alla_ms_8192": kt.get("ms_8192"),
                "alla_max_abs_err": kt["max_abs_err"],
                "alpha_launches": sum(n[f"{name}/warp"]
                                      for n in alpha_launches)}

    def entry(name, key, replaces, err, shape, sweeps, kernel):
        return {"name": name, "route": "cuda", "design": "warp",
                "source": SOURCES["warp"], "replaces": replaces,
                "launches": launches[f"{name}/warp"], "max_abs_err": err,
                "shape": shape, "sweeps": sweeps, **timings[key],
                "bound_ms": bounds[key]["bound_ms"],
                "bound_by": bounds[key]["bound_by"],
                "prev_design": "block", "prev_design_source": SOURCES["block"],
                "registers": ptxas[kernel]["registers"],
                "spill_bytes": ptxas[kernel]["spill_bytes"],
                "serve_launches_per_update":
                    serving["launches_per_update"][f"{name}/warp"],
                "pipeline_launches": pipeline["launches"][f"{name}/warp"],
                "bias_stat_launches": bias_launches[f"{name}/warp"],
                "factor_pipeline_launches": factor_launches[f"{name}/warp"],
                "scenario_launches": scenario_launches[f"{name}/warp"],
                "nw_associative_launches":
                    nw_assoc["run_fused_launches"][f"{name}/warp"],
                "compile_profile_launches":
                    profiled["launches"][f"{name}/warp"],
                "mesh_launches": {k: v[f"{name}/warp"]
                                  for k, v in mesh_launches.items()},
                "mesh_shard_ms": {
                    path: {s: t for s, t in shapes.items()
                           if s.startswith(key)}
                    for path, shapes in mesh_shard_ms.items()},
                "grad_launches": grad_launches[f"{name}/warp"],
                "cli_launches": {k: v[f"{name}/warp"]
                                 for k, v in cli_launches.items()},
                "store_launches": {k: v[f"{name}/warp"]
                                   for k, v in store_launches.items()},
                "fault_launches": {
                    "harness_in_process": fault["launches"][f"{name}/warp"],
                    "per_plan": {
                        p: {"harness": n[f"{name}/warp"],
                            "subprocesses": [
                                s[f"{name}/warp"] for s in
                                fault["subprocess_launches"].get(p, [])]}
                        for p, n in fault["plan_launches"].items()}},
                "audit_launches": {
                    cell: sum(per.get(name, {}).values())
                    for cell, per in audit_kernels["launches"].items()},
                "audit_shapes": {
                    shape: {**t, "max_abs_err":
                            audit_kernels["max_abs_err"][shape]}
                    for shape, t in audit_kernels["shard_shapes"].items()
                    if shape.startswith(key)},
                "audit_csi300_launches":
                    audit_probes["launches"][f"{name}/warp"],
                **serve[key], **alla_entry(name, key)}

    nw_alla, nw_name = alla["nw_kernel"], (
        f"newey_west_scan_kernel<float, {nw_kernel['q']}>")
    kernels = [
        entry("jacobi_eigh_weighted", "weighted",
              "mfm_tpu/ops/eigh_pallas.py:339", weighted_err, [B, K, K], sw,
              f"warp_weighted_kernel<{K}>"),
        {**entry("jacobi_eigh", "full", "mfm_tpu/ops/eigh_pallas.py:258",
                 full_err, [Bf, K, K], sf, f"warp_eigh_kernel<{K}>"),
         "scenario_shape": gate["shape"], "scenario_ms": gate["ms"],
         "scenario_plain_ms": gate["plain_ms"],
         "scenario_bound_ms": gate["bound_ms"],
         "scenario_library_ms": gate["library_ms"],
         "grad_shape": grad_kernel["shape"], "grad_ms": grad_kernel["ms"],
         "grad_plain_ms": grad_kernel["plain_ms"],
         "grad_bound_ms": grad_kernel["bound_ms"],
         "grad_library_ms": grad_kernel["library_ms"]},
        {"name": "newey_west_scan", "route": "cuda",
         "design": "a thread per (i, j) of the K x K state", "source": NW_SOURCE,
         "replaces": None, "plain_version":
             "mfm_tpu_torch/models/newey_west.py:_scan_loop",
         "launches": nw_launches,
         "leaves_differing": nw_kernel["leaves_differing"],
         **{k: nw_kernel[k] for k in ("shape", "q", "ms", "call_ms",
                                      "plain_ms", "bound_ms", "bound_by")},
         "registers": ptxas[nw_name]["registers"],
         "spill_bytes": ptxas[nw_name]["spill_bytes"],
         "init_state_launches": serving["nw_launches"]["init_state"],
         "serve_launches_per_update": serving["nw_launches"]["per_update"],
         "guarded_launches_per_update": guarded["nw_launches"]["per_update"],
         "alla_launches": alla["nw_launches"],
         "alla_leaves_differing": nw_alla["leaves_differing"],
         **{f"alla_{k}": nw_alla[k] for k in ("shape", "ms", "call_ms",
                                              "plain_ms", "bound_ms",
                                              "bound_by")}},
    ]
    mark("kernel_times")
    emit("smoke", seconds=time.perf_counter() - t_start,
         sections_s={name: t - marks[i][1]
                     for i, (name, t) in enumerate(marks[1:])})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
