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
design of both kernels and agrees with the same path run on the plain
versions within the ``risk`` budgets of ``tools/parity_budget.json``.
Then it drives the daily serving step at the same width — ``init_state``
on the first 1350 dates, the last 40 as one-date updates and as a slab —
in four phases (``serve_update``, ``serve_guarded``, ``serve_incremental``,
``serve_checkpoint``), each held against the full-history run and each
required to go through the warp design of both kernels and to be bitwise
the full run; one more (``serve_bitwise_ops``) requires each op of the
update to keep a date's bits at the batch sizes an update gives it.  Then
the risk pipeline at the same width, in five phases: ``pipeline_ingest``
(the synthetic barra table, ~398,000 rows, densified),
``pipeline_run`` (``run_risk_pipeline``, bitwise ``run_fused`` on the
densified arrays), ``pipeline_analytics`` (specific risk, portfolio risk,
``portfolio_bias(100)`` and the eigenfactor bias statistics, held to the
same functions on the CPU), ``pipeline_append`` (a checkpoint at 1350
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
differences), ``grad_served`` (bench config 9: 10,000 lines with
construct solves through the coalescer, bitwise the sequential loop;
a warm-started solve on the guarded checkpoint) and ``sweep_refine``
(the sweep config's refined leg).  Last it times each kernel at the main path's shapes, the two designs in turns
(block, warp, warp, block), beside its plain version, its bound, the warp
design's ceiling and ``torch.linalg.eigh``, and, after holding it against
its plain version there, at the shapes a one-date update launches, and
samples the SM clock from ``nvidia-smi`` while each warp kernel runs.

Output: the card's name and power limit first; one JSON line per phase;
the ``{"kernels": [...]}`` line second to last; and last
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero before
the last line is printed.  Without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

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


class SmokeFailure(RuntimeError):
    pass


def require(ok, what: str):
    if not ok:
        raise SmokeFailure(what)


def emit(tag: str, **fields):
    print(json.dumps({"phase": tag, **fields}), flush=True)


def sync():
    torch.cuda.synchronize()


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
    """max over the batch of max|x - ref| / max|ref| within each matrix."""
    flat = (x - ref).abs().flatten(1).amax(1)
    return float((flat / ref.abs().flatten(1).amax(1)).max())


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
    for stem in ("jacobi_eigh_warp", "jacobi_eigh"):
        for k in build.ptxas_report(stem):
            m = _KERNEL_NAME.search(k["kernel"])
            name = (f"{m.group(1)}<{m.group(2) or m.group(3)}>" if m
                    else k["kernel"])
            rows.append({"kernel": name,
                         "n": int(m.group(2)) if m and m.group(2) else None,
                         "registers": k.get("registers"),
                         "stack_bytes": k.get("stack_bytes"),
                         "spill_bytes": k.get("spill_store_bytes", 0)
                         + k.get("spill_load_bytes", 0)})
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


def profile_run(fn, top: int = 6) -> dict:
    """Device busy time of one call of ``fn`` from ``torch.profiler``
    (CUDA activity only, to keep the tracer's host cost low): kernel
    launches, summed kernel time, its share of the call's wall, and the
    kernels that took the most device time.  ``busy_s`` is None when the
    tracer saw no device activity."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return {"wall_s": wall,
            "busy_s": busy if rows else None,
            "busy_share": busy / wall if rows else None,
            "device_kernels": sum(e.count for e in rows),
            "top": [{"kernel": e.key[:80], "count": e.count,
                     "device_s": e.self_device_time_total / 1e6}
                    for e in rows[:top]]}


def bound(B, n, rounds, in_bytes, out_bytes, extra_ops=0):
    """The least time the card could take for ``B`` Jacobi eighs of n x n
    over ``rounds`` rounds (9 n^2 flop a matrix a round, plus
    ``extra_ops``), at the FP32 peak, and for the bytes at the memory
    rate; the larger of the two bounds it."""
    ops = rounds * 9 * n * n * B + extra_ops
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
    return bound(B, n, sweeps * (n - 1), 4 * B * n * n, 4 * B * (n * n + n))


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
    (_, st0), init_s = timed(lambda: model(slice(0, T0)).init_state(
        sim_covs=sim_covs, sim_length=T))

    st, rows, walls = st0, [], []
    reset_launches()
    for t in range(T0, T):
        (o, st), dt = timed(lambda: model(slice(t, t + 1)).update(st))
        rows.append(o)
        walls.append(dt)
    per_update = serving_launches(T - T0, "serve_update")
    seq_state = st
    o_slab, st_slab = model(slice(T0, T)).update(st0)
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
        "launches_per_update": per_update,
        "profile_one_update": profile_run(
            lambda: model(slice(T - 1, T)).update(seq_state)),
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
    (o_g, rep, st_g), slab_s = timed(
        lambda: model(slice(T0, T), gcfg, bad).update_guarded(gst))
    slab_launches = serving_launches(1, "serve_guarded slab")
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
    for t in range(T0, T):
        (_, _, st), dt = timed(
            lambda: model(slice(t, t + 1), gcfg, bad).update_guarded(st))
        walls.append(dt)
    per_update = serving_launches(T - T0, "serve_guarded")
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
        "launches_per_update": per_update,
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
#: outputs moved a bias stat by 2.6e-3 relative at T=420 on the CPU)
ANALYTICS_TOL = {"specific_vol": 1e-5, "portfolio_risk": 1e-5,
                 "portfolio_bias": 2e-3, "bias_stats_summary": 2e-2}


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
    bias_launches = card["launches"]["bias_stats_summary"]
    res = {"held_stocks": card["held"], "walls": card["walls"],
           "cpu_walls": host["walls"],
           "portfolio_risk": {k: r[k] for k in keys},
           "sum_contributions_rel": contrib_rel,
           "total_vol_identity_rel": total_rel,
           "vs_cpu": vs_cpu, "tolerance": ANALYTICS_TOL,
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
    failed = [k for k, v in vs_cpu.items() if not v <= ANALYTICS_TOL[k]]
    require(not failed, f"pipeline_analytics: the card disagrees with the "
            f"CPU on {failed}: {vs_cpu}")
    require(bias_launches["jacobi_eigh/warp"] == 4
            and bias_launches["jacobi_eigh/block"] == 0
            and bias_launches["jacobi_eigh_weighted/warp"] == 0,
            f"pipeline_analytics: bias_stats_summary must launch the full "
            f"kernel's warp design 4 times: {bias_launches}")
    ctx["bias_launches"] = bias_launches
    return res


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
FLEET_LINES, FLEET_RATE, FLEET_LINGER = 10_000, 2400.0, 0.1
#: the one-at-a-time baseline's lines and the closed loop's
FLEET_BASELINE_LINES, FLEET_CLOSED_LINES = 400, 2000
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
    0.20, 0.0): 10,000 lines open loop at 2,400 req/s through the
    ``Coalescer`` (linger 0.1 s), every response bitwise the sequential
    loop's per request id; the 400-line one-at-a-time baseline; the
    32-client closed loop.  p50 / p99 and ``p99_within_linger_plus_batch``
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
           "baseline_qps": FLEET_BASELINE_LINES / base_wall,
           "baseline_wall_s": base_wall,
           "sequential_wall_s": seq_wall,
           "open_loop_qps": len(delivered) / open_wall if open_wall else 0.0,
           "open_loop_wall_s": open_wall, "latency": lat,
           "max_batch_wall_s": max_batch, "drains": len(batch_walls),
           "p99_within_linger_plus_batch": bool(
               lat.get("p99_s", float("inf")) <= FLEET_LINGER + max_batch),
           "bitwise_mismatches": len(mismatched),
           "unanswered": lat.get("unanswered"),
           "closed_loop_qps": closed["qps"], "closed_loop_wall_s":
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


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from mfm_tpu_torch import RiskModel, RiskModelConfig
    from mfm_tpu_torch.convert import budget_check, outputs_to_numpy
    from mfm_tpu_torch.data.synthetic import CSI300, synthetic_risk_inputs
    from mfm_tpu_torch.models.eigen import sim_sweeps_for, simulated_eigen_covs
    from mfm_tpu_torch.models.risk_model import (
        MIN_EIGEN_DATES,
        MIN_REGRESSION_DATES,
    )
    from mfm_tpu_torch.ops import _build
    from mfm_tpu_torch.ops import eigh as E
    from mfm_tpu_torch.ops.eigh_cuda import (
        _launch_eigh,
        _launch_weighted,
        jacobi_eigh_cuda,
        jacobi_eigh_weighted_diag_cuda,
        launch_counts,
        reset_launches,
    )

    # -- phase 1: device and build --------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    kind = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    libs = _build.build_all()
    emit("build", seconds=time.perf_counter() - t0,
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
    out = rm.run_fused(sim_covs=sim_covs, sim_length=T)
    sync()
    launches = launch_counts()
    emit("main_path_launches", **launches)
    require(launches["jacobi_eigh_weighted/warp"] >= 1,
            "the main path never launched the weighted kernel's warp design")
    require(launches["jacobi_eigh/warp"] >= 2,
            "the main path launched the full kernel's warp design fewer "
            "than 2 times")
    require(launches["jacobi_eigh_weighted/block"] == 0
            and launches["jacobi_eigh/block"] == 0,
            "the main path (n=42, float32) launched a block-design kernel")
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
    serve_guarded(ctx)
    serve_incremental(ctx)
    serve_checkpoint(ctx)

    # -- phase 6: the risk pipeline at CSI300 width ------------------------
    ctx["shape"] = CSI300
    pipeline_ingest(ctx)
    pipeline = pipeline_run(ctx)
    pipeline_analytics(ctx)
    pipeline_append(ctx)
    eigen_mc_bf16(ctx)
    bias_launches = ctx["bias_launches"]

    # -- phase 7: factor production at CSI300 width, raw panel to risk ------
    ctx["factor_budget"] = budget["factors"]
    factor_rolling(ctx)
    factor_engine(ctx)
    factor_launches = factor_pipeline(ctx)["launches"]

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
    require(scenario_launches["jacobi_eigh/warp"] >= 1,
            "the scenario path never launched the full kernel's warp design")
    require(scenario_launches["jacobi_eigh/block"] == 0
            and scenario_launches["jacobi_eigh_weighted/block"] == 0,
            f"the scenario path launched a block-design kernel: "
            f"{scenario_launches}")
    gate = ctx["scenario_gate"]

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
    require(grad_launches["jacobi_eigh/warp"] >= 1,
            "the grad path never launched the full kernel's warp design")
    require(grad_launches["jacobi_eigh/block"] == 0
            and grad_launches["jacobi_eigh_weighted/block"] == 0,
            f"the grad path launched a block-design kernel: {grad_launches}")
    grad_kernel = ctx["grad_kernel"]
    scratch.cleanup()
    del ctx

    # -- phase 4: each kernel at the main path's shapes --------------------
    # the inputs are the ones this run's eigen stage gave the kernels
    eye = torch.eye(K, device="cuda")
    F0 = torch.where(out.nw_valid[:, None, None], out.nw_cov, eye).contiguous()
    D0, _ = E.batched_eigh(F0, canonical_signs=False)
    s = torch.sqrt(torch.clamp_min(D0, 0.0))
    G = (s[:, None, :, None] * sim_covs[None] * s[:, None, None, :]
         ).reshape(T * M, K, K).contiguous()
    d0 = D0[:, None, :].expand(T, M, K).reshape(T * M, K).contiguous()
    sw = sim_sweeps_for(K, torch.float32, T)
    sf = E._sweeps_for(K, torch.float32)

    ww, hh = jacobi_eigh_weighted_diag_cuda(G, d0, sweeps=sw)
    sync()
    wwp, hhp = E.jacobi_eigh_weighted_diag_slots(G, d0, sw)
    w_equal, h_rel = bool(torch.equal(ww, wwp)), rel_per_matrix(hh, hhp)
    require(w_equal and h_rel <= 1e-4,
            f"weighted kernel at the main path's shape: w bitwise {w_equal}, "
            f"h {h_rel}")
    weighted_err = float(max((ww - wwp).abs().max(), (hh - hhp).abs().max()))
    del wwp, hhp

    wf, Vf = jacobi_eigh_cuda(F0, sweeps=sf, sort=False, canonical_signs=False)
    sync()
    wfp, Vfp = E.jacobi_eigh_slots(F0, sf)
    f_equal = bool(torch.equal(wf, wfp)) and bool(torch.equal(Vf, Vfp))
    rec, orth = recon_orth(wf, Vf, F0)
    require(f_equal and rec <= 5e-5 and orth <= ORTH_TOL_F32,
            f"full kernel at the main path's shape: w, V bitwise {f_equal}, "
            f"recon {rec} orth {orth}")
    full_err = float(max((wf - wfp).abs().max(), (Vf - Vfp).abs().max()))
    emit("main_shape_check", weighted_w_equal=w_equal, weighted_h_rel=h_rel,
         full_wV_equal=f_equal, full_recon=rec, full_orth=orth)

    def lib_weighted():
        w, V = torch.linalg.eigh(G)
        return w, torch.einsum("bki,bk->bi", V * V, d0)

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
    timings["weighted"]["plain_ms"] = time_ms(
        lambda: E.jacobi_eigh_weighted_diag_slots(G, d0, sw), 1)
    timings["full"]["plain_ms"] = time_ms(lambda: E.jacobi_eigh_slots(F0, sf), 3)
    timings["full"]["library_ms"] = time_ms(lambda: torch.linalg.eigh(F0), 2)
    # one call of the library eigh at 139,000 matrices takes about a
    # minute; it was warmed up on the (1390, 42, 42) batch just above
    timings["weighted"]["library_ms"] = time_ms(lib_weighted, 1, warmup=False)

    bound_of = {
        "weighted": lambda b: bound(b, K, sw * (K - 1), 4 * b * (K * K + K),
                                    4 * b * 2 * K, extra_ops=3 * K * K * b),
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
                "grad_launches": grad_launches[f"{name}/warp"],
                **serve[key]}

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
    ]
    emit("smoke", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
