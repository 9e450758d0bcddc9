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
a cache-fronted coalescer).  The query path launches no kernel.  Last
it times each kernel at the main path's shapes, the two designs in turns
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
    G = XtW @ Xr
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
        "matmul XtW @ Xr (normal matrix)": (lambda a, b: a @ b, (XtW, Xr),
                                            reg),
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


def config6_engine(device, dtype=None):
    """Bench config 6's factor space (bench.py:925-930): K = 42, its
    covariance and its benchmark ``idx``, from ``default_rng(0)``.
    Returns the engine, the float32 covariance and the generator."""
    import numpy as np

    from mfm_tpu_torch.serve import QueryEngine

    K = 1 + 31 + 10
    rng = np.random.default_rng(0)
    A = (rng.standard_normal((K, K)) / np.sqrt(K)).astype(np.float32)
    cov = (A @ A.T + 1e-3 * np.eye(K, dtype=np.float32)) * 1e-4
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

    def bound(B, n, rounds, in_bytes, out_bytes, extra_ops=0):
        ops = rounds * 9 * n * n * B + extra_ops
        t_ops, t_bytes = ops / PEAK_FP32_PER_S, (in_bytes + out_bytes) / PEAK_BYTES_PER_S
        # the warp design's ceiling: no FMA contraction (half the FP32
        # peak) and n/2 of a warp's 32 lanes at work
        return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                    bound_by="operations" if t_ops >= t_bytes else "bytes",
                    design_ceiling_ms=1e3 * t_ops * 2 * 32 / (n // 2),
                    flops=ops, bytes=in_bytes + out_bytes)

    bound_of = {
        "weighted": lambda b: bound(b, K, sw * (K - 1), 4 * b * (K * K + K),
                                    4 * b * 2 * K, extra_ops=3 * K * K * b),
        "full": lambda b: bound(b, K, sf * (K - 1), 4 * b * K * K,
                                4 * b * (K * K + K)),
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
                **serve[key]}

    kernels = [
        entry("jacobi_eigh_weighted", "weighted",
              "mfm_tpu/ops/eigh_pallas.py:339", weighted_err, [B, K, K], sw,
              f"warp_weighted_kernel<{K}>"),
        entry("jacobi_eigh", "full", "mfm_tpu/ops/eigh_pallas.py:258",
              full_err, [Bf, K, K], sf, f"warp_eigh_kernel<{K}>"),
    ]
    emit("smoke", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
