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
Then it times each kernel at the main path's shapes, the two designs in
turns (block, warp, warp, block), beside its plain version, its bound, the
warp design's ceiling and ``torch.linalg.eigh``, and samples the SM clock
from ``nvidia-smi`` while each warp kernel runs.

Output: the card's name and power limit first; one JSON line per phase;
the ``{"kernels": [...]}`` line second to last; and last
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero before
the last line is printed.  Without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from mfm_tpu_torch import RiskModel, RiskModelConfig
    from mfm_tpu_torch.convert import budget_check, outputs_to_numpy
    from mfm_tpu_torch.data.synthetic import CSI300, synthetic_risk_inputs
    from mfm_tpu_torch.models.eigen import sim_sweeps_for, simulated_eigen_covs
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

    B, Bf = G.shape[0], F0.shape[0]
    bounds = {
        "weighted": bound(B, K, sw * (K - 1), 4 * B * (K * K + K),
                          4 * B * 2 * K, extra_ops=3 * K * K * B),
        "full": bound(Bf, K, sf * (K - 1), 4 * Bf * K * K,
                      4 * Bf * (K * K + K)),
    }
    emit("kernel_bounds", **bounds)

    def entry(name, key, replaces, err, shape, sweeps, kernel):
        return {"name": name, "route": "cuda", "design": "warp",
                "source": SOURCES["warp"], "replaces": replaces,
                "launches": launches[f"{name}/warp"], "max_abs_err": err,
                "shape": shape, "sweeps": sweeps, **timings[key],
                "bound_ms": bounds[key]["bound_ms"],
                "bound_by": bounds[key]["bound_by"],
                "prev_design": "block", "prev_design_source": SOURCES["block"],
                "registers": ptxas[kernel]["registers"],
                "spill_bytes": ptxas[kernel]["spill_bytes"]}

    kernels = [
        entry("jacobi_eigh_weighted", "weighted",
              "mfm_tpu/ops/eigh_pallas.py:339", weighted_err, [B, K, K], sw,
              f"warp_weighted_kernel<{K}>"),
        entry("jacobi_eigh", "full", "mfm_tpu/ops/eigh_pallas.py:258",
              full_err, [Bf, K, K], sf, f"warp_eigh_kernel<{K}>"),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
