"""Wall of ``RiskModel.run_fused`` at CSI300 width for two checkouts of the
repository, in turns, on one card.

    python3 mfm_tpu_torch/tools/main_path_turns.py ROOT_A ROOT_B \
        [--runs 3] [--rounds 1]

Each turn is a process of its own that imports ``mfm_tpu_torch`` from its
checkout (building that checkout's kernels into its own ``build/``), runs
``run_fused`` on the seed-0 CSI300 panel with injected ``sim_covs`` once
to warm up and then ``--runs`` times, and reports each wall (host clock,
ending in a device synchronise) and their median.  The turns go A, B, B,
A, ``--rounds`` times, so a drift of the host during the call falls on
both sides.  Prints the card's name and power limit, one JSON line per
turn, and a summary line with each checkout's turn medians and the count
of A, B pairs (consecutive turns of one round) in which B was faster.
Needs the card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def _turn(root: str, runs: int) -> dict:
    """One turn, in this process, from the checkout at ``root``."""
    sys.path.insert(0, root)
    import torch

    from mfm_tpu_torch import RiskModel
    from mfm_tpu_torch.data.synthetic import CSI300, synthetic_risk_inputs
    from mfm_tpu_torch.models.eigen import simulated_eigen_covs

    T, N, P, Q = CSI300
    panel = synthetic_risk_inputs(T, N, P, Q, seed=0)
    rm = RiskModel(*panel, n_industries=P, device="cuda")
    sim = simulated_eigen_covs(torch.Generator(device="cuda").manual_seed(0),
                               rm.K, T, rm.config.eigen_n_sims)
    walls = []
    for _ in range(runs + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rm.run_fused(sim_covs=sim, sim_length=T)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    import mfm_tpu_torch

    return {"root": root, "package": mfm_tpu_torch.__file__,
            "warmup_s": walls[0], "walls_s": walls[1:],
            "median_s": statistics.median(walls[1:])}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs=2, metavar="ROOT")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        print(json.dumps(_turn(args.turn, args.runs)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    a, b = (str(Path(r).resolve()) for r in args.roots)
    medians = {a: [], b: []}
    order = [a, b, b, a] * args.rounds
    for root in order:
        out = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), a, b,
             "--runs", str(args.runs), "--turn", root],
            capture_output=True, text=True, cwd=root, timeout=900)
        if out.returncode:
            raise SystemExit(f"turn in {root} failed:\n{out.stderr}")
        turn = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(turn), flush=True)
        medians[root].append(turn["median_s"])
    b_faster = sum(x > y for x, y in zip(medians[a], medians[b]))
    print(json.dumps({"order": ["A", "B", "B", "A"] * args.rounds,
                      "A": a, "B": b, "median_s_by_turn": medians,
                      "pairs": len(medians[a]), "pairs_B_faster": b_faster,
                      "median_of_medians_s": {
                          "A": statistics.median(medians[a]),
                          "B": statistics.median(medians[b])}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
