"""Readings behind a cell's limits: the program's numbers over many seeds
and the control's over a few, in one process, at the cell's own size.

    python3 mfmbench/calibrate.py --workload alla.rebuild \\
        --seeds 12 --control-seeds 3 --first-seed 1000

For each seed it sets the cell up (inputs from the seed), answers as the
window does (one rebuild, or the traffic's ``check_requests`` scoring
requests) and compares the answers with the reference, as a run does.
For each control seed each of the traffic's ``controls`` takes the
program's place: the reference at TF32 matrix products for the rebuild,
at bfloat16 with prefix-sum and with direct window sums for alpha.
``--controls`` names others instead, such as ``float32``, the reference at
the configuration's own precision, as a witness; ``--risk KEY=JSON`` runs
the program with a model parameter changed, as another.  One JSON line per
reading, then a summary: each number's largest program reading and
smallest control reading over every control.  The benchmark's runs never
run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)
sys.pycache_prefix = str(ROOT / "build" / "pycache")
sys.dont_write_bytecode = False

from mfmbench import compare, harness  # noqa: E402


def readings(cell: dict, seed: int, controls: list, device,
             base: Path = harness.HERE, risk: dict | None = None) -> dict:
    """The program's numbers for ``seed`` and each control's in
    ``controls``, as ``{"program": {...}, "controls": {name: {...}}}``;
    ``risk`` overrides the configuration's model parameters (a witness)."""
    import torch

    config = harness.load_json(base / "configs" / f"{cell['config']}.json")
    if risk:
        config["risk"] = {**config["risk"], **risk}
    traffic = harness.load_json(base / "traffic" / f"{cell['traffic']}.json")
    traffic = dict(traffic, warmup=0)
    loop = harness.load_module(base / "loops" / f"{traffic['loop']}.py")
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = config["tf32"]
        torch.backends.cudnn.allow_tf32 = config["tf32"]
    run = loop.Cell(config, traffic, seed, device)
    run.setup()
    for _ in range(traffic.get("check_requests", 1)):
        run.answer()
    prog, ctl = [], {c: [] for c in controls}
    for key, got in run.sample():
        want = run.want(key)
        prog.append(run.numbers(got, want))
        for c in controls:
            ctl[c].append(run.numbers(run.want(key, c), want))
    return {"program": compare.worst(prog),
            "controls": {c: compare.worst(rows) for c, rows in ctl.items()}}


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=1000)
    p.add_argument("--controls", default=None,
                   help="comma-separated; the traffic's controls if left out")
    p.add_argument("--risk", action="append", default=[],
                   metavar="KEY=JSON", help="override a model parameter")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    risk = {k: json.loads(v) for k, v in
            (item.split("=", 1) for item in args.risk)}
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = {c["name"]: c for c in bench["workloads"]}[args.workload]
    controls = args.controls.split(",") if args.controls else \
        harness.load_json(harness.HERE / "traffic" /
                          f"{cell['traffic']}.json")["controls"]
    lower, upper = {}, {}
    for i in range(max(args.seeds, args.control_seeds)):
        seed = args.first_seed + i
        t0 = time.perf_counter()
        r = readings(cell, seed,
                     controls if i < args.control_seeds else [], args.device,
                     risk=risk)
        if i < args.seeds:
            for k, v in r["program"].items():
                lower[k] = max(lower.get(k, 0.0), v)
        for c in r["controls"].values():
            for k, v in c.items():
                upper[k] = min(upper.get(k, float("inf")), v)
        print(json.dumps({"workload": cell["name"], "seed": seed, **r,
                          "s": time.perf_counter() - t0}), flush=True)
    print(json.dumps({"workload": cell["name"], "risk": risk, "lower": lower,
                      "upper": upper, "seeds": args.seeds,
                      "control_seeds": args.control_seeds,
                      "controls": controls}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
