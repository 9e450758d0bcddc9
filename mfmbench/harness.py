"""The benchmark's harness: one cell run once, driven by data.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration and a
traffic mix; the harness finds each by that name as a file of its own:

- ``configs/<config>.json``: the deployment's sizes and parameters;
- ``traffic/<traffic>.json``: the mix's parameters, ``loop`` naming the
  generator and loop in ``loops/<loop>.py`` that reads them;
- ``limits/<cell>.json``: the limit of each number the comparison gives;
- ``metrics/<metric>.py``: one reader per metric, ``read(record)``, which
  returns the metric from the run's record or None where it finds nothing.

A run: set-up (inputs from the seed, warm-up), then with ``--trace 0`` a
window of ``--seconds`` on the host clock and the cell's end-to-end
metrics, with ``--trace 1`` the traced requests and its per-layer
metrics; then, the window closed and the peak memory read, the reference
over the answers drawn from the seed.  The last line of standard output is
the result.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

from mfmbench import compare

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level modules no run may hold once its window has closed: the JAX
#: package the port was made from, and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "mfm_tpu")


def process_start() -> float:
    """This process's start on the epoch clock, from ``/proc`` (10 ms)."""
    with open("/proc/self/stat") as fh:
        ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as fh:
        btime = next(int(line.split()[1]) for line in fh
                     if line.startswith("btime"))
    return btime + ticks / os.sysconf("SC_CLK_TCK")


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: Path):
    name = "mfmbench._" + path.parent.name + "_" + path.stem.replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_for(bench: dict, cell: str, trace: int) -> list:
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def run_cell(bench: dict, cell: dict, seed: int, seconds: float, trace: int,
             device, t_start: float, base: Path = HERE) -> dict:
    """The result of one run of ``cell``, its files found under ``base``
    (the process clock's ``t_start`` begins its set-up)."""
    import torch

    config = load_json(base / "configs" / f"{cell['config']}.json")
    traffic = load_json(base / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(base / "limits" / f"{cell['name']}.json")["numbers"]
    loop = load_module(base / "loops" / f"{traffic['loop']}.py")
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = config["tf32"]
        torch.backends.cudnn.allow_tf32 = config["tf32"]

    run = loop.Cell(config, traffic, seed, device)
    run.setup()
    rec = {"setup_s": time.time() - t_start}
    rec.update(run.window(seconds) if not trace else run.traced())
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    rows = [run.numbers(got, run.want(key)) for key, got in run.sample()]
    del run
    numbers = compare.worst(rows)
    ok, checked = compare.judge(numbers, limits)
    bad = sum(not compare.judge(row, limits)[0] for row in rows)

    metrics = {}
    for m in metrics_for(bench, cell["name"], trace):
        value = load_module(base / "metrics" / f"{m['name']}.py").read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": _finite(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": bool(ok), "attempted": rec["attempted"],
              "failed": bad, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = rec["busy_s"]
        dev["window_s"] = rec["traced_window_s"]
        result["breakdown"] = {"device_ops": rec["device_ops"],
                               "idle_gaps": rec["idle_gaps"]}
    notes = dict(rec.get("notes", {}))
    # the comparison's readings that carry no limit, for the record
    notes["readings"] = {k: _finite(v) for k, v in numbers.items()
                         if k not in limits}
    if on_card:
        notes["power_limit"] = power_limit()
    print("notes " + json.dumps(notes), file=sys.stderr, flush=True)
    # the numbers compared come last, each beside its limit
    result["checked"] = {k: {"value": _finite(v["value"]),
                             "limit": v["limit"]}
                         for k, v in checked.items()}
    return result


def power_limit() -> str | None:
    try:
        done = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return done.stdout.strip() or None


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv) -> int:
    t_start = process_start()
    args = parse(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {c["name"]: c for c in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(bench, cell, args.seed, args.seconds, args.trace,
                      "cuda", t_start)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {bad}", file=sys.stderr)
        return 3
    for k, v in result["checked"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
