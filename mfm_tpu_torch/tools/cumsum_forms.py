"""Forms of the alpha path's date-axis cumsum on the card, in turns.

    python3 mfm_tpu_torch/tools/cumsum_forms.py [--exprs-alla 100]

``alpha.dsl._cumsum`` on the card (one ``torch.cumsum`` over the dates as
the innermost axis), the same call over the outer axis, and the CPU's
blocked order (the reference's ``jnp.cumsum`` on XLA's CPU backend, run
on the card).  Each form evaluates ``chip_smoke.py``'s config-5 workload:
the 1,000 expressions and their scorecard at CSI300 width (median of 3
a turn) and the first ``--exprs-alla`` expressions through
``compile_alpha_scores(chunk=50)`` at all-A width (one run a turn); the
turns go through the forms and back, so a drift of the host falls on
every form.  Each form's float32 summary is compared with the CPU at
float64 on config 5's sample (the six templates and 100 seeded
expressions), as ``ALPHA_TOL`` holds it, and with the card at float64 on
all-A's six templates (``ALPHA_ALLA_TOL``); the cumsum's own device time
on the close panel is by CUDA events.  Prints the card's name and power
limit, then one JSON line a width.  Needs the card.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]


def _blocked(x, block=16):
    T = x.shape[0]
    if T <= block:
        return x.cumsum(0)
    nb = -(-T // block)
    pad = x.new_zeros((nb * block - T,) + x.shape[1:])
    inner = torch.cat([x, pad]).reshape((nb, block) + x.shape[1:]).cumsum(1)
    done = _blocked(inner[:, -1], block)
    before = torch.cat([torch.zeros_like(done[:1]), done[:-1]])
    return (before[:, None] + inner).reshape((nb * block,) + x.shape[1:])[:T]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--exprs-alla", type=int, default=100)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from mfm_tpu_torch.alpha import dsl
    from mfm_tpu_torch.alpha.metrics import alpha_summary
    from mfm_tpu_torch.data.synthetic import CSI300, UNIVERSES

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    forms = {"port": dsl._cumsum, "outer": lambda x: x.cumsum(0),
             "blocked": _blocked}
    order = list(forms) + list(forms)[::-1]
    six = len(cs.ALPHA_TEMPLATES)
    for width, (T, N) in (("csi300", CSI300[:2]),
                          ("alla", UNIVERSES["alla"][:2])):
        panel_np, exprs, fwd_np = cs.alpha_workload(T, N, 1000)
        panel, fwd = cs.alpha_tensors(panel_np, fwd_np, "cuda")
        if width == "csi300":
            rng = np.random.default_rng(5)
            sample = sorted(set(range(six)) | set(
                rng.choice(len(exprs), 100, replace=False).tolist()))
            p64, f64 = cs.alpha_tensors(panel_np, fwd_np, "cpu",
                                        torch.float64)
            ref = alpha_summary(dsl.compile_alpha_batch(
                [exprs[i] for i in sample])(p64), f64)
            batch = dsl.compile_alpha_batch(exprs)
            run = lambda: alpha_summary(batch(panel), fwd)  # noqa: E731
            n, reps, tol = len(exprs), 3, cs.ALPHA_TOL
        else:
            sample = list(range(six))
            p64, f64 = cs.alpha_tensors(panel_np, fwd_np, "cuda",
                                        torch.float64)
            ref = dsl.compile_alpha_scores(exprs[:six], chunk=50)(p64, f64)
            score = dsl.compile_alpha_scores(exprs[:args.exprs_alla],
                                             chunk=50)
            run = lambda: score(panel, fwd)  # noqa: E731
            n, reps, tol = args.exprs_alla, 1, cs.ALPHA_ALLA_TOL
        idx = torch.as_tensor(sample, device="cuda")
        walls, diff = {k: [] for k in forms}, {}
        for k in order:
            dsl._cumsum = forms[k]
            got = run()
            walls[k].append(statistics.median(
                cs.timed(run)[1] for _ in range(reps)))
            if k not in diff:
                diff[k] = {key: v["max_abs"] for key, v in cs.summary_diff(
                    {key: v[idx] for key, v in got.items()}, ref).items()}
                diff[k]["cumsum_ms"] = cs.time_ms(
                    lambda: forms[k](panel["close"]), 20)
        dsl._cumsum = forms["port"]
        cs.emit("cumsum_forms", width=width, T=T, N=N, exprs=n, order=order,
                walls_s=walls, exprs_per_s={
                    k: n / statistics.mean(v) for k, v in walls.items()},
                vs_float64=diff, tol=tol)
    return 0


if __name__ == "__main__":
    sys.exit(main())
