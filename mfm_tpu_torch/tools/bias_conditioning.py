"""How far the eigenfactor bias statistics of the CSI300 risk pipeline
move under float32 rounding alone, on one card.

    python3 mfm_tpu_torch/tools/bias_conditioning.py [--rowlocal-gram]

Runs ``run_risk_pipeline`` on the seed-0 synthetic CSI300 barra table
(the table ``chip_smoke.py`` ingests, with the same injected
``sim_covs``), then ``bias_stats_summary`` three ways: on the card, on
the CPU over the card's outputs (the comparison of ``chip_smoke.py``
phase ``pipeline_analytics``), and on the card over the outputs moved by
one ulp (``nw_cov``, ``eigen_cov`` and ``factor_ret``).  Each comparison
prints its four entries of largest relative difference (relative to
max(|value|, 1), as the phase measures), with scope, label and
eigenfactor rank, and the smallest eigenvalue of the first 40 valid
Newey-West covariances relative to their largest.  ``--rowlocal-gram``
runs the regression's normal matrices as the CPU's row-local sums
(``ops/eigh._bt``) on the card too, in place of its batched
product.  Prints the card's name and power limit first.  Needs the card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def _worst(got, want, n=4) -> list:
    out = []
    for scope in want:
        for label in want[scope]:
            pairs = zip(got[scope][label]["bias"], want[scope][label]["bias"])
            for rank, (g, w) in enumerate(pairs):
                if g is not None and w is not None:
                    out.append({"rel": abs(g - w) / max(abs(w), 1.0),
                                "scope": scope, "label": label,
                                "rank": rank, "got": g, "want": w})
    return sorted(out, key=lambda r: -r["rel"])[:n]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rowlocal-gram", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import numpy as np
    import torch

    from mfm_tpu_torch import PipelineConfig, run_risk_pipeline
    from mfm_tpu_torch.data.synthetic import CSI300, synthetic_barra_table
    from mfm_tpu_torch.models.bias import bias_stats_summary
    from mfm_tpu_torch.models.eigen import simulated_eigen_covs
    from mfm_tpu_torch.ops import xreg
    from mfm_tpu_torch.ops.eigh import _bt

    if not torch.cuda.is_available():
        print("bias_conditioning: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    if args.rowlocal_gram:
        xreg._gram = lambda XtW, Xr: _bt(XtW.contiguous(),
                                         Xr.transpose(-1, -2).contiguous())
    T, N, P, Q = CSI300
    K = 1 + P + Q
    table, _ = synthetic_barra_table(T=T, N=N, P=P, Q=Q, seed=0)
    sim_covs = simulated_eigen_covs(
        torch.Generator(device="cuda").manual_seed(0), K, T, 100,
        dtype=torch.float32)
    o = run_risk_pipeline(table, config=PipelineConfig(), sim_covs=sim_covs,
                          sim_length=T, device="cuda").outputs

    def summary(out):
        return bias_stats_summary(out.nw_cov, out.nw_valid, out.eigen_cov,
                                  out.eigen_valid, out.factor_ret)

    card = summary(o)
    host = summary(type(o)(*(x.cpu() for x in o)))
    moved = ("nw_cov", "eigen_cov", "factor_ret")
    nudged = summary(type(o)(*(
        torch.nextafter(x, torch.full_like(x, float("inf")))
        if f in moved else x for f, x in zip(o._fields, o))))
    valid = o.nw_valid.cpu().numpy()
    lam = np.linalg.eigvalsh(o.nw_cov.double().cpu().numpy()[valid][:40])
    print(json.dumps({
        "normal_matrices": ("row-local sums" if args.rowlocal_gram
                            else "batched product"),
        "card_vs_cpu": _worst(card, host),
        "card_vs_card_one_ulp": _worst(nudged, card),
        "first_valid_dates_min_rel_eig": float((lam[:, 0]
                                                / lam[:, -1]).min())}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
