#!/usr/bin/env python
"""The stage-level mesh-doctrine report of the port (counterpart of
``tools/collective_audit.py``; the pass itself is
``mfm_tpu_torch/analysis/collectives.py``, pass A3 of the audit).

    python mfm_tpu_torch/tools/collective_audit.py [--device cuda|cpu]

Prints the JSON report of :func:`build_report` (the regression, the full
pipeline and ``rolling_beta_hsigma`` on 8x1, 4x2 and 2x4 meshes at
T=192, N=96) and exits 0 iff the structural invariants hold.
``MFM_TORCH_VIRTUAL_DEVICES`` is set to 8 when it is unset.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from mfm_tpu_torch._device import VIRTUAL_DEVICES_ENV  # noqa: E402
from mfm_tpu_torch.analysis.collectives import (  # noqa: E402,F401
    build_report,
    check_invariants,
    eigh_gather_budget,
    summarize,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="collective_audit")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    os.environ.setdefault(VIRTUAL_DEVICES_ENV, "8")
    rep = build_report(device=args.device)
    print(json.dumps(rep, indent=1))
    return 0 if rep["invariants_hold"] else 1


if __name__ == "__main__":
    sys.exit(main())
