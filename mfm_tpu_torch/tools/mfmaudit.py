#!/usr/bin/env python
"""Executable wrapper for the port's IR audit (``mfm_tpu_torch/analysis/``).

Usage (from the checkout's root):
  python mfm_tpu_torch/tools/mfmaudit.py [--strict] [--json FILE]
      [--passes A1,A3] [--baseline FILE] [--budgets FILE]
      [--write-budgets] [--device cuda|cpu]

Runs every registered entry point once on the audit's config matrix and
applies the five passes (A1 aliasing, A2 dtype leaks and host reads, A3
collectives, A4 the recompile surface, A5 memory budgets on the card).
``MFM_TORCH_VIRTUAL_DEVICES`` is set to 8 when it is unset, so the mesh
cells run on one device, as ``tools/mfmaudit.py`` pins the reference's
8-way host split.  The same body is ``python -m mfm_tpu_torch.cli audit``.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from mfm_tpu_torch.analysis.run import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
