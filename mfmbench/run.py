"""Run one cell of the benchmark of ``mfm_tpu_torch`` once, on the CUDA
card(s) of this machine, from the root of a checkout:

    python3 mfmbench/run.py --workload alla.rebuild --seed 7 \\
        --seconds 35 --trace 0

The cells are ``BENCHMARK.json``'s ``workloads``; ``mfmbench/README.md``
says what each is for.  The last line of standard output is the result,
the numbers compared with the reference are the last lines of standard
error.  Without enough CUDA devices it exits 2 and prints no result.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# imports resolve from the checkout's root, never from this folder, and
# every process of a checkout shares one bytecode cache inside it
sys.path[0] = str(ROOT)
sys.pycache_prefix = str(ROOT / "build" / "pycache")
sys.dont_write_bytecode = False

from mfmbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
