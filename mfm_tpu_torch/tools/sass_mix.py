"""Instruction mix of a built CUDA kernel of the PyTorch port, from its SASS.

    python3 mfm_tpu_torch/tools/sass_mix.py \
        [--stem jacobi_eigh_warp] [--kernel warp_weighted_kernelILi42E]

Builds ``mfm_tpu_torch/csrc/<stem>.cu`` if needed (``nvcc``), disassembles
the library with ``cuobjdump -sass``, picks the kernel whose mangled name
contains ``--kernel``, and prints one JSON line: the kernel's instruction
count, the span of its hottest loop (the longest backward branch) and that
loop's count of each opcode.  The Jacobi kernels run one such loop a round,
so loop instructions x rounds x matrices over (4 schedulers x SMs x SM
clock) is the time the kernel would take if it issued an instruction every
cycle on every scheduler.  Needs the CUDA toolkit (``cuobjdump``), so it
runs on the machine with the card; it launches nothing.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

_INSN = re.compile(r"^\s+/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)(\S*)\s*(.*?);")


def _cuobjdump() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "cuobjdump"
    found = str(cand) if cand.exists() else shutil.which("cuobjdump")
    if not found:
        raise SystemExit("cuobjdump not found: needs the CUDA toolkit")
    return found


def mix(lib: Path, kernel: str) -> dict:
    sass = subprocess.run([_cuobjdump(), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        name = func.split("\n", 1)[0].strip()
        if kernel not in name:
            continue
        insns = [(int(m.group(1), 16), m.group(3), m.group(5))
                 for line in func.splitlines() if (m := _INSN.match(line))]
        loops = []
        for addr, op, rest in insns:
            tgt = re.match(r"(?:!?U?P\w+,\s*)?0x([0-9a-f]+)", rest)
            if op == "BRA" and tgt and int(tgt.group(1), 16) < addr:
                loops.append((int(tgt.group(1), 16), addr))
        lo, hi = max(loops, key=lambda s: s[1] - s[0]) if loops else (0, -1)
        body = collections.Counter(op for addr, op, _ in insns if lo <= addr <= hi)
        return {"kernel": name, "instructions": len(insns),
                "loop": [hex(lo), hex(hi)], "loop_instructions": sum(body.values()),
                "loop_mix": dict(body.most_common())}
    raise SystemExit(f"no kernel matching {kernel!r} in {lib}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stem", default="jacobi_eigh_warp")
    ap.add_argument("--kernel", action="append",
                    help="substring of the mangled name (repeatable)")
    args = ap.parse_args()
    from mfm_tpu_torch.ops import _build

    lib = _build.build_all()[args.stem]
    for kernel in args.kernel or ["warp_weighted_kernelILi42E",
                                  "warp_eigh_kernelILi42E"]:
        print(json.dumps(mix(lib, kernel)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
