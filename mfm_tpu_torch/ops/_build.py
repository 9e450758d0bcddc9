"""Build and load the port's CUDA kernels.

Each ``mfm_tpu_torch/csrc/*.cu`` file compiles with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, which the
wrappers load with ``ctypes``.  PyTorch's own extension loader is not used:
a source that includes PyTorch's headers takes minutes to compile, a plain
C one seconds.  Libraries land in ``build/kernels/`` at the checkout root,
named by a hash of the source and the flags, so an edited source rebuilds
and an unchanged one is reused.  Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found: set CUDA_HOME or put nvcc on PATH to build the "
        "mfm_tpu_torch CUDA kernels")


def _target(src: Path) -> Path:
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def build_all() -> dict[str, Path]:
    """Compile every kernel source whose library is missing — one ``nvcc``
    per source, all started together — and return ``{stem: library}``.
    Raises with nvcc's stderr when a build fails."""
    sources = sorted(CSRC.glob("*.cu"))
    todo = [(src, _target(src)) for src in sources]
    todo = [(src, out) for src, out in todo if not out.exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for src, out in todo:
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            procs.append((src, out, tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        errors = []
        for src, out, tmp, proc in procs:
            _, err = proc.communicate()
            if proc.returncode == 0:
                os.replace(tmp, out)  # atomic: a reader never sees a torn file
            else:
                tmp.unlink(missing_ok=True)
                errors.append(f"{src.name}: nvcc exited {proc.returncode}\n{err}")
        if errors:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return {src.stem: _target(src) for src in sources}


@functools.lru_cache(maxsize=None)
def load(stem: str) -> ctypes.CDLL:
    """The built library of ``csrc/<stem>.cu``, building it at first use."""
    return ctypes.CDLL(str(build_all()[stem]))
