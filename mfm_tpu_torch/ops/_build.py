"""Build and load the port's CUDA kernels.

Each ``mfm_tpu_torch/csrc/*.cu`` file compiles with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, which the
wrappers load with ``ctypes``.  PyTorch's own extension loader is not used:
a source that includes PyTorch's headers takes minutes to compile, a plain
C one seconds.  Libraries land in ``build/kernels/`` at the checkout root,
named by a hash of the source and the flags, so an edited source rebuilds
and an unchanged one is reused.  Beside each library lies nvcc's report
(``-Xptxas -v``: each kernel's registers, stack frame and spill bytes),
kept on success too; :func:`ptxas_report` parses it.  Nothing is built at
import time.  Each build and each load is an event of the compile-contract
counter (:mod:`mfm_tpu_torch.utils.contracts`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

from mfm_tpu_torch.utils import contracts

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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


def _log(lib: Path) -> Path:
    return lib.with_suffix(".ptxas.txt")


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
        t0 = time.perf_counter()
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
                _log(out).write_text(err)
                os.replace(tmp, out)  # atomic: a reader never sees a torn file
                # all nvcc processes started together: each build's wall
                # runs from that start until its own process is reaped
                contracts.notify(contracts.KERNEL_BUILD_EVENT, src.name,
                                 time.perf_counter() - t0)
            else:
                tmp.unlink(missing_ok=True)
                errors.append(f"{src.name}: nvcc exited {proc.returncode}\n{err}")
        if errors:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return {src.stem: _target(src) for src in sources}


@functools.lru_cache(maxsize=None)
def load(stem: str) -> ctypes.CDLL:
    """The built library of ``csrc/<stem>.cu``, building it at first use."""
    t0 = time.perf_counter()
    lib = ctypes.CDLL(str(build_all()[stem]))
    contracts.notify(contracts.KERNEL_LOAD_EVENT, stem,
                     time.perf_counter() - t0)
    return lib


_ENTRY = re.compile(r"Compiling entry function '(\w+)' for '(\w+)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def ptxas_report(stem: str) -> list[dict]:
    """Each kernel of ``csrc/<stem>.cu`` as ``-Xptxas -v`` reported it when
    the library was built: mangled name, registers, stack frame and spill
    bytes.  Builds the library if it is missing."""
    text = _log(build_all()[stem]).read_text()
    kernels, cur = [], None
    for line in text.splitlines():
        if m := _ENTRY.search(line):
            cur = {"kernel": m.group(1), "arch": m.group(2)}
            kernels.append(cur)
        elif cur is not None and (m := _FRAME.search(line)):
            cur.update(stack_bytes=int(m.group(1)),
                       spill_store_bytes=int(m.group(2)),
                       spill_load_bytes=int(m.group(3)))
        elif cur is not None and (m := _REGS.search(line)):
            cur["registers"] = int(m.group(1))
    return kernels
