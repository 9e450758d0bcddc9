"""Where the start of one of the port's CLI processes goes, on the card.

The recovery matrix and the fleet start many short CLI processes (``risk
--update``, ``doctor``, ``serve`` workers); on the card's host each costs
seconds before its command's own work.  This tool builds the recovery
matrix's baseline checkpoint (``tools/faultinject.py``'s ``Baseline``, at
CSI300 width by default) and runs each command ``--reps`` times through a
driver that stamps the time at interpreter start, after ``import torch``,
after ``import mfm_tpu_torch.cli``, after the first CUDA call (only when
the command computes on the card), after the command's own work and at
exit, and reports whether the command left CUDA initialized.  It also runs
``python -X importtime -c "import mfm_tpu_torch.cli"`` and reports the
heaviest imports.  With ``--bytecode-cache DIR`` the commands run with
``PYTHONPYCACHEPREFIX=DIR`` and bytecode writing on (a first run fills
the cache and is reported apart), which is what a host that ships its
packages without bytecode and sets ``PYTHONDONTWRITEBYTECODE`` needs so
that a process does not compile ``torch``'s modules again.  One JSON line
per run, then a summary line:

    python3 mfm_tpu_torch/tools/proc_start.py [--reps 2] [--out F.json]
    python3 mfm_tpu_torch/tools/proc_start.py --bytecode-cache build/pyc
    python3 mfm_tpu_torch/tools/proc_start.py --device cpu --T 44 \\
        --hist 32 --N 20 --P 3 --Q 2 --sims 8    # a small CPU rehearsal
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: the stamping driver: runs ``cli.main(argv)`` as ``python -m
#: mfm_tpu_torch.cli`` would, with a time stamp between the stages
_DRIVER = """\
import json
import os
import sys
import time

t = {"start": time.time()}
import torch
t["torch"] = time.time()
from mfm_tpu_torch import cli
t["import"] = time.time()
if os.environ.get("PROC_START_CUDA") == "1":
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
t["cuda"] = time.time()
code = 0
try:
    cli.main(sys.argv[1:])
except SystemExit as e:
    code = e.code if isinstance(e.code, int) else 1
t["work"] = time.time()
sys.stderr.write("\\nPROC_START " + json.dumps(
    {"t": t, "cuda_initialized": torch.cuda.is_initialized()}) + "\\n")
sys.stderr.flush()
sys.exit(code)
"""


def _bytecode_env(cache: str | None) -> dict:
    """The environment of a child process: with ``cache``, bytecode is
    written to and read from ``cache``."""
    env = dict(os.environ)
    if cache:
        env.pop("PYTHONDONTWRITEBYTECODE", None)
        env["PYTHONPYCACHEPREFIX"] = os.path.abspath(cache)
    return env


def _stamped(argv, *, cuda: bool, cache: str | None = None) -> dict:
    """One stamped run: seconds per stage and the process's wall."""
    env = {**_bytecode_env(cache), "PYTHONPATH": os.pathsep.join(
        p for p in (REPO_ROOT, os.environ.get("PYTHONPATH")) if p),
        "PROC_START_CUDA": "1" if cuda else "0"}
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-c", _DRIVER, *map(str, argv)],
                          env=env, cwd=REPO_ROOT, capture_output=True,
                          text=True, timeout=600, stdin=subprocess.DEVNULL)
    t_end = time.time()
    line = [ln for ln in proc.stderr.splitlines()
            if ln.startswith("PROC_START ")]
    if proc.returncode != 0 or not line:
        raise SystemExit(f"proc_start: {argv[:2]} exited "
                         f"{proc.returncode}\n{proc.stderr[-2000:]}")
    rec = json.loads(line[-1][len("PROC_START "):])
    t = rec["t"]
    return {"wall_s": t_end - t0,
            "interpreter_s": t["start"] - t0,
            "import_torch_s": t["torch"] - t["start"],
            "import_port_s": t["import"] - t["torch"],
            "first_cuda_call_s": t["cuda"] - t["import"],
            "work_s": t["work"] - t["cuda"],
            "exit_s": t_end - t["work"],
            "cuda_initialized": rec["cuda_initialized"]}


def _importtime(cache: str | None, top: int = 12) -> list:
    """The heaviest imports of ``import mfm_tpu_torch.cli`` by cumulative
    time (``python -X importtime``), in seconds."""
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-c",
         "import mfm_tpu_torch.cli"], cwd=REPO_ROOT, capture_output=True,
        text=True, timeout=600, env=_bytecode_env(cache))
    rows = []
    for ln in proc.stderr.splitlines():
        if not ln.startswith("import time:") or "cumulative" in ln:
            continue
        self_us, cum_us, name = ln.split(":", 1)[1].split("|")
        depth = (len(name) - len(name.lstrip()) - 1) // 2
        rows.append({"module": name.strip(), "depth": depth,
                     "self_s": int(self_us) / 1e6,
                     "cumulative_s": int(cum_us) / 1e6})
    shallow = [r for r in rows if r["depth"] <= 3]
    return sorted(shallow, key=lambda r: -r["cumulative_s"])[:top]


def main(argv=None) -> int:
    if REPO_ROOT not in sys.path:
        sys.path.insert(0, REPO_ROOT)
    from mfm_tpu_torch._device import resolve_device
    from mfm_tpu_torch.tools import faultinject as fi

    ap = argparse.ArgumentParser(prog="proc_start.py",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--out", default=None, metavar="FILE.json")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--bytecode-cache", default=None, metavar="DIR",
                    help="run the commands with PYTHONPYCACHEPREFIX=DIR "
                         "and bytecode writing on")
    geometry = dict(T=1390, hist=1378, slab=4, N=300, P=31, Q=10, sims=100)
    for key, v in geometry.items():
        ap.add_argument(f"--{key}", type=int, default=v)
    args = ap.parse_args(argv)
    g = fi.Geometry(**{k: getattr(args, k) for k in geometry})
    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    root = tempfile.mkdtemp(prefix="mfm_torch_proc_start_")
    runs = []
    cache = args.bytecode_cache
    try:
        base = fi.Baseline(root, 0, g, device)
        fill = None
        if cache:
            # the first process under the cache compiles and writes it
            fill = _stamped(["doctor", base.dir], cuda=False, cache=cache)
            print(json.dumps({"command": "doctor (fills the cache)",
                              **fill}), flush=True)
        for rep in range(args.reps):
            d = base.fresh(root, f"update{rep}", base.snaps[0])
            path = os.path.join(d, "state.npz")
            cmds = {
                "risk --update": (base.update_cmd(
                    0, path, os.path.join(d, "tables")), cuda),
                "doctor": (["doctor", d], False),
                "serve --worker": (["serve", path, "--worker",
                                    "--worker-id", 0, "--device",
                                    device.type], cuda),
            }
            for name, (cmd, on_card) in cmds.items():
                rec = {"command": name, "rep": rep,
                       **_stamped(cmd, cuda=on_card, cache=cache)}
                runs.append(rec)
                print(json.dumps(rec), flush=True)
        imports = _importtime(cache)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    summary = {"geometry": dataclasses.asdict(g),
               "device": device.type, "reps": args.reps,
               "bytecode_cache": cache, "cache_fill": fill,
               "dont_write_bytecode": bool(
                   os.environ.get("PYTHONDONTWRITEBYTECODE")),
               "median_s": {}, "imports": imports}
    for name in dict.fromkeys(r["command"] for r in runs):
        rs = [r for r in runs if r["command"] == name]
        summary["median_s"][name] = {
            k: statistics.median(r[k] for r in rs)
            for k in rs[0] if k.endswith("_s")}
        summary["median_s"][name]["cuda_initialized"] = all(
            r["cuda_initialized"] for r in rs)
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"summary": summary, "runs": runs}, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
