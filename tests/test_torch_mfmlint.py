"""The port's doctrine linter (``mfm_tpu_torch/lint.py``) beside the JAX
package's (``tests/test_mfmlint.py``), test for test.

- the port's tree (``mfm_tpu_torch`` and ``chip_smoke.py``) lints
  strict-clean against its committed baseline, every entry justified;
- a fixture with no JAX call goes through both packages' linters on the
  same tree and gives the same findings (file, line, rule, qualname);
- a fixture with a JAX call is translated to torch line for line: on R3
  and R5 the port gives, on the translation, the findings the reference
  gives on the original (the paths mapped ``mfm_tpu/`` -> ``mfm_tpu_torch/``
  and ``tools/`` -> ``mfm_tpu_torch/tools/``, the port's entrypoints); R1,
  R2, R4 and R7 need a traced region or donation, which the translation
  does not have, and the port gives none of them;
- R6 reads ``PartitionSpec`` axis names against the axes
  ``parallel/mesh.py`` builds its ``Mesh`` over, as the reference does,
  and fires on a stray axis in the port's own spelling (``P`` from
  ``mfm_tpu_torch.parallel.mesh``);
- injection drills on scratch copies of the port flip the CLI to exit 1;
- ``lint.py`` imports no torch, numpy, jax or ``mfm_tpu``.
"""

import ast
import json
import shutil
import textwrap
from pathlib import Path

import pytest

from mfm_tpu import lint as ref_lint
from mfm_tpu_torch import lint
from mfm_tpu_torch.cli import main as cli_main
from mfm_tpu_torch.lint import (
    DEFAULT_BASELINE,
    DEFAULT_TARGETS,
    REPO_ROOT,
    RULES,
    load_baseline,
    main,
    run_lint,
)

REPO = Path(REPO_ROOT)


def _write(root, files):
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))


def _lint(tmp_path, files, baseline=None, pkg=lint):
    _write(tmp_path, files)
    return pkg.run_lint([str(tmp_path)], baseline=baseline,
                        root=str(tmp_path))


def _keys(res, rename=lambda f: f):
    return sorted((rename(v.file.replace("\\", "/")), v.line, v.rule,
                   v.qualname) for v in res.new)


def _to_port(path: str) -> str:
    if path.startswith("mfm_tpu/"):
        return "mfm_tpu_torch/" + path[len("mfm_tpu/"):]
    if path.startswith("tools/"):
        return "mfm_tpu_torch/tools/" + path[len("tools/"):]
    return path


def _translated(tmp_path, original, translation):
    """(reference on the original, port on the translation), the
    reference's paths mapped to the port's."""
    want = _lint(tmp_path / "ref", original, pkg=ref_lint)
    got = _lint(tmp_path / "port", translation)
    return _keys(got), _keys(want, _to_port)


# -- layer 1: the real tree ---------------------------------------------------

def test_repo_lints_clean_with_committed_baseline():
    baseline = load_baseline(str(REPO / DEFAULT_BASELINE))
    assert len(baseline) <= 3, "baseline creep: fix the violation instead"
    for b in baseline:
        assert b.get("justification"), f"unjustified baseline entry: {b}"
    res = run_lint(DEFAULT_TARGETS, baseline=baseline)
    assert not res.new, "\n".join(v.render() for v in res.new)
    assert not res.stale, f"stale baseline entries: {res.stale}"
    assert main(["--strict"]) == 0


def test_cli_lint_subcommand_is_the_pass(capsys):
    with pytest.raises(SystemExit) as exc:
        cli_main(["lint", "--strict", "--json"])
    assert exc.value.code == 0
    out = json.loads(capsys.readouterr().out)
    assert out["new"] == [] and out["stale"] == []
    assert len(out["baselined"]) == len(
        load_baseline(str(REPO / DEFAULT_BASELINE)))


# -- layer 2: fixtures without a JAX call, through both linters ---------------

SHARED = {
    "clean": {"mod.py": "x = 1\n"},
    "syntax_error": {"broken.py": "def f(:\n    pass\n"},
    "host_spans": {
        "tools/host_like.py": """
            import time
            import numpy as np

            def host_golden(x):
                t0 = time.perf_counter()
                y = np.sum(x)                     # pure numpy: synchronous
                return time.perf_counter() - t0, y

            def helper_span(x):
                t0 = time.perf_counter()
                y = helper(x)
                return time.perf_counter() - t0, y

            def helper(x):
                return sorted(x)
        """,
        "mfm_tpu_torch/tools/host_like.py": """
            import time

            def span(x):
                t0 = time.perf_counter()
                y = len(x)
                return time.perf_counter() - t0, y
        """},
    "threads_and_handles": {
        "pkg/fleet.py": """
            import subprocess
            import threading

            class Worker:
                def __init__(self):
                    self.proc = subprocess.Popen(["true"])
                    self._lock = threading.Lock()

                def alive(self):
                    with self._lock:
                        return self.proc.poll() is None

            def record(path, **fields):
                ev = {"kind": "x"}
                ev.update(fields)
                with open(path, "w") as fh:
                    fh.write(str(ev))
                    fh.flush()
        """},
    "partition_spec_axes": {
        # the reference's R6 fixture (tests/test_mfmlint.py:292)
        "parallel/mesh.py": """
            from jax.sharding import Mesh
            def make(devs):
                return Mesh(devs, ("row", "col"))
        """,
        "specs.py": """
            from jax.sharding import PartitionSpec as P
            GOOD = P("row", None)
            ALSO = P(("row", "col"))
            BAD = P("model")           # R6: not a doctrine axis
        """},
    "config_lookalikes": {
        # neither package's R3 reads a non-jax `config.update` or a
        # module attribute store that is no numeric switch
        "pkg/settings.py": """
            import types

            config = types.SimpleNamespace(update=lambda *a: None)
            config.update("jax_enable_x64", True)
            config.update("jax_enable_x64", True)

            class Flags:
                allow_fast = True

            Flags.allow_fast = False
        """},
}


@pytest.mark.parametrize("name", list(SHARED))
def test_fixtures_without_jax_give_the_references_findings(tmp_path, name):
    got = _lint(tmp_path, SHARED[name])
    want = ref_lint.run_lint([str(tmp_path)], root=str(tmp_path))
    assert _keys(got) == _keys(want)


def test_syntax_error_is_reported_in_both(tmp_path):
    got = _lint(tmp_path, SHARED["syntax_error"])
    assert [(v.rule, v.qualname) for v in got.new] == [("R1", "<module>")]
    assert "syntax error" in got.new[0].message


def test_strict_fails_on_stale_baseline(tmp_path):
    (tmp_path / "clean.py").write_text("x = 1\n")
    bl = tmp_path / "baseline.json"
    bl.write_text(json.dumps([{"file": "clean.py", "rule": "R1",
                               "qualname": "ghost", "note": "stale"}]))
    args = [str(tmp_path), "--baseline", str(bl), "--root", str(tmp_path)]
    for pkg in (lint, ref_lint):
        assert pkg.main(args) == 0          # default: stale is a warning
        assert pkg.main(args + ["--strict"]) == 1


# -- layer 2: JAX fixtures translated to torch ---------------------------------

def test_r3_switch_placement_and_duplicates(tmp_path):
    original = {
        "mfm_tpu/deep/worker.py": """
            import jax
            jax.config.update("jax_enable_x64", True)   # R3: not entrypoint
        """,
        "tools/capture.py": """
            import jax
            jax.config.update("jax_platforms", "cpu")    # entrypoint: fine
            jax.config.update("jax_enable_x64", True)    # distinct key: fine
            jax.config.update("jax_platforms", "cpu")    # R3: duplicate key
        """}
    translation = {
        "mfm_tpu_torch/deep/worker.py": """
            import torch
            torch.set_default_dtype(torch.float64)       # R3: not entrypoint
        """,
        "mfm_tpu_torch/tools/capture.py": """
            import torch
            torch.set_float32_matmul_precision("highest")    # entrypoint
            torch.backends.cuda.matmul.allow_tf32 = False    # distinct switch
            torch.set_float32_matmul_precision("highest")    # R3: duplicate
        """}
    got, want = _translated(tmp_path, original, translation)
    assert got == want
    assert {(f, r) for f, _l, r, _q in got} == {
        ("mfm_tpu_torch/deep/worker.py", "R3"),
        ("mfm_tpu_torch/tools/capture.py", "R3")}


def test_r3_tf32_flag_through_an_alias_outside_the_entrypoints(tmp_path):
    """``matmul = torch.backends.cuda.matmul; matmul.allow_tf32 = ...`` is
    a TF32 switch whatever the receiver's name; ``utils/prec.py``, the CLI
    and the smoke may set it, and setting it and restoring it from a
    saved value is no duplicate."""
    res = _lint(tmp_path, {
        "mfm_tpu_torch/models/fast.py": """
            import torch

            def go():
                matmul = torch.backends.cuda.matmul
                matmul.allow_tf32 = True                 # R3
        """,
        "mfm_tpu_torch/utils/prec.py": """
            import torch

            def scoped():
                matmul = torch.backends.cuda.matmul
                saved = matmul.allow_tf32
                matmul.allow_tf32 = False
                try:
                    pass
                finally:
                    matmul.allow_tf32, = (saved,)
        """,
        "chip_smoke.py": """
            import torch
            torch.backends.cudnn.allow_tf32 = False
        """})
    assert [(v.file.replace("\\", "/"), v.rule, v.qualname)
            for v in res.new] == [("mfm_tpu_torch/models/fast.py", "R3", "go")]


def test_r5_unforced_timing_span_in_tools(tmp_path):
    original = {
        "tools/bench_like.py": """
            import time
            import jax.numpy as jnp
            import numpy as np

            def unforced(x):
                t0 = time.perf_counter()
                y = jnp.sum(x)                    # R5: dispatch, not compute
                return time.perf_counter() - t0, y

            def forced(x):
                t0 = time.perf_counter()
                y = jnp.sum(x).block_until_ready()
                return time.perf_counter() - t0, y

            def host_golden(x):
                t0 = time.perf_counter()
                y = np.sum(x)                     # pure numpy: synchronous
                return time.perf_counter() - t0, y
        """,
        "mfm_tpu/inner.py": """
            import time
            import jax.numpy as jnp

            def unforced(x):
                t0 = time.perf_counter()
                y = jnp.sum(x)
                return time.perf_counter() - t0, y
        """}
    translation = {
        "mfm_tpu_torch/tools/bench_like.py": """
            import time
            import torch
            import numpy as np

            def unforced(x):
                t0 = time.perf_counter()
                y = torch.sum(x)                  # R5: enqueue, not compute
                return time.perf_counter() - t0, y

            def forced(x):
                t0 = time.perf_counter()
                y = torch.sum(x).item()
                return time.perf_counter() - t0, y

            def host_golden(x):
                t0 = time.perf_counter()
                y = np.sum(x)                     # pure numpy: synchronous
                return time.perf_counter() - t0, y
        """,
        "mfm_tpu_torch/inner.py": """
            import time
            import torch

            def unforced(x):
                t0 = time.perf_counter()
                y = torch.sum(x)
                return time.perf_counter() - t0, y
        """}
    got, want = _translated(tmp_path, original, translation)
    assert got == want
    assert [(r, q) for _f, _l, r, q in got] == [("R5", "unforced")]


def test_r5_eigen_sweep_cell_timing(tmp_path):
    original = {"tools/sweep_like.py": """
        import time
        import numpy as np
        import jax
        import jax.numpy as jnp

        def unforced_cell(stage, covs, valid, sim_covs):
            t0 = time.perf_counter()
            out = jax.jit(stage)(covs, valid, sim_covs)  # R5: dispatch only
            return time.perf_counter() - t0, out

        def forced_cell(stage, covs, valid, sim_covs):
            t0 = time.perf_counter()
            out = float(np.asarray(jnp.nansum(jax.jit(stage)(
                covs, valid, sim_covs))))
            return time.perf_counter() - t0, out
    """}
    translation = {"mfm_tpu_torch/tools/sweep_like.py": """
        import time
        import numpy as np
        import torch
        import torch

        def unforced_cell(stage, covs, valid, sim_covs):
            t0 = time.perf_counter()
            out = torch.no_grad()(stage)(covs, valid, sim_covs)  # R5
            return time.perf_counter() - t0, out

        def forced_cell(stage, covs, valid, sim_covs):
            t0 = time.perf_counter()
            out = float(torch.nansum(torch.no_grad()(stage)(
                covs, valid, sim_covs)).cpu())
            return time.perf_counter() - t0, out
    """}
    got, want = _translated(tmp_path, original, translation)
    assert got == want == [("mfm_tpu_torch/tools/sweep_like.py", 7, "R5",
                            "unforced_cell")]


def test_r5_smoke_sync_and_package_toucher(tmp_path):
    """The smoke's own ``sync()`` forces; a span around a package function
    that reaches torch transitively needs it."""
    res = _lint(tmp_path, {
        "mfm_tpu_torch/models/m.py": """
            import torch

            def inner(x):
                return torch.exp(x)

            def outer(x):
                return inner(x) + 1
        """,
        "chip_smoke.py": """
            import time
            import torch
            from mfm_tpu_torch.models.m import outer

            def sync():
                torch.cuda.synchronize()

            def phase_bad(x):
                t0 = time.perf_counter()
                y = outer(x)
                return time.perf_counter() - t0, y

            def phase_good(x):
                t0 = time.perf_counter()
                y = outer(x)
                sync()
                return time.perf_counter() - t0, y
        """})
    assert [(v.rule, v.qualname) for v in res.new] == [("R5", "phase_bad")]


TRACED = {
    "R1": """
        import numpy as np
        import jax
        import jax.numpy as jnp

        def helper(x):
            return np.mean(x)

        @jax.jit
        def traced(x):
            return helper(x) + jnp.sum(x)
    """,
    "R2": """
        import jax
        import jax.numpy as jnp

        @jax.jit
        def bad(x):
            return jax.lax.fori_loop(0, 7 * 3, lambda i, c: c + i, x)
    """,
    "R4": """
        from functools import partial
        import jax

        @partial(jax.jit, donate_argnums=(0,))
        def step(x, y):
            return x + y

        def bad(a, b):
            out = step(a, b)
            return out + a
    """,
    "R7": """
        import jax
        import jax.numpy as jnp
        from mfm_tpu.utils.obs import log

        @jax.jit
        def bad(x):
            log("info", "step")
            return jnp.sum(x)
    """,
}
TRACED_TORCH = {
    "R1": """
        import numpy as np
        import torch
        import torch

        def helper(x):
            return np.mean(x)

        # eager torch: no traced region
        def traced(x):
            return helper(x) + torch.sum(x)
    """,
    "R2": """
        import torch
        import torch

        # eager torch: a Python loop, the counter a Python int
        def bad(x):
            return sum((x + i for i in range(7 * 3)), x)
    """,
    "R4": """
        from functools import partial
        import torch

        # eager torch: no donation
        def step(x, y):
            return x + y

        def bad(a, b):
            out = step(a, b)
            return out + a
    """,
    "R7": """
        import torch
        import torch
        from mfm_tpu_torch.utils.obs import log

        # eager torch: telemetry beside the device work is host code
        def bad(x):
            log("info", "step")
            return torch.sum(x)
    """,
}


@pytest.mark.parametrize("rule", list(TRACED))
def test_traced_region_rules_have_no_torch_counterpart(tmp_path, rule):
    """The reference flags the original; the translation has no traced
    region or donation, and the port flags nothing, its RULES saying
    why."""
    extra = {"mfm_tpu/utils/obs.py": "def log(level, event, **fields):\n"
                                     "    pass\n"}
    want = _lint(tmp_path / "ref", {"mod.py": TRACED[rule], **extra},
                 pkg=ref_lint)
    assert rule in {v.rule for v in want.new}
    port_extra = {"mfm_tpu_torch/utils/obs.py": extra["mfm_tpu/utils/obs.py"]}
    got = _lint(tmp_path / "port", {"mod.py": TRACED_TORCH[rule],
                                    **port_extra})
    assert got.new == []
    assert "no traced region" in RULES[rule]


def test_r6_waits_for_the_mesh(tmp_path):
    """The mesh is ported (§A 16d): R6 fires on a stray axis name in a
    spec of the port's mesh module, names the legal axes, and leaves
    other sharding types (a DTensor ``Shard``) alone."""
    res = _lint(tmp_path, {
        "mfm_tpu_torch/parallel/mesh.py": """
            def make_mesh(devs):
                return Mesh(devs, ("date", "stock"))
            P = PartitionSpec
            SPREAD = P(("date", "stock"))
        """,
        "mfm_tpu_torch/models/m.py": """
            from mfm_tpu_torch.parallel.mesh import P
            OK = P("date", None)
            BAD = P("model", "stock")
        """,
        "specs.py": """
            from torch.distributed.tensor import Shard
            ALSO_OK = Shard(7)
        """})
    assert [(v.file, v.line, v.rule) for v in res.new] == [
        ("mfm_tpu_torch/models/m.py", 4, "R6")]
    assert "'model'" in res.new[0].message
    assert "['date', 'stock']" in res.new[0].message
    assert "mesh doctrine" in RULES["R6"] and "16d" not in RULES["R6"]


def test_baseline_roundtrip_and_stale_reporting(tmp_path):
    src = {"mfm_tpu_torch/tools/t.py": """
        import time
        import torch

        def bad(x):
            t0 = time.perf_counter()
            y = torch.exp(x)
            return time.perf_counter() - t0, y
    """}
    dirty = _lint(tmp_path, src)
    assert len(dirty.new) == 1
    entry = {"file": dirty.new[0].file, "rule": dirty.new[0].rule,
             "qualname": dirty.new[0].qualname, "note": "fixture"}
    clean = run_lint([str(tmp_path)], baseline=[entry], root=str(tmp_path))
    assert not clean.new and len(clean.baselined) == 1 and not clean.stale
    stale_entry = dict(entry, qualname="no_such_function")
    res = run_lint([str(tmp_path)], baseline=[entry, stale_entry],
                   root=str(tmp_path))
    assert res.stale == [stale_entry]


def test_json_output(tmp_path, capsys):
    _write(tmp_path, {"chip_smoke.py": """
        import time
        import torch

        def phase(x):
            t0 = time.perf_counter()
            y = torch.exp(x)
            return time.perf_counter() - t0, y
    """})
    rc = main([str(tmp_path), "--baseline", "none", "--root", str(tmp_path),
               "--json"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 1 and out["stale"] == [] and out["baselined"] == []
    assert [(v["rule"], v["qualname"], v["line"]) for v in out["new"]] == \
        [("R5", "phase", 5)]


# -- layer 3: injection drills on scratch copies of the port --------------------

def _scratch(tmp_path):
    shutil.copytree(REPO / "mfm_tpu_torch", tmp_path / "mfm_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "*.so"))
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    return [str(tmp_path / "mfm_tpu_torch"), str(tmp_path / "chip_smoke.py"),
            "--baseline", str(REPO / DEFAULT_BASELINE),
            "--root", str(tmp_path), "--strict"]


def test_injected_unforced_span_fails_cli(tmp_path):
    """A wall around the main path without a synchronize, appended to a
    scratch copy of the smoke, flips the CLI from exit 0 to exit 1; with
    the ``sync()`` the copy is clean again."""
    args = _scratch(tmp_path)
    assert main(args) == 0, "pristine scratch copy should lint clean"
    smoke = tmp_path / "chip_smoke.py"
    src = smoke.read_text()
    drill = textwrap.dedent("""

        def _scratch_wall(rm, sim_covs, T):
            t0 = time.perf_counter()
            rm.run_fused(sim_covs=sim_covs, sim_length=T)
            return time.perf_counter() - t0
    """)
    smoke.write_text(src + drill)
    assert main(args) == 1
    res = run_lint([str(smoke), str(tmp_path / "mfm_tpu_torch")],
                   root=str(tmp_path))
    assert [(v.rule, v.qualname) for v in res.new
            if v.qualname == "_scratch_wall"] == [("R5", "_scratch_wall")]
    smoke.write_text(src + drill.replace(
        "    return time", "    sync()\n    return time"))
    assert main(args) == 0


def test_injected_global_switch_fails_cli(tmp_path):
    """Turning TF32 on in a model module flips the CLI to exit 1 (R3)."""
    args = _scratch(tmp_path)
    mod = tmp_path / "mfm_tpu_torch" / "models" / "newey_west.py"
    mod.write_text(mod.read_text() + textwrap.dedent("""

        def _scratch_fast():
            torch.backends.cuda.matmul.allow_tf32 = True
    """))
    assert main(args) == 1
    res = run_lint([str(mod)], root=str(tmp_path))
    assert [(v.rule, v.qualname) for v in res.new] == [("R3",
                                                        "_scratch_fast")]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("rel", ["mfm_tpu_torch/lint.py",
                                 "mfm_tpu_torch/analysis/sync.py",
                                 "mfm_tpu_torch/analysis/__init__.py"])
def test_passes_are_stdlib_only(rel):
    mods = set(_imports(REPO / rel))
    assert not mods & {"torch", "numpy", "jax", "jaxlib", "mfm_tpu",
                       "pandas", "triton"}
    assert mods <= {"__future__", "argparse", "ast", "dataclasses", "json",
                    "os", "sys", "typing", "mfm_tpu_torch"}
