"""Import isolation: a run loads neither JAX nor the JAX package the port
was made from (compared by whole top-level names: ``mfm_tpu_torch`` begins
with ``mfm_tpu`` and is not it), and the references load nothing of the
program."""

import subprocess
import sys
import time

import pytest

from conftest import ROOT, cell_of
from mfmbench import harness


def test_top_level_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "mfm_tpu_torch_fake.sub", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "mfm_tpu.sub", object())
    assert harness.forbidden_modules() == ["mfm_tpu"]


@pytest.mark.parametrize("cell", ["alla.rebuild", "alla.alpha"])
def test_a_run_loads_no_jax_package(tiny, bench, cell):
    code = (
        "import sys, time\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from mfmbench import harness\n"
        f"bench = harness.load_json(harness.ROOT / 'BENCHMARK.json')\n"
        f"cell = [c for c in bench['workloads'] if c['name'] == {cell!r}][0]\n"
        f"r = harness.run_cell(bench, cell, 3, 0.2, 0, 'cpu', time.time(),"
        f" base=harness.Path({str(tiny)!r}))\n"
        "assert r['correct'], r\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    names = eval(out.stdout.strip().splitlines()[-1])
    assert "mfm_tpu_torch" in names
    assert not {"jax", "jaxlib", "flax", "mfm_tpu"} & set(names)


def test_the_references_load_nothing_of_the_program():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from mfmbench import gen\n"
        "from mfmbench.reference import alpha, risk\n"
        "inp = gen.risk_inputs(120, 20, 3, 2, 1, 1, 'cpu')\n"
        "sim = gen.sim_covs(6, 120, 4, 1, 'cpu')\n"
        "risk.rebuild(inp, inp['rets'][0], sim, {'nw_lags': 2, "
        "'nw_half_life': 252.0, 'eigen_scale_coef': 1.4, "
        "'vol_regime_half_life': 42.0}, 3)\n"
        "panel, fwd = gen.alpha_panel(60, 20, 1, 'cpu')\n"
        "alpha.score(['cs_rank(delta(close, 2))'], panel, fwd)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    names = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not {"jax", "jaxlib", "flax", "mfm_tpu", "mfm_tpu_torch"} & names


@pytest.mark.card
def test_one_cell_on_the_card(tmp_path):
    """``run.py`` end to end on the card: a short all-A alpha window."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    out = subprocess.run(
        [sys.executable, "mfmbench/run.py", "--workload", "alla.alpha",
         "--seed", "2147483999", "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    import json

    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
