"""Shared fixtures of the benchmark's own tests (``python -m pytest
mfmbench/tests``): a copy of the benchmark's data files at CPU sizes."""

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: the CPU sizes of each configuration: the same widths of the model's
#: stages at small scale (K = 9: 5 industries, 3 styles), and enough dates
#: for the eigen Monte-Carlo's 4-sweep tier (T >= 32 K); alpha panels wide
#: enough that rank ties move the scores no more than at the cells' widths
TINY = {"shape": {"T": 300, "N": 60, "P": 5, "Q": 3},
        "alpha_panel": {"T": 300, "N": 1000}, "eigen_n_sims": 20}


def pytest_configure(config):
    # several test workers share the cores: few threads each
    torch.set_num_threads(2)
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips on a machine without one")


def tiny_copy(dest: Path) -> Path:
    """The benchmark's folder copied to ``dest`` with every configuration
    cut to :data:`TINY`."""
    base = dest / "mfmbench"
    shutil.copytree(ROOT / "mfmbench", base,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    for path in (base / "configs").glob("*.json"):
        c = json.loads(path.read_text())
        c["shape"], c["alpha_panel"] = TINY["shape"], TINY["alpha_panel"]
        c["risk"]["eigen_n_sims"] = TINY["eigen_n_sims"]
        path.write_text(json.dumps(c))
    return base


@pytest.fixture(scope="session")
def tiny(tmp_path_factory) -> Path:
    return tiny_copy(tmp_path_factory.mktemp("bench"))


@pytest.fixture(scope="session")
def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_of(bench: dict, name: str) -> dict:
    return {c["name"]: c for c in bench["workloads"]}[name]
