"""The port's compile and memory profiling (``obs/profile.py``,
``utils/obs.compiled_memory``, ``obs/instrument.py``'s compile counter and
compiled-memory gauges) on the CPU, against the JAX package's.

- ``compiled_cost`` of a matmul counts the flops XLA's cost analysis
  counts (2mnk in both);
- a recorded kernel launch adds the operation count of ``chip_smoke.py``'s
  bound;
- ``compiled_memory`` returns the fields the CPU can know, under the
  reference's names;
- ``capture_compile_walls`` collects a build event's wall;
- ``watch_compiles`` is idempotent and ``unwatch_compiles`` removes it;
- the three metrics carry the reference's names, help strings, labels
  and buckets, and ``record_compiled_memory`` writes the reference's
  series;
- a ``--metrics-dir`` run of each package's CLI counts its compiles in
  ``mfm_jit_compiles_total``.
"""

import contextlib
import io
import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mfm_tpu.cli import main as ref_main
from mfm_tpu.obs import instrument as ref_instrument
from mfm_tpu.obs import profile as ref_profile
from mfm_tpu.obs.metrics import MetricsRegistry as RefRegistry
from mfm_tpu.utils.obs import compiled_memory as ref_compiled_memory
from mfm_tpu_torch.cli import main
from mfm_tpu_torch.data.csvio import write_csv
from mfm_tpu_torch.data.synthetic import synthetic_barra_table
from mfm_tpu_torch.obs import instrument, profile
from mfm_tpu_torch.obs.metrics import MetricsRegistry
from mfm_tpu_torch.ops import eigh_cuda
from mfm_tpu_torch.utils import contracts
from mfm_tpu_torch.utils.obs import compiled_memory

torch.set_num_threads(2)


@pytest.mark.parametrize("m,k,n", [(8, 16, 4), (3, 5, 7), (64, 32, 1)])
def test_compiled_cost_of_a_matmul_is_the_references(m, k, n):
    a = np.random.default_rng(m).standard_normal((m, k))
    b = np.random.default_rng(n).standard_normal((k, n))
    want = ref_profile.compiled_cost(lambda x, y: x @ y, jnp.asarray(a),
                                     jnp.asarray(b))
    got = profile.compiled_cost(lambda x, y: x @ y, torch.from_numpy(a),
                                torch.from_numpy(b))
    assert got == {"flops": 2.0 * m * k * n}
    assert got["flops"] == want["flops"]


@pytest.fixture
def launch_records(monkeypatch):
    """The launch tables as a fresh copy, put back afterwards (other tests
    read the process's counts)."""
    monkeypatch.setattr(eigh_cuda, "LAUNCHES",
                        {k: {"warp": 0, "block": 0}
                         for k in eigh_cuda.LAUNCHES})
    monkeypatch.setattr(eigh_cuda, "LAUNCH_SHAPES",
                        {k: {} for k in eigh_cuda.LAUNCHES})


@pytest.mark.parametrize("kernel,B,n,sweeps,bound", [
    ("jacobi_eigh_weighted", 139_000, 42, 4, chip_smoke.weighted_kernel_bound),
    ("jacobi_eigh", 1390, 42, 7, chip_smoke.full_kernel_bound),
    ("jacobi_eigh", 16, 42, 7, chip_smoke.full_kernel_bound),
])
def test_a_recorded_launch_adds_the_bounds_operation_count(
        launch_records, kernel, B, n, sweeps, bound):
    """A launch the wrappers record (the CPU launches none: the record is
    made by hand) adds its operation count — 9 n^2 flop a matrix a round
    of the n - 1 rounds a sweep, plus 3 n^2 for the weighted kernel's h,
    the count ``chip_smoke.py``'s bound uses — to the run's flops, beside
    a matmul counted by ``FlopCounterMode``."""
    a = torch.ones(4, 6, dtype=torch.float64)

    def run(x):
        eigh_cuda._count_launch(kernel, "warp", B, n, sweeps)
        return x @ x.T

    run_ = profile.compile_fn(run, a)
    want = sweeps * (n - 1) * 9 * n * n * B
    if kernel == "jacobi_eigh_weighted":
        want += 3 * n * n * B
    assert profile.kernel_flops(kernel, B, n, sweeps) == want
    assert bound(B, n, sweeps)["flops"] == want
    assert run_.kernel_flops == want
    assert profile.cost_of(run_) == {"flops": want + 2 * 4 * 6 * 4}
    assert eigh_cuda.launch_shapes()[kernel] == {(B, n, sweeps): 1}
    eigh_cuda.reset_launches()
    assert eigh_cuda.launch_shapes() == {k: {} for k in eigh_cuda.LAUNCHES}


def test_compiled_memory_on_the_cpu_has_the_fields_the_cpu_knows():
    x = torch.ones(10, 3, dtype=torch.float64)
    y = torch.ones(3, dtype=torch.float32)

    def fn(a, b):
        return a, a.sum(0) * b.double()      # one output is an argument

    got = compiled_memory(fn, x, y)
    assert got == {"argument_bytes": 240 + 12, "output_bytes": 240 + 24,
                   "alias_bytes": 240, "generated_code_bytes": 0}
    want = ref_compiled_memory(
        lambda a, b: (a, a.sum(0) * b), jnp.ones((10, 3)), jnp.ones(3))
    # the reference's buffer analysis has these fields too, plus the
    # transient and peak, which the CPU cannot measure here
    assert set(got) < set(want)
    assert set(want) - set(got) == {"temp_bytes", "peak_bytes"}
    assert set(profile.compiled_memory_of(profile.compile_fn(fn, x, y))) \
        == set(got)


def test_capture_compile_walls_collects_build_and_load_walls():
    before = instrument.JIT_COMPILE_SECONDS.cumulative()[-1][1]
    with profile.capture_compile_walls() as walls:
        contracts.notify(contracts.KERNEL_BUILD_EVENT, "x.cu", 1.5)
        contracts.notify(contracts.KERNEL_LOAD_EVENT, "x", 0.25)
        contracts.notify(contracts.NEW_SIGNATURE_EVENT, "batched_eigh")
    assert walls == [1.5, 0.25]
    assert instrument.JIT_COMPILE_SECONDS.cumulative()[-1][1] == before + 2
    assert contracts._LISTENERS == []
    contracts.notify(contracts.KERNEL_BUILD_EVENT, "y.cu", 3.0)
    assert walls == [1.5, 0.25]
    with profile.capture_compile_walls() as none:
        pass
    assert none == []


def test_executable_profile_has_the_references_keys():
    a = torch.ones(5, 5, dtype=torch.float64)
    got = profile.executable_profile(lambda x: x @ x, a)
    want = ref_profile.executable_profile(lambda x: x @ x, jnp.ones((5, 5)))
    assert list(got) == list(want)
    assert got["cost"] == {"flops": 250.0}
    assert got["compile_wall_s"] is None     # no kernel built or loaded
    assert got["source"] == "flop_counter"
    assert got["memory"]["argument_bytes"] == 200


def test_watch_compiles_is_idempotent_and_unwatch_removes_it():
    instrument.unwatch_compiles()
    assert contracts._WATCHERS == [] and not contracts.listening()
    instrument.watch_compiles()
    instrument.watch_compiles()
    assert len(contracts._WATCHERS) == 1 and contracts.listening()
    assert contracts._LISTENERS == []
    before = instrument.JIT_COMPILES_TOTAL.value()
    for event in (contracts.KERNEL_BUILD_EVENT, contracts.KERNEL_LOAD_EVENT,
                  contracts.NEW_SIGNATURE_EVENT,
                  contracts.BUCKET_SIGNATURE_EVENT):
        contracts.notify(event, "detail")
    assert instrument.JIT_COMPILES_TOTAL.value() == before + 4
    instrument.unwatch_compiles()
    instrument.unwatch_compiles()
    assert contracts._WATCHERS == [] and not contracts.listening()
    contracts.notify(contracts.KERNEL_LOAD_EVENT, "detail")
    assert instrument.JIT_COMPILES_TOTAL.value() == before + 4


@pytest.mark.parametrize("name", ["COMPILED_BYTES", "JIT_COMPILES_TOTAL",
                                  "JIT_COMPILE_SECONDS"])
def test_metrics_are_declared_as_the_references(name):
    got, want = getattr(instrument, name), getattr(ref_instrument, name)
    assert (got.name, got.kind, got.help_text, got.labelnames) == \
        (want.name, want.kind, want.help_text, want.labelnames)
    if name == "JIT_COMPILE_SECONDS":
        assert got.buckets == want.buckets


def test_record_compiled_memory_writes_the_references_series():
    mem = {"temp_bytes": 10, "argument_bytes": 20, "output_bytes": 30,
           "alias_bytes": 0, "generated_code_bytes": 0, "peak_bytes": 60,
           "note": "skipped: not a number"}
    snaps = []
    for mod, reg_cls in ((instrument, MetricsRegistry),
                         (ref_instrument, RefRegistry)):
        reg = reg_cls()
        gauge = reg.gauge(mod.COMPILED_BYTES.name,
                          mod.COMPILED_BYTES.help_text,
                          labelnames=mod.COMPILED_BYTES.labelnames)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(mod, "COMPILED_BYTES", gauge)
            mod.record_compiled_memory("eigen", mem)
        snaps.append(reg.snapshot())
    assert snaps[0] == snaps[1]
    series = snaps[0]["mfm_compiled_bytes"]["series"]
    assert {s["labels"]["kind"]: s["value"] for s in series} == {
        k: float(v) for k, v in mem.items() if k != "note"}
    assert {s["labels"]["stage"] for s in series} == {"eigen"}


def _compiles_total(prom: str) -> float:
    m = re.search(r"^mfm_jit_compiles_total(?:\{\})? ([0-9.e+]+)$", prom,
                  re.M)
    assert m, prom[:2000]
    return float(m.group(1))


def test_metrics_dir_run_of_each_package_counts_its_compiles(
        tmp_path, monkeypatch):
    table, _ = synthetic_barra_table(T=50, N=30, P=3, Q=2)
    write_csv(tmp_path / "b.csv", table)
    monkeypatch.setenv("MFM_COMPILATION_CACHE", "off")
    monkeypatch.chdir(tmp_path)
    # a fresh signature set: the eigh dispatchers' first calls are events
    monkeypatch.setattr(contracts, "_SEEN", set())
    for pkg in ("ref", "port"):
        argv = ["risk", "--barra", "b.csv", "--out", f"{pkg}_out",
                "--eigen-sims", "4", "--dtype", "float64",
                "--metrics-dir", f"{pkg}_metrics"]
        code = 0
        with contextlib.redirect_stdout(io.StringIO()):
            try:
                if pkg == "ref":
                    ref_main(["--platform", "cpu", *argv])
                else:
                    main([*argv, "--device", "cpu"])
            except SystemExit as e:
                code = e.code
        assert code == 0, (pkg, code)
        prom = (tmp_path / f"{pkg}_metrics" / "metrics.prom").read_text()
        assert "# TYPE mfm_jit_compiles_total counter" in prom
        assert _compiles_total(prom) >= 1, pkg
        snap = json.loads(
            (tmp_path / f"{pkg}_metrics" / "metrics.json").read_text())
        assert "mfm_jit_compiles_total" in snap["metrics"]
