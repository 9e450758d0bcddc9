"""The port's associative Newey-West (``newey_west_expanding(...,
method="associative")``, a doubling prefix scan over the packed (T, D)
state) on the CPU at float64, against the JAX package's
``lax.associative_scan`` form and against the port's own serial scan.

- the covariances agree with the reference's associative form within
  ``rtol=1e-9, atol=1e-15`` (the reference's own scan-vs-associative
  tolerance) and ``valid`` is equal, at (T, K) = (120, 10) and (200, 42);
- the same holds against the port's serial scan;
- ``run_fused`` with ``nw_method="associative"`` in both packages, with
  injected ``sim_covs``, agrees at 1e-8 in every output;
- every entry point that carries or guards state refuses the method with
  the reference's exception and message;
- ``risk --nw-method associative --save-outputs`` and ``pipeline
  --nw-method associative`` through both CLIs give the same tables and
  the same Newey-West covariances.
"""

import contextlib
import csv
import dataclasses
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfm_tpu.cli import main as ref_main
from mfm_tpu.config import RiskModelConfig as RefConfig
from mfm_tpu.data.etl import PanelStore as RefStore
from mfm_tpu.data.synthetic import synthetic_collections as ref_collections
from mfm_tpu.models.newey_west import (
    newey_west_expanding_associative as ref_associative,
)
from mfm_tpu.models.risk_model import RiskModel as RefRiskModel
from mfm_tpu_torch import RiskModel, RiskModelConfig
from mfm_tpu_torch.cli import main
from mfm_tpu_torch.config import QuarantinePolicy
from mfm_tpu_torch.convert import config_from_reference, outputs_to_numpy, to_port
from mfm_tpu_torch.data.artifacts import _numpy, load_risk_outputs
from mfm_tpu_torch.data.csvio import write_csv
from mfm_tpu_torch.data.etl import PanelStore
from mfm_tpu_torch.data.synthetic import (
    synthetic_barra_table,
    synthetic_collections,
)
from mfm_tpu_torch.models.newey_west import (
    linear_prefix_scan,
    newey_west_expanding,
)

from tests.test_torch_risk_model import FIELDS, PANEL, _assert_same, _case

torch.set_num_threads(2)

RTOL, ATOL = 1e-9, 1e-15
SHAPES = [(120, 10), (200, 42)]


def _returns(T, K, seed=0):
    return np.random.default_rng(seed).standard_normal((T, K)) * 0.01


@pytest.mark.parametrize("T,K", SHAPES)
def test_associative_matches_the_reference_associative(T, K):
    x = _returns(T, K)
    want, want_valid = ref_associative(jnp.asarray(x), 2, 252.0)
    got, valid = newey_west_expanding(torch.from_numpy(x), 2, 252.0,
                                      method="associative")
    assert np.array_equal(valid.numpy(), np.asarray(want_valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("T,K", SHAPES)
def test_associative_matches_the_ports_scan(T, K):
    x = torch.from_numpy(_returns(T, K, seed=1))
    got, valid = newey_west_expanding(x, 2, 252.0, method="associative")
    want, want_valid = newey_west_expanding(x, 2, 252.0, method="scan")
    assert torch.equal(valid, want_valid)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("q,half_life,min_valid", [
    (0, 3.0, None), (3, 1.0, None), (1, 20.0, 5), (2, 0.25, None)])
def test_associative_other_lags_and_short_half_lives(q, half_life, min_valid):
    """Other lag counts, and half lives short enough that lam^-t would
    overflow float64 over 150 dates: the scan never inverts lam."""
    x = _returns(150, 6, seed=2)
    want, want_valid = ref_associative(jnp.asarray(x), q, half_life,
                                       min_valid)
    got, valid = newey_west_expanding(torch.from_numpy(x), q, half_life,
                                      min_valid, method="associative")
    assert np.array_equal(valid.numpy(), np.asarray(want_valid))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("T", [1, 2, 3, 8, 33])
def test_linear_prefix_scan_is_the_serial_recurrence(T):
    g = np.random.default_rng(T)
    a = torch.from_numpy(g.uniform(0.5, 1.0, (T, 1)))
    u = torch.from_numpy(g.standard_normal((T, 5)))
    s, want = torch.zeros(5, dtype=torch.float64), []
    for t in range(T):
        s = a[t] * s + u[t]
        want.append(s)
    np.testing.assert_allclose(linear_prefix_scan(a, u).numpy(),
                               torch.stack(want).numpy(), rtol=1e-13,
                               atol=1e-15)


M = 8


def _float64(case):
    return {k: (v.astype(np.float64) if v.dtype.kind == "f" else v)
            for k, v in case.items()}


@pytest.fixture(scope="module")
def fused():
    """Both packages' ``run_fused`` with the associative method on one
    seeded panel and the same injected draws, float64."""
    T, N, P, Q = 80, 40, 4, 3
    case = _float64(_case(T, N, P, Q, M, seed=5))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MFM_EIGH_CPU_JACOBI_BATCH", "1")
        ref = RefRiskModel(*(jnp.asarray(case[k]) for k in PANEL),
                           n_industries=P,
                           config=RefConfig(eigen_n_sims=M,
                                            nw_method="associative"))
        want = ref.run_fused(sim_covs=jnp.asarray(case["sim_covs"]),
                             sim_length=T)
    cfg = config_from_reference(dataclasses.asdict(
        RefConfig(eigen_n_sims=M, nw_method="associative")))
    assert cfg.nw_method == "associative"
    t = to_port(case, "cpu", torch.float64)
    rm = RiskModel(*(t[k] for k in PANEL), n_industries=P, config=cfg,
                   device="cpu")
    got = rm.run_fused(sim_covs=t["sim_covs"], sim_length=T)
    scan = RiskModel(*(t[k] for k in PANEL), n_industries=P,
                     config=dataclasses.replace(cfg, nw_method="scan"),
                     device="cpu").run(sim_covs=t["sim_covs"], sim_length=T)
    return ({k: np.asarray(v) for k, v in want._asdict().items()},
            outputs_to_numpy(got), outputs_to_numpy(scan))


@pytest.mark.parametrize("field", FIELDS)
def test_run_fused_associative_matches_the_reference(fused, field):
    want, got, scan = fused
    assert got[field].shape == want[field].shape
    _assert_same(got[field], want[field], rtol=1e-8)
    # and the port's associative run is its scan run within the same band
    _assert_same(got[field], scan[field], rtol=1e-8)


def _refusal(make):
    try:
        make()
    except Exception as e:   # noqa: BLE001 — the type is the comparison
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("entry", ["init_state", "update", "update_guarded"])
def test_stateful_entry_points_refuse_the_associative_method(entry):
    """Both packages refuse before reading the state: the same exception
    type and message."""
    T, N, P, Q = 40, 20, 3, 2
    case = _float64(_case(T, N, P, Q, 4, seed=6))
    quarantine = entry == "update_guarded"
    ref = RefRiskModel(*(jnp.asarray(case[k]) for k in PANEL),
                       n_industries=P, config=RefConfig(
                           eigen_n_sims=4, nw_method="associative",
                           quarantine=_ref_policy(quarantine)))
    port = RiskModel(*(torch.from_numpy(case[k]) for k in PANEL),
                     n_industries=P, config=RiskModelConfig(
                         eigen_n_sims=4, nw_method="associative",
                         quarantine=QuarantinePolicy(enabled=quarantine)),
                     device="cpu")
    args = () if entry == "init_state" else (None,)
    want = _refusal(lambda: getattr(ref, entry)(*args))
    got = _refusal(lambda: getattr(port, entry)(*args))
    assert want is not None and want[0] == "ValueError"
    assert got == want


def _ref_policy(enabled):
    from mfm_tpu.config import QuarantinePolicy as RefPolicy

    return RefPolicy(enabled=enabled)


def run(pkg: str, argv: list) -> tuple:
    """One in-process CLI call: (exit code or message, stdout lines)."""
    buf = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(buf):
        try:
            if pkg == "ref":
                ref_main(["--platform", "cpu", *argv])
            else:
                main([*argv, "--device", "cpu"])
        except SystemExit as e:
            code = e.code
    return code, buf.getvalue().splitlines()


def _rows(path) -> tuple:
    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))
    return rows[0], [r[0] for r in rows[1:]], np.array(
        [[float(c) if c else np.nan for c in r[1:]] for r in rows[1:]])


def _same_tables(got_dir, want_dir, names):
    for name in names:
        gh, gi, g = _rows(got_dir / f"{name}.csv")
        wh, wi, w = _rows(want_dir / f"{name}.csv")
        assert (gh, gi) == (wh, wi), name
        np.testing.assert_allclose(g, w, rtol=1e-8, atol=1e-12,
                                   equal_nan=True, err_msg=name)


def _same_nw(got_dir, want_dir):
    got, _ = load_risk_outputs(str(got_dir / "risk_outputs.npz"), "cpu")
    want = np.load(want_dir / "risk_outputs.npz")
    assert np.array_equal(_numpy(got.nw_valid), want["nw_valid"])
    assert want["nw_valid"].any()
    np.testing.assert_allclose(_numpy(got.nw_cov), want["nw_cov"],
                               rtol=1e-8, atol=1e-14)


NO_DRAW = ("factor_returns", "r_squared", "specific_returns")
FLAGS = ["--nw-method", "associative", "--eigen-sims", "8", "--dtype",
         "float64"]


def test_risk_cli_runs_the_associative_method_in_both_packages(
        tmp_path, monkeypatch):
    table, _ = synthetic_barra_table(T=80, N=40, P=4, Q=3)
    write_csv(tmp_path / "b.csv", table)
    monkeypatch.setenv("MFM_COMPILATION_CACHE", "off")
    monkeypatch.chdir(tmp_path)
    recs = {}
    for pkg in ("ref", "port"):
        code, lines = run(pkg, ["risk", "--barra", "b.csv", "--out", pkg,
                                "--save-outputs", *FLAGS])
        assert code == 0, code
        recs[pkg] = json.loads(lines[-1])
    assert recs["port"]["dates"] == recs["ref"]["dates"] == 80
    _same_tables(tmp_path / "port", tmp_path / "ref", NO_DRAW)
    _same_nw(tmp_path / "port", tmp_path / "ref")


def test_pipeline_cli_runs_the_associative_method_in_both_packages(
        tmp_path, monkeypatch):
    """Without a resumable carry neither package writes ``risk_state.npz``
    nor its manifest, so neither record carries a ``health``."""
    gen = dict(T=100, N=30, n_industries=4, seed=7)
    synthetic_collections(PanelStore(str(tmp_path / "port_store")), **gen)
    ref_collections(RefStore(str(tmp_path / "ref_store")), **gen)
    monkeypatch.setenv("MFM_COMPILATION_CACHE", "off")
    recs = {}
    for pkg in ("ref", "port"):
        code, lines = run(pkg, ["pipeline", "--store",
                                str(tmp_path / f"{pkg}_store"), "--out",
                                str(tmp_path / pkg),
                                "--eigen-sim-length", "50", *FLAGS])
        assert code == 0, code
        recs[pkg] = json.loads(lines[-1])
        assert not (tmp_path / pkg / "risk_state.npz").exists()
        assert "health" not in recs[pkg]
    for k in ("rows", "dates", "stocks", "factors"):
        assert recs["port"][k] == recs["ref"][k], k
    _same_tables(tmp_path / "port", tmp_path / "ref", NO_DRAW)
    _same_nw(tmp_path / "port", tmp_path / "ref")
