"""The port's batched query engine (``mfm_tpu_torch/serve/query.py``) and
``RiskPipelineResult.query_engine`` against the JAX package's, on the CPU
at float64.

Engines built from the same numpy inputs are held to the reference on all
seven output fields within rtol 1e-10 (only the order of the K- and
N-term sums differs).  Engines built by the two packages' pipelines from
the same barra table are held within rtol 1e-8, the pipelines' own
agreement (``tests/test_torch_pipeline.py``).  Inside the port, a batch is
bitwise its single queries although the two pad to different buckets.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from mfm_tpu import pipeline as ref_pipeline
from mfm_tpu.config import PipelineConfig as RefPipelineConfig
from mfm_tpu.config import QuarantinePolicy as RefPolicy
from mfm_tpu.config import RiskModelConfig as RefConfig
from mfm_tpu.data.synthetic import synthetic_barra_table as ref_table
from mfm_tpu.serve import QueryEngine as RefEngine
from mfm_tpu.serve import bucket_for as ref_bucket_for
from mfm_tpu_torch.convert import (
    pipeline_config_from_reference,
    state_from_reference,
)
from mfm_tpu_torch.data.artifacts import load_risk_state
from mfm_tpu_torch.data.synthetic import synthetic_barra_table
from mfm_tpu_torch.pipeline import append_risk_pipeline, run_risk_pipeline
from mfm_tpu_torch.serve import QueryEngine, QueryOutputs, bucket_for

torch.set_num_threads(2)

K = 5
N = 11
RTOL = 1e-10          # same inputs, sums in another order
PIPE_RTOL = 1e-8      # engines built by the two pipelines


def _cov(seed=0, k=K):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((k, k)) / np.sqrt(k)
    return (a @ a.T + 1e-3 * np.eye(k)) * 1e-4


def _kwargs(space):
    """Engine arguments of one space, from numpy seeds."""
    if space == "factor":
        rng = np.random.default_rng(1)
        return {"benchmarks": {"idx": rng.standard_normal(K)}}
    rng = np.random.default_rng(2)
    return {"exposures": rng.standard_normal((N, K)),
            "specific_var": (0.02 * rng.random(N)) ** 2,
            "stocks": [f"s{i}" for i in range(N)],
            "benchmarks": {"bmk": rng.dirichlet(np.ones(N))}}


def _engines(space):
    kw = _kwargs(space)
    return (QueryEngine(_cov(), device="cpu", **kw), RefEngine(_cov(), **kw))


def _close(got, want, what, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    assert np.array_equal(np.isnan(got), np.isnan(want)), what
    scale = np.abs(want[np.isfinite(want)]).max(initial=0.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-14 * scale,
                               err_msg=what)


def _close_outputs(got, want, what, rtol=RTOL):
    assert type(got) is QueryOutputs and got._fields == want._fields
    for f in want._fields:
        _close(getattr(got, f), getattr(want, f), f"{what}: {f}", rtol)


@pytest.mark.parametrize("space", ["factor", "stock"])
@pytest.mark.parametrize("benchmark", [False, True])
def test_query_matches_the_reference(space, benchmark):
    port, ref = _engines(space)
    name = "idx" if space == "factor" else "bmk"
    rng = np.random.default_rng(3)
    W = rng.standard_normal((7, port.N))
    bench = [name if i % 2 == 0 else None for i in range(7)] if benchmark \
        else None
    got = port.query(W, bench=bench)
    _close_outputs(got, ref.query(W, bench=bench), f"{space} {benchmark}")
    # Euler: contributions sum to the factor variance
    _close(got.contribution.sum(1), got.factor_var, "euler", 1e-12)
    if not benchmark:
        assert np.isnan(got.beta).all()
    # the padded device form: the bucket's rows, tensors
    raw = port.query(W, bench=bench, trim=False)
    assert all(torch.is_tensor(x) and x.shape[0] == 8 for x in raw)
    assert np.array_equal(raw.total_vol[:7].numpy(), got.total_vol)


@pytest.mark.parametrize("n", [1, 8, 9, 32, 33, 1000, 100_000, 1_000_000])
def test_bucket_ladder_is_the_reference_ladder(n):
    assert bucket_for(n) == ref_bucket_for(n)
    assert bucket_for(1_000_000) == 2_097_152


def test_bucket_ladder_refuses_an_empty_batch():
    with pytest.raises(ValueError):
        bucket_for(0)


@pytest.mark.parametrize("space", ["factor", "stock"])
def test_batch_equals_singles_bitwise(space):
    """A batch of 13 portfolios (bucket 32) is bitwise 13 single queries
    (bucket 8 each), and bitwise the same rows of a batch padded to the
    bucket of 1,000."""
    eng, _ = _engines(space)
    bname = "idx" if space == "factor" else "bmk"
    rng = np.random.default_rng(5)
    B = 13
    W = rng.standard_normal((B, eng.N))
    bench = [bname if i % 3 == 0 else None for i in range(B)]
    batch = eng.query(W, bench=bench)
    wide = eng.query(W, bench=bench, bucket=bucket_for(1000))
    for i in range(B):
        one = eng.query(W[i], bench=[bench[i]])
        for f in batch._fields:
            got = getattr(batch, f)[i]
            assert np.array_equal(got, getattr(one, f)[0], equal_nan=True), \
                f"{f} row {i}: batch != single (bitwise)"
            assert np.array_equal(got, getattr(wide, f)[i], equal_nan=True), \
                f"{f} row {i}: bucket 32 != bucket 2048 (bitwise)"


def test_chunked_batch_is_bitwise_the_whole_batch():
    """A bucket above the engine's chunk runs in chunks of one row count;
    the rows are bitwise those of one unchunked call."""
    eng, _ = _engines("stock")
    rng = np.random.default_rng(6)
    W = rng.standard_normal((100, N))
    bench = ["bmk" if i % 2 else None for i in range(100)]
    whole = eng.query(W, bench=bench, bucket=128)
    eng.chunk = 8
    for f, got in zip(whole._fields, eng.query(W, bench=bench, bucket=128)):
        assert np.array_equal(got, getattr(whole, f), equal_nan=True), f


def test_pad_batch_validation():
    eng, _ = _engines("factor")
    with pytest.raises(ValueError, match="expects 5 values"):
        eng.pad_batch(np.zeros((2, 4)))
    with pytest.raises(ValueError, match="bucket 8 < batch"):
        eng.pad_batch(np.zeros((9, K)), bucket=8)
    with pytest.raises(ValueError, match="3 benchmark entries"):
        eng.pad_batch(np.zeros((2, K)), bench=["idx", None, "idx"])
    with pytest.raises(KeyError):
        eng.pad_batch(np.zeros((2, K)), bench=["nope", None])
    with pytest.raises(KeyError, match="out of range"):
        eng.pad_batch(np.zeros((2, K)), bench=[2, None])
    w, bidx, B, bucket = eng.pad_batch(np.zeros((3, K)), bench=["idx"] * 3)
    assert (B, bucket) == (3, 8)
    assert w.shape == (8, K) and bidx.shape == (8,)
    assert bidx.dtype == torch.int32 and w.dtype == torch.float64
    assert bidx.tolist() == [1, 1, 1, 0, 0, 0, 0, 0]


@pytest.mark.parametrize("args,kw,match", [
    ((np.zeros((2, 3)),), {}, "must be \\(K, K\\)"),
    ((np.full((2, 2), np.nan),), {}, "non-finite"),
    ((_cov(),), {"specific_var": np.ones(K)}, "needs exposures"),
    ((_cov(),), {"benchmarks": {"b": [np.nan] * K}}, "finite"),
    ((_cov(),), {"factor_names": ["a"]}, "1 factor names"),
    ((_cov(),), {"exposures": np.ones((3, K + 1))}, "exposures must be"),
    ((_cov(),), {"exposures": np.ones((3, K)), "specific_var": np.ones(2)},
     "specific_var must be"),
    ((_cov(),), {"exposures": np.ones((3, K)), "stocks": ["a"]},
     "1 stock ids"),
])
def test_engine_input_validation_is_the_reference(args, kw, match):
    for cls, dev in ((QueryEngine, {"device": "cpu"}), (RefEngine, {})):
        with pytest.raises(ValueError, match=match):
            cls(*args, **kw, **dev)


def test_engine_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        assert QueryEngine(_cov()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            QueryEngine(_cov())
    assert QueryEngine(_cov(), device="cpu")._cov.device.type == "cpu"


@pytest.mark.parametrize("space", ["factor", "stock"])
def test_with_cov_shares_the_constants(space):
    port, ref = _engines(space)
    stressed = _cov() * 1.21
    sib = port.with_cov(stressed, staleness=2, scenario_id="stress")
    want = ref.with_cov(stressed, staleness=2, scenario_id="stress")
    for k in ("_Xt", "_svar", "_bw", "_bx"):
        assert getattr(sib, k) is getattr(port, k), k
    assert sib._cov is not port._cov and port.scenario_id is None
    assert (sib.staleness, sib.scenario_id) == (2, "stress")
    assert sib.with_cov(stressed).staleness == 2
    rng = np.random.default_rng(7)
    W = rng.standard_normal((5, port.N))
    bench = [list(port.benchmark_index)[0]] * 5
    _close_outputs(sib.query(W, bench=bench), want.query(W, bench=bench),
                   "with_cov")
    with pytest.raises(ValueError, match="must be"):
        port.with_cov(np.eye(K + 1))
    with pytest.raises(ValueError, match="non-finite"):
        port.with_cov(np.full((K, K), np.inf))


def test_from_risk_state_requires_guarded():
    for cls in (QueryEngine, RefEngine):
        with pytest.raises(ValueError, match="quarantine"):
            cls.from_risk_state(types.SimpleNamespace(guarded=False))


def test_from_risk_state_names_and_staleness():
    state = types.SimpleNamespace(guarded=True,
                                  last_good_cov=torch.from_numpy(_cov(k=4)),
                                  staleness=torch.tensor(2, dtype=torch.int32))
    meta = {"style_names": ["size"], "industry_codes": [10, 20]}
    eng = QueryEngine.from_risk_state(state, meta, device="cpu")
    assert eng.factor_names == ["country", "10", "20", "size"]
    assert eng.staleness == 2 and eng.space == "factor"
    eng2 = QueryEngine.from_risk_state(
        state, {"style_names": ["a"], "industry_codes": [1]}, device="cpu")
    assert eng2.factor_names == ["f0", "f1", "f2", "f3"]


# -- engines built from the pipelines ----------------------------------------

T, NP, P, Q, M = 120, 60, 6, 4, 8
T0 = 100


@pytest.fixture(autouse=True)
def _reference_jacobi(monkeypatch):
    monkeypatch.setenv("MFM_EIGH_CPU_JACOBI_BATCH", "1")


def _ref_cfg(guarded):
    risk = RefConfig(eigen_n_sims=M, seed=13,
                     **({"quarantine": RefPolicy(enabled=True)}
                        if guarded else {}))
    return RefPipelineConfig(risk=risk, dtype="float64")


def _cfg(guarded):
    return pipeline_config_from_reference(
        dataclasses.asdict(_ref_cfg(guarded)))


@pytest.fixture(scope="module")
def case():
    df, _ = ref_table(T=T, N=NP, P=P, Q=Q, seed=0)
    table, _ = synthetic_barra_table(T=T, N=NP, P=P, Q=Q, seed=0)
    d = np.random.default_rng(1).standard_normal((M, 1 + P + Q, T))
    d -= d.mean(axis=-1, keepdims=True)
    sim = np.einsum("mkt,mlt->mkl", d, d) / (T - 1)
    return df, table, sim


def _head(table, n_dates):
    cut = np.unique(np.asarray(table["date"]))[n_dates]
    if isinstance(table, pd.DataFrame):
        return table[table["date"] < cut]
    keep = np.asarray(table["date"]) < cut
    return {k: np.asarray(v)[keep] for k, v in table.items()}


def _collapse_date(table, index):
    """The table with 60% of date ``index``'s rows dropped (each industry
    keeps its first member): the guard quarantines that date."""
    dates = np.unique(table["date"])
    industry = table["industry"]
    first = np.zeros(len(industry), bool)
    for code in np.unique(industry):
        first |= table["stocknames"] == table["stocknames"][industry == code][0]
    on_date = np.nonzero(table["date"] == dates[index])[0]
    rng = np.random.default_rng(3)
    drop = rng.choice(on_date[~first[on_date]], int(0.6 * len(on_date)),
                      replace=False)
    keep = np.ones(len(industry), bool)
    keep[drop] = False
    return {k: v[keep] for k, v in table.items()}


def _cap_weights(arrays, t):
    cap = np.where(arrays.valid[t], np.nan_to_num(arrays.cap[t]), 0.0)
    return cap / cap.sum()


def _books(eng, valid, n=9, seed=8):
    rng = np.random.default_rng(seed)
    W = np.abs(rng.standard_normal((n, eng.N))) * valid
    return W / W.sum(1, keepdims=True)


def _hold_pipeline_engines(got, want, t):
    assert got.space == want.space == "stock"
    assert got.factor_names == want.factor_names
    assert got.stocks == want.stocks
    assert got.staleness == want.staleness
    assert got.benchmark_index == want.benchmark_index
    _close(got._cov, want._cov, "cov", PIPE_RTOL)
    _close(got._Xt.T, want._X, "exposures", PIPE_RTOL)
    _close(got._svar, want._svar, "specific var", PIPE_RTOL)
    valid = np.asarray(want._X).any(1)
    W = _books(got, valid)
    bench = ["cap" if i % 2 else None for i in range(len(W))]
    _close_outputs(got.query(W, bench=bench), want.query(W, bench=bench),
                   f"date {t}", PIPE_RTOL)


def test_pipeline_query_engine_matches_the_reference_unguarded(case):
    df, table, sim = case
    ref = ref_pipeline.run_risk_pipeline(
        df, config=_ref_cfg(False), sim_covs=jnp.asarray(sim), sim_length=T)
    port = run_risk_pipeline(table, config=_cfg(False),
                             sim_covs=torch.from_numpy(sim), sim_length=T,
                             device="cpu")
    bench = {"cap": _cap_weights(port.arrays, -1)}
    got = port.query_engine(t=-1, benchmarks=bench)
    want = ref.query_engine(t=-1, benchmarks=bench)
    assert got.staleness == 0 and got._cov.device.type == "cpu"
    _hold_pipeline_engines(got, want, -1)
    with pytest.raises(IndexError):
        port.query_engine(t=T)


def test_pipeline_query_engine_matches_the_reference_guarded(case, tmp_path):
    """Both packages append a table whose date T0+5 collapses from the
    reference's guarded checkpoint; each engine of that date serves the
    last healthy covariance, one date stale."""
    df, table, sim = case
    head = ref_pipeline.run_risk_pipeline(
        _head(df, T0), config=_ref_cfg(True), with_state=True,
        sim_covs=jnp.asarray(sim), sim_length=T)
    path = str(tmp_path / "state.npz")
    ref_pipeline.save_pipeline_state(path, head)
    poisoned = _collapse_date(table, T0 + 5)
    want_app = ref_pipeline.append_risk_pipeline(
        path, pd.DataFrame(poisoned), config=_ref_cfg(True))
    got_app = append_risk_pipeline(path, poisoned, config=_cfg(True),
                                   device="cpu")
    assert np.nonzero(got_app.report.quarantined.numpy())[0].tolist() == [5]
    bench = {"cap": _cap_weights(got_app.arrays, 5)}
    for t in (5, -1):
        got = got_app.query_engine(t=t, benchmarks=bench)
        want = want_app.query_engine(t=t, benchmarks=bench)
        assert got.staleness == (1 if t == 5 else 0)
        _hold_pipeline_engines(got, want, t)


def test_from_risk_state_on_reference_checkpoints(case, tmp_path):
    """A guarded checkpoint the reference saved serves the same answers
    from both packages: through ``state_from_reference`` alone (names
    f0..fK) and with the checkpoint's meta (country, industries, styles)."""
    df, _, sim = case
    head = ref_pipeline.run_risk_pipeline(
        _head(df, T0), config=_ref_cfg(True), with_state=True,
        sim_covs=jnp.asarray(sim), sim_length=T)
    path = str(tmp_path / "state.npz")
    ref_pipeline.save_pipeline_state(path, head)
    rng = np.random.default_rng(9)
    W = rng.standard_normal((6, 1 + P + Q))
    bench = {"tilt": rng.standard_normal(1 + P + Q)}
    state, _ = state_from_reference(path, device="cpu")
    got = QueryEngine.from_risk_state(state, benchmarks=bench, device="cpu")
    want = RefEngine.from_risk_state(head.state, benchmarks=bench)
    assert got.factor_names == want.factor_names == \
        [f"f{i}" for i in range(1 + P + Q)]
    _close_outputs(got.query(W, bench=["tilt"] * 6),
                   want.query(W, bench=["tilt"] * 6), "state_from_reference")
    state, meta = load_risk_state(path, device="cpu")
    got = QueryEngine.from_risk_state(state, meta, device="cpu")
    want = RefEngine.from_risk_state(head.state, meta)
    assert got.factor_names == want.factor_names
    assert got.factor_names[:2] == ["country", str(meta["industry_codes"][0])]
    assert got.staleness == want.staleness == 0
    _close_outputs(got.query(W), want.query(W), "checkpoint with meta")
