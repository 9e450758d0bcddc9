"""The port's alpha DSL, metrics and evaluators (``mfm_tpu_torch/alpha/``)
against the JAX package's, on the CPU at float64.

The same numpy panel, made from a seed, goes through both packages: every
op of the vocabulary (aliases included) on a panel with NaNs, exact ties,
constant windows, out-of-range group codes and ``delay`` past the series
start; the validator's rejections message for message; the batch and
fused-score evaluators; the scorecard metrics; and config 5's workload as
a whole.  Tolerance: rtol 1e-9 (atol 1e-12) with identical NaN patterns,
tighter than the reference's own tolerances against pandas (``ts_corr``
1e-6, ``ts_cov`` 1e-4).  Each place where plain PyTorch behaves otherwise
than ``jax.numpy`` has a case of its own (``test_trap_*``), which fails on
the plain-torch behaviour.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import chip_smoke
from mfm_tpu.alpha import dsl as ref_dsl
from mfm_tpu.alpha import metrics as ref_metrics
from mfm_tpu.alpha import select as ref_select
from mfm_tpu_torch.alpha import dsl, metrics, select

torch.set_num_threads(2)

RTOL, ATOL = 1e-9, 1e-12


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, what="", rtol=RTOL, atol=ATOL):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want),
                                  err_msg=f"{what}: NaN pattern")
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               equal_nan=True, err_msg=what)


@pytest.fixture(scope="module")
def panels():
    """(reference panel of jnp arrays, port panel of CPU tensors), float64:
    5% NaN holes, a column of exact cross-sectional ties, constant windows,
    a column rounded into exact time-series ties, group codes with a NaN
    and an out-of-range code."""
    rng = np.random.default_rng(0)
    T, N = 60, 12
    close = np.exp(np.cumsum(0.02 * rng.standard_normal((T, N)), axis=0))
    close[rng.random((T, N)) < 0.05] = np.nan
    close[:, 7] = close[:, 6]                # exact ties across stocks
    close[10:22, 3] = 1.37                   # constant windows
    close[30:42, 4] = 2.0
    close[:, 5] = np.round(close[:, 5], 1)   # ties in time
    volume = np.exp(rng.normal(10, 1, (T, N)))
    volume[rng.random((T, N)) < 0.05] = np.nan
    ret = np.full_like(close, np.nan)
    ret[1:] = close[1:] / close[:-1] - 1
    opn = close * np.exp(rng.normal(0, 0.01, (T, N)))
    ind = np.broadcast_to(rng.integers(0, 3, N), (T, N)).astype(float).copy()
    ind[5, 2] = np.nan
    ind[7, 1] = 70.0                         # outside [0, 64): NaN out
    fields = {"close": close, "volume": volume, "ret": ret, "open": opn,
              "ind": ind}
    return ({k: jnp.asarray(v) for k, v in fields.items()},
            {k: torch.from_numpy(v) for k, v in fields.items()})


#: one expression per op of the vocabulary, aliases included
OP_CASES = {
    "abs": "abs(ret)",
    "log": "log(close - 1.0)",
    "sign": "sign(ret)",
    "sqrt": "sqrt(ret)",
    "power": "power(close, 2.5)",
    "min": "min(close, open)",
    "max": "max(close, 1.0)",
    "where": "where(ret > 0, close, -volume)",
    "cs_rank": "cs_rank(close)",
    "cs_zscore": "cs_zscore(close)",
    "cs_demean": "cs_demean(ret)",
    "cs_scale": "cs_scale(ret)",
    "delay": "delay(close, 3)",
    "delta": "delta(close, 3)",
    "ts_mean": "ts_mean(close, 5)",
    "ts_std": "ts_std(close, 5)",
    "ts_sum": "ts_sum(ret, 7)",
    "ts_min": "ts_min(close, 5)",
    "ts_max": "ts_max(close, 5)",
    "ts_product": "ts_product(ret + 1.0, 5)",
    "ts_rank": "ts_rank(close, 6)",
    "ts_corr": "ts_corr(close, volume, 10)",
    "ts_cov": "ts_cov(close, volume, 10)",
    "ts_argmax": "ts_argmax(close, 7)",
    "ts_argmin": "ts_argmin(close, 7)",
    "decay_linear": "decay_linear(close, 6)",
    "signed_power": "signed_power(ret, 0.5)",
    "cs_winsorize": "cs_winsorize(close, 2.0)",
    "cs_neutralize": "cs_neutralize(ret, ind)",
    "rank": "rank(volume)",
    "stddev": "stddev(ret, 9)",
    "correlation": "correlation(close, open, 8)",
    "covariance": "covariance(ret, volume, 8)",
    "sum": "sum(close, 4)",
    "product": "product(close, 3)",
    "signedpower": "signedpower(ret, 2.0)",
    "indneutralize": "indneutralize(close, ind, 3)",
    "scale": "scale(close)",
}


def test_op_cases_cover_the_vocabulary():
    assert set(OP_CASES) == set(dsl._OPS) == set(ref_dsl._OPS)


@pytest.mark.parametrize("op", sorted(OP_CASES))
def test_op_matches_reference(op, panels):
    ref, port = panels
    src = OP_CASES[op]
    want = ref_dsl.compile_alpha(src)(ref)
    got = dsl.compile_alpha(src)(port)
    assert got.dtype == torch.float64
    _close(got, want, src)


@pytest.mark.parametrize("src", [
    "delay(close, 60)", "delay(close, 200)", "delta(close, 61)",
    "delay(close, 0)", "ts_mean(close, 200)", "ts_rank(close, 1)",
    "-close % 2 + +volume", "cs_rank(close) > 0.5",
    "where(close > 0, close ** 2, 0.0) / ts_mean(close, 5)",
    "-1 * correlation(rank(delta(log(volume), 1)), "
    "rank((close - open) / open), 6)",
])
def test_edge_expression_matches_reference(src, panels):
    ref, port = panels
    _close(dsl.compile_alpha(src)(port),
           np.asarray(ref_dsl.compile_alpha(src)(ref), np.float64), src)


# -- where plain torch differs from jax.numpy ------------------------------------

def test_trap_sign_keeps_nan(panels):
    """torch.sign(nan) is 0: a missing stock would count as valid in
    cs_rank(sign(x)), and every other rank would move."""
    assert torch.sign(torch.tensor(float("nan"))) == 0
    ref, port = panels
    src = "cs_rank(sign(close - 1.0))"
    got = dsl.compile_alpha(src)(port)
    _close(got, ref_dsl.compile_alpha(src)(ref), src)
    assert torch.isnan(got).sum() == torch.isnan(port["close"]).sum()


def test_trap_mod_is_python_sign_modulo(panels):
    """``%`` is jnp.mod (the divisor's sign), not torch.fmod (the
    dividend's): they differ on negatives; a zero divisor gives NaN."""
    x = torch.tensor([-1.25, 1.25, float("nan"), 3.0], dtype=torch.float64)
    assert not torch.equal(torch.fmod(x, 1.0)[:2], torch.remainder(x, 1.0)[:2])
    ref, port = panels
    for src in ("ret % 0.01", "-close % 0.3", "close % -0.7", "close % 0.0"):
        _close(dsl.compile_alpha(src)(port), ref_dsl.compile_alpha(src)(ref),
               src)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_trap_integer_constants_stack_in_the_panel_dtype(dtype, panels):
    """where(cond, 1, 0) is int64 in plain torch (int32 in JAX): the
    stacked batch must come out in the panel's float dtype, as jnp.stack
    promotes it; min/max with a float constant bind."""
    ref, port = panels
    p = {k: v.to(dtype) for k, v in port.items()}
    assert torch.where(p["ret"] > 0, 1, 0).dtype == torch.int64
    srcs = ["where(ret > 0, 1, 0)", "min(ret, 0.0)", "max(close, 2.0)",
            "ret > 0", "cs_rank(close)"]
    out = dsl.compile_alpha_batch(srcs)(p)
    assert out.dtype == dtype and out.shape == (5, 60, 12)
    want = ref_dsl.evaluate_alphas(
        srcs, {k: jnp.asarray(_np(v)) for k, v in p.items()}, jit=False)
    _close(out, want, "batch", rtol=1e-6 if dtype == torch.float32 else RTOL)


def test_trap_cs_rank_breaks_ties_by_position(panels):
    """Stable sort: among exact ties the earlier stock ranks first (pandas
    method='first'); an unstable sort may order them either way."""
    ref, port = panels
    x = port["close"][:, :8].clone()
    x[:, 1::2] = x[:, ::2]                   # every value twice
    got = dsl.cs_rank(x)
    np.testing.assert_array_equal(
        _np(got), np.asarray(ref_dsl.cs_rank(jnp.asarray(_np(x)))))
    both = torch.isfinite(x[:, 0])
    assert (got[both, 0] < got[both, 1]).all()


def test_trap_ts_argmax_argmin_give_ties_to_the_most_recent_day():
    x = torch.tensor([[1.0], [3.0], [2.0], [3.0], [1.0], [1.0]],
                     dtype=torch.float64)
    mx = dsl.ts_argmax(x, 4)
    mn = dsl.ts_argmin(x, 4)
    # window ending at date 4 holds 3, 2, 3, 1: the max's latest day is 1
    # day back; at date 5 (2, 3, 1, 1) the min is today
    assert mx[4, 0] == 1 and mn[5, 0] == 0
    ref = jnp.asarray(_np(x))
    np.testing.assert_array_equal(_np(mx), np.asarray(ref_dsl.ts_argmax(ref, 4)))
    np.testing.assert_array_equal(_np(mn), np.asarray(ref_dsl.ts_argmin(ref, 4)))


def test_trap_windows_reduce_over_the_window_axis(panels):
    """unfold puts the window last; today is the window's last entry."""
    ref, port = panels
    win = dsl._windows(port["close"], 5)
    assert win.shape == (60, 12, 5)
    torch.testing.assert_close(win[:, :, -1], port["close"], equal_nan=True)
    for src in ("ts_min(close, 5)", "ts_max(volume, 9)", "ts_rank(ret, 4)",
                "ts_product(close, 2)"):
        _close(dsl.compile_alpha(src)(port), ref_dsl.compile_alpha(src)(ref),
               src)


@pytest.mark.parametrize("T", [5, 16, 17, 33, 60, 257, 1390])
def test_trap_cumsum_adds_in_the_reference_order(T):
    """jnp.cumsum on the CPU adds in blocks of 16 (torch.cumsum runs
    straight through): the window sums keep the reference's bits."""
    x = np.random.default_rng(T).standard_normal((T, 3))
    np.testing.assert_array_equal(_np(dsl._cumsum(torch.from_numpy(x))),
                                  np.asarray(jnp.cumsum(jnp.asarray(x), 0)))


def test_trap_constant_windows_keep_the_reference_values(panels):
    """ts_std's ss - s*s/n and ts_corr's variances cancel in a constant
    window; a straight cumsum leaves ~1e-8 (or a NaN) where the reference
    has other rounding."""
    ref, port = panels
    for src in ("ts_std(close, 5)", "ts_corr(close, volume, 10)",
                "ts_cov(close, open, 6)", "stddev(close, 3)"):
        got = dsl.compile_alpha(src)(port)
        _close(got, ref_dsl.compile_alpha(src)(ref), src)
    straight = torch.cumsum(port["close"].nan_to_num(), 0)
    assert not torch.equal(straight, dsl._cumsum(port["close"].nan_to_num()))


def test_trap_cs_neutralize_is_a_deterministic_segment_sum(panels):
    """No scatter-add (atomics on the card) and no one-hot: per-(date,
    group) sums in stock order, NaN for missing or out-of-range codes,
    equal to the reference's scatter over any group count."""
    ref, port = panels
    for k in (3, 64, 4096):
        got = dsl.cs_neutralize(port["ret"], port["ind"], k)
        want = ref_dsl.cs_neutralize(ref["ret"], ref["ind"], k)
        _close(got, want, f"num_groups={k}")
        assert torch.equal(got.nan_to_num(7.0), dsl.cs_neutralize(
            port["ret"], port["ind"], k).nan_to_num(7.0))
    out = dsl.cs_neutralize(port["ret"], port["ind"], 3)
    assert torch.isnan(out[5, 2]) and torch.isnan(out[7, 1])
    # group codes past num_groups are NaN, not aliased into a group
    assert torch.isnan(dsl.cs_neutralize(port["ret"], port["ind"], 2)[
        port["ind"] == 2]).all()


# -- the validator -----------------------------------------------------------------

#: every rejection of tests/test_alpha.py and tests/test_alpha_llm.py
REJECTED = [
    "__import__('os')", "close.attr", "close[0]", "(lambda: 1)()",
    "[x for x in close]", "unknown_fn(close)",
    "rank", "sum + 1", "delta(rank, 5)",
    "scale(cs_rank(close), 2)", "sum(close)", "ts_corr(close, 5)",
    "where(close > 0)", "where(close > 0, close)",
    "where(close > 0, close, 0.0, 1.0)", "min(close)", "max()",
    "power(close)", "power(close, 2.0, 3.0)",
    "ts_mean(close, 5.5)", "ts_mean(close, 0)", "delta(close, -2)",
    "delay(close, volume)", "cs_neutralize(close, ind, 32.5)",
    "cs_neutralize(close, ind, 1000000000)", "ts_rank(close, 50000)",
    "ts_corr(close, volume, 10.0)", "stddev(close, 2.5)",
    "ts_rank(close, True)",
    "-" * 500 + "close", "close" + "+close" * 150,
    "-" * 20000 + "close", "close" + "+close" * 10000,
    "[close]", "(close, volume)", "{1: close}", "close if volume else ret",
    "close and volume", "not close", "close // volume", "close ^ volume",
    "close << 2", "f'{close}'", "close + 'x'",
    "ts_mean(close, 3) < ret < close", "max(close, 5)", "close +",
]


@pytest.mark.parametrize("src", REJECTED, ids=lambda s: s[:40])
def test_validator_rejects_as_the_reference(src):
    with pytest.raises((ValueError, SyntaxError)) as ref_err:
        ref_dsl.compile_alpha(src)
    with pytest.raises(ref_err.type) as got_err:
        dsl.compile_alpha(src)
    assert str(got_err.value) == str(ref_err.value)


@pytest.mark.parametrize("src", [
    "cs_winsorize(close)", "cs_winsorize(close, 3.0)",
    "where(close > 0, close, -close)", "power(close, 2.0)",
    "ts_mean(close, 5)", "delay(close, 0)", "delta(close, 0)",
    "cs_neutralize(close, ind)", "cs_neutralize(close, ind, 32)",
    "signed_power(close, 0.5)", "((((close))))", "close" + "+close" * 50,
    "max(close, 5.0)", "max(close, open)", "ts_max(close, 5)",
    "cs_rank(delta(close, 5)) * volume",
])
def test_validator_accepts_as_the_reference(src):
    assert dsl.compile_alpha(src).fields == ref_dsl.compile_alpha(src).fields


def test_validator_fuzz_agrees_with_the_reference():
    """The reference's fragment-soup fuzz: every junk line compiles in both
    packages or fails in both with the same message."""
    import random
    import warnings

    rng = random.Random(0)
    frags = ["cs_rank", "ts_mean", "close", "volume", "(", ")", ",", "5",
             "5.5", "+", "-", "*", "/", "**", ">", "where", "min", "lambda",
             "[", "]", ".", "sum", "delay", "'x'", "__import__", "None",
             "True", "1e300", "0", "-3", "close.T", "{", "}", ":", "x", " ",
             "ind"]
    n_ok = 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", SyntaxWarning)
        for _ in range(2000):
            s = "".join(rng.choice(frags) for _ in range(rng.randint(1, 12)))
            outcome = []
            for mod in (ref_dsl, dsl):
                try:
                    outcome.append(("ok", mod.compile_alpha(s).fields))
                except (ValueError, SyntaxError) as err:
                    outcome.append((type(err).__name__, str(err)))
            assert outcome[0] == outcome[1], s
            n_ok += outcome[0][0] == "ok"
    assert n_ok > 50


# -- evaluators and metrics --------------------------------------------------------

def _workload(T, N, n):
    panel, exprs, fwd = chip_smoke.alpha_workload(T, N, n)
    return ({k: torch.from_numpy(v).double() for k, v in panel.items()},
            exprs, torch.from_numpy(fwd).double())


def test_smoke_workload_is_the_reference_workload():
    """chip_smoke.py's numpy copy of bench.py's _alpha_workload."""
    panel, exprs, fwd = chip_smoke.alpha_workload(50, 9, 40)
    ref_panel, ref_exprs, ref_fwd = bench._alpha_workload(50, 9, 40)
    assert exprs == ref_exprs
    for k, v in ref_panel.items():
        np.testing.assert_array_equal(panel[k], np.asarray(v))
    np.testing.assert_array_equal(fwd, np.asarray(ref_fwd))


def test_batch_chunks_are_bitwise_the_one_group_batch():
    panel, exprs, _ = _workload(80, 15, 25)
    one = dsl.compile_alpha_batch(exprs, chunk=None)(panel)
    for chunk in (1, 4, 7, 1000):
        assert torch.equal(dsl.compile_alpha_batch(exprs, chunk=chunk)(
            panel).nan_to_num(9.0), one.nan_to_num(9.0))
    assert one.shape == (25, 80, 15)
    with pytest.raises(ValueError, match="no sources"):
        dsl.compile_alpha_batch([])
    with pytest.raises(ValueError, match="no sources"):
        dsl.compile_alpha_scores([])


def test_fused_scores_match_the_summary_of_the_batch():
    """compile_alpha_scores reduces each chunk to its summary; across chunk
    boundaries it equals alpha_summary of the whole batch (the
    reference's test holds it at rtol 1e-6; here it is bitwise)."""
    panel, exprs, fwd = _workload(70, 12, 13)
    base = metrics.alpha_summary(dsl.evaluate_alphas(exprs, panel), fwd)
    for chunk in (2, 5, None):
        fused = dsl.compile_alpha_scores(exprs, chunk=chunk)(panel, fwd)
        assert set(fused) == set(base)
        for k in base:
            assert fused[k].shape == (13,)
            torch.testing.assert_close(fused[k], base[k], rtol=1e-6,
                                       atol=1e-7, equal_nan=True)
            assert torch.equal(fused[k].nan_to_num(9.0),
                               base[k].nan_to_num(9.0)), k


@pytest.fixture(scope="module")
def scored():
    """Config 5's workload at T=120, N=40, 60 expressions, in both
    packages at float64: (port alphas, fwd, reference alphas, fwd, the
    reference's panel and the expressions).

    The reference's alphas are its op-by-op evaluation
    (``evaluate_alphas(jit=False)``).  Under ``jit`` XLA fuses ts_corr's
    ``cov / sqrt(vx * vy)`` into a multiply by an approximate rsqrt, so a
    2-point window's correlation, exactly +-1, comes out +-1 or an ulp off
    it, and the rank metrics break those exact ties by that rounding;
    op by op every operation is IEEE's, as the port's are."""
    panel, exprs, fwd = _workload(120, 40, 60)
    ref_panel = {k: jnp.asarray(_np(v)) for k, v in panel.items()}
    ref_fwd = jnp.asarray(_np(fwd))
    return (dsl.compile_alpha_batch(exprs, chunk=16)(panel), fwd,
            ref_dsl.evaluate_alphas(exprs, ref_panel, jit=False), ref_fwd,
            ref_panel, exprs)


def test_batch_matches_reference(scored):
    got, _, want, _, ref_panel, exprs = scored
    _close(got, want, "evaluate_alphas(jit=False)")
    _close(got, ref_dsl.compile_alpha_batch(exprs, chunk=16)(ref_panel),
           "compile_alpha_batch")


@pytest.mark.parametrize("name", ["information_coefficient", "rank_ic",
                                  "quantile_spread"])
def test_metric_matches_reference(name, scored):
    got, fwd, want, ref_fwd, _, _ = scored
    _close(getattr(metrics, name)(got, fwd),
           getattr(ref_metrics, name)(want, ref_fwd), name)


def test_rank_turnover_matches_reference(scored):
    got, _, want, _, _, _ = scored
    _close(metrics.rank_turnover(got), ref_metrics.rank_turnover(want))


def test_slice_as_a_whole_matches_reference(scored):
    """Config 5's workload through compile_alpha_batch, alpha_summary and
    select_alphas in both packages: summaries within 1e-9, the same picks,
    the same correlation matrix."""
    got, fwd, want, ref_fwd, _, _ = scored
    s = metrics.alpha_summary(got, fwd)
    r = ref_metrics.alpha_summary(want, ref_fwd)
    assert set(s) == set(r)
    for k in r:
        _close(s[k], r[k], k)
    sel = select.select_alphas(got, fwd, k=8)
    ref = ref_select.select_alphas(want, ref_fwd, k=8)
    assert sel["indices"] == ref["indices"]
    assert sel["rejected"] == ref["rejected"]
    _close(sel["corr"], ref["corr"], "corr")
    np.testing.assert_allclose(sel["scores"], ref["scores"], rtol=RTOL)


@pytest.mark.parametrize("shape, tol", [
    (chip_smoke.ALPHA_TOL_SHAPE, chip_smoke.ALPHA_TOL),
    (chip_smoke.ALPHA_ALLA_TOL_SHAPE, chip_smoke.ALPHA_ALLA_TOL),
], ids=["alpha_engine", "alpha_alla"])
def test_alpha_tol_is_three_times_the_reference_float32_drift(shape, tol):
    """chip_smoke.ALPHA_TOL (and ALPHA_ALLA_TOL), the card's float32
    summary against float64: about 3x the reference's own float32-vs-
    float64 drift per key, measured here as the smoke's comment says
    (mfm_tpu on the CPU, op by op, the six templates' first instances of
    config 5's workload at the constant's shape)."""
    panel, exprs, fwd = chip_smoke.alpha_workload(*shape, n_exprs=6)
    out = {}
    for dt in (jnp.float32, jnp.float64):
        p = {k: jnp.asarray(v, dt) for k, v in panel.items()}
        a = ref_dsl.evaluate_alphas(exprs, p, jit=False)
        out[dt] = {k: np.asarray(v, np.float64) for k, v in
                   ref_metrics.alpha_summary(a, jnp.asarray(fwd, dt)).items()}
    assert set(tol) == set(out[jnp.float64])
    for k, limit in tol.items():
        a, b = out[jnp.float32][k], out[jnp.float64][k]
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        drift = float(np.nanmax(np.abs(a - b)))
        assert 2.5 * drift <= limit <= 4.0 * drift, (k, drift, limit)
        assert math.isfinite(limit)
