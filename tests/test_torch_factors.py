"""The port's factor layer (``mfm_tpu_torch/factors/``, ``ops/masked.py``,
``panel.py``) against the JAX package's, on the CPU at float64.

The same numpy inputs, made from a seed, go through both packages: the
row-space packing exactly, the TTM ring on adversarial report ids, the
cross-sectional regressions and post-processing, and every output of
``FactorEngine.run`` under both rolling implementations, at short windows
(many scan chunks in T=300) and at the reference's default windows on
T=600.  Tolerance: rtol 1e-8 with identical NaN patterns.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from mfm_tpu import panel as ref_panel
from mfm_tpu.config import FactorConfig as RefFactorConfig
from mfm_tpu.config import RollingSpec as RefRollingSpec
from mfm_tpu.data.synthetic import panel_to_engine_fields as ref_fields
from mfm_tpu.data.synthetic import synthetic_market_panel as ref_market_panel
from mfm_tpu.factors import engine as ref_engine
from mfm_tpu.factors import post as ref_post
from mfm_tpu.factors import style as ref_style
from mfm_tpu.ops import masked as ref_masked
from mfm_tpu_torch import panel
from mfm_tpu_torch.convert import factor_config_from_reference
from mfm_tpu_torch.data.synthetic import panel_to_engine_fields
from mfm_tpu_torch.factors import engine, post, style
from mfm_tpu_torch.ops import masked

torch.set_num_threads(2)

SHORT = RefFactorConfig(
    beta=RefRollingSpec(window=40, half_life=10, min_periods=8),
    rstr_total=60, rstr_lag=5, rstr_half_life=15, rstr_min_periods=8,
    dastd=RefRollingSpec(window=40, half_life=8, min_periods=8),
    cmra_window=30,
    stom=RefRollingSpec(window=10, min_periods=7),
    stoq=RefRollingSpec(window=21, min_periods=14),
    stoa=RefRollingSpec(window=42, min_periods=21),
)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, what, rtol=1e-8):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want),
                                  err_msg=f"{what}: NaN pattern")
    m = np.isfinite(want)
    scale = np.abs(want[m]).max() if m.any() else 0.0
    np.testing.assert_allclose(got[m], want[m], rtol=rtol, atol=1e-12 * scale,
                               err_msg=what)


# -- row-space packing ------------------------------------------------------------

def _observed(T, N, seed):
    rng = np.random.default_rng(seed)
    obs = rng.random((T, N)) > 0.3
    obs[:, 0] = False        # never observed
    obs[:, 1] = True         # always observed
    obs[: T // 2, 2] = False  # listed halfway
    return obs


@pytest.mark.parametrize("seed", [0, 1])
def test_rowspace_gather_scatter_are_the_reference(seed):
    T, N = 37, 9
    obs = _observed(T, N, seed)
    idx = engine.rowspace_index(_t(obs))
    want_idx = np.asarray(ref_engine.rowspace_index(jnp.asarray(obs)))
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    x = np.random.default_rng(seed).standard_normal((T, N))
    x[~obs] = np.nan
    per_date = np.arange(T, dtype=float)
    for data in (x, per_date):
        got = engine.gather_rows(_t(data), idx).numpy()
        want = np.asarray(ref_engine.gather_rows(jnp.asarray(data),
                                                 jnp.asarray(want_idx)))
        np.testing.assert_array_equal(got, want)
    rs = engine.gather_rows(_t(x), idx)
    back = engine.scatter_rows(rs, idx).numpy()
    np.testing.assert_array_equal(back, x)  # the round trip is exact
    np.testing.assert_array_equal(
        back, np.asarray(ref_engine.scatter_rows(jnp.asarray(rs.numpy()),
                                                 jnp.asarray(want_idx))))


# -- the TTM ring ---------------------------------------------------------------------

def _ttm_case():
    """Report ids and values per column: -1 gaps, an id back after a gap,
    a decreasing id, NaN values, no report at all, one report only."""
    ids = np.array([
        [-1, 0, 0, 1, 1, -1, 2, 2, 3, 3, -1, -1, 4, 5, 6, 7, 7, 8],
        [0, 1, -1, 1, 2, 3, -1, 3, 4, 4, 5, 6, 7, 8, 9, 10, 11, 12],
        [5, 4, 3, 3, 2, 1, 0, -1, 1, 2, 3, 4, 4, 4, 5, 6, 7, 8],
        [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17],
        [-1] * 18,
        [3] * 18,
        [0, -1, 0, -1, 1, -1, 1, 2, -1, 2, 3, 3, -1, 4, 0, 0, 5, 6],
    ]).T
    rng = np.random.default_rng(4)
    values = rng.standard_normal(ids.shape) * 1e5
    values[5, 3] = np.nan       # a NaN report value: 4 pushes of NaN TTM
    values[9, 1] = np.nan       # NaN on a day that repeats an id: not pushed
    values[ids < 0] = np.nan
    return ids, values


def test_ttm_rolling4_matches_the_reference_scan():
    ids, values = _ttm_case()
    got = style.ttm_rolling4(_t(values), _t(ids))
    want = ref_style.ttm_rolling4(jnp.asarray(values), jnp.asarray(ids))
    assert np.isfinite(np.asarray(want)).sum() >= 20
    _close(got, want, "ttm_rolling4")


def test_ttm_rolling4_random_report_streams():
    rng = np.random.default_rng(9)
    T, N = 400, 30
    step = rng.random((T, N)) < 0.05
    ids = np.cumsum(step, axis=0) + rng.integers(0, 3, N)
    ids[rng.random((T, N)) < 0.1] = -1
    back = rng.random((T, N)) < 0.01
    ids[back] = np.maximum(ids[back] - 2, 0)  # revisions back to older ids
    values = rng.standard_normal((T, N))
    values[rng.random((T, N)) < 0.02] = np.nan
    got = style.ttm_rolling4(_t(values), _t(ids))
    want = ref_style.ttm_rolling4(jnp.asarray(values), jnp.asarray(ids))
    _close(got, want, "ttm_rolling4 random")


# -- cross-sectional regressions ------------------------------------------------------

def test_masked_ols_residuals_batched_matches_per_date_reference():
    rng = np.random.default_rng(1)
    T, N, R = 8, 30, 2
    y = rng.standard_normal((T, N))
    X = rng.standard_normal((T, N, R))
    y[rng.random((T, N)) < 0.1] = np.nan
    X[rng.random((T, N, R)) < 0.05] = np.nan
    y[3, 3:] = np.nan                 # too few valid rows: all NaN
    mask = rng.random((T, N)) > 0.1
    got = masked.masked_ols_residuals(_t(y), _t(X), _t(mask))
    for t in range(T):
        want = ref_masked.masked_ols_residuals(y[t], X[t], mask[t])
        _close(got[t], want, f"date {t}")
    assert torch.isnan(got[3]).all()
    one = masked.masked_ols_residuals(_t(y), _t(X[..., 0]), min_valid=2)
    for t in range(T):
        _close(one[t], ref_masked.masked_ols_residuals(y[t], X[t, :, 0],
                                                       min_valid=2), "R=1")


def test_masked_ols_residuals_cuts_singular_values_as_jnp_pinv():
    """A section whose normal matrix has sigma_min/sigma_max between
    torch.linalg.pinv's default cut (3 eps) and jnp.linalg.pinv's (30 eps):
    the reference drops the near-null direction, so must the port."""
    rng = np.random.default_rng(0)
    N = 30
    s = rng.standard_normal(N)
    X = np.stack([s, s + 1e-7 * rng.standard_normal(N)], axis=-1)
    y = rng.standard_normal(N)
    A = np.concatenate([np.ones((N, 1)), X], axis=1)
    sv = np.linalg.svd(A.T @ A, compute_uv=False)
    eps = np.finfo(np.float64).eps
    assert 3 * eps < sv[-1] / sv[0] < 30 * eps
    want = np.asarray(ref_masked.masked_ols_residuals(y, X))
    got = masked.masked_ols_residuals(_t(y), _t(X))
    _close(got, want, "near-collinear section")
    batched = masked.masked_ols_residuals(_t(np.stack([y, y])),
                                          _t(np.stack([X, X])))
    _close(batched[1], want, "near-collinear section, batched")


def _sizes(T=12, N=25, seed=2):
    rng = np.random.default_rng(seed)
    size = rng.normal(11.0, 1.2, (T, N))
    size[rng.random((T, N)) < 0.1] = np.nan
    size[4, 1:] = np.nan    # one valid: NLSIZE needs 2
    size[5, 2:] = np.nan    # exactly two
    return size


def test_nlsize_matches_reference():
    size = _sizes()
    _close(style.compute_nlsize(_t(size)),
           ref_style.compute_nlsize(jnp.asarray(size)), "NLSIZE")
    mask = np.random.default_rng(3).random(size.shape) > 0.2
    _close(style.compute_nlsize(_t(size), _t(mask)),
           ref_style.compute_nlsize(jnp.asarray(size), jnp.asarray(mask)),
           "NLSIZE masked")


def test_post_processing_matches_reference():
    rng = np.random.default_rng(5)
    T, N = 10, 30
    names = ["SIZE", "BETA", "DASTD", "CMRA", "HSIGMA", "STOM", "STOQ", "STOA"]
    f = {k: rng.standard_normal((T, N)) for k in names}
    for k in names:
        f[k][rng.random((T, N)) < 0.15] = np.nan
    f["CMRA"][:, :] = np.nan     # a component missing everywhere
    f["HSIGMA"][2, :-1] = np.nan  # a single survivor
    f["BETA"][6, 3:] = np.nan     # too few rows to orthogonalize
    comp = (("volatility", ("DASTD", "CMRA", "HSIGMA"), (0.7, 0.15, 0.15)),
            ("liquidity", ("STOM", "STOQ", "STOA", "MISSING"),
             (0.5, 0.25, 0.25, 1.0)))
    rules = (("volatility", ("BETA", "SIZE")), ("liquidity", ("SIZE",)))
    got = post.apply_post_processing({k: _t(v) for k, v in f.items()}, comp,
                                     rules, n_std=2.0)
    want = ref_post.apply_post_processing(
        {k: jnp.asarray(v) for k, v in f.items()}, comp, rules, n_std=2.0)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], k)
    _close(post.winsorize_panel(_t(f["SIZE"])),
           ref_post.winsorize_panel(jnp.asarray(f["SIZE"])), "winsorize")
    parts = [f["DASTD"], f["CMRA"], f["HSIGMA"]]
    _close(post.composite_factor([_t(p) for p in parts], (0.7, 0.15, 0.15)),
           ref_post.composite_factor([jnp.asarray(p) for p in parts],
                                     (0.7, 0.15, 0.15)), "composite")
    _close(post.orthogonalize(_t(f["STOM"]), [_t(f["BETA"]), _t(f["SIZE"])]),
           ref_post.orthogonalize(jnp.asarray(f["STOM"]),
                                  [jnp.asarray(f["BETA"]),
                                   jnp.asarray(f["SIZE"])]), "orthogonalize")


# -- the engine ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def panels():
    return {"short": ref_market_panel(T=300, N=25, n_industries=5, seed=3,
                                      missing=0.03, listing_gap=0.3),
            "default": ref_market_panel(T=600, N=20, n_industries=5, seed=8,
                                        missing=0.02, listing_gap=0.2)}


def _engines(data, cfg, impl, post_process=True):
    want = ref_engine.FactorEngine(
        ref_fields(data, jnp.float64), jnp.asarray(data["index_close"]),
        config=cfg, block=16, rolling_impl=impl).run(post_process=post_process)
    port_cfg = factor_config_from_reference(dataclasses.asdict(cfg))
    eng = engine.FactorEngine(
        panel_to_engine_fields(data, torch.float64, "cpu"),
        torch.from_numpy(data["index_close"]), config=port_cfg, block=16,
        rolling_impl=impl, device="cpu")
    return eng.run(post_process=post_process), want


@pytest.mark.parametrize("windows", ["short", "default"])
@pytest.mark.parametrize("impl", ["scan", "block"])
def test_factor_engine_matches_reference(panels, impl, windows):
    cfg = SHORT if windows == "short" else RefFactorConfig()
    got, want = _engines(panels[windows], cfg, impl)
    assert set(got) == set(want)  # the reference's jit sorts its dict keys
    assert len(want) == 2 + 18 + 5  # returns, sub-factors, composites
    for k in want:
        assert got[k].dtype == torch.float64, k
        assert np.isfinite(np.asarray(want[k])).any(), f"{k} all NaN"
        _close(got[k], want[k], f"{k} ({impl}, {windows})")


def test_factor_engine_without_post_processing_and_a_subset(panels):
    data = panels["short"]
    got, want = _engines(data, dataclasses.replace(
        SHORT, factors_to_run=("beta", "EARNINGS", "NLSIZE")), "scan",
        post_process=False)
    assert list(got) == ["ret", "log_ret", "BETA", "HSIGMA", "CETOP", "ETOP",
                         "NLSIZE"]
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], k)


def test_factor_engine_block_size_device_and_errors(panels):
    data = panels["short"]
    fields = panel_to_engine_fields(data, torch.float32, "cpu")
    close = torch.from_numpy(data["index_close"]).float()
    for cfg in (RefFactorConfig(), SHORT):
        eng = engine.FactorEngine(
            fields, close, device="cpu",
            config=factor_config_from_reference(dataclasses.asdict(cfg)))
        want = ref_engine.FactorEngine(ref_fields(data, jnp.float32),
                                       jnp.asarray(data["index_close"]),
                                       config=cfg)
        assert eng.block == want.block
    with pytest.raises(ValueError, match="unknown factor"):
        engine.FactorEngine(fields, close, device="cpu").run(factors=("ALPHA",))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            engine.FactorEngine(fields, close)


# -- the panel ----------------------------------------------------------------------

def test_panel_and_returns_match_reference():
    rng = np.random.default_rng(6)
    close = np.exp(rng.standard_normal((9, 4)))
    close[2, 1] = np.nan
    close[5, 3] = 0.0
    np.testing.assert_array_equal(panel.pct_change(close),
                                  ref_panel.pct_change(close))
    np.testing.assert_array_equal(panel.log_return(close),
                                  ref_panel.log_return(close))
    long = pd.DataFrame({
        "trade_date": [3, 1, 2, 1, 3, 3],
        "ts_code": ["b", "a", "a", "b", "a", "a"],
        "close": [1.0, 2.0, "x", 4.0, 5.0, 6.0],
        "pb": [0.5, np.nan, 1.5, 2.5, 3.5, 4.5],
    })
    got = panel.Panel.from_long(long)
    want = ref_panel.Panel.from_long(long)
    np.testing.assert_array_equal(got.dates, want.dates)
    np.testing.assert_array_equal(got.stocks, want.stocks)
    for k in want.fields:
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got.mask(), want.mask())
    np.testing.assert_array_equal(got.mask("pb"), want.mask("pb"))
    pd.testing.assert_frame_equal(got.to_long(), want.to_long())
    pd.testing.assert_frame_equal(got.to_long("pb", dropna=False),
                                  want.to_long("pb", dropna=False))
    assert "close" in got and got.select(["pb"]).fields.keys() == {"pb"}
    with pytest.raises(ValueError, match="shape"):
        got["bad"] = np.zeros((2, 2))
