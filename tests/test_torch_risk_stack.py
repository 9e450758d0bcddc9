"""The port's one-date entry points of the risk stack against the JAX
package's and the loopy NumPy goldens, on the CPU at float64:
``models/eigen.eigen_risk_adjust`` (one covariance, injected simulated
covariances) and ``ops/xreg.cross_section_regress`` (one date's
constrained WLS), with the reference's degenerate dates."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import golden
from mfm_tpu.data.barra import barra_frame_to_arrays
from mfm_tpu.data.synthetic import synthetic_barra_table
from mfm_tpu.models.eigen import eigen_risk_adjust as ref_eigen_risk_adjust
from mfm_tpu.ops.xreg import cross_section_regress as ref_cross_section
from mfm_tpu_torch.models.eigen import eigen_risk_adjust
from mfm_tpu_torch.ops.xreg import cross_section_regress, regress_panel

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# -- eigen_risk_adjust -----------------------------------------------------------

@pytest.fixture(scope="module")
def fret():
    rng = np.random.default_rng(7)
    T, K = 90, 5
    e = 0.01 * rng.standard_normal((T, K))
    f = np.copy(e)
    for t in range(1, T):
        f[t] += 0.4 * f[t - 1]
    return f


def _sim_covs(rng, M, K, L=200):
    draws = rng.standard_normal((M, K, L))
    d = draws - draws.mean(axis=-1, keepdims=True)
    return draws, np.einsum("mkt,mlt->mkl", d, d) / (L - 1)


def test_eigen_adjust_matches_golden_and_reference(fret):
    K = fret.shape[1]
    cov = golden.golden_newey_west(fret, 2, 252.0)
    draws, sim_covs = _sim_covs(np.random.default_rng(3), 16, K)
    got = eigen_risk_adjust(_t(cov), _t(sim_covs), 1.4).numpy()
    np.testing.assert_allclose(
        got, golden.golden_eigen_adj(cov, draws, scale_coef=1.4),
        rtol=1e-8, atol=1e-14)
    np.testing.assert_allclose(got, np.asarray(ref_eigen_risk_adjust(
        jnp.asarray(cov), jnp.asarray(sim_covs), 1.4)), rtol=1e-9, atol=1e-15)
    assert got.shape == (K, K)
    np.testing.assert_allclose(got, got.T, rtol=1e-12)


def test_eigen_adjust_of_a_singular_cov_matches_reference(fret):
    """An exactly-zero eigenvalue takes the degenerate-ratio branch; a
    negative one makes the covariance invalid (NaN) in both packages."""
    K = fret.shape[1]
    _, sim_covs = _sim_covs(np.random.default_rng(9), 8, K)
    for evals in ([0.0] + list(1e-4 * (1 + np.arange(K - 1))),
                  [-1e-6] + list(1e-4 * (1 + np.arange(K - 1)))):
        cov = np.diag(evals)
        got = eigen_risk_adjust(_t(cov), _t(sim_covs), 1.4).numpy()
        want = np.asarray(ref_eigen_risk_adjust(jnp.asarray(cov),
                                                jnp.asarray(sim_covs), 1.4))
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-15)


# -- cross_section_regress -------------------------------------------------------

@pytest.fixture(scope="module")
def barra():
    df, style_names = synthetic_barra_table(T=40, N=60, P=6, Q=4, seed=1,
                                            missing=0.05)
    arrays = barra_frame_to_arrays(df, style_names=style_names)
    return df, style_names, arrays


def _date(a, t):
    return (a.ret[t], a.cap[t], a.styles[t], a.industry[t], a.valid[t])


def _both(args, P, **kw):
    got = cross_section_regress(*map(_t, args), n_industries=P, **kw)
    want = ref_cross_section(*map(jnp.asarray, args), n_industries=P, **kw)
    return got, want


def _same(got, want, rtol=1e-9, atol=1e-13):
    for name in ("factor_ret", "specific_ret", "r2", "exposure"):
        g, w = getattr(got, name), getattr(want, name)
        if w is None:
            assert g is None, name
            continue
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w),
                                      err_msg=name)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                   equal_nan=True, err_msg=name)


@pytest.mark.parametrize("t", [0, 7, 23, 39])
def test_one_date_matches_golden_and_reference(t, barra):
    df, style_names, a = barra
    got, want = _both(_date(a, t), a.n_industries)
    _same(got, want)
    gold = golden.golden_reg_by_time(df, style_names, a.industry_codes)
    g = gold[a.dates[t]]
    np.testing.assert_allclose(got.factor_ret.numpy(), g["f"], rtol=1e-8,
                               atol=1e-12)
    np.testing.assert_allclose(float(got.r2), g["r2"], rtol=1e-8)
    # one date is the panel's row at that date
    panel = regress_panel(*(_t(x[t:t + 1]) for x in (
        a.ret, a.cap, a.styles, a.industry, a.valid)),
        n_industries=a.n_industries)
    assert torch.equal(panel.factor_ret[0], got.factor_ret)


def test_pure_factor_exposure_identity(barra):
    """Omega X R == R: unit exposure of each pure-factor portfolio to its
    own factor (CrossSection.py:104)."""
    _, _, a = barra
    got, want = _both(_date(a, 7), a.n_industries, return_exposure=True)
    _same(got, want)
    expo = got.exposure.numpy()
    assert abs(expo[0, 0] - 1.0) < 1e-8
    Q = a.styles.shape[-1]
    np.testing.assert_allclose(expo[-Q:, -Q:], np.eye(Q), atol=1e-8)


def test_no_industry_branch(barra):
    _, _, a = barra
    t = 3
    v = a.valid[t]
    got, want = _both(_date(a, t), 0)
    _same(got, want)
    f, _, r2 = golden.golden_cross_section(a.ret[t][v], a.cap[t][v],
                                           a.styles[t][v],
                                           np.zeros((v.sum(), 0)))
    np.testing.assert_allclose(got.factor_ret.numpy(), f, rtol=1e-8,
                               atol=1e-12)
    np.testing.assert_allclose(float(got.r2), r2, rtol=1e-8)


# the degenerate dates of tests/test_edge_cases.py

def test_empty_universe_date_yields_nan():
    N, P, Q = 12, 3, 2
    rng = np.random.default_rng(0)
    args = (rng.standard_normal(N), np.exp(rng.normal(0, 1, N)),
            rng.standard_normal((N, Q)), rng.integers(0, P, N),
            np.zeros(N, bool))
    got, want = _both(args, P)
    assert torch.isnan(got.specific_ret).all()
    assert not torch.isfinite(got.r2)
    _same(got, want)


def test_single_stock_date():
    N, P, Q = 8, 2, 1
    rng = np.random.default_rng(1)
    valid = np.zeros(N, bool)
    valid[3] = True
    args = (rng.standard_normal(N), np.exp(rng.normal(0, 1, N)),
            rng.standard_normal((N, Q)), np.full(N, 1), valid)
    got, want = _both(args, P)
    assert got.factor_ret.shape == (1 + P + Q,)
    assert torch.isnan(got.specific_ret[~torch.from_numpy(valid)]).all()
    _same(got, want)


def test_last_industry_absent_is_non_finite_as_the_reference():
    """The constraint divides by the last industry's zero cap sum
    (CrossSection.py:70): non-finite in both packages."""
    N, P, Q = 20, 4, 2
    rng = np.random.default_rng(2)
    args = (rng.standard_normal(N), np.exp(rng.normal(0, 1, N)),
            rng.standard_normal((N, Q)), rng.integers(0, P - 1, N),
            np.ones(N, bool))
    got, want = _both(args, P)
    assert not torch.isfinite(got.factor_ret).all()
    np.testing.assert_array_equal(torch.isfinite(got.factor_ret).numpy(),
                                  np.isfinite(np.asarray(want.factor_ret)))


@pytest.mark.parametrize("seed", [4, 5])
def test_middle_industry_absent_is_priced_by_the_pinv(seed):
    """An industry absent in the middle: the Jacobi pseudo-inverse gives
    its factor return exactly 0 where the reference leaves rounding noise
    (~1e-16), so that lane is held in absolute terms, never relative."""
    N, P, Q = 30, 5, 2
    rng = np.random.default_rng(seed)
    industry = rng.choice([0, 1, 3, 4], N)          # industry 2 absent
    args = (0.01 * rng.standard_normal(N), np.exp(rng.normal(0, 1, N)),
            rng.standard_normal((N, Q)), industry, np.ones(N, bool))
    got, want = _both(args, P)
    f, fw = got.factor_ret.numpy(), np.asarray(want.factor_ret)
    absent = 1 + 2
    assert np.isfinite(f).all() and np.isfinite(fw).all()
    assert abs(f[absent]) <= 1e-12 and abs(fw[absent]) <= 1e-12
    keep = np.arange(f.size) != absent
    np.testing.assert_allclose(f[keep], fw[keep], rtol=1e-9, atol=1e-13)
    np.testing.assert_allclose(got.specific_ret.numpy(),
                               np.asarray(want.specific_ret), rtol=1e-9,
                               atol=1e-13)
    np.testing.assert_allclose(float(got.r2), float(want.r2), rtol=1e-9)
