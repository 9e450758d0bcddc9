"""The port's bias statistics and specific-risk model
(``mfm_tpu_torch/models/bias.py``, ``models/specific.py``) against the JAX
package on the CPU, at float64, to rtol 1e-8.

The same numpy inputs, made from a seed, go through both.  The reference's
eigenfactor bias stat decomposes with XLA's eigh and the port with its own
Jacobi (the full kernel's plain version here), so it is held on
covariances with well separated eigenvalues, where both give the same
eigenvectors up to sign, which the sum-normalisation cancels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfm_tpu.models import bias as ref_bias
from mfm_tpu.models import specific as ref_specific
from mfm_tpu_torch.models import bias, specific

torch.set_num_threads(2)


def _close(got, want, rtol=1e-8):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want)
        return
    finite = np.isfinite(want)
    scale = np.abs(want[finite]).max() if finite.any() else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-12 * scale)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("N", [200, 37, 7])  # 7 < ngroup: empty groups
def test_bayes_shrink_unmasked_matches_reference(N):
    rng = np.random.default_rng(N)
    vol = np.abs(rng.normal(0.02, 0.01, N))
    cap = np.exp(rng.normal(11, 1, N))
    want = ref_bias.bayes_shrink(jnp.asarray(vol), jnp.asarray(cap))
    _close(bias.bayes_shrink(_t(vol), _t(cap)), want)


@pytest.mark.parametrize("ngroup,q", [(10, 1.0), (5, 0.5), (3, 2.0)])
def test_bayes_shrink_masked_matches_reference_one_date_and_batched(ngroup,
                                                                    q):
    """One date as the reference runs it, and every date at once (the
    port's batched form) against the reference vmapped over dates."""
    rng = np.random.default_rng(ngroup)
    T, N = 9, 61  # N - 1 = 60: q (N - 1) lands on integers
    vol = np.abs(rng.normal(0.02, 0.01, (T, N)))
    cap = np.exp(rng.normal(11, 1, (T, N)))
    mask = rng.random((T, N)) > 0.25
    mask[0] = True
    vol[~mask] = np.nan  # masked-out poison must not leak
    cap[~mask & (rng.random((T, N)) > 0.5)] = np.nan
    one = ref_bias.bayes_shrink(jnp.asarray(vol[1]), jnp.asarray(cap[1]),
                                ngroup=ngroup, q=q, mask=jnp.asarray(mask[1]))
    _close(bias.bayes_shrink(_t(vol[1]), _t(cap[1]), ngroup=ngroup, q=q,
                             mask=_t(mask[1])), one)
    want = jax.vmap(lambda v, c, m: ref_bias.bayes_shrink(
        v, c, ngroup=ngroup, q=q, mask=m))(
        jnp.asarray(vol), jnp.asarray(cap), jnp.asarray(mask))
    _close(bias.bayes_shrink(_t(vol), _t(cap), ngroup=ngroup, q=q,
                             mask=_t(mask)), want)


def _specific_returns(seed, T=130, N=24):
    rng = np.random.default_rng(seed)
    u = 0.02 * rng.standard_normal((T, N))
    u[rng.random((T, N)) < 0.15] = np.nan
    u[:40, 0] = np.nan  # a late listing
    cap = np.exp(rng.normal(11, 1, (T, N)))
    cap[rng.random((T, N)) < 0.05] = np.nan
    return u, cap


@pytest.mark.parametrize("half_life,min_periods", [(42.0, 10), (10.0, 3)])
def test_ewma_specific_vol_matches_reference(half_life, min_periods):
    u, _ = _specific_returns(3)
    want = ref_specific.ewma_specific_vol(jnp.asarray(u), half_life,
                                          min_periods)
    _close(specific.ewma_specific_vol(_t(u), half_life, min_periods), want)


def test_specific_risk_by_time_matches_reference():
    u, cap = _specific_returns(4)
    want = ref_specific.specific_risk_by_time(
        jnp.asarray(u), jnp.asarray(cap), half_life=30.0, ngroup=5, q=1.0,
        min_periods=8)
    got = specific.specific_risk_by_time(_t(u), _t(cap), half_life=30.0,
                                         ngroup=5, q=1.0, min_periods=8)
    assert np.isfinite(got[1].numpy()).any()
    for g, w in zip(got, want):
        _close(g, w)


def _portfolio_case(seed, T=40, N=30, K=5, Q=6):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((T, N, K))
    dval = rng.random((T, N)) > 0.1
    A = rng.standard_normal((T, K, 3 * K))
    covs = 1e-4 * np.einsum("tik,tjk->tij", A, A) / (3 * K)
    cov_valid = np.arange(T) >= 4
    covs[~cov_valid] = np.nan
    spec = np.abs(rng.normal(0.02, 0.005, (T, N)))
    spec[rng.random((T, N)) < 0.1] = np.nan
    ret = 0.02 * rng.standard_normal((T, N))
    ret[rng.random((T, N)) < 0.05] = np.nan
    weights = np.abs(rng.standard_normal((Q, N)))
    weights[0, :] = 0.0  # an empty portfolio: no valid date
    return X, dval, covs, cov_valid, spec, ret, weights


def test_portfolio_bias_stat_and_bias_std_match_reference():
    case = _portfolio_case(5)
    z_r, ok_r = ref_bias.portfolio_bias_stat(*(jnp.asarray(a) for a in case))
    z, ok = bias.portfolio_bias_stat(*(_t(a) for a in case))
    _close(ok, ok_r)
    _close(z, z_r)
    assert ok.any() and not ok[0].any()
    T = case[0].shape[0]
    for mask in (ok, ok & (torch.arange(T - 1) >= 20)[None, :]):
        want = ref_bias.bias_std(z_r, jnp.asarray(mask.numpy()))
        got = bias.bias_std(z, mask)
        _close(got, want)
        assert torch.isnan(got[0])


def _distinct_covs(seed, T=60, K=6):
    """Covariances U diag(lam) U' with eigenvalues spread over [1, 6]e-4,
    at least 1e-4 apart, and random orthogonal U; a few invalid dates."""
    rng = np.random.default_rng(seed)
    U = np.linalg.qr(rng.standard_normal((T, K, K)))[0]
    lam = 1e-4 * (1.0 + np.arange(K) + 0.3 * rng.random((T, K)))
    covs = np.einsum("tik,tk,tjk->tij", U, lam, U)
    valid = rng.random(T) > 0.1
    covs[~valid] = np.nan
    f = np.sqrt(1e-4) * rng.standard_normal((T, K))
    return covs, valid, f


@pytest.mark.parametrize("predlen", [1, 3])
def test_eigenfactor_bias_stat_matches_reference(predlen):
    covs, valid, f = _distinct_covs(6)
    want = ref_bias.eigenfactor_bias_stat(jnp.asarray(covs),
                                          jnp.asarray(valid), jnp.asarray(f),
                                          predlen=predlen)
    got = bias.eigenfactor_bias_stat(_t(covs), _t(valid), _t(f),
                                     predlen=predlen)
    assert np.isfinite(got.numpy()).all()
    _close(got, want)


def test_bias_stats_summary_matches_reference():
    nw, nw_valid, f = _distinct_covs(7, T=80)
    eig, eig_valid, _ = _distinct_covs(8, T=80)
    args = (nw, nw_valid, eig, eig_valid, f)
    for burn_in in (30, 100):  # 100 > T: no after-burn-in scope
        want = ref_bias.bias_stats_summary(*(jnp.asarray(a) for a in args),
                                           burn_in=burn_in)
        got = bias.bias_stats_summary(*(_t(a) for a in args),
                                      burn_in=burn_in)
        assert got == want
