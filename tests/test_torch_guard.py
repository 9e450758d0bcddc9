"""The serving slice's modules against the JAX package on the CPU: the
input guards and their NaN-aware median, the skip-masked Newey-West and
vol-regime recursions, and the incremental eigen Monte-Carlo.

Both packages get the same numpy inputs made from a seed.  Guard verdicts
and rings must match exactly; the float64 recursions within rtol 1e-8.
The incremental eigen gets the reference's own ``simulated_eigen_draws``
tensor as numpy (``jax.random`` and ``torch.Generator`` cannot give the
same draws), and the reference runs its Brent-Luk Jacobi
(``MFM_EIGH_CPU_JACOBI_BATCH=1``) at the port's sweep caps.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfm_tpu.config import QuarantinePolicy as RefPolicy
from mfm_tpu.models import eigen as ref_eigen
from mfm_tpu.models.newey_west import newey_west_expanding_resume as ref_nw
from mfm_tpu.models.vol_regime import vol_regime_adjust_resume as ref_vr
from mfm_tpu.serve import guard as ref_guard
from mfm_tpu_torch.config import QuarantinePolicy, RiskModelConfig
from mfm_tpu_torch.models.eigen import (
    draw_bucket,
    eigen_carry_init,
    eigen_risk_adjust_incremental,
    sim_sweeps_for,
    simulated_eigen_draws,
)
from mfm_tpu_torch.models.newey_west import newey_west_expanding_resume
from mfm_tpu_torch.models.vol_regime import vol_regime_adjust_resume
from mfm_tpu_torch.serve import guard
from mfm_tpu_torch.serve._checks import mad_outlier_cells, nanmedian

torch.set_num_threads(2)


def _close(got, want, rtol=1e-8):
    want = np.asarray(want)
    finite = np.isfinite(want)
    scale = np.abs(want[finite]).max() if finite.any() else 0.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=1e-12 * scale)


# -- nanmedian ----------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_nanmedian_matches_numpy_on_even_and_odd_counts(dtype):
    """Every finite count from 0 (all NaN) to 9 in one batch: the mean of
    the two middle values at even counts, not torch's lower one."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((200, 9)).astype(dtype)
    counts = np.arange(200) % 10
    for row, c in enumerate(counts):
        x[row, rng.permutation(9)[c:]] = np.nan
    x[7, :3] = [np.inf, -np.inf, 1.0]  # infinities are values, as in numpy
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN rows
        want = np.nanmedian(x, axis=-1)
    got = nanmedian(torch.from_numpy(x)).numpy()
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, want)
    assert float(torch.nanmedian(torch.tensor([1.0, 2.0, 3.0, 4.0]))) == 2.0
    assert float(nanmedian(torch.tensor([1.0, 2.0, 3.0, 4.0, np.nan]))) == 2.5


def test_mad_outlier_cells_match_the_reference_formula():
    from mfm_tpu.serve._checks import mad_outlier_cells as ref_mad

    rng = np.random.default_rng(1)
    x = rng.standard_normal((6, 25))
    x[0, :5] += 80.0
    x[1] = 3.0  # constant section: MAD 0 disables the check
    x[2, ::3] = np.nan
    got = mad_outlier_cells(torch.from_numpy(x), 10.0).numpy()
    for row in range(x.shape[0]):
        np.testing.assert_array_equal(got[row], ref_mad(x[row], 10.0, np))
    assert got[0, :5].all() and not got[1].any()


# -- guard_slab -----------------------------------------------------------------

def _guard_case(N, seed):
    """A 9-date slab that trips each check once (with one date tripping two),
    and a half-filled trailing ring."""
    rng = np.random.default_rng(seed)
    T = 9
    ret = 0.02 * rng.standard_normal((T, N))
    cap = rng.lognormal(10, 1, (T, N))
    valid = rng.random((T, N)) > 0.05
    ret[1, : int(0.6 * N)] = np.nan               # nan_density
    ret[3, : N // 4] += 50.0                       # ret_outlier
    valid[4] = False
    valid[4, :3] = True                            # universe_collapse
    cap[5, 2] = -1.0                               # cap_nonpos
    valid[5, 2] = True
    ret[7, : int(0.6 * N)] = np.nan                # nan_density + cap
    cap[7, N - 1] = np.nan
    valid[7, N - 1] = True
    ring = np.full(12, np.nan)
    ring[:5] = [N - 1, N - 2, N - 1, N, N - 1]
    return ret, cap, valid, ring, 5


@pytest.mark.parametrize("N", [24, 25])
def test_guard_slab_matches_reference_exactly(N):
    ret, cap, valid, ring, pos = _guard_case(N, seed=N)
    pre = np.zeros(9, np.uint32)
    pre[6] = ref_guard.REASON_DATE_ORDER
    heal = np.zeros(9, bool)
    heal[3] = True
    ref_pol = RefPolicy(enabled=True)
    pol = QuarantinePolicy(enabled=True)
    for kw_ref, kw in (({}, {}),
                       (dict(pre_reasons=jnp.asarray(pre),
                             heal_mask=jnp.asarray(heal)),
                        dict(pre_reasons=pre, heal_mask=heal))):
        q_r, reasons_r, ring_r, pos_r = ref_guard.guard_slab(
            jnp.asarray(ret), jnp.asarray(cap), jnp.asarray(valid),
            jnp.asarray(ring), jnp.asarray(pos, jnp.int32), ref_pol, **kw_ref)
        q, reasons, ring_p, pos_p = guard.guard_slab(
            torch.from_numpy(ret), torch.from_numpy(cap),
            torch.from_numpy(valid), torch.from_numpy(ring),
            torch.tensor(pos, dtype=torch.int32), pol, **kw)
        np.testing.assert_array_equal(reasons.numpy().astype(np.uint32),
                                      np.asarray(reasons_r))
        np.testing.assert_array_equal(q.numpy(), np.asarray(q_r))
        np.testing.assert_array_equal(ring_p.numpy(), np.asarray(ring_r))
        assert int(pos_p) == int(pos_r)
    # each check tripped where it was planted
    bits = reasons.numpy()
    assert bits[1] == guard.REASON_NAN_DENSITY
    assert bits[3] == guard.REASON_RET_OUTLIER and not q[3]  # healed
    assert bits[4] == guard.REASON_UNIVERSE_COLLAPSE
    assert bits[5] == guard.REASON_CAP_NONPOS
    assert bits[6] == guard.REASON_DATE_ORDER
    assert bits[7] == guard.REASON_NAN_DENSITY | guard.REASON_CAP_NONPOS
    assert not q[[0, 2, 8]].any()


def test_guard_ring_init_disables_the_collapse_check():
    ring, pos = guard.guard_ring_init(5, torch.float64)
    assert torch.isnan(ring).all() and int(pos) == 0
    ret = torch.zeros((1, 8), dtype=torch.float64)
    valid = torch.zeros((1, 8), dtype=torch.bool)
    valid[0, 0] = True
    q, reasons, ring2, pos2 = guard.guard_slab(
        ret, torch.ones_like(ret), valid, ring, pos,
        QuarantinePolicy(enabled=True))
    assert not q[0] and int(reasons[0]) == 0
    assert float(ring2[0]) == 1.0 and int(pos2) == 1
    assert torch.isnan(ring).all()  # the input ring is not written to


def test_host_date_reasons_and_reason_names_match_reference():
    dates = ["2020-01-02", "2020-01-02", "2020-01-03", "2020-01-01"]
    for last in (None, "2020-01-01", "2020-01-05"):
        got = guard.host_date_reasons(dates, last_date=last)
        want = ref_guard.host_date_reasons(dates, last_date=last)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for mask in range(64):
        assert guard.reason_names(mask) == ref_guard.reason_names(mask)


@pytest.mark.parametrize("fields", [
    {"universe_window": 0}, {"universe_window": True}, {"max_nan_frac": 1.5},
    {"min_universe_frac": -0.1}, {"mad_k": 0.0},
])
def test_quarantine_policy_validates_like_the_reference(fields):
    with pytest.raises(ValueError):
        RefPolicy(**fields)
    with pytest.raises(ValueError):
        QuarantinePolicy(**fields)


def test_quarantine_policy_identity_is_the_reference_tuple():
    kw = dict(enabled=True, max_nan_frac=0.1, mad_k=7.5, universe_window=21)
    assert QuarantinePolicy(**kw).identity() == RefPolicy(**kw).identity()
    assert QuarantinePolicy().identity() == RefPolicy().identity()


# -- skip-masked recursions ----------------------------------------------------

# masks inside the q=2 lag warm-up (dates 0, 1), inside t <= K (K = 5:
# date 3), and mid-history; two adjacent masked dates
SKIPS = [(0,), (1,), (3,), (12, 13), (0, 4, 20)]


@pytest.mark.parametrize("skips", SKIPS)
def test_newey_west_skip_mask_matches_reference(skips):
    rng = np.random.default_rng(2)
    x = 0.01 * rng.standard_normal((30, 5))
    x[list(skips)] = np.nan  # a masked date's NaN must not reach the sums
    skip = np.zeros(30, bool)
    skip[list(skips)] = True
    covs_r, valid_r, carry_r = ref_nw(jnp.asarray(x), q=2, half_life=20.0,
                                      skip_mask=jnp.asarray(skip))
    xt = torch.from_numpy(x)
    covs, valid, carry = newey_west_expanding_resume(
        xt, q=2, half_life=20.0, skip_mask=torch.from_numpy(skip))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_r))
    ok = ~skip
    _close(covs.numpy()[ok], np.asarray(covs_r)[ok])
    for got, want in zip(jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(np.asarray, carry)),
            jax.tree_util.tree_leaves(carry_r)):
        _close(got, want)
    assert int(carry[0]) == 30 - len(skips)
    # resumed in two pieces with the mask split: the same, bitwise
    c1, v1, k1 = newey_west_expanding_resume(xt[:10], q=2, half_life=20.0,
                                             skip_mask=skip[:10])
    c2, v2, k2 = newey_west_expanding_resume(xt[10:], q=2, half_life=20.0,
                                             carry=k1, skip_mask=skip[10:])
    assert torch.equal(torch.cat([v1, v2]), valid)
    assert torch.equal(torch.cat([c1, c2])[ok], covs[ok])
    for a, b in zip(jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(np.asarray, k2)),
            jax.tree_util.tree_leaves(
                jax.tree_util.tree_map(np.asarray, carry))):
        np.testing.assert_array_equal(a, b)
    # excision: the carry equals that of the series with the dates cut out
    _, _, cut = newey_west_expanding_resume(xt[ok], q=2, half_life=20.0)
    for a, b in zip(jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(np.asarray, cut)),
            jax.tree_util.tree_leaves(
                jax.tree_util.tree_map(np.asarray, carry))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("skips", SKIPS)
def test_vol_regime_skip_mask_matches_reference(skips):
    rng = np.random.default_rng(3)
    T, K = 30, 4
    f = 0.01 * rng.standard_normal((T, K))
    X = rng.standard_normal((T, K, 3 * K))
    covs = 1e-4 * np.einsum("tik,tjk->tij", X, X) / (3 * K)
    valid = np.arange(T) >= 6
    skip = np.zeros(T, bool)
    skip[list(skips)] = True
    valid &= ~skip
    covs[~valid] = np.nan
    f[skip] = np.nan
    adj_r, lamb_r, carry_r = ref_vr(jnp.asarray(f), jnp.asarray(covs),
                                    jnp.asarray(valid), half_life=10.0,
                                    skip_mask=jnp.asarray(skip))
    ft, ct, vt = (torch.from_numpy(a) for a in (f, covs, valid))
    adj, lamb, carry = vol_regime_adjust_resume(ft, ct, vt, half_life=10.0,
                                                skip_mask=skip)
    _close(lamb.numpy(), np.asarray(lamb_r), rtol=1e-10)
    _close(adj.numpy(), np.asarray(adj_r), rtol=1e-10)
    for got, want in zip(carry, carry_r):
        _close(got.numpy(), np.asarray(want), rtol=1e-10)
    _, _, cut = vol_regime_adjust_resume(ft[~skip], ct[~skip], vt[~skip],
                                         half_life=10.0)
    assert all(torch.equal(a, b) for a, b in zip(cut, carry))


# -- incremental eigen -----------------------------------------------------------

def _eigen_case(T=20, K=6, M=5, seed=4):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((T, K, 3 * K))
    covs = np.einsum("tik,tjk->tij", X, X) / (3 * K)
    valid = np.arange(T) >= 2
    valid[9] = False
    draws = np.array(ref_eigen.simulated_eigen_draws(
        jax.random.key(0), K, draw_bucket(T), M, dtype=jnp.float64))
    return covs, valid, draws


@pytest.mark.parametrize("chunk,skips", [(None, ()), (None, (3, 11)),
                                         (4, (3, 11)), (7, ())])
def test_eigen_incremental_matches_reference(monkeypatch, chunk, skips):
    monkeypatch.setenv("MFM_EIGH_CPU_JACOBI_BATCH", "1")
    covs, valid, draws = _eigen_case()
    T, K, M = covs.shape[0], covs.shape[-1], draws.shape[0]
    skip = np.zeros(T, bool)
    skip[list(skips)] = True
    sweeps = sim_sweeps_for(K, torch.float64, T)
    out_r, ok_r, carry_r = ref_eigen.eigen_risk_adjust_incremental(
        jnp.asarray(covs), jnp.asarray(valid), jnp.asarray(draws),
        ref_eigen.eigen_carry_init(M, K, jnp.float64), 1.4,
        sim_sweeps=sweeps, chunk=chunk, skip_mask=jnp.asarray(skip))
    out, ok, carry = eigen_risk_adjust_incremental(
        torch.from_numpy(covs), torch.from_numpy(valid),
        torch.from_numpy(draws), eigen_carry_init(M, K, torch.float64), 1.4,
        sim_sweeps=sweeps, chunk=chunk, skip_mask=torch.from_numpy(skip))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_r))
    _close(out.numpy(), np.asarray(out_r))
    for got, want in zip(carry, carry_r):
        _close(got.numpy(), np.asarray(want))
    assert int(carry[2]) == T - len(skips)


def test_eigen_incremental_chunked_resumed_and_excised_bitwise():
    covs, valid, draws = _eigen_case(T=24, seed=5)
    covs_t, valid_t, draws_t = (torch.from_numpy(a)
                                for a in (covs, valid, draws))
    init = eigen_carry_init(5, 6, torch.float64)
    full = eigen_risk_adjust_incremental(covs_t, valid_t, draws_t, init,
                                         sim_sweeps=5)
    for chunk in (1, 5, 24):
        part = eigen_risk_adjust_incremental(covs_t, valid_t, draws_t, init,
                                             sim_sweeps=5, chunk=chunk)
        assert torch.equal(part[0].nan_to_num(), full[0].nan_to_num())
        assert all(torch.equal(a, b) for a, b in zip(part[2], full[2]))
    a = eigen_risk_adjust_incremental(covs_t[:10], valid_t[:10], draws_t,
                                      init, sim_sweeps=5)
    b = eigen_risk_adjust_incremental(covs_t[10:], valid_t[10:], draws_t,
                                      a[2], sim_sweeps=5)
    assert torch.equal(torch.cat([a[0], b[0]]).nan_to_num(),
                       full[0].nan_to_num())
    assert all(torch.equal(x, y) for x, y in zip(b[2], full[2]))
    # a skipped date consumes no column: (good, BAD, good) == (good, good)
    skip = torch.zeros(24, dtype=torch.bool)
    skip[12] = True
    sk = eigen_risk_adjust_incremental(covs_t, valid_t, draws_t, init,
                                       sim_sweeps=5, skip_mask=skip)
    keep = ~skip
    cut = eigen_risk_adjust_incremental(covs_t[keep], valid_t[keep], draws_t,
                                        init, sim_sweeps=5)
    assert all(torch.equal(x, y) for x, y in zip(sk[2], cut[2]))
    assert torch.equal(sk[0][keep].nan_to_num(), cut[0].nan_to_num())


def test_draws_are_prefix_stable_across_a_bucket_rollover():
    for T in (1, 64, 65, 1390, 2048, 2049):
        assert draw_bucket(T) == ref_eigen.draw_bucket(T)
    for dtype in (torch.float32, torch.float64):
        d64 = simulated_eigen_draws(3, 6, 64, 8, dtype=dtype)
        d128 = simulated_eigen_draws(3, 6, 128, 8, dtype=dtype)
        assert d128.shape == (8, 6, 128) and d128.dtype == dtype
        assert torch.equal(d128[..., :64], d64)
        assert not torch.equal(d128[..., 64:], d128[..., :64])
    other = simulated_eigen_draws(4, 6, 64, 8)
    assert not torch.equal(other, simulated_eigen_draws(3, 6, 64, 8))
    d = simulated_eigen_draws(0, 6, 1024, 8, dtype=torch.float64)
    assert abs(float(d.mean())) < 0.02 and abs(float(d.std()) - 1) < 0.02


def test_config_takes_incremental_and_quarantine():
    cfg = RiskModelConfig(eigen_incremental=True,
                          quarantine=QuarantinePolicy(enabled=True))
    assert cfg.identity()[-1] == QuarantinePolicy(enabled=True).identity()
    with pytest.raises(ValueError, match="eigen_incremental"):
        RiskModelConfig(eigen_incremental=True, eigen_sim_length=48)
