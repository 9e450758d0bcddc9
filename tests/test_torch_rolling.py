"""The port's rolling-window kernels (``mfm_tpu_torch/ops/rolling.py``)
against the JAX package's, on the CPU at float64.

The same numpy inputs, made from a seed, go through both packages' five
factor kernels under both implementations ("scan", "block"), at short
windows, where the scan path's chunks of ``window`` rows cross many chunk
boundaries in T=300, and at the reference's default windows on T=600.
Tolerance: rtol 1e-8 with identical NaN patterns.  The two-level scans are
also held to brute-force windowed sums and maxima.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfm_tpu.ops import rolling as ref
from mfm_tpu_torch.ops import rolling

torch.set_num_threads(2)

N = 12


def _series(T, seed=0):
    rng = np.random.default_rng(seed)
    mkt = 0.01 * rng.standard_normal(T)
    ret = 0.8 * mkt[:, None] + 0.015 * rng.standard_normal((T, N))
    ret[:40, 1] = np.nan            # late listing
    ret[50:90, 2] = np.nan          # a long suspension
    holes = rng.random((T, N)) < 0.05
    holes[:, -3:] = False           # fully observed: CMRA's full windows
    ret[holes] = np.nan
    ret[:, 3] = np.nan              # never enough data
    ret[T // 2:, 4] = np.nan        # delisted halfway
    mkt[rng.random(T) < 0.02] = np.nan
    return ret, mkt


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


#: (kernel, short-window kwargs, default-window kwargs)
KERNELS = {
    "beta_hsigma": (dict(window=40, half_life=10, min_periods=8),
                    dict(window=252, half_life=63, min_periods=42)),
    "weighted_std": (dict(window=40, half_life=8, min_periods=8),
                     dict(window=252, half_life=42, min_periods=42)),
    "decay_weighted_mean": (dict(window=55, half_life=15, min_periods=8),
                            dict(window=483, half_life=126, min_periods=42)),
    "sum": (dict(window=21, min_periods=14), dict(window=252, min_periods=126)),
    "cmra": (dict(window=30), dict(window=252)),
}


def _call(pkg, name, ret, mkt, asarray, **kw):
    x, m = asarray(ret), asarray(mkt)
    if name == "beta_hsigma":
        return pkg.rolling_beta_hsigma(x, m, **kw)
    if name in ("decay_weighted_mean", "cmra"):
        x = asarray(np.log1p(ret))
    return (getattr(pkg, f"rolling_{name}")(x, **kw),)


@pytest.mark.parametrize("windows", ["short", "default"])
@pytest.mark.parametrize("impl", rolling.ROLLING_IMPLS)
@pytest.mark.parametrize("name", list(KERNELS))
def test_rolling_kernel_matches_reference(name, impl, windows):
    T = 300 if windows == "short" else 600
    ret, mkt = _series(T)
    kw = KERNELS[name][windows == "default"]
    kw = dict(kw, impl=impl, block=32)
    want = _call(ref, name, ret, mkt, jnp.asarray, **kw)
    got = _call(rolling, name, ret, mkt, torch.from_numpy, **kw)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.float64
        assert np.isfinite(np.asarray(w)).any(), f"{name}[{i}] all NaN"
        _close(g, w, f"{name}[{i}] {impl} {windows}")


@pytest.mark.parametrize("name", list(KERNELS))
def test_scan_and_block_agree(name):
    ret, mkt = _series(300, seed=5)
    kw = dict(KERNELS[name][0], block=16)
    scan = _call(rolling, name, ret, mkt, torch.from_numpy, impl="scan", **kw)
    block = _call(rolling, name, ret, mkt, torch.from_numpy, impl="block",
                  **kw)
    for s, b in zip(scan, block):
        _close(s, b, f"{name} scan vs block", rtol=1e-9)


def test_unknown_impl_raises():
    ret, mkt = _series(50)
    with pytest.raises(ValueError, match="impl must be one of"):
        rolling.rolling_sum(torch.from_numpy(ret), window=5, min_periods=2,
                            impl="loop")


# -- the two-level scans against brute force ---------------------------------

def _brute(x, window, reduce, fill):
    T = x.shape[0]
    out = np.full(x.shape, fill)
    for t in range(T):
        out[t] = reduce(x[max(0, t - window + 1): t + 1], axis=0)
    return out


@pytest.mark.parametrize("T,window", [(1, 3), (7, 7), (50, 7), (301, 40)])
def test_windowed_sum_and_max_scans_are_brute_force(T, window):
    rng = np.random.default_rng(T)
    x = rng.standard_normal((T, 5))
    got = rolling.windowed_sum_scan(torch.from_numpy(x), window).numpy()
    np.testing.assert_allclose(got, _brute(x, window, np.sum, 0.0),
                               rtol=1e-12, atol=1e-12)
    xm = np.where(rng.random((T, 5)) < 0.3, -np.inf, x)
    got = rolling.windowed_max_scan(torch.from_numpy(xm), window).numpy()
    np.testing.assert_array_equal(got, _brute(xm, window, np.max, -np.inf))


@pytest.mark.parametrize("expo_kind", ["event", "calendar"])
def test_decay_windowed_sums_scan_is_brute_force(expo_kind):
    T, W = 230, 37
    rng = np.random.default_rng(3)
    valid = rng.random((T, 4)) > 0.2
    term = np.where(valid, rng.standard_normal((T, 4)), 0.0)
    if expo_kind == "event":
        expo, decay = np.cumsum(valid, axis=0).astype(float), 0.5 ** (1 / 9)
    else:
        expo, decay = np.arange(T, dtype=float)[:, None], 0.5 ** (-1 / 9)
    (got,) = rolling.decay_windowed_sums_scan(
        [torch.from_numpy(term)], W, torch.from_numpy(expo), decay)
    want = np.zeros_like(term)
    for t in range(T):
        j = np.arange(max(0, t - W + 1), t + 1)
        e = np.broadcast_to(expo, term.shape)
        want[t] = np.sum(decay ** (e[t] - e[j]) * term[j], axis=0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12)
    (ref_got,) = ref.decay_windowed_sums_scan(
        [jnp.asarray(term)], W, jnp.asarray(expo), decay)
    _close(got, ref_got, "decay_windowed_sums_scan")


# -- helpers ---------------------------------------------------------------------

@pytest.mark.parametrize("half_life", [10, 42, 63, 126])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_decay_rate_and_tail_weights_match_reference(half_life, dtype):
    lam = rolling.decay_rate(half_life, getattr(torch, dtype))
    want = ref.decay_rate(half_life, getattr(jnp, dtype))
    assert lam.dtype == getattr(torch, dtype)
    assert float(lam) == float(want)
    valid = np.random.default_rng(half_life).random((3, 40, 6)) > 0.3
    got = rolling.ewma_tail_weights_from_mask(torch.from_numpy(valid), lam,
                                              dim=1)
    np.testing.assert_allclose(
        got.numpy(),
        np.asarray(ref.ewma_tail_weights_from_mask(jnp.asarray(valid), want,
                                                   axis=1)),
        rtol=1e-6 if dtype == "float32" else 1e-14)


def test_auto_block_matches_reference():
    for n in (1, 30, 300, 1000, 5000, 20000):
        for window in (21, 252, 504):
            for itemsize in (4, 8):
                assert rolling.auto_block(n, window=window, itemsize=itemsize) \
                    == ref.auto_block(n, window=window, itemsize=itemsize)
    assert rolling.auto_block(300) == 64 and rolling.auto_block(5000) == 16
