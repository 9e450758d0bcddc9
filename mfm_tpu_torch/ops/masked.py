"""Masked cross-sectional primitives (counterpart of ``mfm_tpu/ops/masked.py``).

Everything here operates on dense tensors where invalid entries are
excluded via a boolean mask (or NaN), reproducing the reference's drop-row
semantics with static shapes.  ``dim`` takes the place of JAX's ``axis``.
"""

from __future__ import annotations

import torch

from mfm_tpu_torch.utils.prec import highest_matmul_precision


def _as_mask(x, mask):
    if mask is None:
        return torch.isfinite(x)
    return mask & torch.isfinite(x)


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


def masked_mean(x, mask=None, dim=-1, keepdim: bool = False):
    """Mean over valid entries. Empty slice -> NaN (like pandas mean of none)."""
    m = _as_mask(x, mask)
    xz = torch.where(m, x, _zero(x))
    n = m.sum(dim=dim, keepdim=keepdim)
    return xz.sum(dim=dim, keepdim=keepdim) / n


def masked_var(x, mask=None, dim=-1, ddof: int = 0, keepdim: bool = False):
    """Variance over valid entries (ddof=0 matches ``np.var``; ddof=1 matches
    pandas ``.std()**2``)."""
    m = _as_mask(x, mask)
    zero = _zero(x)
    n = m.sum(dim=dim, keepdim=True)
    mu = torch.where(m, x, zero).sum(dim=dim, keepdim=True) / n
    d2 = torch.where(m, (x - mu) ** 2, zero)
    v = d2.sum(dim=dim, keepdim=True) / (n - ddof)
    if not keepdim:
        v = v.squeeze(dim)
    return v


def masked_std(x, mask=None, dim=-1, ddof: int = 0, keepdim: bool = False):
    return torch.sqrt(masked_var(x, mask, dim=dim, ddof=ddof, keepdim=keepdim))


def masked_weighted_mean(x, w, mask=None, dim=-1, keepdim: bool = False):
    """Weighted mean over valid entries; weights renormalized over the valid
    set."""
    m = _as_mask(x, mask)
    zero = _zero(x)
    wz = torch.where(m, w, zero)
    return (wz * torch.where(m, x, zero)).sum(dim=dim, keepdim=keepdim) \
        / wz.sum(dim=dim, keepdim=keepdim)


def winsorize_cs(x, n_std: float = 2.5, dim=-1):
    """Per-cross-section clip at mean +/- n_std * sample std (ddof=1).

    A single-survivor section has NaN sample std, and pandas ``clip``
    ignores NaN thresholds — the value passes through unclipped.
    """
    m = torch.isfinite(x)
    mu = masked_mean(x, m, dim=dim, keepdim=True)
    sd = masked_std(x, m, dim=dim, ddof=1, keepdim=True)
    lo, hi = mu - n_std * sd, mu + n_std * sd
    bounded = torch.isfinite(lo) & torch.isfinite(hi)
    return torch.where(m & bounded, torch.clamp(x, lo, hi), x)


def zscore_cap_weighted(x, cap, mask=None, dim=-1):
    """Barra style standardization: cap-weighted mean, equal-weight std
    (ddof=0)."""
    m = _as_mask(x, mask)
    zero = _zero(x)
    capm = torch.where(m, cap, zero)
    wmu = (capm * torch.where(m, x, zero)).sum(dim=dim, keepdim=True) \
        / capm.sum(dim=dim, keepdim=True)
    sd = masked_std(x, m, dim=dim, ddof=0, keepdim=True)
    return torch.where(m, (x - wmu) / sd, torch.full_like(x, float("nan")))


@highest_matmul_precision
def masked_ols_residuals(y, X, mask=None, *, min_valid: int | None = None):
    """Residuals of OLS y ~ [1, X] over the valid rows of each
    cross-section, batched over leading dimensions (one call for all
    dates).

    y: (..., N); X: (..., N, R), or (..., N) for one regressor; mask:
    (..., N) or None.  Rows invalid in y or any column of X get NaN
    residuals; a section with fewer than ``min_valid`` valid rows (default
    R+2) is all NaN.  Solves the (R+1)x(R+1) normal equations with a
    pseudo-inverse for rank-deficient safety, cutting singular values at
    ``10 * (R+1) * eps * sigma_max`` as ``jnp.linalg.pinv`` does
    (``torch.linalg.pinv``'s default cut is ten times lower).
    """
    if X.dim() == y.dim():
        X = X[..., None]
    N, R = X.shape[-2:]
    m = torch.isfinite(y) & torch.isfinite(X).all(dim=-1)
    if mask is not None:
        m = m & mask
    zero = _zero(y)
    ones = torch.ones(m.shape + (1,), dtype=y.dtype, device=y.device)
    A = torch.cat([ones, torch.where(m[..., None], X, zero)], dim=-1) \
        * m.to(y.dtype)[..., None]
    yz = torch.where(m, y, zero)
    rtol = 10 * (R + 1) * torch.finfo(y.dtype).eps
    coef = torch.linalg.pinv(A.mT @ A, rtol=rtol) @ (A.mT @ yz[..., None])
    resid = yz - (A @ coef)[..., 0]
    thresh = (R + 2) if min_valid is None else min_valid
    ok = m.sum(-1, keepdim=True) >= thresh
    return torch.where(m & ok, resid, float("nan"))
