"""Batched constrained cross-sectional WLS (counterpart of
``mfm_tpu/ops/xreg.py``).

The reference's per-date ``CrossSection.reg()`` as one masked computation
over the whole (T, N) panel — the JAX package's ``vmap`` over dates is a
leading T axis written out here:

- style standardization: cap-weighted mean, equal-weight population std
- design X = [country=1 | industry one-hot | standardized styles]
- WLS weights W = sqrt(cap)/sum(sqrt(cap))
- industry-neutrality constraint R eliminating the LAST industry with
  cap-weight ratios
- pure-factor-portfolio weights Omega = R pinv(Xr' W Xr) Xr' W
- factor returns, specific returns, exposure check,
  R^2 = 1 - var(spec)/var(ret)

The per-date pseudo-inverse is hoisted into ONE batched
:func:`~mfm_tpu_torch.ops.eigh.pinv_psd` over all T normal matrices — the
Jacobi eigh kernel on the card.

Every sum over the stocks runs over the innermost, contiguous dimension,
so that a date's numbers do not depend on how many dates share the call
(from 16 dates on; ``RiskModel`` pads a shorter slab) and a daily update
is bitwise the suffix of a full-history run.  On the card a batched
matrix-vector product (cuBLAS) and a reduction over an outer dimension
both change their summation order with the batch size; matrix-matrix
products and contiguous innermost reductions over 16 or more rows do
not (``chip_smoke.py``, phase ``serve_bitwise_ops``).  The CPU's batched
matrix-matrix product does: MKL gives a matrix at an odd position in the
batch other bits than the same matrix at position 0, so on the CPU the
normal matrices are sums of elementwise products too (:func:`_gram`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mfm_tpu_torch.ops.eigh import _bt, pinv_psd
from mfm_tpu_torch.ops.masked import masked_var, zscore_cap_weighted
from mfm_tpu_torch.utils.prec import highest_matmul_precision


def _rowdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum(a * b) over the last dimension — a batched matrix-vector
    product as an elementwise product and a contiguous innermost sum,
    whose per-row order does not depend on the number of rows."""
    return (a * b).sum(dim=-1)


def _gram(XtW: torch.Tensor, Xr: torch.Tensor) -> torch.Tensor:
    """The normal matrices ``XtW @ Xr`` for (T, k, N) and (T, N, k)
    operands, each keeping its bits at any number of dates and any
    position among them.  On the card the batched matrix product does
    (``chip_smoke.py``, phase ``serve_bitwise_ops``); on the CPU it does
    not, and the per-lane sums of :func:`~mfm_tpu_torch.ops.eigh._bt`
    take its place."""
    if XtW.is_cuda:
        return XtW @ Xr
    return _bt(XtW.contiguous(), Xr.transpose(-1, -2).contiguous())


class CrossSectionResult(NamedTuple):
    factor_ret: torch.Tensor  # (T, K) pure factor returns [country, P industries, Q styles]
    specific_ret: torch.Tensor  # (T, N) NaN outside the valid universe
    r2: torch.Tensor  # (T,)
    exposure: torch.Tensor | None = None  # (T, K, K) pure-factor portfolio exposures


def _constraint_matrix(ind_cap: torch.Tensor, Q: int) -> torch.Tensor:
    """Industry-neutrality constraint R of shape (..., K, K-1), K = 1 + P + Q,
    for per-industry total caps ``ind_cap`` (..., P).

    In the reduced basis the last industry's exposure is expressed through
    the other industries' cap weights: row ``P`` becomes
    ``-ind_cap_i / ind_cap_P`` over industry columns, and the last
    industry's own column is removed.
    """
    P = ind_cap.shape[-1]
    K = 1 + P + Q
    batch = ind_cap.shape[:-1]
    R = torch.eye(K, dtype=ind_cap.dtype, device=ind_cap.device)
    R = R.expand(batch + (K, K)).clone()
    R[..., P, :] = 0.0
    R[..., P, 1:1 + P] = -ind_cap / ind_cap[..., -1:]
    keep = [k for k in range(K) if k != P]
    return R[..., keep]


@highest_matmul_precision
def regression_design(ret, cap, styles, industry, valid, *, n_industries: int,
                      standardize_styles: bool = True):
    """The dates' regression design in its exact estimation basis.

    ret/cap/industry/valid: (T, N); styles: (T, N, Q).  Returns
    (X (T, N, K), valid (T, N), capz (T, N)): the masked country column,
    industry one-hot, cap-weighted-standardized styles — with the
    regression's own universe narrowing (finite ret/cap, industry in
    [0, P)).
    """
    dtype = styles.dtype
    P = n_industries
    valid = valid & torch.isfinite(ret) & torch.isfinite(cap)
    if P:
        valid = valid & (industry >= 0) & (industry < P)
    vf = valid.to(dtype)
    zero = torch.zeros((), dtype=dtype, device=styles.device)

    if standardize_styles:
        # stocks innermost: the z-score's sums over N are contiguous
        s = zscore_cap_weighted(styles.transpose(-1, -2).contiguous(),
                                cap[..., None, :], valid[..., None, :],
                                dim=-1).transpose(-1, -2)
    else:
        s = styles
    s = torch.where(valid[..., None], s, zero)
    capz = torch.where(valid, cap, zero)
    country = vf[..., None]
    if P:
        codes = torch.arange(P, dtype=industry.dtype, device=industry.device)
        ind_oh = (industry[..., None] == codes).to(dtype) * vf[..., None]
        X = torch.cat([country, ind_oh, s], dim=-1)
    else:
        X = torch.cat([country, s], dim=-1)
    return X, valid, capz


class _NormalEq(NamedTuple):
    X: torch.Tensor        # (T, N, K) design in estimation basis
    retz: torch.Tensor     # (T, N) returns, zeroed outside the universe
    valid: torch.Tensor    # (T, N) the regression's own universe
    R: torch.Tensor | None  # (T, K, K-1) constraint, None when P == 0
    XtW: torch.Tensor      # (T, K-1, N) (or (T, K, N) when P == 0)
    G: torch.Tensor        # (T, K-1, K-1) constrained normal matrix


@highest_matmul_precision
def _normal_equations(ret, cap, styles, industry, valid, *, n_industries,
                      standardize_styles) -> _NormalEq:
    """Design + constrained normal equations of every date (everything
    before the pseudo-inverse)."""
    P = n_industries
    Q = styles.shape[-1]
    X, valid, capz = regression_design(
        ret, cap, styles, industry, valid, n_industries=P,
        standardize_styles=standardize_styles)
    w = torch.sqrt(capz)
    w = w / w.sum(dim=-1, keepdim=True)

    if P:
        ind_oh = X[..., 1:1 + P].transpose(-1, -2).contiguous()  # (T, P, N)
        ind_cap = _rowdot(ind_oh, capz[..., None, :])
        R = _constraint_matrix(ind_cap, Q)  # (T, K, K-1)
        Xr = X @ R  # (T, N, K-1)
    else:
        R = None
        Xr = X
    XtW = Xr.transpose(-1, -2) * w[..., None, :]
    G = _gram(XtW, Xr)
    zero = torch.zeros((), dtype=ret.dtype, device=ret.device)
    return _NormalEq(X, torch.where(valid, ret, zero), valid, R, XtW, G)


@highest_matmul_precision
def _solve_from_normal(normal: _NormalEq, Ginv: torch.Tensor, *,
                       return_exposure: bool) -> CrossSectionResult:
    """Second half of the regression given ``Ginv = pinv(G)``."""
    X, retz, valid, R, XtW, _ = normal
    omega = Ginv @ XtW if R is None else R @ (Ginv @ XtW)  # (T, K, N)
    factor_ret = _rowdot(omega, retz[..., None, :])  # (T, K)
    spec = retz - _rowdot(X, factor_ret[..., None, :])
    # equal-weight population variance over the date's universe; R^2 is
    # 1 minus a ratio near 1 where the factors explain little (~K/N of
    # noise returns: 0.8% at all-A width), so at float32 the two
    # variances and the ratio are taken in float64, and only R^2 rounded
    hi = torch.promote_types(spec.dtype, torch.float64)
    r2 = (1.0 - masked_var(spec.to(hi), valid, dim=-1, ddof=0) / masked_var(
        retz.to(hi), valid, dim=-1, ddof=0)).to(spec.dtype)
    spec = torch.where(valid, spec, torch.full_like(spec, float("nan")))
    exposure = (omega @ X) if return_exposure else None
    return CrossSectionResult(factor_ret, spec, r2, exposure)


@highest_matmul_precision
def cross_section_regress(ret, cap, styles, industry, valid, *,
                          n_industries: int,
                          standardize_styles: bool = True,
                          return_exposure: bool = False) -> CrossSectionResult:
    """One date's constrained WLS pure-factor regression, masked: ret/cap/
    industry/valid (N,), styles (N, Q); the results without the date axis.
    Industry codes outside [0, P) are invalid; P=0 runs the no-industry
    branch.  It is :func:`regress_panel` over a panel of one date."""
    res = regress_panel(ret[None], cap[None], styles[None], industry[None],
                        valid[None], n_industries=n_industries,
                        standardize_styles=standardize_styles,
                        return_exposure=return_exposure)
    return CrossSectionResult(*(None if x is None else x[0] for x in res))


@highest_matmul_precision
def regress_panel(ret, cap, styles, industry, valid, *, n_industries: int,
                  standardize_styles: bool = True,
                  return_exposure: bool = False,
                  kernels: bool = True) -> CrossSectionResult:
    """Constrained WLS pure-factor regression of every date of the panel.

    ret/cap: (T, N); styles: (T, N, Q); industry: (T, N) int; valid: (T, N)
    bool.  P=0 (``n_industries=0``) runs the no-industry branch.  All T
    normal matrices are pseudo-inverted in one batched eigh.
    """
    normal = _normal_equations(
        ret, cap, styles, industry, valid, n_industries=n_industries,
        standardize_styles=standardize_styles)
    Ginv = pinv_psd(normal.G, kernels=kernels)
    return _solve_from_normal(normal, Ginv, return_exposure=return_exposure)
