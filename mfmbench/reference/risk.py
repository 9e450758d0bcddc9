"""The plain reference of a full risk-model rebuild: the four stages of
``Barra-master/mfm/MFM.py`` written out in plain PyTorch from their
definitions, at the precision it is asked for (float64 for the reference,
lower ones for the control).

It takes only what the benchmark made (the panel and the simulated
covariances) and imports nothing of the program:

1. regression (``CrossSection.reg``): styles standardised with cap-weighted
   means and equal-weighted population deviations over the date's universe,
   design [country | industry one-hot | styles], weights sqrt(cap)
   normalised, the last industry eliminated by cap-weighted neutrality, the
   constrained normal equations solved, R^2 = 1 - var(spec) / var(ret);
2. Newey-West (``utils.Newey_West``) of every expanding window, its
   exponential weights, weighted mean, weighted auto-covariances and
   Bartlett weights summed directly over the window, not recursively;
3. eigen adjustment (``utils.eigen_risk_adj``): F0's eigenbasis, each
   simulated covariance G_m = diag(s) C_m diag(s) decomposed to convergence
   (:func:`..linalg.eigh`), the rank-paired bias, scaled, rebuilt;
4. vol regime (``MFM.vol_regime_adj_by_time``): the cross-sectional bias
   statistic and its exponentially weighted mean over the valid dates.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mfmbench.reference.linalg import Precision, eigh


def _blocks(T: int, step: int):
    for a in range(0, T, step):
        yield a, min(T, a + step)


def regression(ret, cap, styles, industry, valid, P: int, prec: Precision,
               block: int = 64) -> tuple:
    """(factor_ret (T, K), specific_ret (T, N) NaN outside the universe,
    r2 (T,)) of the constrained WLS of every date."""
    dt = prec.dtype
    T, N, Q = styles.shape
    K = 1 + P + Q
    outs = []
    for a, b in _blocks(T, block):
        r, c, s = (x[a:b].to(dt) for x in (ret, cap, styles))
        ind = industry[a:b].long()
        v = valid[a:b] & torch.isfinite(r) & torch.isfinite(c) & \
            (ind >= 0) & (ind < P)
        vf = v.to(dt)
        zero = torch.zeros((), dtype=dt, device=r.device)
        capz = torch.where(v, c, zero)
        n = vf.sum(dim=1)
        sv = torch.where(v[..., None], s, zero)
        mu_cap = (capz[..., None] * sv).sum(dim=1) / capz.sum(dim=1)[:, None]
        mu_eq = sv.sum(dim=1) / n[:, None]
        sd = torch.sqrt(torch.where(v[..., None], (s - mu_eq[:, None]) ** 2,
                                    zero).sum(dim=1) / n[:, None])
        z = torch.where(v[..., None], (s - mu_cap[:, None]) / sd[:, None],
                        zero)
        onehot = ((ind[..., None] == torch.arange(P, device=r.device))
                  & v[..., None]).to(dt)
        X = torch.cat([vf[..., None], onehot, z], dim=-1)            # (B,N,K)
        w = torch.sqrt(capz)
        w = w / w.sum(dim=1, keepdim=True)
        ind_cap = (onehot * capz[..., None]).sum(dim=1)              # (B,P)
        R = torch.eye(K, dtype=dt, device=r.device).repeat(b - a, 1, 1)
        R[:, P, :] = 0.0
        R[:, P, 1:1 + P] = -ind_cap / ind_cap[:, -1:]
        R = R[:, :, [k for k in range(K) if k != P]]                 # (B,K,K-1)
        Xr = prec.mm(X, R)
        XtW = Xr.transpose(1, 2) * w[:, None, :]
        G = prec.mm(XtW, Xr)
        omega = prec.mm(R, torch.linalg.solve(G, XtW))               # (B,K,N)
        retz = torch.where(v, r, zero)
        f = prec.mm(omega, retz[..., None])[..., 0]
        spec = retz - prec.mm(X, f[..., None])[..., 0]

        def var(x):
            m = (x * vf).sum(dim=1) / n
            return (torch.where(v, (x - m[:, None]) ** 2, zero)).sum(dim=1) / n

        r2 = 1.0 - var(spec) / var(retz)
        spec = torch.where(v, spec, torch.full_like(spec, math.nan))
        outs.append((f, spec, r2))
    return tuple(torch.cat(parts) for parts in zip(*outs))


def newey_west(factor_ret, q: int, half_life: float, prec: Precision,
               block: int = 128) -> tuple:
    """(covs (T, K, K), valid (T,)): the Newey-West covariance of every
    expanding window of the (T, K) factor returns, by direct sums."""
    x = factor_ret.to(prec.dtype)
    T, K = x.shape
    dev = x.device
    lam = 0.5 ** (1.0 / half_life)
    idx = torch.arange(T, device=dev)
    covs = []
    for a, b in _blocks(T, block):
        t = torch.arange(a, b, device=dev)
        age = (t[:, None] - idx[None, :]).to(prec.dtype)            # (B,T)
        wt = torch.where(age >= 0, lam ** age.clamp_min(0),
                         torch.zeros_like(age))
        wt = wt / wt.sum(dim=1, keepdim=True)
        mu = prec.mm(wt, x)                                          # (B,K)
        d = x[None] - mu[:, None, :]                                 # (B,T,K)
        V = prec.mm((d * wt[..., None]).transpose(1, 2), d)
        for lag in range(1, q + 1):
            # sum_i w_{i+lag} d_i d_{i+lag}'
            Gl = prec.mm((d[:, :T - lag] * wt[:, lag:, None]).transpose(1, 2),
                         d[:, lag:])
            V = V + (1.0 - lag / (1.0 + q)) * (Gl + Gl.transpose(1, 2))
        covs.append(V)
    n = idx + 1
    return torch.cat(covs), (n > q) & (n > K)


def eigen_adjust(nw_cov, nw_valid, sim_covs, scale_coef: float,
                 prec: Precision, block_mats: int = 65536) -> tuple:
    """(adjusted covs (T, K, K) at every date; valid (T,); F0's smallest
    over its largest eigenvalue (T,)): the eigenfactor risk adjustment of every date against the M simulated
    covariances.  A date is valid where Newey-West is and F0 is positive
    semi-definite."""
    dt = prec.dtype
    T, K = nw_cov.shape[0], nw_cov.shape[-1]
    M = sim_covs.shape[0]
    eye = torch.eye(K, dtype=dt, device=nw_cov.device)
    F0 = torch.where(nw_valid[:, None, None], nw_cov.to(dt), eye)
    D0, U0 = eigh(F0)                                                # ascending
    psd = D0[:, 0] >= 0
    s = torch.sqrt(torch.clamp_min(D0, 0.0))
    C = sim_covs.to(dt)
    eps = float(torch.finfo(dt).eps)
    step = max(1, block_mats // M)
    v2 = []
    for a, b in _blocks(T, step):
        G = (s[a:b, None, :, None] * C[None] * s[a:b, None, None, :]
             ).reshape(-1, K, K)
        Dm, Vm = eigh(G)                                             # ascending
        d0 = D0[a:b, None, :].expand(b - a, M, K).reshape(-1, K)
        h = ((Vm * Vm) * d0[:, :, None]).sum(dim=1)                  # sum_k V_ki^2 d0_k
        thr = eps * Dm.abs().amax(dim=-1, keepdim=True)
        deg = Dm.abs() <= thr
        one = torch.ones((), dtype=dt, device=G.device)
        ratio = torch.where(deg, one, h / torch.where(deg, one, Dm))
        v2.append(torch.clamp_min(ratio.reshape(b - a, M, K).mean(dim=1),
                                  0.0))
        del G, Dm, Vm
    v2 = torch.cat(v2)
    v = scale_coef * (torch.sqrt(v2) - 1.0) + 1.0
    out = prec.mm(U0 * (v * v * D0)[:, None, :], U0.transpose(1, 2))
    return out, nw_valid & psd, D0[:, 0] / D0.abs().amax(dim=-1)


def _masked(covs, ok):
    return torch.where(ok[:, None, None], covs,
                       torch.full_like(covs, math.nan))


def vol_regime(factor_ret, covs, valid, half_life: float,
               prec: Precision) -> tuple:
    """(adjusted covs (T, K, K), lamb (T,)): the volatility multiplier of
    every date, the exponentially weighted mean of the squared bias
    statistic over the valid dates so far."""
    dt = prec.dtype
    f = factor_ret.to(dt)
    covs = covs.to(dt)
    var = torch.diagonal(covs, dim1=-2, dim2=-1)
    ok = valid & torch.isfinite(var).all(dim=-1)
    b2 = (f * f / var).mean(dim=-1)
    npdt = np.float64 if dt == torch.float64 else np.float32
    b2 = np.where(ok.cpu().numpy(), b2.cpu().numpy(), 0).astype(npdt)
    okf = ok.cpu().numpy().astype(npdt)
    lam = npdt(0.5 ** (1.0 / half_life))
    num = den = npdt(0.0)
    fvm2 = np.zeros(len(b2), dtype=npdt)
    for i in range(len(b2)):
        num = lam * num + okf[i] * b2[i]
        den = lam * den + okf[i]
        fvm2[i] = num / den if den > 0 else npdt(0.0)
    fv = torch.from_numpy(fvm2).to(device=covs.device, dtype=dt)
    return covs * fv[:, None, None], torch.sqrt(fv)


def rebuild(inputs: dict, ret, sim_covs, risk: dict, P: int,
            precision: str = "float64") -> dict:
    """Every output of a full rebuild of the panel with returns ``ret``,
    under the configuration's ``risk`` parameters; beside them F0's
    ``psd_margin`` at every date and ``with_valid(valid)``, the eigen and
    vol-regime outputs under another validity of the dates."""
    prec = Precision(precision)
    fr, spec, r2 = regression(ret, inputs["cap"], inputs["styles"],
                              inputs["industry"], inputs["valid"], P, prec)
    nw_cov, nw_valid = newey_west(fr, risk["nw_lags"], risk["nw_half_life"],
                                  prec)
    eig_all, eig_valid, margin = eigen_adjust(
        nw_cov, nw_valid, sim_covs, risk["eigen_scale_coef"], prec)

    def with_valid(valid) -> dict:
        cov = _masked(eig_all, valid)
        vr_cov, lamb = vol_regime(fr, cov, valid,
                                  risk["vol_regime_half_life"], prec)
        return {"eigen_cov": cov, "eigen_valid": valid, "vr_cov": vr_cov,
                "lamb": lamb}

    return {"factor_ret": fr, "specific_ret": spec, "r2": r2,
            "nw_cov": nw_cov, "nw_valid": nw_valid, **with_valid(eig_valid),
            "psd_margin": margin, "with_valid": with_valid}
