"""Model-health statistics: the eigenfactor and random-portfolio bias
statistics and Bayesian specific-vol shrinkage (counterpart of
``mfm_tpu/models/bias.py``).

- :func:`eigenfactor_bias_stat` — the USE4 acceptance test comparing
  predicted eigen-portfolio volatility to realized returns
  (``Barra-master/mfm/utils.py:97-117``); its eighs run on the port's
  Jacobi route (the full kernel on the card).
- :func:`portfolio_bias_stat` / :func:`bias_std` — the same test on
  arbitrary (random) portfolios.
- :func:`bayes_shrink` — cap-group Bayesian shrinkage of specific
  volatility (``utils.py:133-168``), batched over any leading (date) dims.

- :func:`plot_bias_stats` — the bias-by-rank picture (matplotlib,
  imported only when called).
"""

from __future__ import annotations

import numpy as np
import torch

from mfm_tpu_torch.ops.eigh import batched_eigh
from mfm_tpu_torch.parallel.mesh import replicate_under_mesh
from mfm_tpu_torch.utils.prec import highest_matmul_precision


@highest_matmul_precision
def eigenfactor_bias_stat(covs: torch.Tensor, valid: torch.Tensor,
                          factor_ret: torch.Tensor,
                          predlen: int = 1) -> torch.Tensor:
    """Bias statistic of the eigenfactor portfolios.

    For each date i, eigendecompose cov_i, normalize each eigenvector to
    sum 1 (portfolio weights), predicted vol
    ``sigma = sqrt(predlen * diag(U' cov U))``, realized return over the
    next ``predlen`` dates compounded, ``b_i = U' r / sigma``; the
    statistic is the per-factor population std of b over the valid dates
    (the reference skips dates with invalid covariances).  Returns (K,).

    The eighs are ``batched_eigh(sort=True, canonical_signs=False)``: the
    sum-normalisation ``U / sum(U)`` cancels each eigenvector's sign.
    """
    T, K = factor_ret.shape
    dtype, dev = factor_ret.dtype, factor_ret.device
    eye = torch.eye(K, dtype=dtype, device=dev)
    safe = torch.where(valid[:, None, None], covs, eye)[: T - predlen]

    # compounded realized returns over (i, i+predlen] from cumsums of log1p
    cs = torch.cumsum(torch.log1p(factor_ret), dim=0)
    cs = torch.cat([torch.zeros((1, K), dtype=dtype, device=dev), cs])
    retlen = torch.expm1(cs[predlen:] - cs[:-predlen])[1:]  # (T-predlen, K)

    _, U = batched_eigh(safe, sort=True, canonical_signs=False)
    U = U / U.sum(dim=-2, keepdim=True)
    sigma = torch.sqrt(predlen * ((safe @ U) * U).sum(dim=-2))
    b = (U * retlen[:, :, None]).sum(dim=-2) / sigma  # (T-predlen, K)
    m = valid[: T - predlen, None]
    n = m.sum()
    zero = torch.zeros((), dtype=dtype, device=dev)
    mu = torch.where(m, b, zero).sum(dim=0) / n
    var = torch.where(m, (b - mu) ** 2, zero).sum(dim=0) / n
    return torch.sqrt(var)


def bias_stats_summary(nw_cov, nw_valid, eigen_cov, eigen_valid, factor_ret,
                       burn_in: int = 252) -> dict:
    """JSON-ready USE4 acceptance summary: bias statistics per eigenfactor
    rank before (Newey-West) and after the eigen adjustment, over all valid
    dates and, when any exist, excluding the expanding-window burn-in.
    Non-finite ranks become ``None`` and are left out of the aggregates.
    """
    scopes = [("all_valid_dates", {
        "newey_west": eigenfactor_bias_stat(nw_cov, nw_valid, factor_ret),
        "eigen_adjusted": eigenfactor_bias_stat(eigen_cov, eigen_valid,
                                                factor_ret),
    })]
    if bool(nw_valid[burn_in:].any()):
        t_ok = torch.arange(factor_ret.shape[0],
                            device=factor_ret.device) >= burn_in
        scopes.append((f"after_burn_in_{burn_in}", {
            "newey_west": eigenfactor_bias_stat(nw_cov, nw_valid & t_ok,
                                                factor_ret),
            "eigen_adjusted": eigenfactor_bias_stat(
                eigen_cov, eigen_valid & t_ok, factor_ret),
        }))

    def _num(x):
        return round(float(x), 4) if np.isfinite(x) else None

    out: dict = {}
    for scope, stats in scopes:
        out[scope] = {}
        for label, b in stats.items():
            b = b.cpu().numpy()
            dev = np.abs(b[np.isfinite(b)] - 1)
            out[scope][label] = {
                "bias": [_num(x) for x in b],
                "mean_abs_dev_from_1": _num(np.mean(dev)) if dev.size else None,
                "max_abs_dev_from_1": _num(np.max(dev)) if dev.size else None,
            }
    return out


def plot_bias_stats(bias_by_label: dict, path: str) -> None:
    """Plot eigenfactor bias statistics per eigen-portfolio rank.

    Renders any number of labelled bias arrays (e.g. ``{"newey_west": b0,
    "eigen_adjusted": b1}``) to ``path``, through an explicit Agg canvas so
    the process-global matplotlib backend is left untouched.
    """
    from matplotlib.backends.backend_agg import FigureCanvasAgg
    from matplotlib.figure import Figure

    fig = Figure(figsize=(7, 4))
    FigureCanvasAgg(fig)
    ax = fig.add_subplot()
    for label, b in bias_by_label.items():
        b = np.asarray(b)
        ax.plot(1 + np.arange(b.shape[0]), b, marker="o", ms=3, lw=1,
                label=label)
    ax.axhline(1.0, color="gray", lw=0.8, ls="--")
    ax.set_xlabel("eigenfactor rank")
    ax.set_ylabel("bias statistic")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)


@highest_matmul_precision
def portfolio_bias_stat(X, design_valid, covs, cov_valid, spec_vol, ret,
                        weights):
    """Bias statistic of arbitrary test portfolios (the USE4 acceptance test
    in its random-portfolio form).

    For each base portfolio q and date t: weights are the q-th base vector
    restricted to date t's support (regression universe with a specific-vol
    estimate) and renormalized to sum 1; predicted variance is
    ``x'F_t x + sum_i w_i^2 sigma_i^2`` with ``x = X_t' w``; the realized
    return is the t+1-labelled return ``ret[t+1]`` of the held stocks (a
    holding with no t+1 observation contributes 0).

    Args: ``X`` (T, N, K) per-date regression designs; ``design_valid``
    (T, N); ``covs`` (T, K, K); ``cov_valid`` (T,); ``spec_vol`` (T, N)
    (NaN = no estimate); ``ret`` (T, N); ``weights`` (Q, N) nonnegative.
    Returns ``(z (Q, T-1), mask (Q, T-1))``; :func:`bias_std` takes the std
    under any date mask.  Date-sharded inputs (``parallel/mesh.py``) are
    gathered first: the realized leg reads each date's next date, across
    a shard boundary.
    """
    X, design_valid, covs, cov_valid, spec_vol, ret = replicate_under_mesh(
        (X, design_valid, covs, cov_valid, spec_vol, ret))
    dtype, dev = X.dtype, X.device
    K = X.shape[-1]
    zero = torch.zeros((), dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)
    support = design_valid & torch.isfinite(spec_vol)
    sf = support.to(dtype)
    s = weights @ sf.T                                          # (Q, T)
    s_safe = torch.where(s > 0, s, one)

    Xs = torch.where(support[..., None], X, zero)
    x = torch.einsum("tnk,qn->qtk", Xs, weights) / s_safe[..., None]
    covs_safe = torch.where(cov_valid[:, None, None], covs,
                            torch.eye(K, dtype=dtype, device=dev))
    fvar = (torch.einsum("qtk,tkl->qtl", x, covs_safe) * x).sum(dim=-1)
    sv = torch.where(support, spec_vol, zero)
    svar = ((weights * weights) @ (sv * sv).T) / (s_safe ** 2)
    sigma = torch.sqrt(fvar + svar)                             # (Q, T)

    # realized at formation date t: the held stocks' t+1-labelled returns
    # with the formation date's weights; rank-1 in q, so no (Q, T, N)
    ret0 = torch.where(torch.isfinite(ret), ret, zero)
    r = (weights @ (sf[:-1] * ret0[1:]).T) / s_safe[:, :-1]

    sig = sigma[:, :-1]
    ok = (cov_valid[:-1][None, :] & (s[:, :-1] > 0) & (sig > 0)
          & torch.isfinite(sig))
    z = torch.where(ok, r / torch.where(ok, sig, one),
                    torch.full_like(r, float("nan")))
    return z, ok


def bias_std(z: torch.Tensor, mask: torch.Tensor, dim: int = -1):
    """Population std over masked entries (``np.std`` semantics; NaN where
    fewer than 2 are valid)."""
    m = mask & torch.isfinite(z)
    n = m.sum(dim=dim)
    zero = torch.zeros((), dtype=z.dtype, device=z.device)
    zz = torch.where(m, z, zero)
    mu = zz.sum(dim=dim) / torch.clamp_min(n, 1)
    var = torch.where(m, (z - mu.unsqueeze(dim)) ** 2, zero).sum(dim=dim) \
        / torch.clamp_min(n, 1)
    return torch.where(n >= 2, torch.sqrt(var),
                       torch.full_like(var, float("nan")))


def _group_edges(capital, n, ngroup: int):
    """The ``ngroup - 1`` inner quantile edges of ``capital`` (..., N) over
    its ``n`` (..., 1) smallest entries, by the reference's linear
    interpolation: positions ``q (n - 1)`` in float64 from numpy's
    ``linspace`` (``jnp.linspace``'s values; ``torch.linspace`` rounds some
    differently, and an edge one ulp off can move a stock across a group),
    ``s[lo] (1 - frac) + s[hi] frac``."""
    N = capital.shape[-1]
    lin = torch.as_tensor(np.linspace(0.0, 1.0, ngroup + 1)[1:-1],
                          dtype=torch.float64, device=capital.device)
    pos = (lin * (n - 1)).expand(capital.shape[:-1] + lin.shape)
    lo = torch.clamp(torch.floor(pos), 0, N - 1).long()
    hi = torch.clamp(torch.ceil(pos), 0, N - 1).long()
    frac = (pos - lo).to(capital.dtype)
    s = torch.sort(capital, dim=-1).values
    return (torch.gather(s, -1, lo) * (1.0 - frac)
            + torch.gather(s, -1, hi) * frac)


@highest_matmul_precision
def bayes_shrink(volatility: torch.Tensor, capital: torch.Tensor,
                 ngroup: int = 10, q: float = 1.0, mask=None) -> torch.Tensor:
    """Bayesian shrinkage of specific volatility toward cap-group means.

    Stocks are bucketed into ``ngroup`` cap quantile groups; each group has
    cap-weighted mean vol m_g and equal-weight dispersion
    s_g = sqrt(mean((vol - m_g)^2)); the shrinkage intensity is
    ``v = q|vol - m_g| / (q|vol - m_g| + s_g)`` and the estimate
    ``v m_g + (1-v)|vol|``.  The stock axis is the last; any leading dims
    (dates) are a batch, run at once.

    ``mask`` (bool, like ``volatility``) restricts the universe: quantile
    edges, group means and dispersions are computed over masked-in stocks
    only, and masked-out entries return NaN.  Where the reference would
    give 0/0 (a singleton group, zero dispersion at the group mean) the
    intensity is 0, and empty groups (N < ngroup) contribute nothing.
    """
    dtype, dev = volatility.dtype, volatility.device
    N = capital.shape[-1]
    zero = torch.zeros((), dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)
    if mask is None:
        qs = _group_edges(capital, N, ngroup)
        # like jnp.quantile: a NaN anywhere makes every edge NaN
        qs = torch.where(torch.isnan(capital).any(dim=-1, keepdim=True),
                         torch.full_like(qs, float("nan")), qs)
        mf = torch.ones_like(volatility)
    else:
        # masked-out NaN vol/cap must not reach the one-hot sums (0 * NaN)
        volatility = torch.where(mask, volatility, zero)
        capital = torch.where(mask, capital, one)
        mf = mask.to(dtype)
        qs = _group_edges(torch.where(mask, capital, float("inf")),
                          mask.sum(dim=-1, keepdim=True), ngroup)
    group = torch.searchsorted(qs.contiguous(), capital.contiguous(),
                               right=False)  # jnp side="left"
    codes = torch.arange(ngroup, device=dev)
    oh = (group[..., None] == codes).to(dtype) * mf[..., None]  # (..., N, G)
    cap_g = (oh * capital[..., None]).sum(dim=-2)
    cnt_g = oh.sum(dim=-2)
    # an empty group's mean is 0, not NaN: 0 * NaN would reach every stock
    m_g = torch.where(cnt_g > 0,
                      (oh * (volatility * capital)[..., None]).sum(dim=-2)
                      / torch.where(cap_g > 0, cap_g, one), zero)
    dev2 = (volatility[..., None] - m_g[..., None, :]) ** 2 * oh
    s_g = torch.where(cnt_g > 0,
                      torch.sqrt(dev2.sum(dim=-2)
                                 / torch.where(cnt_g > 0, cnt_g, one)), zero)
    m_s = (oh * m_g[..., None, :]).sum(dim=-1)
    s_s = (oh * s_g[..., None, :]).sum(dim=-1)
    a = q * torch.abs(volatility - m_s)
    pos = a + s_s > 0
    v = torch.where(pos, a / torch.where(pos, a + s_s, one), zero)
    out = v * m_s + (1.0 - v) * torch.abs(volatility)
    if mask is not None:
        out = torch.where(mask, out, torch.full_like(out, float("nan")))
    return out
