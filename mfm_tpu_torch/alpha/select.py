"""Alpha selection: greedy top-k under a pairwise-correlation cap
(counterpart of ``mfm_tpu/alpha/select.py``).

After :func:`~mfm_tpu_torch.alpha.dsl.compile_alpha_batch` scores a
candidate batch (LLM-generated or otherwise), pick the k best expressions
whose strategy PnL is not just a re-discovery of one another — the
standard industrial acceptance rule ("PnL correlation with existing alphas
< 0.7").

Correlation is measured between per-date signal series (the top-minus-
bottom quantile spread — a long-short PnL — or the IC series), with
pairwise-valid date masks, exactly matching ``pandas.DataFrame.corr`` with
``min_periods``.  Everything pairwise is (E, T) matrix products in full
float32 (TF32 off) on the card; the greedy pass itself is tiny and
host-side numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from mfm_tpu_torch.alpha.metrics import (
    _rowsum,
    information_coefficient,
    quantile_spread,
)
from mfm_tpu_torch.utils.prec import highest_matmul_precision


def signal_series(alphas: torch.Tensor, fwd_ret: torch.Tensor,
                  kind: str = "spread", q: float = 0.2) -> torch.Tensor:
    """Per-expression per-date signal series, shape (E, T).

    ``kind="spread"``: top-minus-bottom ``q``-quantile forward return (a
    daily long-short PnL — the series whose correlation defines alpha
    redundancy).  ``kind="ic"``: the per-date information coefficient.
    """
    if kind == "spread":
        return quantile_spread(alphas, fwd_ret, q)
    if kind == "ic":
        return information_coefficient(alphas, fwd_ret)
    raise ValueError(f"unknown signal kind {kind!r} (want 'spread' or 'ic')")


@highest_matmul_precision
def series_correlation_matrix(series: torch.Tensor,
                              min_periods: int = 3) -> torch.Tensor:
    """Pairwise Pearson correlation of (E, T) series with NaN handling.

    Entry (i, j) is the correlation over the dates where BOTH series are
    finite (``pandas.DataFrame.corr(min_periods=...)`` semantics — the
    pairwise means/variances are computed over the joint-valid dates, not
    each series' own).  Pairs with fewer than ``min_periods`` joint dates
    are NaN.  All pairwise sums are (E, T) @ (T, E) products.
    """
    m = torch.isfinite(series)
    x = torch.where(m, series, 0.0)
    mf = m.to(x.dtype)
    n = mf @ mf.T                      # joint-valid date counts
    sxy = x @ x.T                      # Σ x_i x_j over joint dates
    sx = x @ mf.T                      # Σ x_i over dates where j also valid
    sxx = (x * x) @ mf.T               # Σ x_i² over joint dates
    nn = torch.where(n > 0, n, 1.0)
    cov = sxy - sx * sx.T / nn
    var_i = sxx - sx * sx / nn
    var_j = var_i.T
    corr = cov / torch.sqrt(var_i * var_j)
    return torch.where(n >= min_periods, corr, float("nan"))


def greedy_select(scores: np.ndarray, corr: np.ndarray, k: int,
                  max_corr: float = 0.7, min_score: float = 0.0) -> dict:
    """Greedy pick of ``k`` indices by descending score under the cap.

    Walks candidates from best score down; a candidate joins the selection
    iff its |corr| to every already-selected index is ≤ ``max_corr``.  An
    undefined correlation (NaN — too few joint-valid dates) does not block:
    there is no evidence of redundancy.  Candidates with NaN score or score
    < ``min_score`` never join.  Returns ``indices`` (selection order),
    ``scores`` and ``max_corr_to_selected`` aligned to it, and ``rejected``
    — {index: blocking index} for candidates that hit the cap.
    """
    scores = np.asarray(scores, np.float64)
    corr = np.asarray(corr, np.float64)
    order = np.argsort(-np.where(np.isfinite(scores), scores, -np.inf),
                       kind="stable")
    chosen: list[int] = []
    max_c: list[float] = []
    rejected: dict[int, int] = {}
    for i in order:
        i = int(i)
        if len(chosen) >= k:
            break
        if not np.isfinite(scores[i]) or scores[i] < min_score:
            continue
        cs = np.abs(corr[i, chosen]) if chosen else np.empty(0)
        over = np.nonzero(np.isfinite(cs) & (cs > max_corr))[0]
        if over.size:
            rejected[i] = chosen[int(over[0])]
            continue
        finite = cs[np.isfinite(cs)]
        max_c.append(float(finite.max()) if finite.size else np.nan)
        chosen.append(i)
    return {"indices": chosen,
            "scores": [float(scores[i]) for i in chosen],
            "max_corr_to_selected": max_c,
            "rejected": rejected}


def _to_numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def select_alphas(alphas: torch.Tensor, fwd_ret: torch.Tensor, k: int,
                  max_corr: float = 0.7, scores=None, min_score: float = 0.0,
                  kind: str = "spread", q: float = 0.2,
                  min_periods: int = 3) -> dict:
    """Score → correlate → greedily select from an (E, T, N) alpha batch.

    ``scores``: per-expression ranking (default |mean IC| — candidates are
    sign-ambiguous, so magnitude ranks; pass your own, e.g. ``ic_ir`` from
    :func:`mfm_tpu_torch.alpha.metrics.alpha_summary`, to rank
    differently).  Returns the :func:`greedy_select` dict plus the (E, E)
    ``corr`` matrix (host numpy) for reporting.
    """
    series = signal_series(alphas, fwd_ret, kind=kind, q=q)
    if scores is None:
        ic = information_coefficient(alphas, fwd_ret)
        m = torch.isfinite(ic)
        scores = torch.abs(_rowsum(torch.where(m, ic, 0.0)) / m.sum(dim=-1))
    corr = _to_numpy(series_correlation_matrix(series, min_periods))
    out = greedy_select(_to_numpy(scores), corr, k,
                        max_corr=max_corr, min_score=min_score)
    out["corr"] = corr
    return out
