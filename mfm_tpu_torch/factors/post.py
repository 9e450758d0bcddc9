"""Factor post-processing: winsorize, composite aggregation,
orthogonalization (counterpart of ``mfm_tpu/factors/post.py``).

Contracts: ``Barra_factor_cal/post_processing.py``.  Every op is a
per-date cross-section, batched over all the dates of the (T, N) panel.
"""

from __future__ import annotations

from typing import Sequence

import torch

from mfm_tpu_torch.ops.masked import masked_ols_residuals, winsorize_cs


def winsorize_panel(x: torch.Tensor, n_std: float = 2.5) -> torch.Tensor:
    """Per-date clip at mean +/- n_std * sample std (ddof=1), NaN passing
    through (``post_processing.py:7-24``).  x: (T, N)."""
    return winsorize_cs(x, n_std=n_std, dim=-1)


def composite_factor(components: Sequence[torch.Tensor],
                     weights: Sequence[float]) -> torch.Tensor:
    """Missing-aware weighted average: the weights renormalize over the
    components present in each cell; none present -> NaN
    (``post_processing.py:26-45``)."""
    num = torch.zeros_like(components[0])
    den = torch.zeros_like(components[0])
    for comp, w in zip(components, weights):
        ok = torch.isfinite(comp)
        num = num + torch.where(ok, comp, 0.0) * w
        den = den + ok.to(den.dtype) * w
    return num / den


def orthogonalize(target: torch.Tensor,
                  regressors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-date OLS residual of target on [1, regressors...], one batched
    regression over the dates; a date with fewer than len(regressors)+2
    valid rows is all NaN (``post_processing.py:47-69``).  (T, N) each."""
    X = torch.stack(list(regressors), dim=-1)  # (T, N, R)
    return masked_ols_residuals(target, X, min_valid=X.shape[-1] + 2)


def apply_post_processing(factors: dict, composite_config: Sequence[tuple],
                          ortho_rules: Sequence[tuple], n_std: float = 2.5,
                          winsorize_cols: Sequence[str] | None = None
                          ) -> dict:
    """The whole post-processing stage: winsorize every sub-factor, build
    the composites, then orthogonalize (order of
    ``Barra_factor_cal/main.py:72-86``).  ``composite_config``: (name,
    components, weights) triples; ``ortho_rules``: (target, regressors)
    pairs, as in :class:`mfm_tpu_torch.config.FactorConfig`."""
    out = dict(factors)
    cols = winsorize_cols if winsorize_cols is not None else list(out)
    for name in cols:
        out[name] = winsorize_panel(out[name], n_std=n_std)
    for new_name, comps, weights in composite_config:
        present = [(c, w) for c, w in zip(comps, weights) if c in out]
        out[new_name] = composite_factor([out[c] for c, _ in present],
                                         [w for _, w in present])
    for target, regs in ortho_rules:
        out[target] = orthogonalize(out[target], [out[r] for r in regs])
    return out
