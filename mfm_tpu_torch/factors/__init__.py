"""The 16 Barra sub-factors, post-processing, and the FactorEngine that
runs them (counterpart of ``mfm_tpu/factors/``)."""

from mfm_tpu_torch.factors.engine import FactorEngine
from mfm_tpu_torch.factors.post import (
    composite_factor,
    orthogonalize,
    winsorize_panel,
)
from mfm_tpu_torch.factors.style import (
    compute_beta_hsigma,
    compute_bp,
    compute_cmra,
    compute_dastd,
    compute_earnings_yield,
    compute_growth,
    compute_leverage,
    compute_liquidity,
    compute_nlsize,
    compute_rstr,
    compute_size,
)

__all__ = [
    "compute_size",
    "compute_beta_hsigma",
    "compute_rstr",
    "compute_dastd",
    "compute_cmra",
    "compute_nlsize",
    "compute_bp",
    "compute_liquidity",
    "compute_earnings_yield",
    "compute_growth",
    "compute_leverage",
    "winsorize_panel",
    "composite_factor",
    "orthogonalize",
    "FactorEngine",
]
