"""RiskModel — the port's equivalent of the reference's ``MFM`` class
(counterpart of ``mfm_tpu/models/risk_model.py``).

    rm = RiskModel(ret, cap, styles, industry, valid, n_industries=P)
    out = rm.run_fused()    # or stage-by-stage like the reference

Stages, each one batched call over the whole (T, N) panel:
  1. ``reg_by_time``            — constrained WLS of every date (``MFM.py:48-76``)
  2. ``newey_west_by_time``     — expanding EWMA recursion (``MFM.py:80-101``)
  3. ``eigen_risk_adj_by_time`` — batched Monte-Carlo eigen adjustment
                                  (``MFM.py:105-126``)
  4. ``vol_regime_adj_by_time`` — masked EWMA recursion (``MFM.py:130-167``)

The model runs on the CUDA card unless ``device="cpu"`` is given; with no
CUDA device and no explicit CPU request it raises.  On the card the two
Jacobi eigh kernels carry stages 1 and 3; ``kernels=False`` swaps in their
plain PyTorch versions, for comparison only.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from mfm_tpu_torch._device import resolve_device
from mfm_tpu_torch.config import RiskModelConfig
from mfm_tpu_torch.models.eigen import (
    auto_eigen_chunk,
    eigen_risk_adjust_by_time,
    simulated_eigen_covs,
)
from mfm_tpu_torch.models.newey_west import newey_west_expanding
from mfm_tpu_torch.models.vol_regime import vol_regime_adjust_by_time
from mfm_tpu_torch.ops.xreg import regress_panel


class RiskModelOutputs(NamedTuple):
    factor_ret: torch.Tensor     # (T, K) [country | industries | styles]
    specific_ret: torch.Tensor   # (T, N), NaN outside the per-date universe
    r2: torch.Tensor             # (T,)
    nw_cov: torch.Tensor         # (T, K, K)
    nw_valid: torch.Tensor       # (T,)
    eigen_cov: torch.Tensor      # (T, K, K), NaN where invalid
    eigen_valid: torch.Tensor    # (T,)
    vr_cov: torch.Tensor         # (T, K, K)
    lamb: torch.Tensor           # (T,) volatility multiplier series


def _on(x, device, dtype=None) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=device, dtype=dtype)


@dataclasses.dataclass
class RiskModel:
    """Batched Barra-style risk model over a dense masked panel.

    Args mirror the reference's data contract, in dense form (tensors or
    numpy arrays; they are moved to ``device``):

      ret:      (T, N) next-period returns.
      cap:      (T, N) market caps.
      styles:   (T, N, Q) style exposures.
      industry: (T, N) int codes in [0, P), -1/invalid for missing.
      valid:    (T, N) bool universe mask.
      device:   None (the CUDA card) or an explicit device such as "cpu".
      kernels:  False runs the eigh kernels' plain versions on the card.
    """

    ret: torch.Tensor
    cap: torch.Tensor
    styles: torch.Tensor
    industry: torch.Tensor
    valid: torch.Tensor
    n_industries: int
    config: RiskModelConfig = dataclasses.field(default_factory=RiskModelConfig)
    device: str | torch.device | None = None
    kernels: bool = True

    def __post_init__(self):
        self.device = resolve_device(self.device)
        for f in ("ret", "cap", "styles", "industry", "valid"):
            setattr(self, f, _on(getattr(self, f), self.device))
        self.valid = self.valid.to(torch.bool)
        self.T, self.N = self.ret.shape
        self.Q = self.styles.shape[-1]
        self.K = 1 + self.n_industries + self.Q

    # -- stage 1 -----------------------------------------------------------
    def reg_by_time(self):
        res = regress_panel(
            self.ret, self.cap, self.styles, self.industry, self.valid,
            n_industries=self.n_industries, kernels=self.kernels)
        return res.factor_ret, res.specific_ret, res.r2

    # -- stage 2 -----------------------------------------------------------
    def newey_west_by_time(self, factor_ret):
        return newey_west_expanding(
            factor_ret, q=self.config.nw_lags,
            half_life=self.config.nw_half_life, min_valid=self.K,
            method=self.config.nw_method)

    # -- stage 3 -----------------------------------------------------------
    def _sim_covs(self, generator, dtype):
        """(sim_covs, sim_length) drawn from ``generator`` (default: one on
        this model's device seeded with ``config.seed``)."""
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(self.config.seed)
        sim_len = self.config.eigen_sim_length or self.T
        return simulated_eigen_covs(generator, self.K, sim_len,
                                    self.config.eigen_n_sims,
                                    dtype=dtype), sim_len

    def eigen_risk_adj_by_time(self, nw_cov, nw_valid, generator=None,
                               sim_covs=None, sim_length=None):
        # ``sim_length`` lets callers that inject sim_covs declare the draw
        # count behind them, enabling the automatic sweep cap; undeclared
        # (None) means the full sweep count
        if sim_covs is None:
            sim_covs, sim_length = self._sim_covs(generator, nw_cov.dtype)
        sim_covs = _on(sim_covs, self.device, nw_cov.dtype)
        sweeps = self.config.eigen_sim_sweeps
        if sweeps == "auto":
            sweeps = None
        return eigen_risk_adjust_by_time(
            nw_cov, nw_valid, sim_covs, self.config.eigen_scale_coef,
            sim_sweeps=sweeps, sim_length=sim_length,
            chunk=self._resolve_eigen_chunk(sim_covs.shape[0],
                                            nw_cov.element_size()),
            kernels=self.kernels)

    def _resolve_eigen_chunk(self, n_sims: int, itemsize: int) -> int | None:
        """config.eigen_chunk -> a concrete date-chunk size (or None);
        "auto" sizes it from the device's free memory."""
        c = self.config.eigen_chunk
        if c == "auto":
            return auto_eigen_chunk(self.T, n_sims, self.K, itemsize,
                                    device=self.device)
        return c

    # -- stage 4 -----------------------------------------------------------
    def vol_regime_adj_by_time(self, factor_ret, eigen_cov, eigen_valid):
        return vol_regime_adjust_by_time(
            factor_ret, eigen_cov, eigen_valid,
            half_life=self.config.vol_regime_half_life)

    # -- full pipeline ------------------------------------------------------
    def run(self, generator=None, sim_covs=None,
            sim_length=None) -> RiskModelOutputs:
        factor_ret, specific_ret, r2 = self.reg_by_time()
        nw_cov, nw_valid = self.newey_west_by_time(factor_ret)
        eigen_cov, eigen_valid = self.eigen_risk_adj_by_time(
            nw_cov, nw_valid, generator=generator, sim_covs=sim_covs,
            sim_length=sim_length)
        vr_cov, lamb = self.vol_regime_adj_by_time(factor_ret, eigen_cov,
                                                   eigen_valid)
        return RiskModelOutputs(
            factor_ret, specific_ret, r2,
            nw_cov, nw_valid, eigen_cov, eigen_valid, vr_cov, lamb)

    def run_fused(self, generator=None, sim_covs=None,
                  sim_length=None) -> RiskModelOutputs:
        """The whole four-stage pipeline, ``sim_covs`` resolved on the
        device first.  Same outputs as :meth:`run`; the reference fuses the
        stages into one XLA program, which eager PyTorch has no need of."""
        if sim_covs is None:
            sim_covs, sim_length = self._sim_covs(generator, self.ret.dtype)
        return self.run(sim_covs=sim_covs, sim_length=sim_length)
