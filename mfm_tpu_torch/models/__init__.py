"""The risk model: cross-sectional regression entry point and covariance stack
(Newey-West, eigenfactor risk adjustment, volatility-regime adjustment)."""

from mfm_tpu_torch.models.risk_model import portfolio_vol  # noqa: F401
