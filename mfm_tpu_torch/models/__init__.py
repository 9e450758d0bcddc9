"""The risk model: cross-sectional regression entry point and covariance stack
(Newey-West, eigenfactor risk adjustment, volatility-regime adjustment)."""
