"""Batch alpha-expression evaluation over dense panels (counterpart of
``mfm_tpu/alpha/``).

Parse candidate expressions into masked panel ops, evaluate them over the
(T, N) panel on the tensors' device, score them (IC / rank-IC / turnover
/ quantile spread) against forward returns, and greedily select the top-k
under a pairwise long-short-PnL correlation cap
(:mod:`mfm_tpu_torch.alpha.select`).  The reference left all of it to
XLA; the port runs it as plain torch ops.
"""

from mfm_tpu_torch.alpha.dsl import (
    AlphaExpr,
    compile_alpha,
    compile_alpha_batch,
    evaluate_alphas,
)
from mfm_tpu_torch.alpha.llm import extract_expressions
from mfm_tpu_torch.alpha.metrics import (
    alpha_summary,
    information_coefficient,
    quantile_spread,
    rank_ic,
    rank_turnover,
)
from mfm_tpu_torch.alpha.select import (
    greedy_select,
    select_alphas,
    series_correlation_matrix,
    signal_series,
)

__all__ = [
    "AlphaExpr",
    "compile_alpha",
    "compile_alpha_batch",
    "evaluate_alphas",
    "extract_expressions",
    "information_coefficient",
    "rank_ic",
    "rank_turnover",
    "quantile_spread",
    "alpha_summary",
    "signal_series",
    "series_correlation_matrix",
    "greedy_select",
    "select_alphas",
]
