"""Alpha -> risk-model integration (counterpart of
``mfm_tpu/alpha/integrate.py``).

A batch of (LLM-)generated alpha expressions is evaluated over the raw
market panel, scored against forward returns, greedily de-correlated
(:mod:`mfm_tpu_torch.alpha.select`), and the survivors become extra
*style columns* of the barra table — so the constrained cross-sectional
regression prices them alongside the classic styles and the covariance
stack forecasts their risk.

Exposure convention: each selected alpha is per-date z-scored over its
valid cross-section and missing values become 0 (= mean exposure), so the
reference's drop-any-NaN row filter (``demo.py:25-27``) never loses rows to
alpha warm-up windows; the regression's own cap-weighted standardization
(``CrossSection.py:12-20``) then rescales like any other style.  On dates
where an alpha is entirely invalid the column is all-zero and the
constrained solve's pseudo-inverse prices it at ~0.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from mfm_tpu_torch._device import on_device, resolve_device
from mfm_tpu_torch.alpha.dsl import compile_alpha, cs_zscore, evaluate_alphas
from mfm_tpu_torch.alpha.metrics import _rowsum, information_coefficient
from mfm_tpu_torch.alpha.select import select_alphas


def alpha_style_columns(
    sources: Sequence[str],
    fields: Mapping[str, object],
    fwd_ret,
    k: int,
    max_corr: float = 0.7,
    device=None,
) -> tuple[list[str], np.ndarray, dict]:
    """Evaluate, select, and standardize alphas into style-column form.

    Args:
      sources: candidate expressions (validated against ``fields``).
      fields: (T, N) panel fields the expressions reference (tensors or
        numpy arrays, moved to ``device`` in their own dtype).
      fwd_ret: (T, N) next-period returns (the barra table's ``ret``).
      k / max_corr: selection budget and pairwise PnL-correlation cap
        (:func:`mfm_tpu_torch.alpha.select.select_alphas`).
      device: where to compute; ``None`` is the CUDA card (raises without
        one), the CPU only when asked for by name.

    Returns ``(names, exposures (T, N, k'), report)`` with k' <= k selected
    columns named ``alpha_01``.. in selection order, exposures z-scored per
    date with NaN -> 0 (float32 numpy), and a JSON-ready report mapping
    each name to its expression and mean IC.
    """
    if not sources:
        raise ValueError("no alpha expressions given")
    for i, src in enumerate(sources, 1):
        expr = compile_alpha(src)  # raises on bad syntax/vocabulary
        missing = [f for f in expr.fields if f not in fields]
        if missing:
            raise ValueError(f"expression {i} references unknown panel "
                             f"field(s) {missing}: {src!r}")
    dev = resolve_device(device)
    fields = {name: on_device(v, dev) for name, v in fields.items()}
    fwd_ret = on_device(fwd_ret, dev)
    alphas = evaluate_alphas(sources, fields)          # (E, T, N)
    # one IC pass serves both the selection scores (select_alphas' default
    # is exactly |mean IC|) and the report
    ic = information_coefficient(alphas, fwd_ret)      # (E, T)
    m = torch.isfinite(ic)
    mean_ic = _rowsum(torch.where(m, ic, 0.0)) / torch.clamp_min(
        m.sum(dim=-1), 1)
    sel = select_alphas(alphas, fwd_ret, k, max_corr=max_corr,
                        scores=torch.abs(mean_ic))
    chosen = sel["indices"]                            # selection order
    if not len(chosen):
        raise ValueError("alpha selection kept no expressions (all scores "
                         "below the floor or pairwise-correlated away)")

    z = cs_zscore(alphas[torch.as_tensor(chosen, device=dev)])  # (k', T, N)
    z = torch.where(torch.isfinite(z), z, 0.0)
    exposures = np.moveaxis(z.to(torch.float32).cpu().numpy(), 0, -1)
    mean_ic = mean_ic.cpu().numpy()

    names = [f"alpha_{i + 1:02d}" for i in range(len(chosen))]
    report = {
        name: {
            "expression": sources[int(e)],
            "mean_ic": float(mean_ic[int(e)]),
            # sel["scores"] is aligned to the selection order
            "score": float(sel["scores"][pos]),
        }
        for pos, (name, e) in enumerate(zip(names, chosen))
    }
    return names, exposures, report
