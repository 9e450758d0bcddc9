"""The comparison that decides ``correct``: the program's answers against
the plain reference's, each number held to its limit.

A cell's limits are data (``limits/<cell>.json``): for each number compared,
the limit and the readings it was set from.  A number at or under its limit
passes; a missing or non-finite number fails.
"""

from __future__ import annotations

import math

import torch

#: the rebuild's outputs compared by value, and its validity masks
RISK_VALUES = ("factor_ret", "specific_ret", "r2", "nw_cov", "eigen_cov",
               "vr_cov", "lamb")
RISK_MASKS = ("nw_valid", "eigen_valid")
ALPHA_KEYS = ("mean_ic", "ic_ir", "mean_rank_ic", "coverage",
              "mean_turnover", "mean_spread")


def max_rel(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """(``max |got - want| / max |want|`` over the entries finite on both
    sides, the count of entries finite on one side only)."""
    got, want = got.double(), want.double().to(got.device)
    fg, fw = torch.isfinite(got), torch.isfinite(want)
    both = fg & fw
    apart = int((fg != fw).sum())
    if not bool(both.any()):
        return 0.0, apart
    scale = float(want[both].abs().max())
    diff = float((got[both] - want[both]).abs().max())
    return (diff / scale if scale > 0 else diff), apart


def date_rel(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Each date's ``max |got - want| / max |want|`` over its (K, K)
    entries, NaN at dates not finite on both sides."""
    got, want = got.double().to(want.device), want.double()
    both = torch.isfinite(got).all(dim=(-2, -1)) & \
        torch.isfinite(want).all(dim=(-2, -1))
    diff = (got - want).abs().amax(dim=(-2, -1))
    scale = want.abs().amax(dim=(-2, -1))
    return torch.where(both, diff / scale, torch.full_like(diff, math.nan))


def _quantiles(x: torch.Tensor, prefix: str, out: dict) -> None:
    """The median and the 90th percentile of ``x`` over its finite
    entries, and the index of its largest, as ``<prefix>_med``,
    ``<prefix>_p90`` and ``<prefix>_worst_date``."""
    fin = torch.isfinite(x)
    vals = x[fin]
    if vals.numel() == 0:
        out[prefix + "_med"] = out[prefix + "_p90"] = math.inf
        out[prefix + "_worst_date"] = -1.0
        return
    out[prefix + "_med"] = float(vals.quantile(0.5))
    out[prefix + "_p90"] = float(vals.quantile(0.9))
    out[prefix + "_worst_date"] = float(
        torch.where(fin, x, torch.full_like(x, -1.0)).argmax())


#: a date whose F0 has its smallest eigenvalue within this share of its
#: largest, in the reference, is one the configured float32 may place on
#: either side of positive semi-definite: the program's Newey-West entries
#: differ from the reference's by up to 4.7e-6 of the largest at all-A and
#: 1.4e-5 at CSI300 (``nw_cov``'s lower readings), rounding spread over
#: the entries, which moves the smallest eigenvalue by about that much.
#: Such dates are the first few past validity; on the others F0's margin
#: is 1e-5 to 3e-3
PSD_MARGIN = 1e-5


def risk_numbers(got: dict, want: dict) -> dict:
    """Each rebuild output's ``max_rel`` against the reference's; for the
    eigen and vol-regime covariances and the multiplier ``lamb`` the
    median and 90th percentile over dates of each date's relative gap; the
    entries finite on one side only (``finite_apart``) and the dates whose
    validity differs (``valid_apart``).  At a date within
    :data:`PSD_MARGIN` of semi-definite either verdict is the configured
    arithmetic's; where the program gave the other one, the program is held
    to the reference's outputs under that verdict
    (``want["with_valid"]``), which the reference works out itself."""
    margin = want["psd_margin"]
    undecided = want["nw_valid"] & (margin.abs() <= PSD_MARGIN)
    gv = got["eigen_valid"].to(undecided.device)
    flip = undecided & (gv != want["eigen_valid"])
    out = {"undecided_dates": float(undecided.sum()),
           "turned_dates": float(flip.sum()),
           "turned_margin": float(margin[flip].abs().max())
           if bool(flip.any()) else 0.0}
    if bool(flip.any()):
        want = {**want, **want["with_valid"](want["eigen_valid"] ^ flip)}
    apart = 0
    for k in RISK_VALUES:
        out[k], n = max_rel(got[k], want[k])
        apart += n
    for k in ("eigen_cov", "vr_cov"):
        _quantiles(date_rel(got[k], want[k]), k, out)
    g, w = got["lamb"].double().to(want["lamb"].device), want["lamb"].double()
    _quantiles((g - w).abs() / w.abs(), "lamb", out)
    valid = want["eigen_valid"]
    out["first_valid_date"] = float(valid.to(torch.int8).argmax()) \
        if bool(valid.any()) else -1.0
    out["finite_apart"] = float(apart)
    out["valid_apart"] = float(sum(
        int((got[k].to(want[k].device) != want[k]).sum()) for k in RISK_MASKS))
    return out


def alpha_numbers(got: dict, want: dict) -> dict:
    """Each summary key's largest ``|got - want|`` over the expressions
    scored, and its median over them as ``<key>_med`` (an expression
    finite on one side only counts as infinite)."""
    out = {}
    for k in ALPHA_KEYS:
        g, w = got[k].double().cpu(), want[k].double().cpu()
        fg, fw = torch.isfinite(g), torch.isfinite(w)
        gap = torch.where(fg & fw, (g - w).abs(), torch.zeros_like(g))
        gap = torch.where(fg != fw, torch.full_like(g, math.inf), gap)
        out[k] = float(gap.max()) if gap.numel() else 0.0
        out[k + "_med"] = float(gap.quantile(0.5)) if gap.numel() else 0.0
    return out


def worst(rows: list) -> dict:
    """The largest reading of each number over several checked answers."""
    return {k: max(r[k] for r in rows) for k in rows[0]}


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) for every number that has a
    limit; a number without a reading, or not finite, fails."""
    checked, ok = {}, True
    for name, lim in limits.items():
        v = numbers.get(name)
        good = v is not None and math.isfinite(v) and v <= lim["limit"]
        ok &= good
        checked[name] = {"value": v, "limit": lim["limit"]}
    return ok, checked
