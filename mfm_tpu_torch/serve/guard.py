"""Per-date input guards for the daily serving loop (counterpart of
``mfm_tpu/serve/guard.py``).

One bad date — a NaN-poisoned slab, a feed that lost half the universe, a
split-adjustment bug spraying 10-MAD returns — would corrupt every later
covariance once it entered the Newey-West / vol-regime carries.
:func:`guard_slab` gives each appended date a reason bitmask and a
quarantine verdict on the device, and keeps a ring of healthy-universe
sizes so the collapse check compares against a trailing median.  A
quarantined date does not enter the ring, so a collapse cannot drag its
own reference down.

The checks that read one date alone (NaN density, MAD outliers, cap
positivity) run over the whole slab at once; the collapse check depends
on the ring the earlier dates left, so it runs date by date.  The one check
that cannot run on tensors — non-monotone or duplicate dates — runs on the
host (:func:`host_date_reasons`) and feeds in through ``pre_reasons``.

Reasons are int32 in the port (every bit is below 2**6); their values are
the reference's uint32 masks.  The reference's standalone screen
``guard_slab_jit`` is :func:`guard_slab` itself here.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mfm_tpu_torch.serve._checks import (
    combine_reason_bits,
    mad_outlier_cells,
    names_of_mask,
    nanmedian,
)

REASON_NAN_DENSITY = 1        # non-finite ret fraction inside the universe
REASON_UNIVERSE_COLLAPSE = 2  # valid count << trailing-median universe
REASON_RET_OUTLIER = 4        # too many |ret - median| > mad_k * MAD cells
REASON_CAP_NONPOS = 8         # non-positive / non-finite cap in universe
REASON_DATE_ORDER = 16        # host-side: non-monotone or duplicate date
REASON_FORCED = 32            # host-side: verdict forced by a counterfactual

_REASON_NAMES = (
    (REASON_NAN_DENSITY, "nan_density"),
    (REASON_UNIVERSE_COLLAPSE, "universe_collapse"),
    (REASON_RET_OUTLIER, "ret_outlier"),
    (REASON_CAP_NONPOS, "cap_nonpos"),
    (REASON_DATE_ORDER, "date_order"),
    (REASON_FORCED, "forced"),
)


def reason_names(mask: int) -> list[str]:
    """Human-readable names of the bits set in a reason mask."""
    return names_of_mask(mask, _REASON_NAMES)


class GuardReport(NamedTuple):
    """Per-date verdicts of one guarded update.

    ``served_cov[t]`` is the covariance to hand out at date t: ``vr_cov[t]``
    bitwise-untouched at healthy dates, the last healthy covariance
    (``staleness[t]`` dates old) at quarantined ones.
    """

    quarantined: torch.Tensor   # (T,) bool
    reasons: torch.Tensor       # (T,) int32 bitmask
    staleness: torch.Tensor     # (T,) int32: dates since the served cov was fit
    served_cov: torch.Tensor    # (T, K, K)


def guard_ring_init(window: int, dtype, device=None):
    """Empty trailing-universe ring: NaN slots are "no observation yet" (the
    collapse check disables itself until the ring holds data)."""
    return (torch.full((window,), float("nan"), dtype=dtype, device=device),
            torch.zeros((), dtype=torch.int32, device=device))


def _per_date(x, T, dtype, device) -> torch.Tensor:
    """A (T,) per-date input (tensor, numpy array or sequence; None means
    all zero) as a ``dtype`` tensor on ``device``."""
    if x is None:
        return torch.zeros((T,), dtype=dtype, device=device)
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.asarray(x).astype(np.int64))
    return x.to(device=device, dtype=dtype)


def guard_slab(ret, cap, valid, ring, ring_pos, policy, pre_reasons=None,
               heal_mask=None):
    """Health-check every date of an appended slab, in order.

    Args:
      ret, cap: (T, N) slab panels (compute dtype).
      valid: (T, N) bool universe mask.
      ring: (W,) trailing healthy-universe sizes (NaN = empty slot).
      ring_pos: int32 scalar tensor, the next write slot.
      policy: :class:`mfm_tpu_torch.config.QuarantinePolicy`.
      pre_reasons: optional (T,) host-side reasons
        (:func:`host_date_reasons`) OR-ed into the verdicts.
      heal_mask: optional (T,) bool forcing the verdict HEALTHY at the
        marked dates (a quarantine counterfactual); the reasons stay in
        the report and a healed date feeds the ring like a healthy one.

    Returns ``(quarantined (T,) bool, reasons (T,) int32, ring, ring_pos)``,
    all on the slab's device.  The inputs are not written to.
    """
    T = ret.shape[0]
    dtype, dev = ret.dtype, ret.device
    pre = _per_date(pre_reasons, T, torch.int32, dev)
    heal = _per_date(heal_mask, T, torch.bool, dev)

    n_valid = valid.to(dtype).sum(dim=-1)  # (T,) exact counts
    denom = torch.clamp_min(n_valid, 1.0)

    # 1. NaN/Inf density over the universe
    nan_frac = (valid & ~torch.isfinite(ret)).to(dtype).sum(dim=-1) / denom
    r_nan = nan_frac > policy.max_nan_frac

    # 3. cross-sectional return outliers: |r - med| > mad_k * MAD (a
    # degenerate MAD disables the check, NaN never flags)
    r_use = torch.where(valid & torch.isfinite(ret), ret,
                        torch.full_like(ret, float("nan")))
    out_frac = mad_outlier_cells(r_use, policy.mad_k).to(dtype).sum(-1) / denom
    r_out = out_frac > policy.max_outlier_frac

    # 4. cap positivity: the regression weights are cap-derived
    r_cap = (valid & (~torch.isfinite(cap) | (cap <= 0))).any(dim=-1)

    own = pre | combine_reason_bits((
        (r_nan, REASON_NAN_DENSITY),
        (r_out, REASON_RET_OUTLIER),
        (r_cap, REASON_CAP_NONPOS),
    ))

    # 2. universe collapse against the trailing median of HEALTHY dates,
    # date by date: each verdict decides whether its date enters the ring
    # the next date's median reads.  An empty ring gives a NaN reference,
    # which disables the check.
    W = ring.shape[0]
    slots = torch.arange(W, device=dev)
    pos = ring_pos.to(device=dev, dtype=torch.int32)
    reasons = []
    for i in range(T):
        ref = nanmedian(ring)
        r_uni = torch.isfinite(ref) & (n_valid[i] < policy.min_universe_frac * ref)
        reasons_i = own[i] | combine_reason_bits(
            ((r_uni, REASON_UNIVERSE_COLLAPSE),))
        q_i = (reasons_i != 0) & ~heal[i]
        # only healthy dates feed the trailing-universe reference
        ring = torch.where(q_i | (slots != pos), ring,
                           n_valid[i].to(ring.dtype))
        pos = torch.where(q_i, pos, (pos + 1) % W)
        reasons.append(reasons_i)
    reasons = (torch.stack(reasons) if T else
               torch.zeros((0,), dtype=torch.int32, device=dev))
    return (reasons != 0) & ~heal, reasons, ring, pos


def host_date_reasons(dates, last_date=None) -> np.ndarray:
    """Host-side pre-check: flag non-monotone / duplicate dates.

    ``dates`` is the appended slab's date axis (any orderable values);
    ``last_date`` the checkpoint's last served date.  Returns a (T,) uint32
    numpy array with :data:`REASON_DATE_ORDER` on every date that is <= its
    predecessor (or <= ``last_date``); a flagged date does not become the
    new watermark.
    """
    out = np.zeros(len(dates), np.uint32)
    prev = last_date
    for i, d in enumerate(dates):
        if prev is not None and not (d > prev):
            out[i] = REASON_DATE_ORDER
        else:
            prev = d
    return out
