"""Guard primitives: a NaN-aware median, the MAD outlier mask and the
reason-bitmask plumbing (counterpart of ``mfm_tpu/serve/_checks.py``).

The reference passes its array namespace (``jnp`` or ``np``) so the slab
guards and the host-side request guards share one formula; here the slab
guards are the only caller until the request guards are ported
(ROADMAP.md §A 10), so the functions take tensors.

``torch.nanmedian`` returns the LOWER of the two middle values of an even
count, where ``np.nanmedian`` and ``jnp.nanmedian`` average them, so the
port has its own :func:`nanmedian`.
"""

from __future__ import annotations

import torch


def nanmedian(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Median over ``dim`` ignoring NaNs, as ``np.nanmedian``: the mean of
    the two middle values of an even count, ``(a + b) * 0.5`` as
    ``jnp.nanmedian`` computes it; NaN where every value is NaN."""
    s, _ = torch.sort(x, dim=dim)  # NaN sorts last
    n = (~torch.isnan(x)).sum(dim=dim, keepdim=True)
    lo = torch.clamp_min((n - 1) // 2, 0)
    a = torch.gather(s, dim, lo)
    b = torch.gather(s, dim, n // 2)
    med = torch.where(n > 0, (a + b) * 0.5,
                      torch.full_like(a, float("nan")))
    return med.squeeze(dim)


def mad_outlier_cells(x_use: torch.Tensor, mad_k: float) -> torch.Tensor:
    """Boolean mask of cross-sectional MAD outliers along the last dim.

    ``x_use`` holds the values under test with every excluded cell already
    NaN (NaN never flags: comparisons with NaN are False).  A MAD of 0 — a
    constant cross-section — disables the check (threshold +inf) rather
    than flagging every cell.
    """
    med = nanmedian(x_use, dim=-1)[..., None]
    dev = (x_use - med).abs()
    mad = nanmedian(dev, dim=-1)
    thresh = torch.where(mad > 0, mad_k * mad,
                         torch.full_like(mad, float("inf")))
    return dev > thresh[..., None]


def combine_reason_bits(flag_bit_pairs) -> torch.Tensor:
    """OR ``bit`` into an int32 mask wherever ``flag`` is true.

    ``flag_bit_pairs`` is an iterable of ``(flag, bit)``: ``flag`` a bool
    tensor (all of one shape), ``bit`` an int reason constant.  The port
    keeps reasons in int32 (every bit is below 2**6); the reference's
    uint32 masks hold the same values.
    """
    mask = None
    for flag, bit in flag_bit_pairs:
        b = torch.where(flag, bit, 0).to(torch.int32)
        mask = b if mask is None else mask | b
    return mask


def names_of_mask(mask: int, table) -> list:
    """Human-readable names of the bits set in ``mask``; ``table`` is the
    layer's ``((bit, name), ...)`` registry."""
    return [name for bit, name in table if int(mask) & bit]
