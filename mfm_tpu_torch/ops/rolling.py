"""Masked rolling-window kernels over (T, N) panels (counterpart of
``mfm_tpu/ops/rolling.py``).

Each rolling factor is one batched computation over every stock at once,
in one of two implementations:

- ``"scan"`` (the default): every reduction is an associative sum or max
  over a trailing window, so it has an exact O(T*N) two-level form.  The
  date axis splits into chunks of C = window rows; the window ending at
  row r of chunk q spans at most chunk q and chunk q-1, and
  ``S_t = prefix(chunk q, ..r) + suffix(chunk q-1, r+1..)``: two in-chunk
  scans (``torch.cumsum`` / ``torch.cummax``, reversed by ``torch.flip``)
  and an elementwise combine.  Geometric weights stay exact because they
  are separable: tail-aligned-after-dropna weights (BETA, DASTD) are
  ``decay**(v_t - v_j)`` with v the running valid count (event time),
  head-aligned ones (RSTR) are ``(1/decay)**(t - j)`` up to a per-window
  factor the renormalization cancels (calendar time).  Exponents are
  rebased per chunk, so no power exceeds ``decay**(-C)``.
- ``"block"``: the reference formulation.  Trailing windows are gathered
  ``block`` dates at a time into (block, window, N) tensors and reduced
  in closed form; one Python loop over the ceil(T/block) date blocks
  bounds the memory at block * window * N elements per input.

Weight alignment (the parity-critical part): the reference drops the NaNs
inside a window and gives the last n weights of the decay vector to the n
valid points, so the k-th most recent valid point gets ``decay**k``: a
reversed masked cumsum, no dropna (``ewma_tail_weights_from_mask``).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

#: the rolling-kernel implementations, the single source for config
#: validation (scan = O(T*N) two-level chunked scans, block = the
#: windowed-gather reference formulation)
ROLLING_IMPLS = ("scan", "block")

_NAN = float("nan")


def decay_rate(half_life: float, dtype=torch.float64) -> torch.Tensor:
    """0.5 ** (1 / half_life), computed in ``dtype`` (a 0-d tensor)."""
    return torch.tensor(0.5, dtype=dtype) ** (1.0 / half_life)


def _rev_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.flip(torch.cumsum(torch.flip(x, (dim,)), dim), (dim,))


def ewma_tail_weights_from_mask(valid: torch.Tensor, decay,
                                dim: int = -2) -> torch.Tensor:
    """Unnormalized tail-aligned weights ``decay**(# valid after me)``,
    zero where invalid.  ``valid`` is a boolean window tensor, ``dim`` its
    window axis; ``decay`` a 0-d tensor whose dtype the weights take."""
    decay = torch.as_tensor(decay)
    v = valid.to(decay.dtype)
    after = _rev_cumsum(v, dim) - v
    return torch.where(valid, decay.to(valid.device) ** after, 0.0)


def auto_block(n_stocks: int, window: int = 504, budget_mb: int = 256,
               lo: int = 8, hi: int = 64, itemsize: int = 4) -> int:
    """Date-block size fitting the block impl's window buffer
    (``block * window * n_stocks`` elements per input) in ``budget_mb``:
    the largest power of two in [lo, hi] under it.  504 is the widest
    kernel's window + lag upper bound (RSTR)."""
    per_date = window * max(int(n_stocks), 1) * itemsize
    cap = max(lo, min(hi, budget_mb * 2**20 // per_date))
    b = lo
    while b * 2 <= cap:
        b *= 2
    return b


def rolling_reduce(inputs: Sequence[torch.Tensor], window: int,
                   reducer: Callable, *, block: int = 64):
    """Map ``reducer`` over every length-``window`` trailing window of the
    (T, N) ``inputs``.

    Windows end at each date t and cover [t-window+1, t]; positions before
    the series start are NaN (invalid).  ``reducer`` takes one
    (B, window, N) tensor per input and returns a (B, N) tensor or a tuple
    of them.  The ceil(T/block) date blocks run one after the other, so
    at most block * window * N elements per input are live.
    """
    T, N = inputs[0].shape
    dev = inputs[0].device
    nb = -(-T // block)
    Tp = nb * block
    padded = [torch.cat([x.new_full((window - 1, N), _NAN), x,
                         x.new_full((Tp - T, N), _NAN)]) for x in inputs]
    offs = (torch.arange(block, device=dev)[:, None]
            + torch.arange(window, device=dev)[None, :])  # (B, W)
    outs = []
    for b in range(nb):
        idx = b * block + offs  # window ending at date b*block + i
        res = reducer(*(p[idx] for p in padded))
        outs.append(res if isinstance(res, tuple) else (res,))
    cols = tuple(torch.cat(parts)[:T] for parts in zip(*outs))
    return cols if isinstance(res, tuple) else cols[0]


# -- two-level (chunked prefix/suffix) windowed reductions -------------------

def _chunked(x: torch.Tensor, C: int) -> torch.Tensor:
    """Zero-pad the date axis to a multiple of C; reshape to (nc, C, ...)."""
    T = x.shape[0]
    nc = -(-T // C)
    xp = torch.cat([x, x.new_zeros((nc * C - T,) + tuple(x.shape[1:]))])
    return xp.reshape((nc, C) + tuple(x.shape[1:]))


def _prev_chunk_suffix(B: torch.Tensor, fill=0.0) -> torch.Tensor:
    """In-chunk suffix scans B[q, s] (reduction over rows s.. of chunk q)
    -> Bsh[q, r] = B[q-1, r+1], the previous chunk's share of the window
    ending at row r of chunk q; the reduction's identity ``fill`` (0 for
    sums, -inf for max) where there is none."""
    Bprev = torch.cat([torch.full_like(B[:1], fill), B[:-1]])
    return torch.cat([Bprev[:, 1:], torch.full_like(Bprev[:, :1], fill)],
                     dim=1)


def windowed_sum_scan(term: torch.Tensor, window: int) -> torch.Tensor:
    """Trailing-window sums of ``term`` (T, N; invalid entries zeroed) in
    O(T*N), the exact two-level chunked prefix/suffix form."""
    T = term.shape[0]
    ch = _chunked(term, window)
    out = torch.cumsum(ch, 1) + _prev_chunk_suffix(_rev_cumsum(ch, 1))
    return out.reshape((-1,) + tuple(term.shape[1:]))[:T]


def decay_windowed_sums_scan(terms: Sequence[torch.Tensor], window: int,
                             expo: torch.Tensor, decay) -> list:
    """Trailing-window geometric-weighted sums, O(T*N) per term.

    For each (T, N) ``term`` (invalid entries zeroed) returns
    ``S_t = sum_{j in [t-window+1, t]} decay**(expo_t - expo_j) * term_j``.
    ``expo`` is (T, N) or (T, 1) and nondecreasing along the dates: the
    running valid count (event-time weights) or the date index
    (calendar-time weights); ``decay`` may exceed 1.  Exponents are
    rebased per chunk, so each power stays within the chunk's range.
    """
    C = window
    T = terms[0].shape[0]
    dtype = terms[0].dtype
    lam = torch.as_tensor(decay, dtype=dtype).to(terms[0].device)
    nc = -(-T // C)
    # edge-pad expo: zero padding would put huge rebased exponents in the
    # padded tail rows, whose inf*0 NaNs would ride the reverse cumsum into
    # real rows of the last chunk's suffix
    e = expo.to(dtype)
    ep = torch.cat([e, e[-1:].expand((nc * C - T,) + tuple(e.shape[1:]))])
    ch_e = ep.reshape((nc, C) + tuple(e.shape[1:]))
    e0 = ch_e[:, :1]                           # chunk-start expo
    rel = ch_e - e0                            # >= 0, within the chunk range
    # the next chunk's start expo; the last chunk's suffix is never
    # consumed, so any finite value serves there
    e0n = torch.cat([e0[1:], ch_e[-1:, -1:]])
    wdn = lam ** (-rel)                        # prefix weights
    wup = lam ** (e0n - ch_e)                  # suffix weights (to next e0)
    scale = lam ** rel
    outs = []
    for term in terms:
        ch = _chunked(term, C)
        S = scale * (torch.cumsum(wdn * ch, 1)
                     + _prev_chunk_suffix(_rev_cumsum(wup * ch, 1)))
        outs.append(S.reshape((-1,) + tuple(term.shape[1:]))[:T])
    return outs


def windowed_max_scan(x: torch.Tensor, window: int) -> torch.Tensor:
    """Trailing-window running max of ``x`` (T, N; invalid entries -inf)
    in O(T*N), the two-level chunked cummax."""
    T = x.shape[0]
    # the zero-padded tail rows reach only sliced-off positions and the
    # never-consumed last chunk's suffix, so they win no real max
    ch = _chunked(x, window)
    A = torch.cummax(ch, 1).values
    B = torch.flip(torch.cummax(torch.flip(ch, (1,)), 1).values, (1,))
    out = torch.maximum(A, _prev_chunk_suffix(B, fill=-float("inf")))
    return out.reshape((-1,) + tuple(x.shape[1:]))[:T]


def _check_impl(impl: str) -> bool:
    """Validate the impl switch; True for the scan path."""
    if impl not in ROLLING_IMPLS:
        raise ValueError(f"impl must be one of {ROLLING_IMPLS}, got {impl!r}")
    return impl == "scan"


def _gate(ok, x):
    return torch.where(ok, x, _NAN)


# -- factor kernels ------------------------------------------------------------

def rolling_beta_hsigma(ret: torch.Tensor, market_ret: torch.Tensor, *,
                        window: int = 252, half_life: int = 63,
                        min_periods: int = 42, block: int = 64,
                        impl: str = "scan"):
    """Closed-form rolling WLS of stock returns on market returns
    (``factor_calculator.py:90-122``): BETA is the slope, HSIGMA
    ``sqrt(sum(w e^2) / (n - 2))`` with the unnormalized tail-aligned
    weights.  ret: (T, N); market_ret: (T,) or (T, N).  Returns
    (beta, hsigma), each (T, N).

    The scan path computes the six weighted moments with event-time
    scans and HSIGMA's residual sum from the normal-equation identity
    ``ssr = syy - alpha*sy - beta*sxy``, which cancels when R^2 -> 1
    (float32 drift up to ~2e-4 relative on an index-tracker-like stock,
    ``mfm_tpu/ops/rolling.py:270-282``); the block path forms the
    residuals explicitly.
    """
    T, N = ret.shape
    dtype = ret.dtype
    if market_ret.dim() == 1:
        market_ret = market_ret[:, None].expand(T, N)
    lam = decay_rate(half_life, dtype).to(ret.device)

    if _check_impl(impl):
        valid = torch.isfinite(ret) & torch.isfinite(market_ret)
        m = valid.to(dtype)
        yz = torch.where(valid, ret, 0.0)
        xz = torch.where(valid, market_ret, 0.0)
        v = torch.cumsum(m, 0)  # event time: weight = lam**(v_t - v_j)
        sw, sx, sy, sxx, sxy, syy = decay_windowed_sums_scan(
            [m, xz * m, yz * m, xz * xz * m, xz * yz * m, yz * yz * m],
            window, v, lam)
        n = windowed_sum_scan(m, window)
        beta = (sw * sxy - sx * sy) / (sw * sxx - sx * sx)
        alpha = (sy - beta * sx) / sw
        ssr = syy - alpha * sy - beta * sxy
        scale = torch.clamp_min(ssr, 0.0) / (n - 2)  # moment-form rounding
        ok = n >= min_periods
        return _gate(ok, beta), _gate(ok, torch.sqrt(scale))

    def reducer(y, x):
        valid = torch.isfinite(y) & torch.isfinite(x)
        u = ewma_tail_weights_from_mask(valid, lam, dim=1)
        yz = torch.where(valid, y, 0.0)
        xz = torch.where(valid, x, 0.0)
        n = valid.sum(1)
        sw = u.sum(1)
        sx = (u * xz).sum(1)
        sy = (u * yz).sum(1)
        sxx = (u * xz * xz).sum(1)
        sxy = (u * xz * yz).sum(1)
        beta = (sw * sxy - sx * sy) / (sw * sxx - sx * sx)
        alpha = (sy - beta * sx) / sw
        e = yz - alpha[:, None] - beta[:, None] * xz
        scale = (u * e * e).sum(1) / (n - 2)
        ok = n >= min_periods
        return _gate(ok, beta), _gate(ok, torch.sqrt(scale))

    return rolling_reduce([ret, market_ret], window, reducer, block=block)


def rolling_weighted_std(x: torch.Tensor, *, window: int = 252,
                         half_life: int = 42, min_periods: int = 42,
                         block: int = 64, impl: str = "scan"):
    """DASTD kernel: exp-weighted std with tail-aligned renormalized
    weights (``factor_calculator.py:166-180``).  The scan path uses
    ``var = s2/sw - mu**2`` (the renormalization cancels)."""
    dtype = x.dtype
    lam = decay_rate(half_life, dtype).to(x.device)

    if _check_impl(impl):
        valid = torch.isfinite(x)
        m = valid.to(dtype)
        xz = torch.where(valid, x, 0.0)
        v = torch.cumsum(m, 0)
        sw, s1, s2 = decay_windowed_sums_scan([m, xz * m, xz * xz * m],
                                              window, v, lam)
        mu = s1 / sw
        var = torch.clamp_min(s2 / sw - mu * mu, 0.0)
        n = windowed_sum_scan(m, window)
        return _gate(n >= min_periods, torch.sqrt(var))

    def reducer(w):
        valid = torch.isfinite(w)
        u = ewma_tail_weights_from_mask(valid, lam, dim=1)
        u = u / u.sum(1, keepdim=True)
        mu = (u * torch.where(valid, w, 0.0)).sum(1, keepdim=True)
        var = (u * torch.where(valid, (w - mu) ** 2, 0.0)).sum(1)
        return _gate(valid.sum(1) >= min_periods, torch.sqrt(var))

    return rolling_reduce([x], window, reducer, block=block)


def rolling_decay_weighted_mean(x: torch.Tensor, *, window: int,
                                half_life: int, min_periods: int,
                                block: int = 64, impl: str = "scan"):
    """RSTR kernel: head-aligned decay weights ``decay**p`` at window
    position p, renormalized over the valid points, times the windowed
    series (``factor_calculator.py:136-142``).  The scan path uses the
    calendar-time weights ``(1/decay)**(t-j)``, a constant factor per
    window away from the position weights."""
    dtype = x.dtype
    lam = decay_rate(half_life, dtype).to(x.device)

    if _check_impl(impl):
        valid = torch.isfinite(x)
        m = valid.to(dtype)
        xz = torch.where(valid, x, 0.0)
        t_idx = torch.arange(x.shape[0], dtype=dtype, device=x.device)[:, None]
        num, den = decay_windowed_sums_scan([xz * m, m], window, t_idx,
                                            1.0 / lam)
        n = windowed_sum_scan(m, window)
        return _gate(n >= min_periods, num / den)

    wpos = lam ** torch.arange(window, dtype=dtype, device=x.device)

    def reducer(w):
        valid = torch.isfinite(w)
        u = torch.where(valid, wpos[None, :, None], 0.0)
        u = u / u.sum(1, keepdim=True)
        s = (u * torch.where(valid, w, 0.0)).sum(1)
        return _gate(valid.sum(1) >= min_periods, s)

    return rolling_reduce([x], window, reducer, block=block)


def rolling_sum(x: torch.Tensor, *, window: int, min_periods: int,
                block: int = 64, impl: str = "scan"):
    """NaN-skipping rolling sum with a min_periods gate, the liquidity
    base (``factor_calculator.py:346-350``)."""
    if _check_impl(impl):
        valid = torch.isfinite(x)
        s = windowed_sum_scan(torch.where(valid, x, 0.0), window)
        n = windowed_sum_scan(valid.to(x.dtype), window)
        return _gate(n >= min_periods, s)

    def reducer(w):
        valid = torch.isfinite(w)
        s = torch.where(valid, w, 0.0).sum(1)
        return _gate(valid.sum(1) >= min_periods, s)

    return rolling_reduce([x], window, reducer, block=block)


def rolling_cmra(log_ret: torch.Tensor, *, window: int = 252,
                 block: int = 64, impl: str = "scan"):
    """CMRA kernel: log(1 + max Z) - log(1 + min Z), Z the cumulative-return
    path over a fully valid window (``factor_calculator.py:206-219``).

    The scan path uses the collapse ``log1p(Z_j)`` = the windowed
    cumulative log return, so CMRA is the windowed max minus min of the
    global log-return prefix path (the window base cancels)."""
    dtype = log_ret.dtype
    inf = float("inf")

    if _check_impl(impl):
        valid = torch.isfinite(log_ret)
        m = valid.to(dtype)
        prefix = torch.cumsum(torch.where(valid, log_ret, 0.0), 0)
        rng = (windowed_max_scan(torch.where(valid, prefix, -inf), window)
               + windowed_max_scan(torch.where(valid, -prefix, -inf), window))
        n = windowed_sum_scan(m, window)
        return _gate(n >= window, rng)

    def reducer(w):
        valid = torch.isfinite(w)
        z = torch.exp(torch.cumsum(torch.where(valid, w, 0.0), 1)) - 1.0
        big = torch.where(valid, z, -inf).amax(1)
        small = torch.where(valid, z, inf).amin(1)
        rng = torch.log1p(big) - torch.log1p(small)
        return _gate(valid.sum(1) >= window, rng)

    return rolling_reduce([log_ret], window, reducer, block=block)
