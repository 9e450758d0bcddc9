"""Gradient-based portfolio construction against the served covariance
(counterpart of ``mfm_tpu/grad/construct.py``).

Three solvers over a batch of portfolios, all against the checkpoint's
``last_good_cov`` (what serving answers queries from):

- :func:`minvol_batch` — minimum-vol long-only portfolio on the simplex
  with box constraints, by exponentiated gradient (multiplicative
  weights): ``x <- x * exp(-eta_i * g)`` renormalized.  The step is
  *annealed* (:func:`_anneal`): constant over the first half of the run,
  then geometrically decayed to ``eta * 1e-6``.  A constant normalized
  step settles into a period-2 limit cycle on covariances with strongly
  negative correlations; the anneal drives the orbit radius to zero.
- :func:`riskparity_batch` — equal risk contributions via the convex ERC
  formulation, each step the per-coordinate closed-form root
  ``x_i = (-B_i + sqrt(B_i^2 + 4 F_ii c)) / (2 F_ii)`` applied
  Jacobi-style with damping.
- :func:`hedge_batch` — minimum-vol hedge overlay: projected gradient on
  a masked overlay ``h`` with a box ``|h| <= hmax``.

The reference's fixed-iteration ``lax.fori_loop`` in a donated jit is a
Python loop of plain tensor ops here; ``eta`` and ``steps`` are plain
operands.  ``F x`` is :func:`~mfm_tpu_torch.ops.xreg._rowdot` (an
elementwise product and an innermost sum of K terms per row), never a
matrix product, and nothing else contracts across the batch axis, so a
batch of B equals B singles bitwise; with the default ``lo = 0`` box an
all-zero pad lane stays EXACTLY zero (every update is multiplicative in
the lane's own weights and every normalizer carries ``+ _TINY``).
"""

from __future__ import annotations

import torch

from mfm_tpu_torch.models.risk_model import portfolio_vol
from mfm_tpu_torch.ops.xreg import _rowdot

#: denominator guard: bitwise-neutral next to any real weight sum or
#: gradient magnitude at float32, and 0 / _TINY == 0 keeps pad lanes frozen
_TINY = 1e-30

#: ln(1e-6): the annealed solvers decay their step by this factor over
#: the second half of the run (see module docstring)
_LOG_ANNEAL = -13.815510557964274


def _fx(cov, x):
    """``F x`` per row of ``x`` (B, K) for a shared (K, K) ``F``."""
    return _rowdot(cov, x[..., None, :])


def _anneal(steps: int, eta, dtype, device) -> torch.Tensor:
    """Step sizes of iterations 0..steps-1 at ``dtype``: ``eta`` for the
    first half, then a geometric decay to ``eta * 1e-6`` at the last
    iteration — the reference's schedule, element for element."""
    eta = torch.as_tensor(eta, dtype=dtype, device=device)
    fs = torch.tensor(float(max(steps - 1, 1)), dtype=dtype, device=device)
    i = torch.arange(steps, device=device).to(dtype)
    frac = torch.maximum(2.0 * i / fs - 1.0, torch.zeros((), dtype=dtype,
                                                         device=device))
    return eta * torch.exp(_LOG_ANNEAL * frac)


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def minvol_batch(xs0, cov, lo, hi, eta, steps: int):
    """Min-vol solve for B portfolios.

    Args:
      xs0: (B, K) start weights (any nonnegative warm start; pad lanes
        all-zero).
      cov: (K, K) served factor covariance.
      lo, hi: (K,) box constraints (``lo=0, hi=1`` recovers the plain
        long-only simplex).
      eta: multiplicative-weights rate (peak of the annealed schedule).
      steps: iteration count.

    Returns ``(x (B, K), vol (B,), kkt_resid (B,))``.
    """
    etas = _anneal(int(steps), eta, xs0.dtype, xs0.device)
    x = xs0
    for i in range(int(steps)):
        g = _fx(cov, x)
        gn = g / (g.abs().amax(-1, keepdim=True) + _TINY)
        x = _clip(x * torch.exp(-etas[i] * gn), lo, hi)
        x = x / (x.sum(-1, keepdim=True) + _TINY)
    fx = _fx(cov, x)
    var = _rowdot(x, fx)
    # KKT stationarity at the solution: every coordinate strictly inside
    # the box (clear of it by an absolute 1e-3 of weight) must have
    # marginal variance (F x)_i equal to the portfolio variance x'Fx;
    # the worst relative violation is the convergence diagnostic
    interior = (x > lo + 1e-3) & (x < hi - 1e-3)
    resid = (fx - var[:, None]).abs() / (var[:, None] + _TINY)
    kkt = torch.where(interior, resid, torch.zeros((), dtype=x.dtype,
                                                   device=x.device)).amax(-1)
    return x, portfolio_vol(cov, x), kkt


def riskparity_batch(xs0, cov, eta, steps: int):
    """Risk-parity solve for B portfolios.

    ``eta`` is the Jacobi damping in (0, 1].  Returns ``(x (B, K), vol
    (B,), rc_spread (B,))`` where ``rc_spread`` is (max - min) risk
    contribution over the mean risk contribution — 0 at exact parity.
    """
    K = xs0.shape[-1]
    dtype, dev = xs0.dtype, xs0.device
    eta = torch.as_tensor(eta, dtype=dtype, device=dev)
    d = torch.maximum(torch.diagonal(cov),
                      torch.tensor(_TINY, dtype=dtype, device=dev))
    # c sets the scale of the unnormalized ERC fixed point; an all-zero
    # pad lane gives c = 0, whose root is x = 0 — frozen
    c = (_rowdot(xs0, _fx(cov, xs0)) / K)[:, None]
    x = xs0
    for _ in range(int(steps)):
        off = _fx(cov, x) - d * x
        root = (-off + torch.sqrt(off * off + 4 * d * c)) / (2 * d)
        x = (1 - eta) * x + eta * root
    x = x / (x.sum(-1, keepdim=True) + _TINY)
    rc = x * _fx(cov, x)
    spread = ((rc.amax(-1) - rc.amin(-1))
              / (rc.sum(-1) / K + _TINY))
    return x, portfolio_vol(cov, x), spread


def hedge_batch(xs0, hs0, cov, mask, hmax, eta, steps: int):
    """Hedge-overlay solve for B books.

    Args:
      xs0: (B, K) base books (held fixed).
      hs0: (B, K) overlay starts (normally zeros).
      cov: (K, K) served factor covariance.
      mask: (B, K) 1.0 on the hedgeable factors, 0.0 elsewhere.
      hmax: overlay box, ``|h_i| <= hmax``.
      eta: step rate (peak fraction of ``hmax`` per iteration; annealed
        like min-vol).
      steps: iteration count.

    Returns ``(x_hedged (B, K), h (B, K), vol (B,))``.
    """
    dtype, dev = xs0.dtype, xs0.device
    hmax = torch.as_tensor(hmax, dtype=dtype, device=dev)
    etas = _anneal(int(steps), eta, dtype, dev)
    h = hs0
    for i in range(int(steps)):
        g = mask * _fx(cov, xs0 + mask * h)
        gn = g / (g.abs().amax(-1, keepdim=True) + _TINY)
        # the max-normalized gradient never vanishes, so a constant step
        # orbits the optimum at radius ~eta * hmax; the anneal converges
        h = _clip(h - etas[i] * hmax * gn, -hmax, hmax)
    xt = xs0 + mask * h
    return xt, h, portfolio_vol(cov, xt)
