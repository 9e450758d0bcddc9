"""GradEngine — host orchestration for the differentiable-risk surfaces
(counterpart of ``mfm_tpu/grad/engine.py``).

The engine owns everything that is NOT device math: admissibility
bounds, bucket padding, spec resolution (delegated to a composed
:class:`~mfm_tpu_torch.scenario.engine.ScenarioEngine` so replay and
counterfactual worlds resolve identically), host-side verification of
the worst-case shocks the ascent returns, and the JSON-ready entry dicts
the report writer persists.  The device work is the three kernel
modules (grad/reverse.py, grad/construct.py, grad/sensitivity.py), each
called at bucket-padded shapes on the engine's device — the card unless
``device="cpu"``; on the card the eighs of reverse stress and the
sensitivities are the full Jacobi kernel.

Sanitization doctrine: a non-finite sensitivity is a true statement (the
vol is not differentiable at that point — the eigh gradient at repeated
eigenvalues), so it is recorded as ``null`` + a ``nondifferentiable``
flag, never replaced by a plausible number.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mfm_tpu_torch.grad.construct import (
    hedge_batch,
    minvol_batch,
    riskparity_batch,
)
from mfm_tpu_torch.grad.reverse import reverse_stress_batch
from mfm_tpu_torch.grad.sensitivity import sensitivity_batch
from mfm_tpu_torch.scenario.engine import ScenarioEngine
from mfm_tpu_torch.scenario.spec import ScenarioSpec, validate_spec
from mfm_tpu_torch.serve.query import bucket_for

#: default solver knobs, pinned here so serve, the smoke run and the
#: tests agree on one steady state
REVERSE_STEPS = 200
REVERSE_STEP = 0.1
MINVOL_STEPS = 2000
MINVOL_ETA = 0.15
RISKPARITY_STEPS = 2000
RISKPARITY_ETA = 0.5
HEDGE_STEPS = 200
HEDGE_ETA = 0.1

#: construct request vocabulary (serve/server.py admits exactly these)
SOLVERS = ("min_vol", "risk_parity", "hedge")


@dataclasses.dataclass(frozen=True)
class ShockBall:
    """The admissibility box of the reverse-stress search, in ScenarioSpec
    coordinates.  A box, not a sphere: each shock axis has its own
    physically-meaningful range, and the box is what a clip
    projects onto exactly.  The default ball CONTAINS the whole preset
    drill catalog (crash-2015-analog, covid-2020-analog, corr-meltup) —
    the worst admissible shock can never report less vol than a drill the
    desk already runs.

    Attributes:
      shift_max: |additive vol shift| cap per factor (vol units).
      scale_range: vol scale stays in [1 - r, 1 + r].
      vol_mult_lo/hi: global vol-regime multiplier range.
      corr_beta_lo/hi: correlation-stress range (hi must stay < 1/0.95 of
        the -1 pole validate_spec rejects; 0.95 keeps every spec the
        search can emit admissible by construction).
    """

    shift_max: float = 0.01
    scale_range: float = 0.5
    vol_mult_lo: float = 1.0
    vol_mult_hi: float = 3.5
    corr_beta_lo: float = 0.0
    corr_beta_hi: float = 0.95

    def bounds(self, K: int) -> tuple:
        """``(lo, hi)`` lists over the theta layout
        ``[shift (K,) | scale (K,) | vol_mult | corr_beta]``."""
        lo = ([-self.shift_max] * K + [1.0 - self.scale_range] * K
              + [self.vol_mult_lo, self.corr_beta_lo])
        hi = ([self.shift_max] * K + [1.0 + self.scale_range] * K
              + [self.vol_mult_hi, self.corr_beta_hi])
        return lo, hi

    def contains(self, theta, K: int, rtol: float = 1e-5) -> bool:
        """Host check that a returned shock vector sits inside the box
        (up to dtype round-off of the clip itself)."""
        lo, hi = self.bounds(K)
        lo = np.asarray(lo, np.float64)
        hi = np.asarray(hi, np.float64)
        t = np.asarray(theta, np.float64)
        slack = rtol * np.maximum(np.abs(lo), np.abs(hi))
        return bool(np.all(t >= lo - slack) and np.all(t <= hi + slack))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class GradEngine:
    """Differentiable-risk runs against one served covariance.

    Mirrors :class:`~mfm_tpu_torch.scenario.engine.ScenarioEngine`'s
    contract (same constructor surface, same ``from_risk_state`` guards —
    grad surfaces interrogate the GUARDED checkpoint's ``last_good_cov``,
    the matrix serving actually answers from).  ``device``: None for the
    CUDA card (raises without one), or e.g. ``"cpu"``.
    """

    def __init__(self, cov, *, factor_names=None, staleness: int = 0,
                 dtype=None, replay_lookup=None, counterfactual_fn=None,
                 device=None):
        # compose a ScenarioEngine for validation + base-cov resolution:
        # grad lanes must resolve replay/counterfactual worlds EXACTLY the
        # way forward scenarios do, or the sensitivity a manifest stamps
        # would describe a different world than the entry it sits in
        self._scen = ScenarioEngine(
            cov, factor_names=factor_names, staleness=staleness,
            dtype=dtype, replay_lookup=replay_lookup,
            counterfactual_fn=counterfactual_fn, device=device)
        self.cov = self._scen.cov
        self.dtype = self._scen.dtype
        self.device = self._scen.device
        self.K = self._scen.K
        self.factor_names = self._scen.factor_names
        self.factor_index = self._scen.factor_index
        self.staleness = self._scen.staleness

    @classmethod
    def from_risk_state(cls, state, meta=None, dtype=None,
                        replay_lookup=None, counterfactual_fn=None,
                        device=None):
        """Engine over a guarded ``RiskModelState`` checkpoint (refuses
        unguarded states, names off the checkpoint meta — the
        ``QueryEngine.from_risk_state`` contract)."""
        scen = ScenarioEngine.from_risk_state(
            state, meta=meta, dtype=dtype, replay_lookup=replay_lookup,
            counterfactual_fn=counterfactual_fn, device=device)
        return cls(scen.cov, factor_names=scen.factor_names,
                   staleness=scen.staleness, dtype=scen.dtype,
                   replay_lookup=replay_lookup,
                   counterfactual_fn=counterfactual_fn, device=device)

    def _put(self, a) -> torch.Tensor:
        return self._scen._put(np.asarray(a, self.dtype))

    def _scalar(self, v) -> torch.Tensor:
        return torch.tensor(v, dtype=self._scen._cov.dtype,
                            device=self.device)

    # -- reverse stress testing ----------------------------------------------
    def reverse_stress(self, portfolios, *, ball: ShockBall | None = None,
                       steps: int = REVERSE_STEPS,
                       step: float = REVERSE_STEP,
                       bucket: int | None = None, labels=None) -> list:
        """Worst admissible shock per portfolio (one batched ascent).

        ``portfolios``: (P, K) factor-exposure rows.  Returns P entry
        dicts: the worst-case :class:`ScenarioSpec` (as a dict + hash),
        base/worst vol, the vol delta, and the host-verified
        ``admissible`` flag (inside the ball AND spec-valid AND the
        stressed covariance PSD at compute dtype).
        """
        ball = ball or ShockBall()
        W = np.atleast_2d(np.asarray(portfolios, self.dtype))
        if W.ndim != 2 or W.shape[1] != self.K:
            raise ValueError(f"portfolios must be (P, {self.K}), got "
                             f"{W.shape}")
        P = W.shape[0]
        B = bucket_for(P) if bucket is None else int(bucket)
        if B < P:
            raise ValueError(f"bucket {B} < batch size {P}")
        labels = ([f"p{i}" for i in range(P)] if labels is None
                  else [str(l) for l in labels])

        lo_l, hi_l = ball.bounds(self.K)
        xs = np.zeros((B, self.K), self.dtype)
        xs[:P] = W
        # start at the identity shock
        theta0 = np.zeros((B, 2 * self.K + 2), self.dtype)
        theta0[:, self.K:2 * self.K] = 1.0
        theta0[:, 2 * self.K] = 1.0
        # pad lanes (all-zero portfolios) hit the sqrt(0) gradient corner;
        # the isfinite guard pins them at the identity start and the trim
        # below discards them
        theta_star, vol_star, vol0 = reverse_stress_batch(
            self._scen._cov, self._put(xs), self._put(theta0),
            self._put(lo_l), self._put(hi_l), self._scalar(step),
            int(steps))
        theta_star = theta_star[:P].cpu().numpy()
        vol_star = vol_star[:P].cpu().numpy()
        vol0 = vol0[:P].cpu().numpy()
        psd = self._stressed_psd(theta_star)

        entries = []
        for i in range(P):
            spec = self._theta_spec(theta_star[i], f"reverse-{labels[i]}")
            admissible = (ball.contains(theta_star[i], self.K)
                          and not validate_spec(spec, self.factor_names)
                          and bool(psd[i]))
            entries.append({
                "label": labels[i],
                "spec": spec.to_dict(),
                "spec_hash": spec.spec_hash(),
                "vol_base": float(vol0[i]),
                "vol_worst": float(vol_star[i]),
                "vol_delta": float(vol_star[i] - vol0[i]),
                "admissible": bool(admissible),
            })
        return entries

    def _theta_spec(self, theta, name: str) -> ScenarioSpec:
        """A flat shock vector back to declarative ScenarioSpec form —
        the round trip that makes a reverse-stress answer REPLAYABLE as
        an ordinary forward scenario."""
        K = self.K
        return ScenarioSpec(
            name=name,
            shift=tuple((self.factor_names[j], float(theta[j]))
                        for j in range(K) if theta[j] != 0.0),
            scale=tuple((self.factor_names[j], float(theta[K + j]))
                        for j in range(K) if theta[K + j] != 1.0),
            vol_mult=float(theta[2 * K]),
            corr_beta=float(theta[2 * K + 1]),
        )

    def _stressed_psd(self, thetas) -> np.ndarray:
        """Host check: each worst-case stressed covariance, through the
        REAL serving path (stress + gated projection, one batched call on
        the engine's device), is PSD at compute dtype — min eigenvalue
        (float64, on the host) above the kernel's own reconstruction
        floor, -K * eps * lambda_max.  ``thetas`` (P, 2K+2); a (P,) bool
        array."""
        return stressed_psd(self._scen._cov, self._put(np.atleast_2d(thetas)),
                            self.dtype)

    # -- sensitivity reports -------------------------------------------------
    def sensitivities(self, specs, portfolio, *,
                      bucket: int | None = None) -> list:
        """Exact d vol/d shock + d vol/d exposure rows for each spec, for
        one portfolio (one batched backward).

        Returns one entry dict per spec in input order: rejected specs
        carry ``status="rejected"`` + problems and no rows (the
        scenario-engine admission rules, applied identically); ok specs
        carry the vol at the shock point and the five Jacobian blocks,
        with non-finite rows recorded as ``null`` + ``nondifferentiable``.
        """
        specs = list(specs)
        S = len(specs)
        if S < 1:
            raise ValueError("need at least one scenario spec")
        x = np.asarray(portfolio, self.dtype).reshape(-1)
        if x.shape != (self.K,):
            raise ValueError(f"portfolio must be ({self.K},), got "
                             f"{x.shape}")
        B = bucket_for(S) if bucket is None else int(bucket)
        if B < S:
            raise ValueError(f"bucket {B} < batch size {S}")

        base = np.broadcast_to(self.cov, (B, self.K, self.K)).copy()
        shift = np.zeros((B, self.K), self.dtype)
        scale = np.ones((B, self.K), self.dtype)
        vol_mult = np.ones((B,), self.dtype)
        corr_beta = np.zeros((B,), self.dtype)
        lane_problems = []
        for i, spec in enumerate(specs):
            cov_i, problems = self._scen._resolve(spec)
            lane_problems.append(tuple(problems))
            if problems:
                continue   # rejected: the lane computes the identity point
            base[i] = cov_i
            shift[i], scale[i] = self._scen._shock_vectors(spec)
            vol_mult[i] = spec.vol_mult
            corr_beta[i] = spec.corr_beta

        out = sensitivity_batch(
            self._put(base), self._put(shift), self._put(scale),
            self._put(vol_mult), self._put(corr_beta), self._put(x))
        vol, d_shift, d_scale, d_vm, d_cb, d_x = (
            o.cpu().numpy() for o in out)

        entries = []
        for i, spec in enumerate(specs):
            e = {"name": spec.name, "status": "ok", "problems": []}
            if lane_problems[i]:
                e.update(status="rejected",
                         problems=list(lane_problems[i]))
                entries.append(e)
                continue
            rows = np.concatenate([d_shift[i], d_scale[i],
                                   [d_vm[i], d_cb[i]], d_x[i]])
            finite = bool(np.isfinite(rows).all() and np.isfinite(vol[i]))
            e.update({
                "vol": float(vol[i]) if np.isfinite(vol[i]) else None,
                "nondifferentiable": not finite,
                "d_vol_mult": _num(d_vm[i]),
                "d_corr_beta": _num(d_cb[i]),
                "d_shift": _rows(self.factor_names, d_shift[i]),
                "d_scale": _rows(self.factor_names, d_scale[i]),
                "d_exposure": _rows(self.factor_names, d_x[i]),
            })
            entries.append(e)
        return entries

    # -- portfolio construction ---------------------------------------------
    def construct_solve(self, solver: str, weights, *, lo=None, hi=None,
                        hedge_mask=None, hmax: float = 1.0,
                        eta: float | None = None, steps: int | None = None,
                        bucket: int | None = None) -> dict:
        """Run ONE construction solver over P request books (one batched
        solve at the padded bucket).  ``weights``: (P, K) exposure rows —
        min-vol / risk-parity use them as warm starts, hedge as the fixed
        base books.  Returns ``{"weights", "vols", "diag"}`` as host
        arrays trimmed to P rows (``diag``: kkt residual / rc spread /
        overlay).
        """
        if solver not in SOLVERS:
            raise ValueError(f"unknown solver {solver!r}; have {SOLVERS}")
        W = np.atleast_2d(np.asarray(weights, self.dtype))
        if W.ndim != 2 or W.shape[1] != self.K:
            raise ValueError(f"weights must be (P, {self.K}), got {W.shape}")
        P = W.shape[0]
        B = bucket_for(P) if bucket is None else int(bucket)
        if B < P:
            raise ValueError(f"bucket {B} < batch size {P}")
        cov = self._scen._cov

        def host(*outs):
            x, vol, diag = (o[:P].cpu().numpy() for o in outs)
            return {"weights": x, "vols": vol, "diag": diag}

        if solver == "hedge":
            xs0 = np.zeros((B, self.K), self.dtype)
            xs0[:P] = W
            mask = np.zeros((B, self.K), self.dtype)
            if hedge_mask is None:
                mask[:P] = 1.0
            else:
                mask[:P] = np.asarray(hedge_mask, self.dtype)
            xt, h, vol = hedge_batch(
                self._put(xs0), self._put(np.zeros((B, self.K))), cov,
                self._put(mask), self._scalar(hmax),
                self._scalar(HEDGE_ETA if eta is None else eta),
                HEDGE_STEPS if steps is None else int(steps))
            return host(xt, vol, h)

        # simplex solvers: warm-start from the request book's positive
        # part, blended 10% toward uniform — the multiplicative min-vol
        # update can never resurrect a coordinate that starts at exactly
        # zero, so copying the book verbatim would silently restrict the
        # solve to the book's support.  An all-zero (or all-short) book
        # starts uniform outright; pad lanes stay exactly zero.
        xs0 = np.zeros((B, self.K), self.dtype)
        pos = np.maximum(W, 0)
        sums = pos.sum(axis=1, keepdims=True)
        uniform = np.full((1, self.K), 1.0 / self.K, self.dtype)
        xs0[:P] = np.where(sums > 0,
                           0.9 * pos / np.maximum(sums, 1e-300)
                           + 0.1 * uniform,
                           uniform)
        if solver == "min_vol":
            lo_v = np.zeros(self.K) if lo is None else lo
            hi_v = np.ones(self.K) if hi is None else hi
            return host(*minvol_batch(
                self._put(xs0), cov, self._put(lo_v), self._put(hi_v),
                self._scalar(MINVOL_ETA if eta is None else eta),
                MINVOL_STEPS if steps is None else int(steps)))
        return host(*riskparity_batch(
            self._put(xs0), cov,
            self._scalar(RISKPARITY_ETA if eta is None else eta),
            RISKPARITY_STEPS if steps is None else int(steps)))


def stressed_psd(cov, thetas, dtype) -> np.ndarray:
    """(P,) bool: is each shock of ``thetas`` (P, 2K+2) on the base
    ``cov`` (K, K), pushed through the serving stress and the gated
    projection (:func:`~mfm_tpu_torch.scenario.kernel.psd_project`, on the
    tensors' device), PSD at compute dtype — its float64 minimum
    eigenvalue at or above ``-K * eps * lambda_max``?  The host check of
    reverse stress and of the sweep's refinement."""
    from mfm_tpu_torch.scenario.kernel import psd_project, stress_cov

    K = cov.shape[-1]
    t = thetas
    with torch.no_grad():
        cov_p, _, _ = psd_project(stress_cov(
            cov, t[:, :K], t[:, K:2 * K], t[:, 2 * K], t[:, 2 * K + 1]))
    lam = np.linalg.eigvalsh(cov_p.cpu().numpy().astype(np.float64))
    eps = float(np.finfo(dtype).eps)
    return lam[:, 0] >= -K * eps * np.maximum(lam[:, -1], 0.0)


def _num(v):
    return float(v) if np.isfinite(v) else None


def _rows(names, vals) -> dict:
    return {str(n): _num(v) for n, v in zip(names, vals)}
