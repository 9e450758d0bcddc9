"""RiskModel — the port's equivalent of the reference's ``MFM`` class
(counterpart of ``mfm_tpu/models/risk_model.py``).

    rm = RiskModel(ret, cap, styles, industry, valid, n_industries=P)
    out = rm.run_fused()    # or stage-by-stage like the reference

Stages, each one batched call over the whole (T, N) panel:
  1. ``reg_by_time``            — constrained WLS of every date (``MFM.py:48-76``)
  2. ``newey_west_by_time``     — expanding EWMA recursion (``MFM.py:80-101``)
  3. ``eigen_risk_adj_by_time`` — batched Monte-Carlo eigen adjustment
                                  (``MFM.py:105-126``)
  4. ``vol_regime_adj_by_time`` — masked EWMA recursion (``MFM.py:130-167``)

The daily serving step: :meth:`RiskModel.init_state` fits a history and
returns a :class:`RiskModelState`; :meth:`RiskModel.update` appends a slab
of dates to it, bitwise the suffix of the full-history run;
:meth:`RiskModel.update_guarded` does the same behind the input guards of
``serve/guard.py``, quarantining bad dates and serving the last healthy
covariance in their place.

The model runs on the CUDA card unless ``device="cpu"`` is given; with no
CUDA device and no explicit CPU request it raises.  On the card the two
Jacobi eigh kernels carry stages 1 and 3; ``kernels=False`` swaps in their
plain PyTorch versions, for comparison only.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from mfm_tpu_torch._device import host_flags, on_device, resolve_device
from mfm_tpu_torch.config import RiskModelConfig
from mfm_tpu_torch.models.eigen import (
    auto_eigen_chunk,
    draw_bucket,
    eigen_carry_init,
    eigen_risk_adjust_by_time,
    eigen_risk_adjust_incremental,
    sim_sweeps_for,
    simulated_eigen_covs,
    simulated_eigen_draws,
)
from mfm_tpu_torch.models.newey_west import (
    newey_west_expanding,
    newey_west_expanding_resume,
)
from mfm_tpu_torch.models.vol_regime import (
    vol_regime_adjust_by_time,
    vol_regime_adjust_resume,
)
from mfm_tpu_torch.ops.xreg import _rowdot, regress_panel
from mfm_tpu_torch.serve.guard import GuardReport, guard_slab


class RiskModelOutputs(NamedTuple):
    factor_ret: torch.Tensor     # (T, K) [country | industries | styles]
    specific_ret: torch.Tensor   # (T, N), NaN outside the per-date universe
    r2: torch.Tensor             # (T,)
    nw_cov: torch.Tensor         # (T, K, K)
    nw_valid: torch.Tensor       # (T,)
    eigen_cov: torch.Tensor      # (T, K, K), NaN where invalid
    eigen_valid: torch.Tensor    # (T,)
    vr_cov: torch.Tensor         # (T, K, K)
    lamb: torch.Tensor           # (T,) volatility multiplier series


@dataclasses.dataclass
class RiskModelState:
    """The resumable checkpoint of the whole risk stack at some date T0.

    Holds the exact carries of the two recursive stages — the Newey-West
    ``(t, S, A, Z, Ps, hs, gs, Slags, xlags)`` tuple and the vol-regime
    ``(num, den)`` sums — the frozen eigen Monte-Carlo input (``sim_covs``
    and its declared ``sim_length``), and an identity ``stamp`` so a
    checkpoint refuses to resume under a model that would change the math.
    Because the carries are exact, :meth:`RiskModel.update` from this state
    is bitwise the corresponding suffix of a full-history run.

    ``eigen_batch_hint`` is the init-time T*M batch.  The reference pins
    its eigh solver dispatch to it; the port dispatches by device, so the
    field changes nothing here and is kept for the checkpoint format,
    which both packages share key for key (``data/artifacts.py``).
    """

    nw_carry: tuple
    vr_num: torch.Tensor
    vr_den: torch.Tensor
    sim_covs: torch.Tensor | None
    sim_length: int | None
    eigen_batch_hint: int
    stamp: tuple
    last_date: str | None = None
    #: degraded-mode serving leaves (all five together, None when the state
    #: was built without quarantine): the last healthy vol-regime
    #: covariance, its age in dates, the cumulative quarantined count, and
    #: the trailing-universe ring the collapse check medians over
    last_good_cov: torch.Tensor | None = None   # (K, K)
    staleness: torch.Tensor | None = None       # int32 scalar
    quarantine_count: torch.Tensor | None = None  # int32 scalar
    guard_ring: torch.Tensor | None = None      # (universe_window,)
    guard_ring_pos: torch.Tensor | None = None  # int32 scalar
    #: incremental-eigen carry (config.eigen_incremental; all four
    #: together, None otherwise, and sim_covs is None in that mode): the
    #: frozen per-column draw tensor and the exact raw prefix moments of the
    #: columns consumed so far.  sim_length then counts the dates served,
    #: the draw cursor's upper bound (bucket rollover, sweep tier).
    eig_draws: torch.Tensor | None = None       # (M, K, bucket)
    eig_R: torch.Tensor | None = None           # (M, K, K)
    eig_p: torch.Tensor | None = None           # (M, K)
    eig_n: torch.Tensor | None = None           # int32 scalar

    @property
    def t(self) -> int:
        """Number of dates folded into the state so far."""
        return int(self.nw_carry[0])

    @property
    def guarded(self) -> bool:
        """True when the state carries degraded-mode serving leaves."""
        return self.last_good_cov is not None


#: the fewest dates the regression runs (a shorter slab is padded with
#: copies of its last date): at 16 or more sums CUDA's reduction kernel
#: takes the thread block it takes for a long history
MIN_REGRESSION_DATES = 16
#: the fewest dates the eigen stage runs: at a batch of one, cuBLAS runs
#: other matmul kernels than at two or more
MIN_EIGEN_DATES = 2

_INJECTED = ("eigen_incremental=True derives its draws from config.seed "
             "(they are part of the resumable identity) — injected "
             "generator/sim_covs would break the bitwise-suffix contract")


@dataclasses.dataclass
class RiskModel:
    """Batched Barra-style risk model over a dense masked panel.

    Args mirror the reference's data contract, in dense form (tensors or
    numpy arrays; they are moved to ``device``):

      ret:      (T, N) next-period returns.
      cap:      (T, N) market caps.
      styles:   (T, N, Q) style exposures.
      industry: (T, N) int codes in [0, P), -1/invalid for missing.
      valid:    (T, N) bool universe mask.
      device:   None (the CUDA card) or an explicit device such as "cpu".
      kernels:  False runs the eigh kernels' plain versions on the card.
    """

    ret: torch.Tensor
    cap: torch.Tensor
    styles: torch.Tensor
    industry: torch.Tensor
    valid: torch.Tensor
    n_industries: int
    config: RiskModelConfig = dataclasses.field(default_factory=RiskModelConfig)
    device: str | torch.device | None = None
    kernels: bool = True

    def __post_init__(self):
        self.device = resolve_device(self.device)
        for f in ("ret", "cap", "styles", "industry", "valid"):
            setattr(self, f, on_device(getattr(self, f), self.device))
        self.valid = self.valid.to(torch.bool)
        self.T, self.N = self.ret.shape
        self.Q = self.styles.shape[-1]
        self.K = 1 + self.n_industries + self.Q

    # -- stage 1 -----------------------------------------------------------
    def reg_by_time(self):
        res = regress_panel(
            self.ret, self.cap, self.styles, self.industry, self.valid,
            n_industries=self.n_industries, kernels=self.kernels)
        return res.factor_ret, res.specific_ret, res.r2

    # -- stage 2 -----------------------------------------------------------
    def newey_west_by_time(self, factor_ret):
        return newey_west_expanding(
            factor_ret, q=self.config.nw_lags,
            half_life=self.config.nw_half_life, min_valid=self.K,
            method=self.config.nw_method)

    # -- stage 3 -----------------------------------------------------------
    def _sim_covs(self, generator, dtype):
        """(sim_covs, sim_length) drawn from ``generator`` (default: one on
        this model's device seeded with ``config.seed``)."""
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(self.config.seed)
        sim_len = self.config.eigen_sim_length or self.T
        return simulated_eigen_covs(generator, self.K, sim_len,
                                    self.config.eigen_n_sims, dtype=dtype,
                                    mc_dtype=self.config.eigen_mc_dtype
                                    ), sim_len

    def eigen_risk_adj_by_time(self, nw_cov, nw_valid, generator=None,
                               sim_covs=None, sim_length=None):
        # ``sim_length`` lets callers that inject sim_covs declare the draw
        # count behind them, enabling the automatic sweep cap; undeclared
        # (None) means the full sweep count
        if sim_covs is None:
            sim_covs, sim_length = self._sim_covs(generator, nw_cov.dtype)
        sim_covs = on_device(sim_covs, self.device, nw_cov.dtype)
        sweeps = self.config.eigen_sim_sweeps
        if sweeps == "auto":
            sweeps = None
        return eigen_risk_adjust_by_time(
            nw_cov, nw_valid, sim_covs, self.config.eigen_scale_coef,
            sim_sweeps=sweeps, sim_length=sim_length,
            chunk=self._resolve_eigen_chunk(sim_covs.shape[0],
                                            nw_cov.element_size()),
            kernels=self.kernels, mc_dtype=self.config.eigen_mc_dtype)

    def _resolve_eigen_chunk(self, n_sims: int, itemsize: int) -> int | None:
        """config.eigen_chunk -> a concrete date-chunk size (or None);
        "auto" sizes it from the device's free memory.  Under
        ``eigen_mc_dtype`` G is assembled in the Monte-Carlo dtype, so its
        itemsize (2 for bfloat16) sizes the chunk, as in the reference."""
        c = self.config.eigen_chunk
        if c == "auto":
            if self.config.eigen_mc_dtype is not None:
                itemsize = getattr(torch, self.config.eigen_mc_dtype).itemsize
            return auto_eigen_chunk(self.T, n_sims, self.K, itemsize,
                                    device=self.device)
        return c

    # -- incremental-eigen (config.eigen_incremental) helpers ---------------
    def _eigen_sweeps(self, count: int) -> int | None:
        """Jacobi sweep cap for the simulated eighs at ``count`` consumed
        draw columns (None: the solver default)."""
        sweeps = self.config.eigen_sim_sweeps
        if sweeps == "auto":
            return sim_sweeps_for(self.K, self.ret.dtype, count)
        return sweeps

    def _fresh_eigen_draws(self, count: int) -> torch.Tensor:
        """The (M, K, bucket(count)) per-column draw tensor on this model's
        device; prefix-stable, so a rollover regenerates every consumed
        column bitwise."""
        return simulated_eigen_draws(
            self.config.seed, self.K, draw_bucket(count),
            self.config.eigen_n_sims, dtype=self.ret.dtype,
            device=self.device, mc_dtype=self.config.eigen_mc_dtype)

    def _advance_eigen_host(self, state) -> tuple:
        """Incremental-eigen bookkeeping for one update: advance the date
        count by the slab length, roll the draw bucket over when the count
        outgrows it, resolve the sweep cap.  Returns ``(eig_draws,
        eigen_sweeps, sim_length)``; outside incremental mode the state's
        values pass through (sweeps None).  A state loaded from the
        reference carries the reference's draws; a rollover replaces them
        with the port's, whose columns differ from the consumed ones."""
        if not self.config.eigen_incremental:
            return state.eig_draws, None, state.sim_length
        count = state.sim_length + self.T
        eig_draws = state.eig_draws
        if count > eig_draws.shape[-1]:
            eig_draws = self._fresh_eigen_draws(count)
        return eig_draws, self._eigen_sweeps(count), count

    def _eigen_incremental(self, nw_cov, nw_valid, eig_draws, eig_carry,
                           eigen_sweeps, skip_mask=None):
        return eigen_risk_adjust_incremental(
            nw_cov, nw_valid, eig_draws, eig_carry,
            self.config.eigen_scale_coef, sim_sweeps=eigen_sweeps,
            chunk=self._resolve_eigen_chunk(eig_draws.shape[0],
                                            nw_cov.element_size()),
            skip_mask=skip_mask, kernels=self.kernels,
            mc_dtype=self.config.eigen_mc_dtype)

    # -- stage 4 -----------------------------------------------------------
    def vol_regime_adj_by_time(self, factor_ret, eigen_cov, eigen_valid):
        return vol_regime_adjust_by_time(
            factor_ret, eigen_cov, eigen_valid,
            half_life=self.config.vol_regime_half_life)

    # -- full pipeline ------------------------------------------------------
    def _history_eigen(self, generator, sim_covs, sim_length) -> dict:
        """The eigen stage's input for a run over this model's whole
        history, as keyword arguments of :meth:`_run_carried`.  In
        incremental mode: the fresh draws of ``config.seed``, an empty
        moment carry and the sweep cap (injected draws are refused).
        Otherwise ``sim_covs`` on this device, drawn from ``generator``
        (default: ``config.seed``) when not given."""
        if self.config.eigen_incremental:
            if generator is not None or sim_covs is not None:
                raise ValueError(_INJECTED)
            return dict(
                sim_covs=None, sim_length=self.T,
                eig_draws=self._fresh_eigen_draws(self.T),
                eig_carry=eigen_carry_init(self.config.eigen_n_sims, self.K,
                                           self.ret.dtype, self.device),
                eigen_sweeps=self._eigen_sweeps(self.T))
        if sim_covs is None:
            sim_covs, sim_length = self._sim_covs(generator, self.ret.dtype)
        return dict(sim_covs=on_device(sim_covs, self.device, self.ret.dtype),
                    sim_length=sim_length)

    def run(self, generator=None, sim_covs=None,
            sim_length=None) -> RiskModelOutputs:
        """The whole four-stage pipeline over this model's history: the
        outputs of :meth:`init_state`, without the state."""
        return self._run_carried(
            **self._history_eigen(generator, sim_covs, sim_length))[0]

    def run_fused(self, generator=None, sim_covs=None,
                  sim_length=None) -> RiskModelOutputs:
        """:meth:`run`.  The reference fuses the stages into one XLA
        program, which eager PyTorch has no need of."""
        return self.run(generator, sim_covs, sim_length)

    # -- the daily serving step ----------------------------------------------
    def _run_carried(self, sim_covs, sim_length, nw_carry=None, vr_carry=None,
                     skip_mask=None, eig_draws=None, eig_carry=None,
                     eigen_sweeps=None):
        """The four stages, with Newey-West, vol-regime (and the
        incremental eigen) through their resumable forms, so the exact
        carries come out beside the outputs: :meth:`run`, :meth:`init_state`
        and the updates all go through here.  ``None`` carries start the
        history; a previous call's carries continue it, bitwise.
        ``skip_mask`` ((T,) bool, None = no guards) excises quarantined
        dates from every recursion and forces their ``nw_valid`` False.
        Returns ``(outputs, nw_carry, vr_carry, eig_carry)``, the last None
        outside incremental mode.

        A short slab runs the per-date stages on copies of its last date,
        dropped afterwards, so that each of its dates runs the same kernels
        as in a long history (``chip_smoke.py``, phase
        ``serve_bitwise_ops``, holds each op to that on the card).  The
        regression pads to :data:`MIN_REGRESSION_DATES` dates: CUDA's
        reduction kernel sizes its thread block by the number of sums, and
        below 16 sums a row's sum over the N stocks is split across more
        threads, in another order.  The eigen stage pads to
        :data:`MIN_EIGEN_DATES`: at a batch of one, cuBLAS runs other
        matmul kernels (the eigen rebuild).  The copies are marked skipped
        in the incremental eigen, so they consume no draw.
        """
        T = self.T

        def pad(a, rows):
            if T >= rows or T == 0:
                return a
            return torch.cat([a, a[-1:].expand((rows - T,) + a.shape[1:])])

        res = regress_panel(
            *(pad(a, MIN_REGRESSION_DATES) for a in (
                self.ret, self.cap, self.styles, self.industry, self.valid)),
            n_industries=self.n_industries, kernels=self.kernels)
        factor_ret, specific_ret, r2 = (
            res.factor_ret[:T], res.specific_ret[:T], res.r2[:T])
        nw_cov, nw_valid, nw_carry_out = newey_west_expanding_resume(
            factor_ret, q=self.config.nw_lags,
            half_life=self.config.nw_half_life, min_valid=self.K,
            carry=nw_carry, skip_mask=skip_mask)
        eig_carry_out = None
        nw_cov_e, nw_valid_e = (pad(nw_cov, MIN_EIGEN_DATES),
                                pad(nw_valid, MIN_EIGEN_DATES))
        if self.config.eigen_incremental:
            skip = host_flags(skip_mask, T) + [True] * (len(nw_cov_e) - T)
            eigen_cov, eigen_valid, eig_carry_out = self._eigen_incremental(
                nw_cov_e, nw_valid_e, eig_draws, eig_carry, eigen_sweeps,
                skip_mask=skip)
        else:
            eigen_cov, eigen_valid = self.eigen_risk_adj_by_time(
                nw_cov_e, nw_valid_e, sim_covs=sim_covs,
                sim_length=sim_length)
        eigen_cov, eigen_valid = eigen_cov[:T], eigen_valid[:T]
        vr_cov, lamb, vr_carry_out = vol_regime_adjust_resume(
            factor_ret, eigen_cov, eigen_valid,
            half_life=self.config.vol_regime_half_life, carry=vr_carry,
            skip_mask=skip_mask)
        outputs = RiskModelOutputs(
            factor_ret, specific_ret, r2,
            nw_cov, nw_valid, eigen_cov, eigen_valid, vr_cov, lamb)
        return outputs, nw_carry_out, vr_carry_out, eig_carry_out

    def _stamp(self) -> tuple:
        """Identity of (shape, dtype, math config) a checkpoint must match:
        the reference's tuple, dtype by its numpy name."""
        return (self.n_industries, self.Q, self.N,
                str(self.ret.dtype).removeprefix("torch."),
                self.config.identity())

    def _require_scan_method(self, what: str):
        if self.config.nw_method != "scan":
            raise ValueError(
                f"{what} requires nw_method='scan' (the associative form has "
                f"no resumable carry); got {self.config.nw_method!r}")

    def _require_stamp(self, state: RiskModelState):
        expect = self._stamp()
        if state.stamp != expect:
            raise ValueError(
                f"RiskModelState stamp mismatch: checkpoint carries "
                f"{state.stamp}, this model is {expect} — refusing to resume "
                f"under different shapes/dtype/math config")

    def init_state(self, generator=None, sim_covs=None, sim_length=None,
                   last_date: str | None = None):
        """Full-history run that also returns the resumable checkpoint.

        Returns ``(outputs, state)``: the :class:`RiskModelOutputs` of
        :meth:`run_fused` and the :class:`RiskModelState` from which
        :meth:`update` appends further dates at a cost independent of the
        history already folded in.
        """
        self._require_scan_method("init_state")
        eig = self._history_eigen(generator, sim_covs, sim_length)
        outputs, nw_carry, (vr_num, vr_den), eig_carry = self._run_carried(
            **eig)
        guard = (self._seed_guard_state(outputs)
                 if self.config.quarantine.enabled else {})
        eig_draws = eig.get("eig_draws")
        M = (eig["sim_covs"] if eig_draws is None else eig_draws).shape[0]
        state = RiskModelState(
            nw_carry, vr_num, vr_den, eig["sim_covs"],
            sim_length=eig["sim_length"], eigen_batch_hint=self.T * M,
            stamp=self._stamp(), last_date=last_date, eig_draws=eig_draws,
            **self._eig_fields(eig_carry), **guard)
        return outputs, state

    def _seed_guard_state(self, outputs) -> dict:
        """Degraded-mode leaves for a freshly fitted history, computed on
        the host (the history is trusted; guards protect the appended
        dates).  The ring takes the last ``universe_window`` per-date
        universe sizes; the last-good covariance is the final eigen-valid
        date's adjusted covariance."""
        pol = self.config.quarantine
        counts = self.valid.sum(dim=1).cpu().numpy().astype(np.float64)
        vr = outputs.vr_cov.cpu().numpy()
        ev = outputs.eigen_valid.cpu().numpy()
        W = pol.universe_window
        ring = np.full((W,), np.nan, vr.dtype)
        tail = counts[-W:]
        ring[: len(tail)] = tail.astype(vr.dtype)
        good = np.nonzero(ev)[0]
        if good.size:
            last_good = vr[good[-1]].copy()
            staleness = len(ev) - 1 - good[-1]
        else:
            last_good = np.full(vr.shape[1:], np.nan, vr.dtype)
            staleness = len(ev)
        i32 = lambda v: torch.tensor(int(v), dtype=torch.int32,
                                     device=self.device)
        return dict(
            last_good_cov=torch.from_numpy(last_good).to(self.device),
            staleness=i32(staleness), quarantine_count=i32(0),
            guard_ring=torch.from_numpy(ring).to(self.device),
            guard_ring_pos=i32(len(tail) % W))

    def update(self, state: RiskModelState, last_date: str | None = None):
        """Append this model's panel — the new date(s) only — to ``state``.

        The instance's (T, N) panels are the appended slab; ``state`` comes
        from :meth:`init_state` or a previous update.  Returns ``(outputs,
        new_state)``, ``outputs`` over the slab dates only, bitwise equal to
        the corresponding suffix of a full-history run over the
        concatenated panel.  ``state`` is not written to and stays usable.
        An unguarded update trusts the slab: degraded-mode leaves ride
        along unchanged (:meth:`update_guarded` maintains them).
        """
        self._require_scan_method("update")
        self._require_stamp(state)
        eig_draws, sweeps, count = self._advance_eigen_host(state)
        outputs, nw_carry, (vr_num, vr_den), eig_carry = self._run_carried(
            state.sim_covs, state.sim_length, nw_carry=state.nw_carry,
            vr_carry=(state.vr_num, state.vr_den), eig_draws=eig_draws,
            eig_carry=self._eig_carry(state), eigen_sweeps=sweeps)
        new_state = dataclasses.replace(
            state, nw_carry=nw_carry, vr_num=vr_num, vr_den=vr_den,
            sim_length=count,
            last_date=state.last_date if last_date is None else last_date,
            eig_draws=eig_draws, **self._eig_fields(eig_carry))
        return outputs, new_state

    def update_guarded(self, state: RiskModelState,
                       last_date: str | None = None, pre_reasons=None,
                       heal_mask=None):
        """:meth:`update` behind the serving guards (degraded mode).

        Health-checks every slab date (serve/guard.py), excises quarantined
        dates from the Newey-West, vol-regime and incremental-eigen carries
        (the carry after (good, BAD, good) equals the carry after (good,
        good) bitwise), and maintains the degraded-mode leaves: the last
        healthy covariance, its staleness, the cumulative quarantine count
        and the trailing-universe ring.

        Returns ``(outputs, report, new_state)``: ``outputs`` are the raw
        slab outputs (quarantined dates carry their discarded candidates,
        ``nw_valid``/``eigen_valid`` False there); ``report`` is the
        :class:`GuardReport` whose ``served_cov`` is what a reader should
        get.  ``pre_reasons``: optional (T,) host-side reasons
        (:func:`mfm_tpu_torch.serve.guard.host_date_reasons`) OR-ed in.
        ``heal_mask``: optional (T,) bool forcing the verdict HEALTHY at
        the marked dates.  Requires a state built under a quarantine-enabled
        config.  ``state`` is not written to.
        """
        self._require_scan_method("update_guarded")
        if not self.config.quarantine.enabled:
            raise ValueError(
                "update_guarded requires config.quarantine.enabled=True "
                "(QuarantinePolicy on RiskModelConfig)")
        self._require_stamp(state)
        if not state.guarded:
            raise ValueError(
                "state has no degraded-mode leaves — it was initialized "
                "without quarantine; re-run init_state under a "
                "quarantine-enabled config (the guards need the trailing-"
                "universe ring and last-good covariance seeded at init)")
        quarantined, reasons, ring, ring_pos = guard_slab(
            self.ret, self.cap, self.valid, state.guard_ring,
            state.guard_ring_pos, self.config.quarantine,
            pre_reasons=pre_reasons, heal_mask=heal_mask)
        skip = quarantined.tolist()  # the one read of the verdicts
        eig_draws, sweeps, count = self._advance_eigen_host(state)
        outputs, nw_carry, (vr_num, vr_den), eig_carry = self._run_carried(
            state.sim_covs, state.sim_length, nw_carry=state.nw_carry,
            vr_carry=(state.vr_num, state.vr_den), skip_mask=skip,
            eig_draws=eig_draws, eig_carry=self._eig_carry(state),
            eigen_sweeps=sweeps)
        last_good, staleness, served, stale_series = _serve_degraded(
            outputs.vr_cov, outputs.eigen_valid, skip, state.last_good_cov,
            state.staleness)
        report = GuardReport(quarantined, reasons, stale_series, served)
        new_state = dataclasses.replace(
            state, nw_carry=nw_carry, vr_num=vr_num, vr_den=vr_den,
            sim_length=count,
            last_date=state.last_date if last_date is None else last_date,
            last_good_cov=last_good, staleness=staleness,
            quarantine_count=state.quarantine_count + sum(skip),
            guard_ring=ring, guard_ring_pos=ring_pos, eig_draws=eig_draws,
            **self._eig_fields(eig_carry))
        return outputs, report, new_state

    @staticmethod
    def _eig_carry(state):
        return None if state.eig_R is None else (state.eig_R, state.eig_p,
                                                 state.eig_n)

    @staticmethod
    def _eig_fields(eig_carry) -> dict:
        eig_R, eig_p, eig_n = eig_carry or (None, None, None)
        return dict(eig_R=eig_R, eig_p=eig_p, eig_n=eig_n)


def _serve_degraded(vr_cov, eigen_valid, quarantined, last_good, staleness):
    """Thread (last_good, staleness) through the slab dates in order.  A
    healthy eigen-valid date refreshes last_good and zeroes the age; a
    quarantined date is served last_good at age + 1; healthy dates are
    served their own vr_cov, bitwise untouched.  ``quarantined`` is the
    host list of verdicts; ``eigen_valid`` stays on the device."""
    served = torch.empty_like(vr_cov)
    stale = []
    age = staleness
    for i, q in enumerate(quarantined):
        if q:
            served[i] = last_good
            age = age + 1
            stale.append(age)
        else:
            served[i] = vr_cov[i]
            stale.append(torch.zeros_like(age))
            ev = eigen_valid[i]
            last_good = torch.where(ev, vr_cov[i], last_good)
            age = torch.where(ev, torch.zeros_like(age), age + 1)
    stale = (torch.stack(stale) if stale else
             torch.zeros((0,), dtype=torch.int32, device=vr_cov.device))
    return last_good, age, served, stale


class _MatVec(torch.autograd.Function):
    """``A x`` per row as ``_rowdot(A, x[..., None, :])``, with a backward
    whose sums are contiguous innermost ones too: autograd's own would sum
    ``x``'s gradient over the rows of ``A``, an outer dimension whose
    summation order moves with the batch size on the card."""

    @staticmethod
    def forward(ctx, A, x):
        ctx.save_for_backward(A, x)
        return _rowdot(A, x[..., None, :])

    @staticmethod
    def backward(ctx, g):
        A, x = ctx.saved_tensors
        gA = gx = None
        if ctx.needs_input_grad[0]:
            gA = (g[..., :, None] * x[..., None, :]).sum_to_size(A.shape)
        if ctx.needs_input_grad[1]:
            gx = _rowdot(A.transpose(-1, -2).contiguous(),
                         g[..., None, :]).sum_to_size(x.shape)
        return gA, gx


def portfolio_vol(cov, x, w=None, specific_var=None):
    """Predicted portfolio volatility ``sqrt(x'Fx [+ sum(w^2 s^2)])``
    (``mfm_tpu/models/risk_model.py:766``): ``x`` the (..., K) factor
    exposures, ``cov`` the (..., K, K) factor covariance, and the optional
    specific leg from (..., N) holdings ``w`` against (..., N) specific
    variances.  Leading dimensions broadcast, so one call prices every
    book against every covariance.

    Both products are elementwise products and contiguous innermost sums
    of K terms (``ops/xreg.py::_rowdot``), not ``x @ (cov @ x)``: a
    batched matrix product on the card changes a row's bits with the
    number of rows, and the scenario engine and the sweep hold a book's
    vol bitwise whether it is priced alone or beside others.  Its
    gradient keeps that property (:class:`_MatVec`): the grad subsystem
    differentiates this function.
    """
    var = _rowdot(x, _MatVec.apply(cov, x))
    if w is not None and specific_var is not None:
        var = var + _rowdot(w * w, specific_var)
    return torch.sqrt(var)
