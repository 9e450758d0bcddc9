"""ScenarioEngine — run S what-if worlds against one checkpoint, batched
(counterpart of ``mfm_tpu/scenario/engine.py``).

Host-side orchestration around :func:`mfm_tpu_torch.scenario.kernel.
scenario_batch` (validation, base-cov resolution, obs recording are host
work).  The run protocol:

1. **Admit** every spec through :func:`mfm_tpu_torch.scenario.spec.
   validate_spec` — a poisoned spec (NaN shock, corr_beta past the -1
   pole, unknown factor) is rejected PER-SCENARIO and its lane becomes a
   passthrough, so batchmates' bytes are untouched.
2. **Resolve** each admissible spec's base covariance host-side: today's
   served matrix by default, a historical window's fitted matrix for
   replay specs, a real guarded re-run with flipped verdicts for
   quarantine counterfactuals (``replay_lookup`` / ``counterfactual_fn``
   injectables — :mod:`mfm_tpu_torch.scenario.counterfactual` builds
   both).
3. **Batch** all lanes into the geometric S-bucket (serve/query.py's
   ladder), pad with passthrough lanes, and run the batch on the engine's
   device (the card unless ``device="cpu"``) in one call.
4. **Report**: per-scenario :class:`ScenarioResult` (shocked covariance,
   vol deltas, PSD-projection flag) + obs counters/histograms;
   :mod:`mfm_tpu_torch.scenario.manifest` persists a batch.

Bitwise contracts (tests/test_torch_scenario.py, ``chip_smoke.py`` phase
``scenario_engine``): the identity spec returns the base covariance
byte-for-byte, and a batch of S equals S single runs — the kernel is
lane-independent and the bucket padding is passthrough lanes, never math.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from mfm_tpu_torch._device import resolve_device
from mfm_tpu_torch.data.artifacts import _numpy
from mfm_tpu_torch.obs import instrument as _obs
from mfm_tpu_torch.scenario.kernel import scenario_batch
from mfm_tpu_torch.scenario.spec import ScenarioSpec, validate_spec
from mfm_tpu_torch.serve.query import bucket_for
from mfm_tpu_torch.utils import contracts


@dataclasses.dataclass(frozen=True)
class ScenarioResult:
    """One scenario's answer inside a batch.

    ``status`` is ``"ok"`` or ``"rejected"`` (``problems`` says why; a
    rejected lane computes nothing and contaminates nothing).  For ok
    lanes: ``cov`` is the shocked (K, K) covariance, ``factor_vol`` /
    ``base_factor_vol`` the per-factor vols after/before (their
    difference is the manifest's vol-delta block), ``psd_projected``
    whether the gated projection fired, ``min_eig_stressed`` the smallest
    eigenvalue BEFORE projection.  Arrays are host numpy.
    """

    spec: ScenarioSpec
    status: str
    problems: tuple = ()
    cov: np.ndarray | None = None
    base_factor_vol: np.ndarray | None = None
    factor_vol: np.ndarray | None = None
    psd_projected: bool = False
    min_eig_stressed: float = 0.0

    @property
    def ok(self) -> bool:
        return self.status == "ok"

    def vol_delta(self) -> np.ndarray | None:
        """Per-factor vol change (after - before); None when rejected."""
        if not self.ok:
            return None
        return self.factor_vol - self.base_factor_vol


class ScenarioEngine:
    """Batched scenario runs against one served covariance.

    Args:
      cov: (K, K) baseline served covariance (e.g. ``state.last_good_cov``
        — what the identity scenario returns bitwise), numpy or a tensor.
      factor_names: K names defining the shock-key space (defaults to
        ``f0..f{K-1}``; unknown factors in a spec reject that spec).
      staleness: dates since ``cov`` was fit (rides into manifests).
      dtype: compute dtype (defaults to ``cov``'s).
      replay_lookup: optional ``(start, end) -> (K, K) | None`` resolving
        a historical window to its fitted covariance; ``None`` rejects
        replay specs as unsupported.
      counterfactual_fn: optional ``(flip_quarantine, flip_heal) -> (K, K)``
        running the REAL guarded update with flipped verdicts; ``None``
        rejects counterfactual specs as unsupported.
      device: None for the CUDA card (raises without one), or e.g. "cpu".
    """

    def __init__(self, cov, *, factor_names=None, staleness: int = 0,
                 dtype=None, replay_lookup=None, counterfactual_fn=None,
                 device=None):
        cov = _numpy(cov)
        if cov.ndim != 2 or cov.shape[0] != cov.shape[1]:
            raise ValueError(f"cov must be (K, K), got {cov.shape}")
        if not np.isfinite(cov).all():
            raise ValueError("baseline covariance contains non-finite "
                             "entries — refuse to build a scenario engine "
                             "on it")
        self.device = resolve_device(device)
        self.dtype = np.dtype(dtype) if dtype is not None else cov.dtype
        self.K = int(cov.shape[0])
        self.cov = cov.astype(self.dtype)
        self._cov = self._put(self.cov)
        self.factor_names = ([f"f{i}" for i in range(self.K)]
                             if factor_names is None
                             else list(map(str, factor_names)))
        if len(self.factor_names) != self.K:
            raise ValueError(f"{len(self.factor_names)} factor names for "
                             f"K={self.K}")
        self.factor_index = {n: i for i, n in enumerate(self.factor_names)}
        self.staleness = int(staleness)
        self.replay_lookup = replay_lookup
        self.counterfactual_fn = counterfactual_fn

    def _put(self, a) -> torch.Tensor:
        """A host array as an owning tensor on the engine's device."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    @classmethod
    def from_risk_state(cls, state, meta=None, dtype=None,
                        replay_lookup=None, counterfactual_fn=None,
                        device=None):
        """Engine over a guarded ``RiskModelState`` checkpoint's served
        covariance — the same contract as ``QueryEngine.from_risk_state``
        (factor names off the checkpoint meta, refuse unguarded states)."""
        if not getattr(state, "guarded", False):
            raise ValueError(
                "state has no served covariance — scenarios shock the "
                "guarded checkpoint's last_good_cov; re-run the pipeline "
                "with quarantine enabled")
        names = None
        if meta and "style_names" in meta and "industry_codes" in meta:
            names = (["country"] + [str(c) for c in meta["industry_codes"]]
                     + [str(s) for s in meta["style_names"]])
        cov = _numpy(state.last_good_cov)
        if names is not None and len(names) != cov.shape[0]:
            names = None
        return cls(cov, factor_names=names,
                   staleness=int(_numpy(state.staleness)), dtype=dtype,
                   replay_lookup=replay_lookup,
                   counterfactual_fn=counterfactual_fn, device=device)

    # -- per-spec admission / resolution -------------------------------------
    def _resolve(self, spec: ScenarioSpec):
        """One spec -> (base_cov | None, problems).  Everything host-side;
        a problem list means the lane is rejected (passthrough)."""
        problems = list(validate_spec(spec, self.factor_names))
        if problems:
            return None, problems
        wants_replay = spec.replay is not None
        wants_cf = bool(spec.flip_quarantine or spec.flip_heal)
        if wants_replay and wants_cf:
            return None, ["replay and counterfactual compose ambiguously "
                          "— split into two scenarios"]
        base = self.cov
        if wants_replay:
            if self.replay_lookup is None:
                return None, ["replay spec but the engine has no history "
                              "(build it with replay_lookup)"]
            try:
                base = self.replay_lookup(*spec.replay)
            except Exception as e:   # noqa: BLE001 — reject, don't poison
                return None, [f"replay resolution failed: {e}"]
            if base is None:
                return None, [f"replay window {spec.replay!r} not in the "
                              "engine's history"]
        elif wants_cf:
            if self.counterfactual_fn is None:
                return None, ["counterfactual spec but the engine has no "
                              "slab context (build it with "
                              "counterfactual_fn)"]
            try:
                base = self.counterfactual_fn(spec.flip_quarantine,
                                              spec.flip_heal)
            except Exception as e:   # noqa: BLE001 — reject, don't poison
                return None, [f"counterfactual re-run failed: {e}"]
        if base is not self.cov:
            base = np.asarray(_numpy(base), self.dtype)
        if base.shape != (self.K, self.K):
            return None, [f"resolved base covariance is {base.shape}, "
                          f"need ({self.K}, {self.K})"]
        if not np.isfinite(base).all():
            return None, ["resolved base covariance has non-finite entries"]
        return base, []

    def _shock_vectors(self, spec: ScenarioSpec):
        shift = np.zeros(self.K, self.dtype)
        scale = np.ones(self.K, self.dtype)
        for f, v in spec.shift:
            shift[self.factor_index[f]] += v
        for f, v in spec.scale:
            scale[self.factor_index[f]] *= v
        return shift, scale

    # -- the batched run -----------------------------------------------------
    def run(self, specs, bucket: int | None = None) -> list:
        """Run S scenarios in one batched call on the engine's device.

        ``specs``: iterable of :class:`ScenarioSpec` (names must be unique
        — the manifest and the serve-side scenario table key on them).
        ``bucket`` pins the padded batch shape (tests / steady-state
        loops); default is :func:`bucket_for` of S.  Returns a list of
        :class:`ScenarioResult` in input order.
        """
        specs = list(specs)
        S = len(specs)
        if S < 1:
            raise ValueError("need at least one scenario spec")
        names = [s.name for s in specs]
        if len(set(names)) != S:
            dup = sorted({n for n in names if names.count(n) > 1})
            raise ValueError(f"duplicate scenario names in batch: {dup[:5]}")
        B = bucket_for(S) if bucket is None else int(bucket)
        if B < S:
            raise ValueError(f"bucket {B} < batch size {S}")

        shift = np.zeros((B, self.K), self.dtype)
        scale = np.ones((B, self.K), self.dtype)
        vol_mult = np.ones((B,), self.dtype)
        corr_beta = np.zeros((B,), self.dtype)
        passthrough = np.ones((B,), bool)   # pad lanes stay passthrough

        lane_problems: list = []
        base_rows: dict = {}   # lane -> base override (replay / cf lanes)
        for i, spec in enumerate(specs):
            cov_i, problems = self._resolve(spec)
            lane_problems.append(tuple(problems))
            if problems:
                continue   # rejected: the lane stays a passthrough no-op
            if cov_i is not self.cov:
                base_rows[i] = cov_i
            shift[i], scale[i] = self._shock_vectors(spec)
            vol_mult[i] = spec.vol_mult
            corr_beta[i] = spec.corr_beta
            # identity TRANSFORM lanes pass the base through bitwise (the
            # correctness anchor); shocked lanes compute
            passthrough[i] = spec.shocks_identity

        # the common batch shares self.cov on every lane: an expanded view
        # of the one device copy; replay/counterfactual lanes densify it
        base = np.broadcast_to(self.cov, (B, self.K, self.K))
        if base_rows:
            base = base.copy()
            for i, cov_i in base_rows.items():
                base[i] = cov_i
            base_t = self._put(base)
        else:
            base_t = self._cov.expand(B, self.K, self.K)

        base_vols = np.sqrt(np.maximum(
            np.diagonal(base[:S], axis1=1, axis2=2), 0)).astype(self.dtype)
        t0 = time.perf_counter()
        ops = (base_t, self._put(shift), self._put(scale),
               self._put(vol_mult), self._put(corr_beta),
               self._put(passthrough))
        if contracts.listening():
            contracts.note_bucket(contracts.SCENARIO_BATCH, *ops)
        covs, projected, min_eig = scenario_batch(*ops)
        # crop to the true S before the host copy (the pad never ships);
        # the copies end the device work, so the histogram measures
        # compute, not enqueue
        covs = covs[:S].cpu().numpy()
        projected = projected[:S].cpu().numpy()
        min_eig = min_eig[:S].cpu().numpy()
        dt = time.perf_counter() - t0

        results = []
        n_ok = n_rejected = 0
        for i, spec in enumerate(specs):
            if lane_problems[i]:
                n_rejected += 1
                results.append(ScenarioResult(
                    spec=spec, status="rejected",
                    problems=lane_problems[i]))
                continue
            n_ok += 1
            cov_i = covs[i]
            results.append(ScenarioResult(
                spec=spec, status="ok",
                cov=cov_i,
                base_factor_vol=base_vols[i],
                factor_vol=np.sqrt(np.maximum(np.diagonal(cov_i), 0)),
                psd_projected=bool(projected[i]),
                min_eig_stressed=float(min_eig[i]),
            ))
        _obs.record_scenario_batch(S, dt)
        if n_ok:
            _obs.record_scenario_outcome("ok", n_ok)
        if n_rejected:
            _obs.record_scenario_outcome("rejected", n_rejected)
        n_proj = int(projected.sum())
        if n_proj:
            _obs.record_psd_projections(n_proj)
        return results

    # -- serve-side sugar ----------------------------------------------------
    def query_engines(self, results, template) -> dict:
        """``{scenario_name: QueryEngine}`` over a batch's ok results —
        the table ``QueryServer`` answers scenario-tagged requests from.
        ``template`` is the plain engine to clone (exposures, benchmarks,
        dtype and device ride along; only the covariance changes)."""
        return {r.spec.name: template.with_cov(r.cov,
                                               scenario_id=r.spec.name)
                for r in results if r.ok}
