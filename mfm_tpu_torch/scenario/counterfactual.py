"""Base-covariance resolvers for replay and counterfactual scenarios
(counterpart of ``mfm_tpu/scenario/counterfactual.py``).

Two of the spec kinds cannot be expressed as a covariance transform — they
change WHICH world the shock applies to:

- **Historical replay**: the base becomes the covariance the model had
  fitted through a named stretch of panel history.
- **Quarantine counterfactual**: the base becomes the served covariance
  of a REAL guarded re-run with chosen verdicts flipped — the actual
  ``RiskModel.update_guarded`` with its ``pre_reasons`` / ``heal_mask``
  operands set.  "Counterfactual equals a real re-run with flipped
  verdicts" is therefore true by construction, and
  tests/test_torch_scenario.py pins it bitwise.

Both resolve HOST-SIDE, per scenario, before the one batched call — the
kernel only ever sees (S, K, K) base covariances.  This module builds the
two injectables :class:`mfm_tpu_torch.scenario.engine.ScenarioEngine`
takes (``replay_lookup`` / ``counterfactual_fn``) from the artifacts the
port already produces: a pipeline result's per-date covariance series and
an appended slab + its pre-update checkpoint.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mfm_tpu_torch.data.artifacts import _numpy


def _clone(x):
    if torch.is_tensor(x):
        return x.clone()
    if isinstance(x, tuple):
        return tuple(_clone(v) for v in x)
    return x


def clone_state(state):
    """A ``RiskModelState`` with every tensor leaf (the Newey-West carry's
    included) cloned; the rest rides along.  A counterfactual re-runs
    against a copy, so nothing it does can reach the live serving
    state."""
    return dataclasses.replace(state, **{
        f.name: _clone(getattr(state, f.name))
        for f in dataclasses.fields(state)})


def make_replay_lookup(dates, covs, valid=None):
    """``(start, end) -> (K, K) | None`` over a per-date covariance series.

    ``dates``: the history's date labels (compared as normalized strings,
    the :func:`mfm_tpu_torch.pipeline.date_stamp` order).  ``covs``:
    (T, K, K) fitted covariances, numpy or a tensor (e.g. ``outputs.vr_cov``
    or the guard report's ``served_cov``).  ``valid``: optional (T,) bool
    (e.g. ``eigen_valid``) — invalid dates never resolve.  The window
    resolves to the LAST valid date inside it: the covariance fitted
    through that stretch, as host numpy.
    """
    from mfm_tpu_torch.pipeline import date_stamp

    labels = [date_stamp(d) for d in dates]
    covs = _numpy(covs)
    ok = (np.ones(len(labels), bool) if valid is None
          else _numpy(valid).astype(bool))
    if covs.ndim != 3 or covs.shape[0] != len(labels) or \
            ok.shape != (len(labels),):
        raise ValueError(f"need (T, K, K) covs + T dates (+ optional (T,) "
                         f"valid); got covs {covs.shape} over "
                         f"{len(labels)} dates")

    def lookup(start, end):
        start, end = date_stamp(start), date_stamp(end)
        hits = [i for i, d in enumerate(labels)
                if start <= d <= end and ok[i]]
        if not hits:
            return None
        return covs[hits[-1]]

    return lookup


def replay_lookup_from_result(result):
    """Replay resolver off a :class:`~mfm_tpu_torch.pipeline.
    RiskPipelineResult`: the guard report's ``served_cov`` series when the
    run was guarded (what was actually servable on each date), else the
    raw ``vr_cov`` gated on ``eigen_valid``."""
    if result.report is not None:
        return make_replay_lookup(
            result.arrays.dates, result.report.served_cov,
            valid=~_numpy(result.report.quarantined).astype(bool))
    return make_replay_lookup(
        result.arrays.dates, result.outputs.vr_cov,
        valid=result.outputs.eigen_valid)


def make_counterfactual_fn(model, state, dates):
    """``(flip_quarantine, flip_heal) -> (K, K)`` via a real guarded re-run.

    ``model``: the :class:`~mfm_tpu_torch.models.risk_model.RiskModel` over
    the appended slab.  ``state``: the checkpoint BEFORE that slab.
    ``dates``: the slab's date labels, in order.

    Each call re-runs ``update_guarded`` on a clone of the state with
    ``pre_reasons`` carrying :data:`~mfm_tpu_torch.serve.guard.
    REASON_FORCED` at the force-quarantined dates and ``heal_mask`` True
    at the force-healed ones, and returns the served covariance at the
    final slab date (host numpy) — exactly what that world would have
    handed the query layer.  Unknown flip dates raise ``ValueError`` (the
    engine rejects that scenario, batchmates unaffected).
    """
    from mfm_tpu_torch.pipeline import date_stamp
    from mfm_tpu_torch.serve.guard import REASON_FORCED

    labels = [date_stamp(d) for d in dates]
    if len(labels) != model.T:
        raise ValueError(f"{len(labels)} slab dates for a T={model.T} model")

    def counterfactual(flip_quarantine, flip_heal):
        fq = {date_stamp(d) for d in flip_quarantine}
        fh = {date_stamp(d) for d in flip_heal}
        unknown = sorted((fq | fh) - set(labels))
        if unknown:
            raise ValueError(f"counterfactual flips dates outside the "
                             f"slab: {unknown[:5]} (slab is "
                             f"{labels[0]}..{labels[-1]})")
        pre = np.zeros(len(labels), np.uint32)
        heal = np.zeros(len(labels), bool)
        for i, d in enumerate(labels):
            if d in fq:
                pre[i] = REASON_FORCED
            if d in fh:
                heal[i] = True
        _, report, _ = model.update_guarded(clone_state(state),
                                            pre_reasons=pre, heal_mask=heal)
        return _numpy(report.served_cov[-1])

    return counterfactual
