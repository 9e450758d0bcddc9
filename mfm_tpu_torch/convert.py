"""Carry a reference run's state across to the port, and results back.

The risk model has no trained weights; what both packages must share to
compute the same thing is the configuration, the panel, the Monte-Carlo
``sim_covs`` (M, K, K) — the random draws cannot match between
``jax.random`` and ``torch.Generator``, so a comparison injects them — and,
for the serving step, the resumable state.

- :func:`config_from_reference` builds the port's ``RiskModelConfig`` from
  the reference config's fields as a plain dict (``dataclasses.asdict``),
  :func:`factor_config_from_reference` its ``FactorConfig`` and
  :func:`pipeline_config_from_reference` its ``PipelineConfig``;
- :func:`to_port` turns the numpy panel and ``sim_covs`` into tensors;
- :func:`state_from_reference` loads a checkpoint the reference wrote;
- :func:`outputs_to_numpy`, :func:`state_to_numpy` and
  :func:`report_to_numpy` bring outputs, states and guard reports back to
  numpy, in the reference's dtypes and npz keys;
- :func:`budget_check` holds two sets of outputs against the per-stage
  float32 budgets of ``tools/parity_budget.json``.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from mfm_tpu_torch.config import (
    FactorConfig,
    MeshConfig,
    PipelineConfig,
    QuarantinePolicy,
    RiskModelConfig,
    RollingSpec,
)
from mfm_tpu_torch.data.artifacts import load_risk_state, state_arrays

_PANEL = ("ret", "cap", "styles", "industry", "valid")


def config_from_reference(fields: Mapping) -> RiskModelConfig:
    """The port's config from the reference ``RiskModelConfig``'s fields.

    The ``quarantine`` policy's dict becomes a :class:`QuarantinePolicy`;
    a ``mesh`` entry must make a :class:`MeshConfig` and then goes to the
    pipeline's config (:func:`pipeline_config_from_reference`): the risk
    model takes its mesh from the ambient one (``parallel/mesh.py``
    ``use_mesh``); unknown fields raise.
    """
    fields = dict(fields)
    quarantine = fields.pop("quarantine", None)
    if quarantine is not None:
        fields["quarantine"] = (quarantine if isinstance(
            quarantine, QuarantinePolicy) else QuarantinePolicy(**quarantine))
    mesh = fields.pop("mesh", None)
    if mesh is not None and not isinstance(mesh, MeshConfig):
        MeshConfig(**mesh)
    known = {f.name for f in dataclasses.fields(RiskModelConfig)}
    unknown = sorted(set(fields) - known)
    if unknown:
        raise ValueError(f"fields unknown to the port's RiskModelConfig: {unknown}")
    return RiskModelConfig(**fields)


def _tuples(x):
    """Lists (as a JSON round trip leaves them) back to the config's
    nested tuples."""
    return tuple(_tuples(v) for v in x) if isinstance(x, (list, tuple)) else x


def factor_config_from_reference(fields: Mapping) -> FactorConfig:
    """The port's ``FactorConfig`` from the reference ``FactorConfig``'s
    fields as a plain dict: each rolling spec's dict becomes a
    :class:`RollingSpec`, sequences become the config's tuples; unknown
    fields raise."""
    known = {f.name: f for f in dataclasses.fields(FactorConfig)}
    unknown = sorted(set(fields) - set(known))
    if unknown:
        raise ValueError(f"fields unknown to the port's FactorConfig: {unknown}")
    out = {}
    for name, v in fields.items():
        if isinstance(v, Mapping):
            v = RollingSpec(**v)
        out[name] = _tuples(v)
    return FactorConfig(**out)


def pipeline_config_from_reference(fields: Mapping) -> PipelineConfig:
    """The port's ``PipelineConfig`` from the reference ``PipelineConfig``'s
    fields as a plain dict: ``factors`` through
    :func:`factor_config_from_reference`, ``risk`` through
    :func:`config_from_reference`, ``mesh`` (any shard counts),
    ``dtype``, ``block`` and ``rolling_impl``; unknown fields raise."""
    fields = dict(fields)
    unknown = sorted(set(fields) - {f.name for f in
                                    dataclasses.fields(PipelineConfig)})
    if unknown:
        raise ValueError(f"fields unknown to the port's PipelineConfig: {unknown}")
    factors = fields.pop("factors", None)
    if factors is not None and not isinstance(factors, FactorConfig):
        fields["factors"] = factor_config_from_reference(factors)
    risk = fields.pop("risk", None)
    if risk is not None and not isinstance(risk, RiskModelConfig):
        fields["risk"] = config_from_reference(risk)
    mesh = fields.pop("mesh", None)
    if mesh is not None:
        fields["mesh"] = (mesh if isinstance(mesh, MeshConfig)
                          else MeshConfig(**mesh))
    return PipelineConfig(**fields)


def to_port(arrays: Mapping, device, dtype=torch.float32) -> dict:
    """Numpy panel (``ret, cap, styles, industry, valid``) and optional
    ``sim_covs`` -> tensors on ``device``: floats in ``dtype``, industry
    codes int32, the universe mask bool."""
    out = {}
    for name, x in arrays.items():
        x = np.asarray(x)
        if name == "industry":
            t = torch.from_numpy(x.astype(np.int32))
        elif name == "valid":
            t = torch.from_numpy(x.astype(bool))
        elif name in _PANEL or name == "sim_covs":
            t = torch.from_numpy(np.ascontiguousarray(x)).to(dtype)
        else:
            raise ValueError(f"unknown array {name!r}; expected "
                             f"{_PANEL + ('sim_covs',)}")
        out[name] = t.to(device)
    return out


def outputs_to_numpy(outputs) -> dict:
    """``RiskModelOutputs`` -> ``{field: numpy array}``."""
    return {k: v.detach().cpu().numpy() for k, v in outputs._asdict().items()}


def state_from_reference(npz_path: str, device=None):
    """A ``RiskModelState`` from a checkpoint the reference's
    ``save_risk_state`` wrote — the format is shared, so this is the
    port's :func:`~mfm_tpu_torch.data.artifacts.load_risk_state`, tensors
    on ``device`` (None: the card).  Returns ``(state, meta)``."""
    return load_risk_state(npz_path, device)


def state_to_numpy(state) -> dict:
    """A ``RiskModelState``'s arrays under the checkpoint's npz keys, plus
    ``sim_length``, ``eigen_batch_hint`` and ``stamp``.  bfloat16 draws
    come as their uint16 bit pattern, as in the checkpoint, with
    ``eig_draws_dtype`` naming the dtype."""
    arrays, meta = state_arrays(state)
    extra = {"eig_draws_dtype": meta["eig_draws_dtype"]} \
        if "eig_draws_dtype" in meta else {}
    return {**arrays, "sim_length": state.sim_length,
            "eigen_batch_hint": state.eigen_batch_hint, "stamp": state.stamp,
            **extra}


def report_to_numpy(report) -> dict:
    """A ``GuardReport`` -> ``{field: numpy array}``, ``reasons`` as the
    reference's uint32."""
    out = {k: v.detach().cpu().numpy() for k, v in report._asdict().items()}
    out["reasons"] = out["reasons"].astype(np.uint32)
    return out


def budget_check(got: Mapping, want: Mapping, budget: Mapping):
    """Hold numpy outputs ``got`` against ``want`` within per-field budgets
    (the ``risk`` entry of ``tools/parity_budget.json``), the way
    ``tools/tpu_parity.py compare`` does: over the entries finite on both
    sides, ``|got - want| / max|want|`` has its max and median under the
    field's ``max_rel`` / ``median_rel`` (``default`` for unlisted fields);
    the finite patterns must agree and ``*_valid`` masks match exactly.

    Returns ``(records, failed)``: one record per float field and the list
    of failed checks (empty when everything holds).
    """
    records, failed = {}, []
    for name in want:
        x, y = np.asarray(got[name]), np.asarray(want[name])
        if name.endswith("_valid"):
            if not np.array_equal(x, y):
                failed.append(name)
            continue
        if not np.array_equal(np.isfinite(x), np.isfinite(y)):
            failed.append(name + ":finiteness")
        m = np.isfinite(x) & np.isfinite(y)
        scale = max(float(np.abs(y[m]).max()), 1e-30) if m.any() else 1.0
        d = np.abs(x[m].astype(np.float64) - y[m]) / scale
        rec = {"max_rel": float(d.max()) if d.size else 0.0,
               "median_rel": float(np.median(d)) if d.size else 0.0}
        lim = budget.get(name, budget["default"])
        if rec["max_rel"] > lim["max_rel"]:
            failed.append(name + ":max_rel")
        if rec["median_rel"] > lim.get("median_rel", np.inf):
            failed.append(name + ":median_rel")
        records[name] = rec
    return records, failed
