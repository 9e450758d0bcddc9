"""Scenario engine: batched stress tests over the served risk model
(counterpart of ``mfm_tpu/scenario``).

The what-if surface of the stack (docs/SCENARIOS.md): declarative
:class:`ScenarioSpec` worlds — factor vol shocks, vol-regime overrides,
correlation stress, historical replays, quarantine counterfactuals —
run by :class:`ScenarioEngine` as one batched call per geometric
S-bucket on the card (the PSD gate's eigh is the Jacobi kernel), with
per-scenario rejection isolation and atomic ``scenario_manifest.json``
evidence; :class:`SweepEngine` streams millions of shock worlds through
a fixed-size top-k carry, and refines each book's worst case by the
gradient (``SweepEngine.sweep(refine=...)``).
"""

from mfm_tpu_torch.scenario.counterfactual import (
    clone_state,
    make_counterfactual_fn,
    make_replay_lookup,
    replay_lookup_from_result,
)
from mfm_tpu_torch.scenario.engine import ScenarioEngine, ScenarioResult
from mfm_tpu_torch.scenario.kernel import scenario_batch
from mfm_tpu_torch.scenario.manifest import (
    SCENARIO_MANIFEST_NAME,
    ScenarioManifestError,
    audit_scenario_manifest,
    build_scenario_manifest,
    read_scenario_manifest,
    scenario_manifest_path_for,
    write_scenario_manifest,
)
from mfm_tpu_torch.scenario.sweep import (
    GridSampler,
    ReplaySampler,
    SobolSampler,
    SWEEP_MANIFEST_NAME,
    SweepEngine,
    SweepManifestError,
    SweepResult,
    UniformSampler,
    audit_sweep_manifest,
    build_sweep_manifest,
    monthly_replay_windows,
    read_sweep_manifest,
    sweep_manifest_path_for,
    theta_to_spec,
    write_sweep_manifest,
)
from mfm_tpu_torch.scenario.spec import (
    PRESET_NOTES,
    PRESETS,
    ScenarioBuilder,
    ScenarioSpec,
    preset,
    validate_spec,
)

__all__ = [
    "GridSampler",
    "PRESETS",
    "PRESET_NOTES",
    "ReplaySampler",
    "SCENARIO_MANIFEST_NAME",
    "SWEEP_MANIFEST_NAME",
    "ScenarioBuilder",
    "ScenarioEngine",
    "ScenarioManifestError",
    "ScenarioResult",
    "ScenarioSpec",
    "SobolSampler",
    "SweepEngine",
    "SweepManifestError",
    "SweepResult",
    "UniformSampler",
    "audit_scenario_manifest",
    "audit_sweep_manifest",
    "build_scenario_manifest",
    "build_sweep_manifest",
    "clone_state",
    "make_counterfactual_fn",
    "make_replay_lookup",
    "monthly_replay_windows",
    "preset",
    "read_scenario_manifest",
    "read_sweep_manifest",
    "replay_lookup_from_result",
    "scenario_batch",
    "scenario_manifest_path_for",
    "sweep_manifest_path_for",
    "theta_to_spec",
    "validate_spec",
    "write_scenario_manifest",
    "write_sweep_manifest",
]
