"""Declarative scenario specs: what-if worlds as JSON-round-trippable data
(counterpart of ``mfm_tpu/scenario/spec.py``; the same wire format, so a
spec hashes to the same bytes in either package).

A :class:`ScenarioSpec` names ONE hypothetical world to re-price risk
under.  It is pure declaration — no arrays, no device state — so specs
live in version control, ride in manifests, and hash stably
(:meth:`ScenarioSpec.spec_hash` is the audit key the manifest audit
recomputes).  Five orthogonal axes, composable in one spec:

- **Factor vol shocks** (``shift`` / ``scale``): per-factor additive
  deltas and multiplicative scales on the factor volatilities — "energy
  vol doubles", "momentum vol +5 points".
- **Vol-regime override** (``vol_mult``): a global multiplier on every
  factor vol, the scenario analog of the stage-4 lambda_F series
  (PAPER.md) — "the whole market runs 3x hot".
- **Correlation stress** (``corr_beta``): off-diagonal correlations
  scaled by ``1 + corr_beta`` and clipped to [-1, 1] —
  diversification-collapse / melt-up drills.  May break PSD-ness; the
  kernel's gated projection repairs it and flags the lane.
- **Historical replay** (``replay``): splice a named stretch of panel
  history — the base covariance becomes the one the model had fitted
  through that window (resolved host-side from a pipeline result).
- **Quarantine counterfactual** (``flip_quarantine`` / ``flip_heal``):
  re-run the guarded update with chosen verdicts flipped — "what if the
  guards had (not) quarantined date d?" — via the ``pre_reasons`` /
  ``heal_mask`` operands of ``RiskModel.update_guarded``.

The all-defaults spec is the IDENTITY scenario: the engine serves the
base covariance back bitwise-untouched (the subsystem's correctness
anchor).  Build specs with :class:`ScenarioBuilder` or start from the
:data:`PRESETS` catalog (docs/SCENARIOS.md describes each drill).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math


#: manifest / JSON schema version of the spec wire format
SPEC_SCHEMA_VERSION = 1


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One named what-if world (frozen, hashable, JSON-round-trippable).

    Attributes:
      name: unique id of the scenario inside a batch (manifest key, the
        ``scenario`` field of serve requests).
      shift: ``((factor, vol_delta), ...)`` additive vol shocks.
      scale: ``((factor, vol_scale), ...)`` multiplicative vol scales.
      vol_mult: global vol-regime multiplier override (1.0 = untouched).
      corr_beta: off-diagonal correlation stress (0.0 = untouched).
      replay: optional ``(start_date, end_date)`` historical window whose
        fitted covariance replaces today's as the shock base.
      flip_quarantine: dates whose guard verdict is forced QUARANTINED.
      flip_heal: dates whose guard verdict is forced HEALTHY.
    """

    name: str
    shift: tuple = ()
    scale: tuple = ()
    vol_mult: float = 1.0
    corr_beta: float = 0.0
    replay: tuple | None = None
    flip_quarantine: tuple = ()
    flip_heal: tuple = ()

    def __post_init__(self):
        # normalize the container fields to hashable tuples so specs built
        # from JSON lists and from the builder compare/hash identically
        object.__setattr__(self, "shift", _pairs(self.shift))
        object.__setattr__(self, "scale", _pairs(self.scale))
        object.__setattr__(self, "vol_mult", float(self.vol_mult))
        object.__setattr__(self, "corr_beta", float(self.corr_beta))
        if self.replay is not None:
            object.__setattr__(
                self, "replay",
                (str(self.replay[0]), str(self.replay[1])))
        object.__setattr__(self, "flip_quarantine",
                           tuple(str(d) for d in self.flip_quarantine))
        object.__setattr__(self, "flip_heal",
                           tuple(str(d) for d in self.flip_heal))

    # -- identity ------------------------------------------------------------
    @classmethod
    def identity(cls, name: str = "identity") -> "ScenarioSpec":
        """The no-op scenario: served back bitwise-equal to the baseline."""
        return cls(name=name)

    @property
    def shocks_identity(self) -> bool:
        """True when the covariance TRANSFORM is a no-op (the base may
        still be a replay / counterfactual world)."""
        return (not self.shift and not self.scale
                and self.vol_mult == 1.0 and self.corr_beta == 0.0)

    @property
    def is_identity(self) -> bool:
        """True for the full no-op: identity transform on today's world."""
        return (self.shocks_identity and self.replay is None
                and not self.flip_quarantine and not self.flip_heal)

    @property
    def kinds(self) -> tuple:
        """The spec axes actually in play (manifest / CLI display)."""
        out = []
        if self.shift or self.scale:
            out.append("vol_shock")
        if self.vol_mult != 1.0:
            out.append("vol_regime")
        if self.corr_beta != 0.0:
            out.append("corr_stress")
        if self.replay is not None:
            out.append("replay")
        if self.flip_quarantine or self.flip_heal:
            out.append("counterfactual")
        return tuple(out) or ("identity",)

    # -- JSON round trip -----------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "schema_version": SPEC_SCHEMA_VERSION,
            "name": self.name,
            "shift": [[f, v] for f, v in self.shift],
            "scale": [[f, v] for f, v in self.scale],
            "vol_mult": self.vol_mult,
            "corr_beta": self.corr_beta,
            "replay": None if self.replay is None else list(self.replay),
            "flip_quarantine": list(self.flip_quarantine),
            "flip_heal": list(self.flip_heal),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ScenarioSpec":
        if not isinstance(d, dict):
            raise ValueError(f"spec must be a JSON object, got {type(d)}")
        ver = d.get("schema_version", SPEC_SCHEMA_VERSION)
        if ver != SPEC_SCHEMA_VERSION:
            raise ValueError(f"unsupported spec schema_version {ver!r} "
                             f"(this build reads {SPEC_SCHEMA_VERSION})")
        if "name" not in d:
            raise ValueError("spec is missing 'name'")
        replay = d.get("replay")
        return cls(
            name=str(d["name"]),
            shift=_pairs(d.get("shift", ())),
            scale=_pairs(d.get("scale", ())),
            vol_mult=d.get("vol_mult", 1.0),
            corr_beta=d.get("corr_beta", 0.0),
            replay=None if replay is None else (replay[0], replay[1]),
            flip_quarantine=tuple(d.get("flip_quarantine", ())),
            flip_heal=tuple(d.get("flip_heal", ())),
        )

    def to_json(self) -> str:
        """Canonical JSON (sorted keys, tight separators) — the byte
        stream :meth:`spec_hash` digests, so hash equality IS spec
        equality."""
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))

    @classmethod
    def from_json(cls, s: str) -> "ScenarioSpec":
        return cls.from_dict(json.loads(s))

    def spec_hash(self) -> str:
        """sha256 of the canonical JSON — the manifest audit key."""
        return hashlib.sha256(self.to_json().encode("utf-8")).hexdigest()


def _pairs(items) -> tuple:
    """Normalize ``[[factor, value], ...]`` / dicts to a sorted tuple of
    ``(str, float)`` pairs (canonical order => canonical hash)."""
    if isinstance(items, dict):
        items = items.items()
    out = []
    for it in items:
        f, v = it
        out.append((str(f), float(v)))
    return tuple(sorted(out))


def validate_spec(spec: ScenarioSpec, factor_names=None) -> list:
    """Host-side admission guard for one spec; returns the problem list
    (empty = admissible).

    Mirrors the request guards of serve/server.py: a poisoned spec (NaN
    shock, ``corr_beta`` past the -1 pole, non-positive ``vol_mult``,
    unknown factor) is REJECTED per-scenario — the engine substitutes a
    passthrough lane so batchmates' bytes are untouched
    (tests/test_torch_scenario.py holds it).
    """
    problems = []
    if not isinstance(spec.name, str) or not spec.name:
        problems.append("name must be a non-empty string")
    known = None if factor_names is None else set(map(str, factor_names))
    for label, pairs in (("shift", spec.shift), ("scale", spec.scale)):
        for f, v in pairs:
            if not math.isfinite(v):
                problems.append(f"{label}[{f!r}] is non-finite ({v!r})")
            elif label == "scale" and v < 0:
                problems.append(f"scale[{f!r}] must be >= 0, got {v}")
            if known is not None and f not in known:
                problems.append(f"{label} names unknown factor {f!r}")
    if not (math.isfinite(spec.vol_mult) and spec.vol_mult > 0):
        problems.append(f"vol_mult must be finite and > 0, got "
                        f"{spec.vol_mult!r}")
    if not math.isfinite(spec.corr_beta) or spec.corr_beta <= -1.0:
        problems.append(f"corr_beta must be finite and > -1, got "
                        f"{spec.corr_beta!r}")
    if spec.replay is not None and not (spec.replay[0] <= spec.replay[1]):
        problems.append(f"replay window is reversed: {spec.replay!r}")
    both = set(spec.flip_quarantine) & set(spec.flip_heal)
    if both:
        problems.append(f"dates flipped both ways: {sorted(both)[:5]}")
    return problems


class ScenarioBuilder:
    """Chainable spec builder::

        spec = (ScenarioBuilder("energy-shock")
                .shock("industry_7", mult=2.0)
                .vol_regime(1.5)
                .correlation(0.3)
                .build())
    """

    def __init__(self, name: str):
        self._name = str(name)
        self._shift: dict = {}
        self._scale: dict = {}
        self._vol_mult = 1.0
        self._corr_beta = 0.0
        self._replay = None
        self._flip_q: list = []
        self._flip_h: list = []

    def shock(self, factor: str, add: float = 0.0,
              mult: float = 1.0) -> "ScenarioBuilder":
        """Shock one factor's vol: ``sigma' = sigma * mult + add``."""
        f = str(factor)
        if add:
            self._shift[f] = self._shift.get(f, 0.0) + float(add)
        if mult != 1.0:
            self._scale[f] = self._scale.get(f, 1.0) * float(mult)
        return self

    def vol_regime(self, mult: float) -> "ScenarioBuilder":
        """Override the global vol-regime multiplier."""
        self._vol_mult = float(mult)
        return self

    def correlation(self, beta: float) -> "ScenarioBuilder":
        """Stress off-diagonal correlations by ``1 + beta``."""
        self._corr_beta = float(beta)
        return self

    def replay(self, start: str, end: str) -> "ScenarioBuilder":
        """Use the covariance fitted through [start, end] as the base."""
        self._replay = (str(start), str(end))
        return self

    def flip(self, date: str, heal: bool = False) -> "ScenarioBuilder":
        """Flip date's quarantine verdict (``heal=True`` forces HEALTHY,
        else forces QUARANTINED)."""
        (self._flip_h if heal else self._flip_q).append(str(date))
        return self

    def build(self) -> ScenarioSpec:
        return ScenarioSpec(
            name=self._name,
            shift=tuple(self._shift.items()),
            scale=tuple(self._scale.items()),
            vol_mult=self._vol_mult,
            corr_beta=self._corr_beta,
            replay=self._replay,
            flip_quarantine=tuple(self._flip_q),
            flip_heal=tuple(self._flip_h),
        )


#: the preset drill catalog (docs/SCENARIOS.md).  Analogs, not replays:
#: each encodes the SHAPE of a historical stress (how much vol, how much
#: correlation melt-up) as a pure covariance transform, so it applies to
#: any checkpoint without that history on disk.
PRESETS = {
    "crash-2015-analog": ScenarioSpec(
        name="crash-2015-analog", vol_mult=2.2, corr_beta=0.35),
    "covid-2020-analog": ScenarioSpec(
        name="covid-2020-analog", vol_mult=3.1, corr_beta=0.55),
    "corr-meltup": ScenarioSpec(
        name="corr-meltup", corr_beta=0.9),
}

PRESET_NOTES = {
    "crash-2015-analog": "2015-style drawdown: vols ~2.2x, correlations "
                         "+35% toward 1 (diversification thins)",
    "covid-2020-analog": "2020-crash analog: vols ~3.1x, correlations "
                         "+55% toward 1 (the fastest regime flip on "
                         "record)",
    "corr-meltup": "pure correlation melt-up at unchanged vols — the "
                   "stress that breaks PSD-ness and exercises the "
                   "projection path",
}


def preset(name: str) -> ScenarioSpec:
    """Look up a preset spec by name (raises KeyError with the catalog)."""
    try:
        return PRESETS[name]
    except KeyError:
        raise KeyError(f"unknown preset {name!r}; have "
                       f"{sorted(PRESETS)}") from None
