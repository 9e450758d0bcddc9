"""Host orchestration of the differentiable-risk surfaces (counterpart of
``mfm_tpu/grad/engine.py``).

Only :class:`ShockBall`, the admissibility box of the shock space, is
ported so far; ``GradEngine`` and the solver knobs wait for ROADMAP.md
§A 12.
"""

from __future__ import annotations

import dataclasses

import numpy as np


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
