"""Configuration of the risk stack (counterpart of ``mfm_tpu/config.py``).

:class:`RiskModelConfig`, the serving loop's :class:`QuarantinePolicy` and
the risk pipeline's :class:`PipelineConfig`, with the reference's fields,
defaults, validation and ``identity()``.  Settings whose implementation has
not been ported yet raise ``NotImplementedError`` instead of being ignored.
The reference's ``PipelineConfig`` also carries ``factors``, ``block`` and
``rolling_impl``, which configure factor production (ROADMAP.md §A 9).
"""

from __future__ import annotations

import dataclasses


def _is_count(x) -> bool:
    return isinstance(x, int) and not isinstance(x, bool) and x >= 1


@dataclasses.dataclass(frozen=True)
class QuarantinePolicy:
    """Input-guard thresholds for the daily serving loop (serve/guard.py).

    Disabled by default: the full-history fit trusts its inputs; the
    serving path, appending slabs from a live feed, is where a bad date
    must be caught before it enters the Newey-West / vol-regime carries.
    A date that trips any check is quarantined: the model serves the last
    healthy covariance with a staleness counter and the carries skip the
    date entirely.  The thresholds decide which dates enter the sums, so
    they are part of :meth:`RiskModelConfig.identity`.
    """

    enabled: bool = False
    #: quarantine when the non-finite fraction of returns inside the
    #: universe exceeds this
    max_nan_frac: float = 0.05
    #: |ret - median| > mad_k * MAD marks an outlier cell; the date is
    #: quarantined when the outlier fraction exceeds ``max_outlier_frac``
    mad_k: float = 10.0
    max_outlier_frac: float = 0.05
    #: quarantine when the universe falls below this fraction of the
    #: trailing-median universe over ``universe_window`` healthy dates
    min_universe_frac: float = 0.5
    universe_window: int = 63

    def identity(self) -> tuple:
        return (self.enabled, self.max_nan_frac, self.mad_k,
                self.max_outlier_frac, self.min_universe_frac,
                self.universe_window)

    def __post_init__(self):
        if not _is_count(self.universe_window):
            raise ValueError(f"universe_window must be a positive int, "
                             f"got {self.universe_window!r}")
        for name in ("max_nan_frac", "max_outlier_frac", "min_universe_frac"):
            v = getattr(self, name)
            if not 0.0 <= float(v) <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v!r}")
        if float(self.mad_k) <= 0:
            raise ValueError(f"mad_k must be positive, got {self.mad_k!r}")


@dataclasses.dataclass(frozen=True)
class RiskModelConfig:
    """Hyper-parameters of the covariance stack.

    Defaults match ``Barra-master/demo.py:38-42``: Newey-West q=2 tau=252,
    eigenfactor adjustment M=100 scale=1.4, vol-regime tau=42.  See
    ``mfm_tpu/config.py:154-283`` for the meaning of each field.
    """

    nw_lags: int = 2
    nw_half_life: float = 252.0
    nw_method: str = "scan"
    eigen_n_sims: int = 100
    eigen_scale_coef: float = 1.4
    eigen_sim_length: int | None = None  # None => use panel length T
    eigen_sim_sweeps: int | str | None = "auto"
    eigen_chunk: int | str | None = "auto"
    eigen_mc_dtype: str | None = None
    eigen_incremental: bool = False
    vol_regime_half_life: float = 42.0
    seed: int = 0
    #: serving-loop input guards and degraded mode (serve/guard.py)
    quarantine: QuarantinePolicy = dataclasses.field(
        default_factory=QuarantinePolicy)

    def identity(self) -> tuple:
        """Every field that can change the numbers (``eigen_chunk`` is an
        execution knob: chunked and full-batch runs are identical).  Equal
        to the reference's tuple, so checkpoints stamp alike in both
        packages."""
        return (
            self.nw_lags, self.nw_half_life, self.nw_method,
            self.eigen_n_sims, self.eigen_scale_coef, self.eigen_sim_length,
            self.eigen_sim_sweeps, self.eigen_mc_dtype,
            self.eigen_incremental, self.vol_regime_half_life, self.seed,
            self.quarantine.identity(),
        )

    def __post_init__(self):
        s = self.eigen_sim_sweeps
        if not (s is None or s == "auto" or _is_count(s)):
            raise ValueError(
                f"eigen_sim_sweeps must be an int >= 1, None, or 'auto'; "
                f"got {s!r}")
        if self.nw_method not in ("scan", "associative"):
            raise ValueError(
                f"nw_method must be 'scan' or 'associative', "
                f"got {self.nw_method!r}")
        c = self.eigen_chunk
        if not (c is None or c == "auto" or _is_count(c)):
            raise ValueError(
                f"eigen_chunk must be an int >= 1, None, or 'auto'; got {c!r}")
        if self.eigen_mc_dtype not in (None, "bfloat16"):
            raise ValueError(
                f"eigen_mc_dtype must be None or 'bfloat16', "
                f"got {self.eigen_mc_dtype!r}")
        if not isinstance(self.eigen_incremental, bool):
            raise ValueError(
                f"eigen_incremental must be a bool, "
                f"got {self.eigen_incremental!r}")
        if self.eigen_incremental and self.eigen_sim_length is not None:
            raise ValueError(
                "eigen_incremental=True tracks the growing panel length "
                "(sim_length == T) by construction; a pinned "
                f"eigen_sim_length ({self.eigen_sim_length}) contradicts it "
                "— pick one")
        if self.nw_method == "associative":
            raise NotImplementedError(
                "nw_method='associative' is not ported yet "
                "(ROADMAP.md §A 16)")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh shape: ``n_date_shards`` over the date axis,
    ``n_stock_shards`` over the stock axis.  The port runs on one device,
    so more than one shard raises."""

    n_date_shards: int = 1
    n_stock_shards: int = 1

    def __post_init__(self):
        for name in ("n_date_shards", "n_stock_shards"):
            if not _is_count(getattr(self, name)):
                raise ValueError(f"{name} must be a positive int, "
                                 f"got {getattr(self, name)!r}")
        if self.n_date_shards * self.n_stock_shards > 1:
            raise NotImplementedError(
                "a device mesh of more than one shard is not ported yet "
                "(ROADMAP.md §A 16)")


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """The risk pipeline's settings: the covariance stack, the mesh and the
    compute dtype of the panels (``"float32"`` on the card, ``"float64"``
    in the parity tests)."""

    risk: RiskModelConfig = dataclasses.field(default_factory=RiskModelConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    dtype: str = "float32"

    def __post_init__(self):
        if self.dtype not in ("float32", "float64"):
            raise ValueError(f"dtype must be 'float32' or 'float64', "
                             f"got {self.dtype!r}")
