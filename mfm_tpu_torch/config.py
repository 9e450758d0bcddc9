"""Configuration of the whole pipeline (counterpart of ``mfm_tpu/config.py``).

Factor production's :class:`RollingSpec` and :class:`FactorConfig`, the
covariance stack's :class:`RiskModelConfig`, the serving loop's
:class:`QuarantinePolicy` and the pipeline's :class:`PipelineConfig`, with
the reference's fields, defaults, validation and ``identity()``.  Settings
whose implementation has not been ported yet raise ``NotImplementedError``
instead of being ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


def _is_count(x) -> bool:
    return isinstance(x, int) and not isinstance(x, bool) and x >= 1


@dataclasses.dataclass(frozen=True)
class RollingSpec:
    """Window / half-life / min-periods triple of one rolling factor, e.g.
    BETA's 252 / 63 / 42 (``factor_calculator.py:86``)."""

    window: int
    half_life: int | None = None
    min_periods: int = 1


@dataclasses.dataclass(frozen=True)
class FactorConfig:
    """Every constant of the style-factor layer; the defaults are the
    reference's (``mfm_tpu/config.py:29-99``): BETA/HSIGMA 252/63/42,
    RSTR 504 dates with a 21-date lag (window 483), half-life 126, min 42,
    DASTD 252/42/42, CMRA 252, STOM/STOQ/STOA 21/15, 63/42, 252/126, the
    composite weights, the orthogonalization rules and the winsorization
    at mean +/- 2.5 sample std."""

    beta: RollingSpec = RollingSpec(window=252, half_life=63, min_periods=42)
    rstr_total: int = 504
    rstr_lag: int = 21
    rstr_half_life: int = 126
    rstr_min_periods: int = 42
    dastd: RollingSpec = RollingSpec(window=252, half_life=42, min_periods=42)
    cmra_window: int = 252
    stom: RollingSpec = RollingSpec(window=21, min_periods=15)
    stoq: RollingSpec = RollingSpec(window=63, min_periods=42)
    stoa: RollingSpec = RollingSpec(window=252, min_periods=126)

    winsorize_n_std: float = 2.5

    factors_to_run: Tuple[str, ...] = (
        "SIZE", "BETA", "RSTR", "DASTD", "CMRA", "NLSIZE", "BP",
        "LIQUIDITY", "EARNINGS", "GROWTH", "LEVERAGE",
    )

    #: (name, components, weights): missing components drop out with their
    #: weight renormalized over the rest
    composite: Tuple[Tuple[str, Tuple[str, ...], Tuple[float, ...]], ...] = (
        ("volatility", ("DASTD", "CMRA", "HSIGMA"), (0.7, 0.15, 0.15)),
        ("leverage", ("MLEV", "DTOA", "BLEV"), (1 / 3, 1 / 3, 1 / 3)),
        ("liquidity", ("STOM", "STOQ", "STOA"), (0.5, 0.25, 0.25)),
        ("earnings", ("CETOP", "ETOP"), (0.5, 0.5)),
        ("growth", ("YOYProfit", "YOYSales"), (0.5, 0.5)),
    )

    #: (target, regressors): the per-date OLS residualization
    ortho_rules: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
        ("volatility", ("BETA", "SIZE")),
        ("liquidity", ("SIZE",)),
    )

    #: the barra output names, in output order
    rename_map: Tuple[Tuple[str, str], ...] = (
        ("SIZE", "size"),
        ("BETA", "beta"),
        ("RSTR", "momentum"),
        ("volatility", "residual_volatility"),
        ("NLSIZE", "non_linear_size"),
        ("BP", "book_to_price_ratio"),
        ("liquidity", "liquidity"),
        ("earnings", "earnings_yield"),
        ("growth", "growth"),
        ("leverage", "leverage"),
    )
    output_styles: Tuple[str, ...] = (
        "size", "beta", "momentum", "residual_volatility", "non_linear_size",
        "book_to_price_ratio", "liquidity", "earnings_yield", "growth",
        "leverage",
    )


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


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh shape: ``n_date_shards`` over the date axis (the
    cross-sectional regression and the eigen Monte-Carlo are parallel
    over dates), ``n_stock_shards`` over the stock axis (shard-local panel
    construction, rolling windows); ``parallel/mesh.py`` builds it."""

    n_date_shards: int = 1
    n_stock_shards: int = 1

    def __post_init__(self):
        for name in ("n_date_shards", "n_stock_shards"):
            if not _is_count(getattr(self, name)):
                raise ValueError(f"{name} must be a positive int, "
                                 f"got {getattr(self, name)!r}")


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """The pipeline's settings: factor production, the covariance stack,
    the mesh, the compute dtype of the panels (``"float32"`` on the card,
    ``"float64"`` in the parity tests), the rolling kernels' date block
    and their implementation."""

    factors: FactorConfig = dataclasses.field(default_factory=FactorConfig)
    risk: RiskModelConfig = dataclasses.field(default_factory=RiskModelConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    dtype: str = "float32"
    #: rolling date-block size of the "block" impl (memory = block x
    #: window x N elements per input); None derives it from the panel
    #: width and dtype (``ops/rolling.py::auto_block``)
    block: int | None = None
    #: "scan" (O(T*N) two-level chunked scans, the default) or "block"
    #: (the windowed-gather reference formulation; uses ``block``)
    rolling_impl: str = "scan"

    def __post_init__(self):
        from mfm_tpu_torch.ops.rolling import ROLLING_IMPLS

        if self.dtype not in ("float32", "float64"):
            raise ValueError(f"dtype must be 'float32' or 'float64', "
                             f"got {self.dtype!r}")
        if self.rolling_impl not in ROLLING_IMPLS:
            raise ValueError(f"rolling_impl must be one of {ROLLING_IMPLS}, "
                             f"got {self.rolling_impl!r}")
        if self.block is not None and not _is_count(self.block):
            raise ValueError(f"block must be a positive int or None, "
                             f"got {self.block!r}")
