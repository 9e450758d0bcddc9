"""SweepEngine — stream 10^6 shock worlds through fixed-size aggregates
(counterpart of ``mfm_tpu/scenario/sweep.py``).

:mod:`mfm_tpu_torch.scenario.engine` answers S what-if worlds by
MATERIALIZING every lane's (K, K) shocked covariance to host numpy — the
right shape for a drill report, the wrong one for a million-scenario
search (~4 GB of transfer for answers that are scalars).  This module is
the streaming counterpart: host-side spec GENERATORS feed blocks of C
dense shock lanes to the device, where
:func:`mfm_tpu_torch.scenario.kernel.sweep_chunk`'s two halves
(``sweep_lane_vols``, ``sweep_fold``) fold each block into a
fixed-size carry — per-book top-k worst (vol, theta) entries, a
fixed-bin vol histogram (the quantile sketch) and admission counters —
so nothing S-shaped ever exists on device or host.

The perf lever is the HOST-CERTIFIED PSD gate: the stressed matrix
``diag(sigma_s) C'(cb) diag(sigma_s)`` shares PSD-ness with the clipped
stressed correlation ``C'(cb)`` whenever ``sigma_s`` is strictly
positive (congruence preserves inertia — Sylvester), and ``C'(cb)``
depends only on the scalar ``corr_beta``.  Samplers emit corr_beta on a
small quantized lattice; the engine certifies each (base, level) pair
ONCE with a K x K host eigh in float64, and certified lanes then run
stress + quadratic form with no decomposition at all.  Lanes the
certificate cannot vouch for (stressed correlation within
:data:`PSD_CERT_TOL` of singular or past it, or stressed vols so
ill-scaled that the serving gate's compute-dtype eigh could see a
different sign than the float64 certificate — the
:data:`SWEEP_EIGH_GUARD` margin) are "offenders", buffered and routed
through the EXACT serving path — :func:`scenario_batch`'s per-lane eigh
gate, the Jacobi kernel on the card — then folded into the same carry by
:func:`sweep_merge` with their true post-projection vols.  Streaming
aggregates are therefore exact, not approximate: the top-k table is
bitwise the materializing engine's (tests/test_torch_sweep.py),
offenders and projections included.

``refine=`` adds the grad-guided refinement: the coarse top-k thetas
seed a reverse-stress ascent (:mod:`mfm_tpu_torch.grad.reverse`, two
Jacobi eighs a step on the card), its endpoints fold through the exact
path, and a dense local re-sweep around each book's best endpoint
(:class:`_LocalSampler`) folds into the SAME carry, so the final worst
case can only improve on the coarse top-1.  ``mesh=`` splits each
chunk's lanes over every shard of a ``('date', 'stock')`` mesh
(``parallel/mesh.py``): each shard computes its lanes' vols on its device,
and the vols are gathered to fold into the carry, which with the books
and the base library stays replicated; the result is bitwise the
single-device sweep's.

Host-side orchestration only: the device math lives in
scenario/kernel.py.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from mfm_tpu_torch.data.artifacts import _numpy
from mfm_tpu_torch.obs import instrument as _obs
from mfm_tpu_torch.parallel.mesh import (
    P,
    NamedSharding,
    device_put,
    gather,
    map_shards,
    replicate,
)
from mfm_tpu_torch.scenario.engine import ScenarioEngine
from mfm_tpu_torch.scenario.kernel import (
    _init_sweep_carry,
    scenario_batch,
    sweep_fold,
    sweep_lane_vols,
    sweep_merge,
)
from mfm_tpu_torch.scenario.spec import PRESETS, ScenarioSpec, validate_spec
from mfm_tpu_torch.serve.query import bucket_for
from mfm_tpu_torch.utils import contracts
from mfm_tpu_torch.utils.chaos import chaos_point

#: a (base, corr_beta-level) pair certifies PSD only when the stressed
#: correlation's smallest eigenvalue clears this margin — eigenvalues of
#: a correlation matrix are O(1), so 1e-4 dwarfs both the f64 host eigh
#: error and the compute-dtype divergence of the device-side stress.
#: Anything inside the band is an offender (exact path), never a guess.
PSD_CERT_TOL = 1e-4

#: Sylvester gives lam_min(cov_s) >= lam_min(C') * min(sigma_s)^2 while
#: the serving gate's compute-dtype eigh observes it with error
#: O(eps * lam_max(cov_s)) <= O(eps * lam_max(C') * max(sigma_s)^2); a
#: lane is certified only when the bound clears that noise floor by this
#: factor, so "certified" and "serving leaves it unprojected" are the
#: same set of lanes (the reference measured >1000x headroom on its bench
#: shapes — 64
#: keeps the band conservative without routing healthy lanes to the
#: exact path).
SWEEP_EIGH_GUARD = 64.0

#: offender lanes buffered host-side flush through the exact path at this
#: ladder rung (bucket_for(128) == 128 — one shape, reused every flush)
OFFENDER_CHUNK = 128

SWEEP_MANIFEST_SCHEMA_VERSION = 1
SWEEP_MANIFEST_NAME = "sweep_manifest.json"


class SweepManifestError(RuntimeError):
    """A sweep manifest exists but is unreadable, schema-incompatible, or
    internally inconsistent."""


# -- theta <-> spec -----------------------------------------------------------

def theta_to_spec(theta, factor_names, name: str,
                  replay=None) -> ScenarioSpec:
    """A dense shock vector ``[shift(K) | scale(K) | vol_mult |
    corr_beta]`` back to declarative :class:`ScenarioSpec` form — the
    same round trip the reference's ``GradEngine`` performs, exposed
    module-level so sweep manifests and tests share one canonical encoding (spec hashes
    are comparable across subsystems)."""
    K = len(factor_names)
    th = np.asarray(theta, np.float64)
    return ScenarioSpec(
        name=name,
        shift=tuple((factor_names[j], float(th[j]))
                    for j in range(K) if th[j] != 0.0),
        scale=tuple((factor_names[j], float(th[K + j]))
                    for j in range(K) if th[K + j] != 1.0),
        vol_mult=float(th[2 * K]),
        corr_beta=float(th[2 * K + 1]),
        replay=replay,
    )


# -- host-side spec generators ------------------------------------------------
#
# A sampler is an iterator factory, never a list: ``blocks(chunk)`` yields
# ``(thetas (c, 2K+2) float64, base_idx (c,) int32, cb_level (c,) int32)``
# host arrays with c <= chunk, deterministically for a fixed (seed, n,
# chunk).  ``cb_values`` is the sampler's corr_beta lattice (what the
# engine certifies); ``windows`` its replay windows (base_idx b > 0 means
# windows[b - 1], resolved through the engine's replay_lookup).


def _identity_theta(K: int) -> np.ndarray:
    th = np.zeros(2 * K + 2, np.float64)
    th[K:2 * K] = 1.0
    th[2 * K] = 1.0
    return th


class GridSampler:
    """Deterministic grid over the (vol_mult, corr_beta) plane of the
    shock box — vol shifts/scales stay neutral.  The regime-stress
    slice a risk desk reads first, and the cheapest full-coverage
    smoke of the streaming machinery."""

    kind = "grid"

    def __init__(self, ball, K: int, *, n_vol: int = 32, n_corr: int = 32):
        if n_vol < 1 or n_corr < 1:
            raise ValueError("grid needs n_vol >= 1 and n_corr >= 1")
        self.ball = ball
        self.K = int(K)
        self.n_vol = int(n_vol)
        self.n_corr = int(n_corr)
        self.vol_values = np.linspace(ball.vol_mult_lo, ball.vol_mult_hi,
                                      self.n_vol)
        self.cb_values = np.linspace(ball.corr_beta_lo, ball.corr_beta_hi,
                                     self.n_corr)
        self.windows = ()
        self.n = self.n_vol * self.n_corr

    def blocks(self, chunk: int):
        ident = _identity_theta(self.K)
        for start in range(0, self.n, chunk):
            idx = np.arange(start, min(start + chunk, self.n))
            vi, ci = idx // self.n_corr, idx % self.n_corr
            th = np.tile(ident, (len(idx), 1))
            th[:, 2 * self.K] = self.vol_values[vi]
            th[:, 2 * self.K + 1] = self.cb_values[ci]
            yield (th, np.zeros(len(idx), np.int32), ci.astype(np.int32))

    def describe(self) -> dict:
        return {"kind": self.kind, "n": self.n, "n_vol": self.n_vol,
                "n_corr": self.n_corr, "ball": self.ball.to_dict()}


class UniformSampler:
    """Seeded uniform draws over the whole shock box, corr_beta
    quantized to ``cb_levels`` lattice points (the certification
    contract).  Byte-deterministic for a fixed (seed, n, chunk)."""

    kind = "uniform"

    def __init__(self, ball, K: int, n: int, *, seed: int = 0,
                 cb_levels: int = 33):
        if n < 1:
            raise ValueError("need n >= 1 scenarios")
        if cb_levels < 1:
            raise ValueError("need cb_levels >= 1")
        self.ball = ball
        self.K = int(K)
        self.n = int(n)
        self.seed = int(seed)
        self.cb_values = np.linspace(ball.corr_beta_lo, ball.corr_beta_hi,
                                     int(cb_levels))
        self.windows = ()

    def _draw(self, rng, c: int):
        K = self.K
        b = self.ball
        th = np.empty((c, 2 * K + 2), np.float64)
        th[:, :K] = rng.uniform(-b.shift_max, b.shift_max, (c, K))
        th[:, K:2 * K] = rng.uniform(1.0 - b.scale_range,
                                     1.0 + b.scale_range, (c, K))
        th[:, 2 * K] = rng.uniform(b.vol_mult_lo, b.vol_mult_hi, c)
        lv = rng.integers(0, len(self.cb_values), c).astype(np.int32)
        th[:, 2 * K + 1] = self.cb_values[lv]
        return th, lv

    def blocks(self, chunk: int):
        rng = np.random.default_rng(self.seed)
        done = 0
        while done < self.n:
            c = min(chunk, self.n - done)
            th, lv = self._draw(rng, c)
            done += c
            yield th, np.zeros(c, np.int32), lv

    def describe(self) -> dict:
        return {"kind": self.kind, "n": self.n, "seed": self.seed,
                "cb_levels": len(self.cb_values),
                "ball": self.ball.to_dict()}


class SobolSampler(UniformSampler):
    """Low-discrepancy Sobol' draws over the shock box (scipy.stats.qmc,
    scrambled with the seed).  Falls back to the seeded uniform stream
    when scipy's qmc module is unavailable — ``describe()`` records
    which engine actually ran, so manifests stay honest."""

    kind = "sobol"

    def __init__(self, ball, K: int, n: int, *, seed: int = 0,
                 cb_levels: int = 33):
        super().__init__(ball, K, n, seed=seed, cb_levels=cb_levels)
        try:
            from scipy.stats import qmc
            self._qmc = qmc.Sobol(d=2 * K + 2, scramble=True, seed=seed)
        except Exception:   # noqa: BLE001 — gate the optional dep
            self._qmc = None

    def blocks(self, chunk: int):
        if self._qmc is None:
            yield from super().blocks(chunk)
            return
        K, b = self.K, self.ball
        lo = np.asarray([-b.shift_max] * K + [1.0 - b.scale_range] * K
                        + [b.vol_mult_lo, 0.0])
        hi = np.asarray([b.shift_max] * K + [1.0 + b.scale_range] * K
                        + [b.vol_mult_hi, 1.0])
        done = 0
        while done < self.n:
            c = min(chunk, self.n - done)
            u = self._qmc.random(c)
            th = lo + u * (hi - lo)
            # last dim draws a LEVEL, not a value: quantize to the lattice
            lv = np.minimum((th[:, -1] * len(self.cb_values)).astype(np.int32),
                            len(self.cb_values) - 1)
            th[:, -1] = self.cb_values[lv]
            done += c
            yield th, np.zeros(c, np.int32), lv

    def describe(self) -> dict:
        d = super().describe()
        d["kind"] = self.kind
        d["qmc"] = "sobol" if self._qmc is not None else "uniform-fallback"
        return d


def monthly_replay_windows(dates) -> list:
    """One (start, end) replay window per calendar month present in the
    panel's own date labels — the auto-generated historical-replay
    library.  ``dates`` is any sequence numpy parses as datetime64[D]."""
    days = np.asarray(list(dates), dtype="datetime64[D]")
    if days.size == 0:
        return []
    months = days.astype("datetime64[M]")
    out = []
    for m in np.unique(months):
        in_m = days[months == m]
        out.append((str(in_m.min()), str(in_m.max())))
    return out


class ReplaySampler:
    """The historical-replay library as a sweep: one IDENTITY lane per
    window — each month's fitted covariance served back untouched, the
    streaming analog of a replay drill (compose with
    :func:`monthly_replay_windows`)."""

    kind = "replay"

    def __init__(self, windows, K: int):
        self.windows = tuple((str(a), str(b)) for a, b in windows)
        if not self.windows:
            raise ValueError("replay sweep needs at least one window")
        self.K = int(K)
        self.n = len(self.windows)
        self.cb_values = np.zeros(1)
        self.ball = None

    def blocks(self, chunk: int):
        ident = _identity_theta(self.K)
        for start in range(0, self.n, chunk):
            c = min(chunk, self.n - start)
            yield (np.tile(ident, (c, 1)),
                   np.arange(start + 1, start + 1 + c, dtype=np.int32),
                   np.zeros(c, np.int32))

    def describe(self) -> dict:
        return {"kind": self.kind, "n": self.n,
                "windows": [list(w) for w in self.windows]}


class _LocalSampler:
    """Internal: seeded uniform draws in a sub-box around refinement
    centers (one center per book), corr_beta snapped to a fresh local
    lattice.  Drives the dense local re-sweep after the gradient
    ascent."""

    kind = "local"

    def __init__(self, ball, centers, K: int, n_per: int, *, span: float,
                 seed: int, cb_levels: int = 9):
        self.ball = ball
        self.K = int(K)
        self.centers = np.asarray(centers, np.float64)   # (B, 2K+2)
        self.n_per = int(n_per)
        self.span = float(span)
        self.seed = int(seed)
        self.n = self.n_per * len(self.centers)
        self.windows = ()
        lo, hi = ball.bounds(K)
        self._lo = np.asarray(lo)
        self._hi = np.asarray(hi)
        cbs = self.centers[:, -1]
        half = span * (ball.corr_beta_hi - ball.corr_beta_lo)
        self.cb_values = np.unique(np.clip(
            np.concatenate([np.linspace(c - half, c + half, cb_levels)
                            for c in cbs]),
            ball.corr_beta_lo, ball.corr_beta_hi))

    def blocks(self, chunk: int):
        rng = np.random.default_rng((self.seed, 0x5EEB))
        width = self.span * (self._hi - self._lo)
        for center in self.centers:
            done = 0
            while done < self.n_per:
                c = min(chunk, self.n_per - done)
                th = center + rng.uniform(-1.0, 1.0,
                                          (c, len(center))) * width
                th = np.clip(th, self._lo, self._hi)
                # snap corr_beta to the certified local lattice
                lv = np.abs(th[:, -1:] - self.cb_values[None, :]).argmin(1)
                lv = lv.astype(np.int32)
                th[:, -1] = self.cb_values[lv]
                done += c
                yield th, np.zeros(c, np.int32), lv


# -- the streaming engine -----------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SweepResult:
    """One sweep's full answer — fixed-size regardless of S.

    ``books``: per-portfolio dicts (label, base vol, top-k table with
    specs + hashes, histogram sketch); ``counts``: admission/offender
    tallies; ``refined``: per-book refinement blocks or None.
    """

    books: list
    counts: dict
    sampler: dict
    refined: list | None
    chunk: int
    chunk_bucket: int
    top_k: int
    bins: int
    hist_span: float
    seconds: float

    def to_dict(self) -> dict:
        return {
            "books": self.books,
            "counts": self.counts,
            "sampler": self.sampler,
            "refined": self.refined,
            "chunk": self.chunk,
            "chunk_bucket": self.chunk_bucket,
            "top_k": self.top_k,
            "bins": self.bins,
            "hist_span": self.hist_span,
        }


class SweepEngine:
    """Streaming million-scenario sweeps against one served covariance.

    Composes a :class:`ScenarioEngine` for base resolution, admission
    doctrine and the final replay round trip — a sweep is the same
    what-if surface at a different aspect ratio (constructor and
    ``from_risk_state`` guards match).

    Args mirror :class:`ScenarioEngine` (``device=None`` is the card, or
    the mesh's first device).  ``mesh`` optionally shards the chunk axis
    over a ``('date', 'stock')`` device mesh (carry, books and base
    library stay replicated — the chunk axis is the only large one).
    """

    def __init__(self, cov, *, factor_names=None, staleness: int = 0,
                 dtype=None, replay_lookup=None, mesh=None, device=None):
        if mesh is not None and device is None:
            device = mesh.first_device
        self.mesh = mesh
        self._scen = ScenarioEngine(cov, factor_names=factor_names,
                                    staleness=staleness, dtype=dtype,
                                    replay_lookup=replay_lookup,
                                    device=device)
        self.K = self._scen.K
        self.dtype = self._scen.dtype
        self.device = self._scen.device
        self.cov = self._scen.cov
        self.factor_names = self._scen.factor_names
        self.factor_index = self._scen.factor_index
        self.staleness = self._scen.staleness
        self.replay_lookup = replay_lookup

    @classmethod
    def from_risk_state(cls, state, meta=None, dtype=None,
                        replay_lookup=None, mesh=None, device=None):
        """Engine over a guarded checkpoint, with the
        ``ScenarioEngine.from_risk_state`` contract (factor names off
        the meta, refuse unguarded states)."""
        scen = ScenarioEngine.from_risk_state(state, meta, dtype=dtype,
                                              replay_lookup=replay_lookup,
                                              device=device)
        return cls(scen.cov, factor_names=scen.factor_names,
                   staleness=scen.staleness, dtype=scen.dtype,
                   replay_lookup=replay_lookup, mesh=mesh, device=device)

    def _put(self, a) -> torch.Tensor:
        return self._scen._put(a)

    # -- host certification ---------------------------------------------------
    def _stressed_corrs(self, base: np.ndarray,
                        cb_values: np.ndarray) -> np.ndarray:
        """(V, K, K) float64 stressed correlations of one base, one per
        corr_beta lattice level — EXACTLY the kernel's correlation math
        (same clip, same diag re-pin), evaluated at the compute-dtype
        value of each level."""
        var = np.diagonal(base).astype(np.float64)
        sigma = np.sqrt(np.maximum(var, 0))
        denom = np.outer(sigma, sigma)
        with np.errstate(invalid="ignore", divide="ignore"):
            corr = np.where(denom > 0, base.astype(np.float64) / denom, 0.0)
        eye = np.eye(self.K)
        corr = corr * (1.0 - eye) + eye
        cbs = np.asarray(cb_values, self.dtype).astype(np.float64)
        corr_s = np.clip(corr[None] * (1.0 + cbs[:, None, None]), -1.0, 1.0)
        return corr_s * (1.0 - eye) + eye

    def _certify(self, base_lib: np.ndarray, cb_values: np.ndarray):
        """``(lam_min, lam_max)`` — two (L, V) float64 arrays of the
        stressed correlations' extreme eigenvalues, one row per base,
        one column per corr_beta lattice level.  The Sylvester
        certificate: a lane at a level with ``lam_min > PSD_CERT_TOL``
        (plus the per-lane :data:`SWEEP_EIGH_GUARD` conditioning margin)
        skips the device eigh entirely."""
        L, V = len(base_lib), len(cb_values)
        lam_min = np.zeros((L, V))
        lam_max = np.zeros((L, V))
        for li, base in enumerate(base_lib):
            corr_s = self._stressed_corrs(base, cb_values)
            lam = np.linalg.eigvalsh(corr_s)    # batched host eigh, (V, K)
            lam_min[li] = lam[:, 0]
            lam_max[li] = lam[:, -1]
        return lam_min, lam_max

    # -- the streaming loop ---------------------------------------------------
    def sweep(self, portfolios, sampler, *, chunk: int = 8192,
              top_k: int = 16, bins: int = 64, hist_span: float = 8.0,
              labels=None, ball=None, refine: dict | None = None,
              offender_chunk: int = OFFENDER_CHUNK) -> SweepResult:
        """Stream every scenario the sampler generates through the
        aggregate carry; optionally refine with reverse-stress ascent.

        Args:
          portfolios: (B, K) factor-exposure rows (or one (K,) vector).
          sampler: a spec generator (Grid/Uniform/Sobol/ReplaySampler).
          chunk: scenarios per host block (padded to its bucket): one
            transfer of the block's lanes to the device, folded there in
            ``SWEEP_SUBCHUNK``-sized slices.
          top_k: worst entries kept per book.
          bins: histogram bins; the sketch spans ``[0, hist_span *
            base_vol)`` per book with a saturating top bin.
          labels: book labels for the manifest (default ``book{i}``).
          ball: admissibility box for refinement seeds/bounds (defaults
            to the sampler's, else the standard ``ShockBall``).
          refine: None to skip, or options for the grad-guided loop:
            ``steps`` / ``step`` (ascent schedule), ``n_local`` (dense
            local draws per book), ``local_span`` (sub-box half-width as
            a fraction of each axis), ``seed``, ``ball`` (override box
            for the ascent/local stage — lets a tame coarse sampler pair
            with the full preset-covering ``ShockBall``).
          offender_chunk: exact-path flush rung for uncertified lanes.

        Returns a :class:`SweepResult`; obs counters under
        ``mfm_sweep_*`` record the run.
        """
        t0 = time.perf_counter()
        xs = np.atleast_2d(np.asarray(portfolios, self.dtype))
        if xs.ndim != 2 or xs.shape[1] != self.K:
            raise ValueError(f"portfolios must be (B, {self.K}), got "
                             f"{xs.shape}")
        B = xs.shape[0]
        labels = ([f"book{i}" for i in range(B)] if labels is None
                  else [str(x) for x in labels])
        if len(labels) != B:
            raise ValueError(f"{len(labels)} labels for B={B} books")
        if ball is None:
            ball = getattr(sampler, "ball", None)
        if ball is None:
            from mfm_tpu_torch.grad.engine import ShockBall
            ball = ShockBall()
        chunk = int(chunk)
        if chunk < 1:
            raise ValueError("chunk must be >= 1")

        # resolve the base library host-side, once: row 0 is the served
        # cov; unresolvable replay windows keep a row of None and every
        # lane pointing at one is rejected (never silently retargeted)
        windows = list(getattr(sampler, "windows", ()) or ())
        base_lib, window_problems = [self.cov], []
        for w in windows:
            resolved = None
            if self.replay_lookup is None:
                window_problems.append(f"{w!r}: engine has no history")
            else:
                try:
                    resolved = self.replay_lookup(*w)
                    if resolved is None:
                        window_problems.append(f"{w!r}: not in the "
                                               "engine's history")
                except Exception as e:   # noqa: BLE001 — reject, don't die
                    window_problems.append(f"{w!r}: {e}")
            base_lib.append(None if resolved is None
                            else np.asarray(_numpy(resolved), self.dtype))
        lib_rows = [i for i, b in enumerate(base_lib) if b is not None]
        row_of = np.full(len(base_lib), -1, np.int32)
        row_of[lib_rows] = np.arange(len(lib_rows), dtype=np.int32)
        lib_np = np.stack([base_lib[i] for i in lib_rows])
        sigma_lib = np.sqrt(np.maximum(
            np.diagonal(lib_np, axis1=1, axis2=2), 0)).astype(self.dtype)

        cb_values = np.asarray(sampler.cb_values, np.float64)
        cert = self._certify(lib_np, cb_values)

        # deterministic sketch edges: [0, span * base vol) per book
        vol0 = np.sqrt(np.einsum("bi,ij,bj->b",
                                 xs.astype(np.float64),
                                 self.cov.astype(np.float64),
                                 xs.astype(np.float64)))
        lo = np.zeros(B, self.dtype)
        width = np.maximum(hist_span * vol0 / bins,
                           np.finfo(self.dtype).tiny).astype(self.dtype)

        dev = {"lib": self._put(lib_np), "xs": self._put(xs),
               "lo": self._put(lo), "width": self._put(width)}
        th_w = 2 * self.K + 2
        carry = _init_sweep_carry(B, int(top_k), th_w, int(bins),
                                  dev["lib"].dtype, self.device)
        bucket = bucket_for(chunk)

        state = {"src": 0, "chunks": 0, "off_n": 0, "off_total": 0,
                 "off_th": [], "off_row": [], "off_src": []}
        for th64, bidx, lv in sampler.blocks(chunk):
            carry = self._fold_block(carry, dev, th64, bidx, lv, cert,
                                     row_of, sigma_lib, bucket, state)
            while state["off_n"] >= offender_chunk:
                carry = self._flush_offenders(carry, dev, state,
                                              offender_chunk)
        n_coarse = state["src"]

        refined_blocks = None
        if refine is not None:
            carry, refined_blocks = self._refine(
                carry, dev, lib_np, xs, ball, refine, chunk, state=state,
                offender_chunk=offender_chunk)
        if state["off_n"]:
            carry = self._flush_offenders(carry, dev, state, state["off_n"])

        # ONE host transfer for the whole sweep: the fixed-size carry
        host = [leaf.cpu().numpy() for leaf in carry]
        top_vol, top_theta, top_src, top_base, hist, counts = host
        n_ok, n_rejected, n_projected = (int(x) for x in counts)
        seconds = time.perf_counter() - t0

        books = self._book_tables(labels, xs, vol0, top_vol, top_theta,
                                  top_src, top_base, hist, lo, width,
                                  lib_rows, windows, n_coarse)
        if refined_blocks is not None:
            for b, blk in zip(books, refined_blocks):
                blk["vol_final_top1"] = b["top"][0]["vol"] if b["top"] \
                    else None
                blk["improved"] = (blk["vol_final_top1"] is not None
                                   and blk["vol_final_top1"]
                                   >= blk["vol_coarse_top1"])
        counts_d = {
            "n_scenarios": n_ok + n_rejected,
            "n_ok": n_ok,
            "n_rejected": n_rejected,
            "n_psd_projected": n_projected,
            "n_offenders": state["off_total"],
            "n_chunks": state["chunks"],
            "n_coarse": n_coarse,
        }
        _obs.record_sweep(n_ok, n_rejected, state["chunks"], seconds)
        if state["off_total"]:
            _obs.record_sweep_offenders(state["off_total"])
        if n_projected:
            _obs.record_sweep_projections(n_projected)
        sampler_d = dict(sampler.describe())
        if window_problems:
            sampler_d["window_problems"] = window_problems
        return SweepResult(books=books, counts=counts_d, sampler=sampler_d,
                           refined=refined_blocks, chunk=chunk,
                           chunk_bucket=bucket, top_k=int(top_k),
                           bins=int(bins), hist_span=float(hist_span),
                           seconds=seconds)

    # -- one block through the hot path --------------------------------------
    def _fold_block(self, carry, dev, th64, bidx, lv, cert, row_of,
                    sigma_lib, bucket, state, force_offender=None):
        """Admit, certify and fold one sampler block (host numpy, as in
        the reference); buffer offenders (``force_offender`` sends lanes
        to the exact path whatever the certificate says).  One copy of
        the block's lanes and masks to the device."""
        K = self.K
        c = len(th64)
        th = np.asarray(th64, self.dtype)
        bidx = np.asarray(bidx, np.int32)
        finite = np.isfinite(th).all(axis=1)
        valid = (finite
                 & (th[:, K:2 * K] >= 0).all(axis=1)
                 & (th[:, 2 * K] > 0)
                 & (th[:, 2 * K + 1] > -1))
        in_lib = (bidx >= 0) & (bidx < len(row_of))
        row = row_of[np.where(in_lib, bidx, 0)]
        valid &= in_lib & (row >= 0)
        row = np.where(row >= 0, row, 0).astype(np.int32)

        ident = ((th[:, :K] == 0).all(axis=1)
                 & (th[:, K:2 * K] == 1).all(axis=1)
                 & (th[:, 2 * K] == 1) & (th[:, 2 * K + 1] == 0))
        lam_min, lam_max = cert
        lvc = np.clip(lv, 0, lam_min.shape[1] - 1)
        lam_lo, lam_hi = lam_min[row, lvc], lam_max[row, lvc]
        sig_s = np.maximum(sigma_lib[row] * th[:, K:2 * K]
                           + th[:, :K], 0) * th[:, 2 * K:2 * K + 1]
        s_lo = sig_s.min(axis=1).astype(np.float64)
        s_hi = sig_s.max(axis=1).astype(np.float64)
        eps = float(np.finfo(self.dtype).eps)
        certified = ((lam_lo > PSD_CERT_TOL)
                     & (lam_lo * s_lo ** 2
                        > SWEEP_EIGH_GUARD * eps * lam_hi * s_hi ** 2))
        clean = valid & (ident | certified)
        if force_offender is not None:
            clean &= ~force_offender
        offender = valid & ~clean
        reject = ~valid

        src = state["src"] + np.arange(c, dtype=np.int32)
        state["src"] += c
        if offender.any():
            state["off_th"].append(th[offender])
            state["off_row"].append(row[offender])
            state["off_src"].append(src[offender])
            state["off_n"] += int(offender.sum())
            state["off_total"] += int(offender.sum())

        if not clean.any() and not reject.any():
            # nothing for the hot path to fold (e.g. an all-offender
            # ascent block) — the buffered lanes merge at flush time
            return carry

        pad = bucket - c
        if pad:
            th = np.concatenate([th, np.zeros((pad, th.shape[1]),
                                              self.dtype)])
            row = np.concatenate([row, np.zeros(pad, np.int32)])
            src = np.concatenate([src, np.full(pad, -1, np.int32)])
            clean = np.concatenate([clean, np.zeros(pad, bool)])
            reject = np.concatenate([reject, np.zeros(pad, bool)])
            ident = np.concatenate([ident, np.zeros(pad, bool)])
        state["chunks"] += 1
        put = self._put
        ops = (put(th), put(row), put(src), put(clean), put(reject),
               put(ident & clean))
        if contracts.listening():
            contracts.note_bucket(contracts.SWEEP_CHUNK, *ops)
        th_t, row_t, src_t, take_t, reject_t, pass_t = ops
        if self.mesh is None:
            vols = sweep_lane_vols(dev["lib"], dev["xs"], th_t, row_t, pass_t)
        else:
            # the chunk's lanes over every shard, the library and books on
            # each; a lane's vols keep their bits alone, so the gathered
            # (B, C) vols fold bitwise as the single-device chunk's
            spread = NamedSharding(self.mesh, P(("date", "stock")))
            vols = gather(map_shards(
                sweep_lane_vols, replicate(dev["lib"], self.mesh),
                replicate(dev["xs"], self.mesh),
                *device_put((th_t, row_t, pass_t), spread),
                out_specs=P(None, ("date", "stock"))))
        return sweep_fold(carry, vols, th_t, row_t, src_t, take_t, reject_t,
                          dev["lo"], dev["width"])

    def _flush_offenders(self, carry, dev, state, m):
        """Run m buffered offender lanes through the EXACT serving path
        (scenario_batch's per-lane eigh gate) and merge their true
        post-projection vols into the carry."""
        th = np.concatenate(state["off_th"])
        row = np.concatenate(state["off_row"])
        src = np.concatenate(state["off_src"])
        state["off_th"] = [th[m:]] if len(th) > m else []
        state["off_row"] = [row[m:]] if len(row) > m else []
        state["off_src"] = [src[m:]] if len(src) > m else []
        state["off_n"] = max(len(th) - m, 0)
        th, row, src = th[:m], row[:m], src[:m]

        K = self.K
        bucket = bucket_for(m)
        pad = bucket - m
        take = np.concatenate([np.ones(m, bool), np.zeros(pad, bool)])
        if pad:
            th = np.concatenate([th, np.tile(
                _identity_theta(K).astype(self.dtype), (pad, 1))])
            row = np.concatenate([row, np.zeros(pad, np.int32)])
            src = np.concatenate([src, np.full(pad, -1, np.int32)])
        th_t, row_t, take_t = self._put(th), self._put(row), self._put(take)
        covs, projected, _ = scenario_batch(
            dev["lib"][row_t.long()], th_t[:, :K], th_t[:, K:2 * K],
            th_t[:, 2 * K], th_t[:, 2 * K + 1], ~take_t)
        state["chunks"] += 1
        return sweep_merge(carry, covs, dev["xs"], th_t, self._put(src),
                           row_t, take_t, projected, dev["lo"], dev["width"])

    # -- grad-guided refinement ----------------------------------------------
    def _refine(self, carry, dev, lib_np, xs, ball, refine, chunk, *,
                state, offender_chunk):
        """Coarse top-k thetas -> reverse-stress ascent -> dense local
        re-sweep, all merged back into the SAME carry (so the final
        worst can only improve on the coarse top-1)."""
        from mfm_tpu_torch.grad.engine import REVERSE_STEP, REVERSE_STEPS
        from mfm_tpu_torch.grad.reverse import reverse_stress_batch
        steps = int(refine.get("steps", REVERSE_STEPS))
        step = float(refine.get("step", REVERSE_STEP))
        n_local = int(refine.get("n_local", 512))
        local_span = float(refine.get("local_span", 0.05))
        seed = int(refine.get("seed", 0))
        ball = refine.get("ball") or ball

        K = self.K
        B, k = xs.shape[0], int(carry[0].shape[1])
        top_theta = carry[1].cpu().numpy()
        top_src = carry[2].cpu().numpy()
        top_base = carry[3].cpu().numpy()
        coarse_top1 = carry[0][:, 0].cpu().numpy().astype(np.float64)

        # seeds: each book's top thetas over the SHARED base (ascent runs
        # against self.cov; replay-based entries keep their coarse rank
        # but cannot seed a gradient against a different base)
        ident = _identity_theta(K).astype(self.dtype)
        P = B * k
        theta0 = np.tile(ident, (P, 1))
        xs_rep = np.repeat(xs, k, axis=0)
        seed_counts = []
        for b in range(B):
            mask = (top_src[b] >= 0) & (top_base[b] == 0)
            seed_counts.append(int(mask.sum()))
            for j in np.nonzero(mask)[0]:
                theta0[b * k + j] = top_theta[b, j]
        pad = bucket_for(P) - P
        if pad:
            theta0 = np.concatenate([theta0, np.tile(ident, (pad, 1))])
            xs_rep = np.concatenate([xs_rep, np.zeros((pad, K),
                                                      self.dtype)])
        lo_b, hi_b = ball.bounds(K)
        put = self._put
        theta_star, vol_star, _ = reverse_stress_batch(
            dev["lib"][0], put(xs_rep), put(theta0.astype(self.dtype)),
            put(np.asarray(lo_b, self.dtype)),
            put(np.asarray(hi_b, self.dtype)),
            put(np.asarray(step, self.dtype)), steps)
        theta_star = theta_star[:P].cpu().numpy()
        vol_star = vol_star[:P].cpu().numpy().astype(np.float64)

        # fold the ascent endpoints through the EXACT path (their
        # corr_beta is continuous — no lattice certificate applies)
        row_of = np.arange(len(lib_np), dtype=np.int32)
        sigma_lib = np.sqrt(np.maximum(
            np.diagonal(lib_np, axis1=1, axis2=2), 0)).astype(self.dtype)
        no_cert = (np.zeros((len(lib_np), 1)), np.ones((len(lib_np), 1)))
        carry = self._fold_block(
            carry, dev, theta_star.astype(np.float64),
            np.zeros(P, np.int32), np.zeros(P, np.int32), no_cert,
            row_of, sigma_lib, bucket_for(P), state,
            force_offender=np.ones(P, bool))

        # dense local re-sweep around each book's best refined theta
        centers = np.empty((B, 2 * K + 2), np.float64)
        ascent_best = np.empty(B, np.float64)
        for b in range(B):
            lane = b * k + int(np.argmax(vol_star[b * k:(b + 1) * k]))
            centers[b] = theta_star[lane]
            ascent_best[b] = float(vol_star[lane])
        local = _LocalSampler(ball, centers, K, n_local, span=local_span,
                              seed=seed)
        cert = self._certify(lib_np, local.cb_values)
        bucket = bucket_for(min(chunk, max(local.n_per, 1)))
        for th64, bidx, lv in local.blocks(min(chunk, bucket)):
            carry = self._fold_block(carry, dev, th64, bidx, lv, cert,
                                     row_of, sigma_lib, bucket, state)
            while state["off_n"] >= offender_chunk:
                carry = self._flush_offenders(carry, dev, state,
                                              offender_chunk)

        psd = self._stressed_psd(centers)
        blocks = []
        for b in range(B):
            spec = theta_to_spec(centers[b], self.factor_names,
                                 f"sweep-refined-{b}")
            admissible = (ball.contains(centers[b], K)
                          and not validate_spec(spec, self.factor_names)
                          and bool(psd[b]))
            blocks.append({
                "seed_count": seed_counts[b],
                "ascent_steps": steps,
                "n_local": n_local,
                "local_span": local_span,
                "vol_coarse_top1": float(coarse_top1[b]),
                "vol_ascent_best": float(ascent_best[b]),
                "theta_spec": spec.to_dict(),
                "theta_spec_hash": spec.spec_hash(),
                "admissible": bool(admissible),
            })
        return carry, blocks

    def _stressed_psd(self, thetas) -> np.ndarray:
        """Host check mirroring ``GradEngine._stressed_psd``: each refined
        worst case, pushed through the REAL serving stress + gated
        projection, stays PSD at compute dtype.  ``thetas`` (B, 2K+2); a
        (B,) bool array."""
        from mfm_tpu_torch.grad.engine import stressed_psd
        return stressed_psd(self._scen._cov, self._put(np.asarray(
            np.atleast_2d(thetas), self.dtype)), self.dtype)

    # -- result assembly ------------------------------------------------------
    def _book_tables(self, labels, xs, vol0, top_vol, top_theta, top_src,
                     top_base, hist, lo, width, lib_rows, windows,
                     n_coarse):
        books = []
        neg = np.finfo(self.dtype).min
        for b, label in enumerate(labels):
            entries = []
            for j in range(top_vol.shape[1]):
                if top_src[b, j] < 0 or top_vol[b, j] <= neg / 2:
                    continue
                orig = lib_rows[int(top_base[b, j])]
                window = list(windows[orig - 1]) if orig > 0 else None
                spec = theta_to_spec(
                    top_theta[b, j], self.factor_names,
                    f"sweep-{int(top_src[b, j])}",
                    replay=tuple(window) if window else None)
                src_i = int(top_src[b, j])
                entries.append({
                    "rank": len(entries),
                    "vol": float(top_vol[b, j]),
                    "src": src_i,
                    "origin": "coarse" if src_i < n_coarse else "refined",
                    "base_window": window,
                    "spec": spec.to_dict(),
                    "spec_hash": spec.spec_hash(),
                })
            books.append({
                "label": label,
                "vol_base": float(vol0[b]),
                "top": entries,
                "hist": {
                    "lo": float(lo[b]),
                    "bin_width": float(width[b]),
                    "counts": [int(x) for x in hist[b]],
                },
            })
        return books

    # -- dominance vs the preset catalog --------------------------------------
    def preset_dominance(self, result: SweepResult, portfolios) -> list:
        """Per-book check that the sweep's worst case dominates every
        preset drill, through the REAL materializing engine (the presets
        run as ordinary forward scenarios).  Returns one dict per book;
        the manifest embeds it."""
        xs = np.atleast_2d(np.asarray(portfolios, np.float64))
        drills = self._scen.run([PRESETS[n] for n in sorted(PRESETS)])
        out = []
        for b, book in enumerate(result.books):
            worst = book["top"][0]["vol"] if book["top"] else None
            rows = []
            for r in drills:
                if not r.ok:
                    rows.append({"preset": r.spec.name, "vol": None,
                                 "dominated": False})
                    continue
                v = float(np.sqrt(xs[b] @ np.asarray(r.cov, np.float64)
                                  @ xs[b]))
                rows.append({
                    "preset": r.spec.name,
                    "vol": v,
                    "dominated": bool(worst is not None
                                      and worst >= v * (1 - 1e-5)),
                })
            out.append({"label": book["label"], "vol_worst": worst,
                        "presets": rows,
                        "dominates_all": all(r["dominated"] for r in rows)})
        return out


# -- the sweep manifest -------------------------------------------------------

def sweep_manifest_path_for(artifact_dir: str) -> str:
    """The sweep-manifest slot inside an artifact directory."""
    return os.path.join(artifact_dir, SWEEP_MANIFEST_NAME)


def build_sweep_manifest(result: SweepResult, *, stamp_json=None,
                         backend=None, staleness: int | None = None,
                         dominance: list | None = None,
                         summary: dict | None = None) -> dict:
    """Assemble the manifest dict (pure; :func:`write_sweep_manifest`
    persists).  Deterministic except for ``summary`` (the obs block) —
    byte-comparing two manifests modulo ``summary`` IS a replay check."""
    return {
        "schema_version": SWEEP_MANIFEST_SCHEMA_VERSION,
        "kind": "sweep_manifest",
        "config_stamp": stamp_json,
        "backend": backend,
        "staleness": staleness,
        "sweep": result.to_dict(),
        "dominance": dominance,
        "summary": summary or {},
    }


def write_sweep_manifest(path: str, manifest: dict) -> str:
    """Atomic write (tmp -> fsync -> chaos point -> rename -> dir fsync);
    ``path`` may be the artifact directory.  Returns the final path."""
    if os.path.isdir(path):
        path = os.path.join(path, SWEEP_MANIFEST_NAME)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    try:
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(manifest, fh, indent=1, sort_keys=True, default=str)
            fh.write("\n")
            fh.flush()
            os.fsync(fh.fileno())
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    chaos_point("sweep_manifest.after_tmp", path)
    os.replace(tmp, path)
    try:
        fd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:  # pragma: no cover - exotic filesystems
        pass
    return path


def read_sweep_manifest(path: str) -> dict:
    """Load + schema-check a sweep manifest (``path`` may be its
    directory).  Raises :class:`SweepManifestError` on unreadable / torn
    JSON or schema/kind mismatch."""
    if os.path.isdir(path):
        path = os.path.join(path, SWEEP_MANIFEST_NAME)
    try:
        with open(path, encoding="utf-8") as fh:
            m = json.load(fh)
    except OSError as e:
        raise SweepManifestError(
            f"{path}: unreadable sweep manifest ({e})") from e
    except ValueError as e:
        raise SweepManifestError(
            f"{path}: sweep manifest is not valid JSON ({e}) — torn "
            "write?") from e
    if not isinstance(m, dict):
        raise SweepManifestError(f"{path}: sweep manifest is not a JSON "
                                 "object")
    if m.get("schema_version") != SWEEP_MANIFEST_SCHEMA_VERSION:
        raise SweepManifestError(
            f"{path}: sweep manifest schema_version "
            f"{m.get('schema_version')!r} unsupported (expected "
            f"{SWEEP_MANIFEST_SCHEMA_VERSION})")
    if m.get("kind") != "sweep_manifest":
        raise SweepManifestError(
            f"{path}: kind {m.get('kind')!r} is not a sweep manifest")
    if not isinstance(m.get("sweep"), dict):
        raise SweepManifestError(f"{path}: sweep manifest has no sweep "
                                 "block")
    return m


def audit_sweep_manifest(path: str) -> tuple:
    """Deep audit of a sweep manifest (the reference's ``doctor
    --scenarios``).

    Returns ``(problems, warnings)``.  Problems: count fields that don't
    add up, per-book top tables out of order or with spec hashes that
    don't recompute from the embedded spec, histograms whose mass
    disagrees with ``n_ok``, refinement blocks claiming improvement the
    entries contradict.  Warnings: rejected lanes, unresolvable replay
    windows, refined worst cases that failed admissibility.
    """
    m = read_sweep_manifest(path)
    problems, warnings = [], []
    sw = m["sweep"]
    counts = sw.get("counts", {})
    n_ok = counts.get("n_ok")
    if counts.get("n_scenarios") != (counts.get("n_ok", 0)
                                     + counts.get("n_rejected", 0)):
        problems.append("counts: n_scenarios != n_ok + n_rejected "
                        f"({counts})")
    if counts.get("n_rejected"):
        warnings.append(f"{counts['n_rejected']} lane(s) rejected")
    for wp in (sw.get("sampler", {}).get("window_problems") or ()):
        warnings.append(f"replay window unresolved: {wp}")
    for bi, book in enumerate(sw.get("books", ())):
        label = f"books[{bi}]"
        hist = book.get("hist", {})
        mass = sum(hist.get("counts", ()))
        if n_ok is not None and mass != n_ok:
            problems.append(f"{label}: histogram mass {mass} != n_ok "
                            f"{n_ok}")
        prev = None
        for e in book.get("top", ()):
            if prev is not None and e["vol"] > prev:
                problems.append(f"{label}: top table out of order at "
                                f"rank {e.get('rank')}")
            prev = e["vol"]
            try:
                spec = ScenarioSpec.from_dict(e["spec"])
            except (ValueError, TypeError, KeyError, IndexError) as exc:
                problems.append(f"{label} rank {e.get('rank')}: embedded "
                                f"spec does not parse ({exc})")
                continue
            if spec.spec_hash() != e.get("spec_hash"):
                problems.append(
                    f"{label} rank {e.get('rank')}: spec hash mismatch — "
                    f"recorded {str(e.get('spec_hash'))[:12]}…, recomputed "
                    f"{spec.spec_hash()[:12]}…")
    for bi, blk in enumerate(sw.get("refined") or ()):
        label = f"refined[{bi}]"
        final = blk.get("vol_final_top1")
        coarse = blk.get("vol_coarse_top1")
        if blk.get("improved") and final is not None and coarse is not None \
                and final < coarse:
            problems.append(f"{label}: claims improved but final "
                            f"{final} < coarse {coarse}")
        if not blk.get("admissible", True):
            warnings.append(f"{label}: refined worst case failed "
                            "admissibility")
    dom = m.get("dominance")
    if dom:
        for row in dom:
            if not row.get("dominates_all"):
                warnings.append(f"book {row.get('label')!r} does not "
                                "dominate every preset drill")
    return problems, warnings
