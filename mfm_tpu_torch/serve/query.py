"""Batched portfolio-query engine over the served covariance (counterpart
of ``mfm_tpu/serve/query.py``).

Given the served factor covariance F — possibly stale, possibly the
quarantine layer's last healthy matrix — the engine answers, for B
portfolios at once,

- predicted volatility  sigma_p = sqrt(x'Fx + sum_i w_i^2 s_i^2),
- marginal factor risk  Fx and the Euler contributions x_i (Fx)_i,
- active risk vs a named benchmark  sqrt((x-xb)'F(x-xb) + ...),
- portfolio beta vs that benchmark  cov(p, b) / var(b).

The reference runs one vmapped jit of a row-local function; here the batch
axis is written out as plain tensor ops on the engine's device (the card
unless ``device="cpu"``).

**Batch-size buckets.**  A batch is padded with zero rows up to a
geometric bucket (:func:`bucket_for`).  The ladder is kept from the
reference because the batch == singles contract and the coalescer's fill
accounting rest on it.

**Batch == singles, bitwise.**  Every product is an elementwise product
and a contiguous innermost sum (``ops/xreg.py::_rowdot``), never a matrix
product: cuBLAS and the reduction kernels of an outer dimension change a
row's summation order with the number of rows, a contiguous innermost sum
over 16 or more rows does not.  The sums over the N stocks of the
specific-variance terms run as one (C, 3, N) reduction, so even a bucket
of 8 rows sums 24 rows.  The products of the benchmark table (its
exposures, F times them and its variances) are formed once per engine.

**Row chunks.**  A padded batch runs in chunks of one fixed row count
(:attr:`QueryEngine.chunk`, the largest ladder bucket whose (C, K, K) or
(C, K, N) intermediate fits :data:`CHUNK_BYTES`); a smaller bucket runs
whole.  Since every sum is row-local, the chunking moves no bits.

**Spaces.**  Requests carry either K factor exposures (the checkpoint's
covariance alone) or N stock weights (an engine built with the date's
exposure matrix X and specific variances, e.g. by
:meth:`mfm_tpu_torch.pipeline.RiskPipelineResult.query_engine`).

JAX's donation of the batch has no counterpart and needs none: the padded
batch is built fresh for every call.
"""

from __future__ import annotations

import copy
from typing import NamedTuple

import numpy as np
import torch

from mfm_tpu_torch._device import resolve_device
from mfm_tpu_torch.data.artifacts import _numpy
from mfm_tpu_torch.ops.xreg import _rowdot

#: bucket ladder: base * growth**k (k = 0, 1, ...).  Geometric, so padding
#: waste is bounded by ``growth``x and a 1e6-portfolio batch still only
#: meets ~10 distinct shapes.
BUCKET_BASE = 8
BUCKET_GROWTH = 4

#: the most bytes the largest intermediate of one row chunk may take
CHUNK_BYTES = 1 << 30


def bucket_for(n: int, base: int = BUCKET_BASE,
               growth: int = BUCKET_GROWTH) -> int:
    """Smallest ladder bucket >= n (the padded batch shape)."""
    if n < 1:
        raise ValueError(f"batch size must be >= 1, got {n}")
    b = int(base)
    while b < n:
        b *= int(growth)
    return b


def chunk_rows(row_bytes: int) -> int:
    """The largest ladder bucket whose rows of ``row_bytes`` each fit
    :data:`CHUNK_BYTES` (at least the base): the fixed row count a padded
    batch runs in when its intermediate would not fit whole."""
    c = BUCKET_BASE
    while c * BUCKET_GROWTH * row_bytes <= CHUNK_BYTES:
        c *= BUCKET_GROWTH
    return c


class QueryOutputs(NamedTuple):
    """Per-portfolio answers of one batched query (rows past the true B
    are padding).  ``beta``/``active_risk`` vs benchmark row 0 (the zero
    portfolio) are reported as NaN / total risk respectively — the serving
    layer only surfaces them when a benchmark was actually named."""

    total_vol: object      # (B,)
    factor_var: object     # (B,)
    specific_var: object   # (B,)
    contribution: object   # (B, K) Euler x_i (Fx)_i
    marginal: object       # (B, K) Fx
    active_risk: object    # (B,)
    beta: object           # (B,)


def _matvec(x, A):
    """Rows of ``x`` (C, D) times ``A`` (K, D) transposed: (C, K)."""
    return _rowdot(x[:, None, :], A)


class QueryEngine:
    """Batched portfolio queries against one served covariance.

    Args:
      cov: (K, K) served factor covariance (e.g. ``state.last_good_cov``),
        a numpy array or a tensor.
      factor_names: K names defining the exposure order (defaults to
        ``f0..f{K-1}``).
      exposures: optional (N, K) per-stock factor exposure matrix for the
        served date — supplying it makes this a STOCK-space engine
        (requests carry N stock weights); omitted, requests carry K factor
        exposures directly.
      specific_var: optional (N,) per-stock specific VARIANCE at the served
        date (stock space only; non-finite entries count as 0 — the guard
        layer, not the math, polices weight on vol-less names).
      stocks: optional N stock ids (stock space; used by the request
        guards to map dict-keyed weights).
      benchmarks: ``{name: vector}`` of benchmark portfolios in the
        engine's own space (stock weights / factor exposures).
      staleness: dates since ``cov`` was fit (stamped on every response).
      dtype: compute dtype (defaults to ``cov``'s).
      device: None for the CUDA card (raises without one), or e.g. "cpu".
    """

    def __init__(self, cov, *, factor_names=None, exposures=None,
                 specific_var=None, stocks=None, benchmarks=None,
                 staleness: int = 0, dtype=None, device=None):
        cov = _numpy(cov)
        if cov.ndim != 2 or cov.shape[0] != cov.shape[1]:
            raise ValueError(f"cov must be (K, K), got {cov.shape}")
        if not np.isfinite(cov).all():
            raise ValueError("served covariance contains non-finite entries "
                             "— refuse to build a query engine on it")
        self.device = resolve_device(device)
        self.dtype = np.dtype(dtype) if dtype is not None else cov.dtype
        self.K = int(cov.shape[0])
        self.factor_names = ([f"f{i}" for i in range(self.K)]
                             if factor_names is None
                             else list(map(str, factor_names)))
        if len(self.factor_names) != self.K:
            raise ValueError(f"{len(self.factor_names)} factor names for "
                             f"K={self.K}")
        self.factor_index = {n: i for i, n in enumerate(self.factor_names)}
        self.staleness = int(staleness)
        #: name of the scenario this engine's covariance was shocked under
        #: (None = the plain served matrix; set by :meth:`with_cov`, stamped
        #: on every response by the serve loop)
        self.scenario_id: str | None = None
        if exposures is not None:
            X = _numpy(exposures).astype(self.dtype)
            if X.ndim != 2 or X.shape[1] != self.K:
                raise ValueError(f"exposures must be (N, {self.K}), got "
                                 f"{X.shape}")
            self.N = int(X.shape[0])
            sv = (np.zeros(self.N, self.dtype) if specific_var is None
                  else _numpy(specific_var).astype(self.dtype))
            if sv.shape != (self.N,):
                raise ValueError(f"specific_var must be ({self.N},), got "
                                 f"{sv.shape}")
            # X transposed, so that w @ X is a contiguous innermost sum
            self._Xt = self._const(np.where(np.isfinite(X), X, 0.0).T)
            self._svar = self._const(np.where(np.isfinite(sv), sv, 0.0))
            self.space = "stock"
        else:
            if specific_var is not None:
                raise ValueError("specific_var needs exposures (stock space)")
            self.N = self.K
            self._Xt = self._svar = None
            self.space = "factor"
        self.stocks = None if stocks is None else list(map(str, stocks))
        if self.stocks is not None and len(self.stocks) != self.N:
            raise ValueError(f"{len(self.stocks)} stock ids for N={self.N}")
        # benchmark tables: row 0 is the zero portfolio = "no benchmark"
        names = list(benchmarks or {})
        self.benchmark_index = {n: i + 1 for i, n in enumerate(names)}
        bvecs = np.zeros((len(names) + 1, self.N), self.dtype)
        for n, row in self.benchmark_index.items():
            v = _numpy(benchmarks[n]).astype(self.dtype)
            if v.shape != (self.N,) or not np.isfinite(v).all():
                raise ValueError(f"benchmark {n!r}: need {self.N} finite "
                                 "values")
            bvecs[row] = v
        if self.space == "stock":
            self._bw = self._const(bvecs)
            self._bx = _matvec(self._bw, self._Xt)
        else:
            self._bw = None
            self._bx = self._const(bvecs)
        widest = self.K if self.space == "factor" else max(self.K, self.N)
        self.chunk = chunk_rows(self.K * widest * self.dtype.itemsize)
        self._set_cov(cov)

    def _const(self, a) -> torch.Tensor:
        """An owning copy of ``a`` on the engine's device in its dtype."""
        return torch.from_numpy(np.array(a, self.dtype, order="C")).to(
            self.device)

    def _set_cov(self, cov) -> None:
        """Install ``cov`` and the benchmark table's products with it: F
        times each benchmark's exposures and each benchmark's variance."""
        self._cov = self._const(cov)
        self._Fb = _matvec(self._bx, self._cov)
        self._var_b = _rowdot(self._bx, self._Fb)
        if self.space == "stock":
            self._var_b = self._var_b + _rowdot(self._bw * self._bw,
                                                self._svar)

    # -- batch entry ---------------------------------------------------------
    def pad_batch(self, weights, bench=None, bucket: int | None = None):
        """Host-side batch assembly: (B, D) weights + per-portfolio
        benchmark names/indices -> zero-padded operands at the bucket
        shape, moved to the device in one copy each.  Returns
        ``(w, bidx, B, bucket)``."""
        w = np.asarray(weights, self.dtype)
        if w.ndim == 1:
            w = w[None, :]
        B, D = w.shape
        if D != self.N:
            raise ValueError(
                f"{self.space}-space engine expects {self.N} values per "
                f"portfolio, got {D}")
        bucket = bucket_for(B) if bucket is None else int(bucket)
        if bucket < B:
            raise ValueError(f"bucket {bucket} < batch size {B}")
        wp = np.zeros((bucket, self.N), self.dtype)
        wp[:B] = w
        idx = np.zeros(bucket, np.int32)
        if bench is not None:
            bench = list(bench) if not np.isscalar(bench) else [bench] * B
            if len(bench) != B:
                raise ValueError(f"{len(bench)} benchmark entries for B={B}")
            for i, b in enumerate(bench):
                if b is None:
                    continue
                idx[i] = (int(b) if not isinstance(b, str)
                          else self.benchmark_index[b])
                if not 0 <= idx[i] < len(self.benchmark_index) + 1:
                    raise KeyError(f"benchmark index {idx[i]} out of range")
        return (torch.from_numpy(wp).to(self.device),
                torch.from_numpy(idx).to(self.device), B, bucket)

    def _rows(self, w, bidx) -> QueryOutputs:
        """The answers of one chunk of padded rows."""
        cov = self._cov
        x = w if self.space == "factor" else _matvec(w, self._Xt)
        Fx = _matvec(x, cov)
        fvar = _rowdot(x, Fx)
        a = x - self._bx[bidx]
        Fxb = self._Fb[bidx]
        avar = _rowdot(a, _matvec(a, cov))
        cov_pb = _rowdot(x, Fxb)
        if self.space == "factor":
            sv = torch.zeros_like(fvar)
        else:
            wb = self._bw[bidx]
            # the three sums over the stocks as one (C, 3, N) reduction
            s = _rowdot(torch.stack((w * w, (w - wb) ** 2, w * wb), 1),
                        self._svar)
            sv, avar, cov_pb = s[:, 0], avar + s[:, 1], cov_pb + s[:, 2]
        var_b = self._var_b[bidx]
        return QueryOutputs(
            total_vol=torch.sqrt(fvar + sv),
            factor_var=fvar,
            specific_var=sv,
            contribution=x * Fx,
            marginal=Fx,
            active_risk=torch.sqrt(avar),
            beta=torch.where(var_b > 0, cov_pb / var_b,
                             torch.full_like(var_b, float("nan"))),
        )

    def query(self, weights, bench=None, bucket: int | None = None,
              trim: bool = True) -> QueryOutputs:
        """Answer B portfolio queries in one batched call.

        ``weights``: (B, N|K) batch (or one (N|K,) row).  ``bench``:
        optional per-portfolio benchmark names (None entries = none).
        ``bucket`` pins the padded shape (tests / steady-state loops);
        default is :func:`bucket_for` of B.  With ``trim`` the outputs are
        sliced to B rows and brought to the host as numpy arrays, one copy
        each; ``trim=False`` returns the padded device tensors (a harness
        times the device step alone).
        """
        w, bidx, B, bucket = self.pad_batch(weights, bench, bucket)
        if bucket <= self.chunk:
            out = self._rows(w, bidx)
        else:
            out = None
            for s in range(0, bucket, self.chunk):
                part = self._rows(w[s:s + self.chunk], bidx[s:s + self.chunk])
                if out is None:
                    out = QueryOutputs(*(p.new_empty((bucket,) + p.shape[1:])
                                         for p in part))
                for o, p in zip(out, part):
                    o[s:s + self.chunk] = p
        if not trim:
            return out
        return QueryOutputs(*(o[:B].cpu().numpy() for o in out))

    # -- scenario overlays ---------------------------------------------------
    def with_cov(self, cov, *, staleness: int | None = None,
                 scenario_id: str | None = None) -> "QueryEngine":
        """A sibling engine answering under a DIFFERENT covariance.

        Exposures, specific variances, benchmark tables, stock ids, dtype
        and device are SHARED with this engine (the same tensors, no
        copies); only the covariance and its products with the benchmark
        table change.  ``scenario_id`` tags the sibling; the serve loop
        stamps it on every response answered through it.
        """
        cov = _numpy(cov)
        if cov.shape != (self.K, self.K):
            raise ValueError(f"cov must be ({self.K}, {self.K}), got "
                             f"{cov.shape}")
        if not np.isfinite(cov).all():
            raise ValueError("scenario covariance contains non-finite "
                             "entries — refuse to serve it")
        eng = copy.copy(self)
        eng._set_cov(cov)
        eng.staleness = self.staleness if staleness is None else \
            int(staleness)
        eng.scenario_id = scenario_id
        return eng

    # -- construction from served artifacts ---------------------------------
    @classmethod
    def from_risk_state(cls, state, meta=None, benchmarks=None, dtype=None,
                        device=None):
        """Engine over a :class:`~mfm_tpu_torch.models.risk_model.
        RiskModelState` checkpoint's served covariance (factor space).

        Requires a GUARDED state: ``last_good_cov`` + ``staleness`` are the
        degraded-serving contract (serve/guard.py) — an unguarded state
        holds no covariance to serve.  ``meta`` (the checkpoint's meta)
        supplies the factor-name order when it carries the
        ``save_pipeline_state`` alignment fields.
        """
        if not getattr(state, "guarded", False):
            raise ValueError(
                "state has no served covariance — the query service serves "
                "the guarded (quarantine-enabled) checkpoint's "
                "last_good_cov; re-run the pipeline with quarantine enabled")
        names = None
        if meta and "style_names" in meta and "industry_codes" in meta:
            # mirror BarraArrays.factor_names(): country + industries + styles
            names = (["country"] + [str(c) for c in meta["industry_codes"]]
                     + [str(s) for s in meta["style_names"]])
        cov = _numpy(state.last_good_cov)
        if names is not None and len(names) != cov.shape[0]:
            names = None   # foreign checkpoint meta; fall back to f0..fK
        return cls(cov, factor_names=names, benchmarks=benchmarks,
                   staleness=int(_numpy(state.staleness)), dtype=dtype,
                   device=device)
