"""The declarative entrypoint registry behind ``audit`` (counterpart of
``mfm_tpu/analysis/registry.py``).

Every public entry point the reference compiles is declared here as an
:class:`Entrypoint`, under the reference's name: the port's callable that
does its work, the reference's qualname beside the port's, the operands
the caller contract lets it retire (by name), the meshes it must
tolerate, and the bucket ladder its steady-state "one signature per
bucket" claim is made over.  The audit passes (``aliasing``, ``ir``,
``collectives``, ``surface``, ``budgets``) read these declarations.

The reference lowers each cell from abstract avals and never runs it.
Eager torch has nothing to lower, so a port cell is two things:

- its declared operands, :class:`Spec` trees of shape and dtype (the
  avals), which the recompile-surface pass (A4) reads without running
  anything, and from which the cache key of a ladder rung is made;
- a maker that builds concrete operands at those specs from a fixed
  numpy seed (``make``), always at float32 whatever the caller's dtype —
  the counterpart of the reference's ``disable_x64`` — for the one run of
  the cell that passes A1, A2, A3 and A5 read.  Building a cell makes no
  tensor; only a pass that asks for its run does.

Each entry point's ``fn`` takes the reference function's parameters by
name (those the port has: the reference's traced ``t_count`` is the
port's ``nw_carry[0]``, and the incremental init makes its own draws
and moment carry from ``config.seed``), so the donation contract is kept
by operand name: ``donate`` lists the reference's ``donate=`` positions
read through its function's parameter names.  Several counterparts are
methods, not the reference's jitted steps: ``RiskModel.run_fused``,
``init_state``, ``update`` and ``update_guarded``, and ``QueryEngine``'s
batch step; ``fn`` builds the object and calls the method.

Mesh cells: the risk steps run under ``parallel/mesh.use_mesh`` on a
('date', 'stock') mesh with their panels laid out by ``PIPELINE_SPECS``
before the call (the reference's cells arrive sharded); the carries,
guard leaves and ``sim_covs`` stay whole on the mesh's first device,
where one process keeps a replicated value.  The replicated cells of
``scenario.sweep_*`` and ``grad.*`` run the function once a mesh position
on ``replicate()``d operands through ``map_shards``: they move nothing
and give every position the same bits.  A mesh of more devices than are
up gives the reference's ``mesh-skipped`` warn (``MFM_TORCH_VIRTUAL_DEVICES``
makes one device count several).

:data:`AUDIT_MATRIX` has the reference's values: the budgets and the
cache keys are defined at those shapes.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Mapping

import numpy as np
import torch

from mfm_tpu_torch.utils import contracts

#: the audit's config matrix, the reference's values — part of the budget
#: identity (``mfm_tpu_torch/tools/audit_budgets.json`` measures THESE
#: shapes); change them only with a budget regeneration
#: (``audit --write-budgets``)
AUDIT_MATRIX = {
    "T": 64,    # dates per slab
    "N": 48,    # stocks
    "P": 5,     # industries
    "Q": 3,     # style factors
    "M": 4,     # eigen Monte-Carlo sims
    "SIM_LEN": 48,   # pinned eigen_sim_length of the non-incremental cells
}
_K = 1 + AUDIT_MATRIX["P"] + AUDIT_MATRIX["Q"]   # country + P + Q

#: the fixed numpy seed every cell's operands are made from
SEED = 0


@dataclasses.dataclass(frozen=True)
class Finding:
    """One audit verdict, the reference's.  ``severity`` is ``error``
    (fails ``--strict``), ``warn`` (reported, non-fatal) or ``info``
    (evidence trail).  ``code`` is the stable id the baseline keys on."""

    pass_id: str        # "A1".."A5"
    severity: str       # "error" | "warn" | "info"
    entrypoint: str     # registry name, or "-" for registry-level findings
    cell: str           # cell name, or "-"
    code: str           # e.g. "nondonated-alias"
    message: str

    def key(self) -> str:
        return f"{self.pass_id}:{self.entrypoint}:{self.cell}:{self.code}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Spec:
    """A declared operand: shape and torch dtype (the reference's
    ``ShapeDtypeStruct``).  ``device`` is None: a spec lives nowhere, so
    ``utils/contracts.signature_of`` reads it like a tensor."""

    shape: tuple
    dtype: torch.dtype
    device: object = None


def _s(shape, dtype=torch.float32) -> Spec:
    return Spec(tuple(shape), dtype)


@dataclasses.dataclass(frozen=True, eq=False)   # identity hash: cells key
class Cell:                                      # the run cache
    """One (operands, statics) point of an entrypoint's config matrix.

    ``role``: ``primary`` cells run alone (every pass), ``mesh`` cells run
    under a ('date', 'stock') mesh of ``mesh`` (collectives, dtypes,
    aliasing, budgets), and ``ladder`` cells never run — the surface pass
    reads their specs alone.  ``operands`` maps the entry point's
    parameter names to :class:`Spec` trees (tuples of specs; None for an
    operand the cell leaves out), in call order; ``statics`` are the
    plain Python arguments, whose ``repr`` is part of the cache key.
    """

    name: str
    operands: Mapping
    statics: Mapping
    role: str = "primary"        # "primary" | "mesh" | "ladder"
    mesh: tuple | None = None    # (n_date, n_stock) for role == "mesh"
    bucket: int | None = None    # the declared bucket, where there is one


@dataclasses.dataclass(frozen=True, eq=False)   # identity hash, like Cell
class Entrypoint:
    """One registered public entry point."""

    name: str                    # audit id, e.g. "risk.update_guarded"
    qualname: str                # the reference's "module:func" qualname
    port: str                    # the port's counterpart, "module:qualname"
    fn: Callable                 # fn(**operands, **statics, device=...)
    donate: tuple                # operand names the caller contract retires
    build_cells: Callable[[], "list[Cell]"]
    make: Callable               # make(cell, device) -> operand dict
    collectives_allow: frozenset = frozenset()   # kinds allowed on a mesh
    ladder: str | None = None    # "query" | "scenario" | "eigen" | None
    #: the ``utils/contracts.note_bucket`` site that records this entry
    #: point's padded operands in production, and which operands it
    #: records (None: every operand, under the entry point's name)
    site: str | None = None
    padded: tuple | None = None
    #: run once a mesh position on replicated operands (mesh cells)
    replicated: bool = False
    notes: str = ""

    def cells(self) -> "list[Cell]":
        return self.build_cells()


def leaves(tree) -> list:
    """The leaves of a tuple/list tree (None subtrees have none)."""
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [x for sub in tree for x in leaves(sub)]
    return [tree]


def key_operands(ep: Entrypoint, cell: Cell) -> list:
    """The operand specs the entry point's signature records: the
    ``padded`` operands at a ``note_bucket`` site, else every operand."""
    names = ep.padded if ep.padded is not None else tuple(cell.operands)
    return [leaf for n in names for leaf in leaves(cell.operands[n])]


# -- configurations -----------------------------------------------------------

def _base_config():
    from mfm_tpu_torch.config import RiskModelConfig

    return RiskModelConfig(eigen_n_sims=AUDIT_MATRIX["M"],
                           eigen_sim_length=AUDIT_MATRIX["SIM_LEN"])


def _guarded_config():
    from mfm_tpu_torch.config import QuarantinePolicy, RiskModelConfig

    return RiskModelConfig(eigen_n_sims=AUDIT_MATRIX["M"],
                           eigen_sim_length=AUDIT_MATRIX["SIM_LEN"],
                           quarantine=QuarantinePolicy(enabled=True))


def _incremental_config():
    from mfm_tpu_torch.config import RiskModelConfig

    return RiskModelConfig(eigen_n_sims=AUDIT_MATRIX["M"],
                           eigen_incremental=True)


_CONFIGS = {"base": _base_config, "guarded": _guarded_config,
            "incremental": _incremental_config}


# -- operand specs ------------------------------------------------------------

def _panel_specs() -> dict:
    """The five (T, N)-family panels every risk step starts with, at the
    production float32 path's dtypes."""
    T, N, Q = (AUDIT_MATRIX[k] for k in ("T", "N", "Q"))
    return {"ret": _s((T, N)), "cap": _s((T, N)), "styles": _s((T, N, Q)),
            "industry": _s((T, N), torch.int32),
            "valid": _s((T, N), torch.bool)}


def _sim_covs_spec() -> Spec:
    return _s((AUDIT_MATRIX["M"], _K, _K))


def _carry_specs(q: int) -> dict:
    """The Newey-West ``(t, S, A, Z, Ps, hs, gs, Slags, xlags)`` carry
    (``q`` lags) and the vol-regime ``(num, den)`` sums."""
    K = _K
    nw = (_s((), torch.int32), _s((K,)), _s((K, K)), _s(()),
          (_s((K, K)),) * q, (_s((K,)),) * q, (_s(()),) * q,
          (_s((K,)),) * q, (_s((K,)),) * q)
    return {"nw_carry": nw, "vr_num": _s(()), "vr_den": _s(())}


def _eig_specs(bucket: int) -> dict:
    M = AUDIT_MATRIX["M"]
    return {"eig_draws": _s((M, _K, bucket)), "eig_R": _s((M, _K, _K)),
            "eig_p": _s((M, _K)), "eig_n": _s((), torch.int32)}


def _guard_specs(policy) -> dict:
    """(last_good, staleness, q_count, ring, ring_pos), the reference's
    names for ``RiskModelState``'s degraded-mode leaves."""
    return {"last_good": _s((_K, _K)), "staleness": _s((), torch.int32),
            "q_count": _s((), torch.int32),
            "ring": _s((policy.universe_window,)),
            "ring_pos": _s((), torch.int32)}


# -- operand makers -----------------------------------------------------------

def _rng() -> np.random.Generator:
    return np.random.default_rng(SEED)


def _put(x, device, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(device=device,
                                                        dtype=dtype)


def _panels(device, seed: int) -> dict:
    from mfm_tpu_torch.data.synthetic import synthetic_risk_inputs

    T, N, P, Q = (AUDIT_MATRIX[k] for k in ("T", "N", "P", "Q"))
    arrays = synthetic_risk_inputs(T, N, P, Q, seed=seed)
    return {n: _put(a, device)
            for n, a in zip(("ret", "cap", "styles", "industry", "valid"),
                            arrays)}


def _sim_covs(device) -> torch.Tensor:
    """(M, K, K) sample covariances of standard-normal (K, SIM_LEN) draws,
    ``np.cov``'s normalization."""
    M, L = AUDIT_MATRIX["M"], AUDIT_MATRIX["SIM_LEN"]
    d = _rng().standard_normal((M, _K, L))
    d -= d.mean(axis=-1, keepdims=True)
    return _put(np.einsum("mkt,mlt->mkl", d, d) / (L - 1), device,
                torch.float32)


def _cov(rng, device, batch=()) -> torch.Tensor:
    """A well-conditioned (…, K, K) factor covariance."""
    a = rng.standard_normal(tuple(batch) + (_K, 3 * _K)) * 0.01
    c = a @ np.swapaxes(a, -1, -2) / (3 * _K)
    return _put(c + 1e-5 * np.eye(_K), device, torch.float32)


@functools.lru_cache(maxsize=None)
def _history_state(mode: str, device: str):
    """The state an update cell appends to: ``init_state`` over the seed-0
    history panel under the mode's config, made once a process and device
    (each cell run gets copies of its tensors)."""
    from mfm_tpu_torch.models.risk_model import RiskModel

    sim = None if mode == "incremental" else _sim_covs(device)
    _, st = RiskModel(*_panels(device, 0).values(),
                      n_industries=AUDIT_MATRIX["P"], config=_CONFIGS[mode](),
                      device=device).init_state(
        sim_covs=sim, sim_length=None if sim is None else
        AUDIT_MATRIX["SIM_LEN"])
    return st


def _clone(tree):
    if isinstance(tree, tuple):
        return tuple(_clone(x) for x in tree)
    return tree.clone()


#: ``RiskModelState``'s field behind each of the reference's operand names
_STATE_FIELDS = {"sim_covs": "sim_covs", "nw_carry": "nw_carry",
                 "vr_num": "vr_num", "vr_den": "vr_den",
                 "last_good": "last_good_cov", "staleness": "staleness",
                 "q_count": "quarantine_count", "ring": "guard_ring",
                 "ring_pos": "guard_ring_pos", "eig_draws": "eig_draws",
                 "eig_R": "eig_R", "eig_p": "eig_p", "eig_n": "eig_n"}


def _make_risk(cell: Cell, device) -> dict:
    """The risk steps' operands: the full-history steps' seed-0 panels and
    ``sim_covs`` from the seed; the updates' seed-1 slab, appended to
    copies of the state ``init_state`` left over the seed-0 history (its
    carries, frozen draws and guard leaves under the reference's names),
    with no host pre-verdict and no healed date."""
    names = [n for n, spec in cell.operands.items() if spec is not None]
    if "nw_carry" not in names:
        ops = _panels(device, 0)
        if "sim_covs" in names:
            ops["sim_covs"] = _sim_covs(device)
        return {n: ops[n] for n in names}
    mode = ("incremental" if "eig_draws" in names else
            "guarded" if "ring" in names else "base")
    st = _history_state(mode, str(device))
    ops = _panels(device, 1)
    T = AUDIT_MATRIX["T"]
    ops.update(pre_reasons=torch.zeros(T, dtype=torch.int32, device=device),
               heal_mask=torch.zeros(T, dtype=torch.bool, device=device))
    ops.update({n: _clone(getattr(st, f)) for n, f in _STATE_FIELDS.items()
                if n in names})
    return {n: ops[n] for n in names}


# -- the port's counterparts, under the reference's parameter names -----------

def _model(ret, cap, styles, industry, valid, n_industries, config, device):
    from mfm_tpu_torch.models.risk_model import RiskModel

    return RiskModel(ret, cap, styles, industry, valid,
                     n_industries=n_industries, config=config, device=device)


def _risk_fused(ret, cap, styles, industry, valid, sim_covs, *,
                n_industries, config, sim_length, device):
    """``RiskModel.run_fused`` on the panels and frozen draws."""
    return _model(ret, cap, styles, industry, valid, n_industries, config,
                  device).run_fused(sim_covs=sim_covs, sim_length=sim_length)


def _risk_init(ret, cap, styles, industry, valid, sim_covs=None, *,
               n_industries, config, sim_length, device):
    """``RiskModel.init_state``: the fit and its resumable state (in
    incremental mode the draws and moment carry come from
    ``config.seed``, inside the call)."""
    return _model(ret, cap, styles, industry, valid, n_industries, config,
                  device).init_state(sim_covs=sim_covs, sim_length=sim_length)


def _state(model, *, sim_covs, nw_carry, vr_num, vr_den, sim_length,
           eigen_batch_hint, eig=None, guard=None):
    from mfm_tpu_torch.models.risk_model import RiskModelState

    eig = eig or {}
    guard = guard or {}
    return RiskModelState(
        nw_carry, vr_num, vr_den, sim_covs, sim_length=sim_length,
        eigen_batch_hint=eigen_batch_hint, stamp=model._stamp(),
        last_good_cov=guard.get("last_good"),
        staleness=guard.get("staleness"),
        quarantine_count=guard.get("q_count"),
        guard_ring=guard.get("ring"), guard_ring_pos=guard.get("ring_pos"),
        eig_draws=eig.get("eig_draws"), eig_R=eig.get("eig_R"),
        eig_p=eig.get("eig_p"), eig_n=eig.get("eig_n"))


def _risk_update(ret, cap, styles, industry, valid, sim_covs=None,
                 nw_carry=None, vr_num=None, vr_den=None, eig_draws=None,
                 eig_R=None, eig_p=None, eig_n=None, *, n_industries, config,
                 sim_length, eigen_batch_hint, device):
    """``RiskModel.update`` of the slab onto the state the operands make."""
    m = _model(ret, cap, styles, industry, valid, n_industries, config,
               device)
    st = _state(m, sim_covs=sim_covs, nw_carry=nw_carry, vr_num=vr_num,
                vr_den=vr_den, sim_length=sim_length,
                eigen_batch_hint=eigen_batch_hint,
                eig=dict(eig_draws=eig_draws, eig_R=eig_R, eig_p=eig_p,
                         eig_n=eig_n))
    return m.update(st)


def _risk_update_guarded(ret, cap, styles, industry, valid, sim_covs,
                         nw_carry, vr_num, vr_den, last_good, staleness,
                         q_count, ring, ring_pos, pre_reasons, heal_mask, *,
                         n_industries, config, sim_length, eigen_batch_hint,
                         device):
    """``RiskModel.update_guarded`` of the slab onto the guarded state."""
    m = _model(ret, cap, styles, industry, valid, n_industries, config,
               device)
    st = _state(m, sim_covs=sim_covs, nw_carry=nw_carry, vr_num=vr_num,
                vr_den=vr_den, sim_length=sim_length,
                eigen_batch_hint=eigen_batch_hint,
                guard=dict(last_good=last_good, staleness=staleness,
                           q_count=q_count, ring=ring, ring_pos=ring_pos))
    return m.update_guarded(st, pre_reasons=pre_reasons,
                            heal_mask=heal_mask)


def _benchmarks(rows) -> dict:
    """Benchmark rows 1.. of a table whose row 0 is the zero portfolio."""
    return {f"b{i}": rows[i] for i in range(1, rows.shape[0])}


def _query_factor(x, bidx, cov, bx, *, device):
    """``QueryEngine``'s batch step (``_rows``) in factor space."""
    from mfm_tpu_torch.serve.query import QueryEngine

    eng = QueryEngine(cov, benchmarks=_benchmarks(bx), device=device)
    return eng._rows(x, bidx)


def _query_stock(w, bidx, cov, X, svar, bw, *, device):
    """``QueryEngine``'s batch step in stock space (the engine derives
    the benchmarks' exposures ``bx`` from ``bw`` and ``X``)."""
    from mfm_tpu_torch.serve.query import QueryEngine

    eng = QueryEngine(cov, exposures=X, specific_var=svar,
                      benchmarks=_benchmarks(bw), device=device)
    return eng._rows(w, bidx)


def _guard_step(ret, cap, valid, ring, ring_pos, pre_reasons, heal_mask, *,
                policy, device):
    from mfm_tpu_torch.serve.guard import guard_slab

    return guard_slab(ret, cap, valid, ring, ring_pos, policy,
                      pre_reasons=pre_reasons, heal_mask=heal_mask)


def _direct(module: str, name: str):
    """A port function that takes the reference's operands as they are
    (``device`` is where the operands already live)."""
    def call(*, device, **kw):
        import importlib

        return getattr(importlib.import_module(module), name)(**kw)

    call.__name__ = name
    return call


# -- cells per entrypoint -----------------------------------------------------

def _mesh_cells(operands, statics, meshes=((2, 4),)) -> list:
    return [Cell(f"mesh{nd}x{ns}", operands, statics, role="mesh",
                 mesh=(nd, ns)) for nd, ns in meshes]


def _risk_statics(mode: str, sim_length, hint: bool = False) -> dict:
    T, P, M = (AUDIT_MATRIX[k] for k in ("T", "P", "M"))
    out = dict(n_industries=P, config=_CONFIGS[mode](),
               sim_length=sim_length)
    if hint:
        out["eigen_batch_hint"] = T * M
    return out


def _risk_fused_cells():
    ops = {**_panel_specs(), "sim_covs": _sim_covs_spec()}
    statics = _risk_statics("base", AUDIT_MATRIX["SIM_LEN"])
    return [Cell("base", ops, statics)] + _mesh_cells(
        ops, statics, ((4, 2), (2, 4)))


def _risk_init_cells():
    ops = {**_panel_specs(), "sim_covs": _sim_covs_spec()}
    statics = _risk_statics("base", AUDIT_MATRIX["SIM_LEN"])
    incr = Cell("eigen-incremental", _panel_specs(),
                _risk_statics("incremental", None))
    return [Cell("base", ops, statics), incr] + _mesh_cells(ops, statics)


def _risk_update_cells():
    from mfm_tpu_torch.models.eigen import draw_bucket

    T = AUDIT_MATRIX["T"]
    base = Cell("base", {**_panel_specs(), "sim_covs": _sim_covs_spec(),
                         **_carry_specs(_base_config().nw_lags)},
                _risk_statics("base", AUDIT_MATRIX["SIM_LEN"], hint=True))
    incr_statics = _risk_statics("incremental", T, hint=True)

    def incr_cell(name, bucket, role):
        return Cell(name, {**_panel_specs(),
                           **_carry_specs(_incremental_config().nw_lags),
                           **_eig_specs(bucket)},
                    incr_statics, role=role, bucket=bucket)

    cells = [base, incr_cell("eigen-incremental", draw_bucket(T), "primary")]
    # the declared draw-bucket ladder (pow2 >= 64): the growing history
    # makes a new signature only at bucket rollovers
    for b in (64, 128, 256):
        if draw_bucket(b) != b:
            raise ValueError(f"declared eigen bucket {b} is not a fixed "
                             "point of draw_bucket")
        cells.append(incr_cell(f"bucket{b}", b, "ladder"))
    return cells


def _risk_update_guarded_cells():
    T = AUDIT_MATRIX["T"]
    cfg = _guarded_config()
    ops = {**_panel_specs(), "sim_covs": _sim_covs_spec(),
           **_carry_specs(cfg.nw_lags), **_guard_specs(cfg.quarantine),
           "pre_reasons": _s((T,), torch.int32),
           "heal_mask": _s((T,), torch.bool)}
    statics = _risk_statics("guarded", AUDIT_MATRIX["SIM_LEN"], hint=True)
    return [Cell("base", ops, statics)] + _mesh_cells(ops, statics)


_QUERY_BUCKETS = (8, 32, 128)    # bucket_for's 8 * 4^i ladder, first rungs
_N_BENCH = 3                     # benchmark table rows (2 benchmarks + zero)


def _ladder(make_ops, statics, ladder_fn, mesh: bool = False) -> list:
    """A primary cell at the first bucket, a ladder cell per bucket and,
    with ``mesh``, a replicated mesh cell at the first bucket."""
    b0 = _QUERY_BUCKETS[0]
    cells = [Cell(f"bucket{b0}", make_ops(b0), statics, bucket=b0)]
    for b in _QUERY_BUCKETS:
        if ladder_fn(b) != b:
            raise ValueError(f"declared bucket {b} is not a fixed point of "
                             "the production ladder")
        cells.append(Cell(f"bucket{b}", make_ops(b), statics,
                          role="ladder", bucket=b))
    if mesh:
        cells += _mesh_cells(make_ops(b0), statics)
    return cells


def _bucket_for(b):
    from mfm_tpu_torch.serve.query import bucket_for

    return bucket_for(b)


def _query_factor_cells():
    def ops(b):
        # pad_batch's operand dtypes: float32 weights, int32 indices
        return {"x": _s((b, _K)), "bidx": _s((b,), torch.int32),
                "cov": _s((_K, _K)), "bx": _s((_N_BENCH, _K))}
    return _ladder(ops, {}, _bucket_for)


def _query_stock_cells():
    N, b = AUDIT_MATRIX["N"], _QUERY_BUCKETS[0]
    ops = {"w": _s((b, N)), "bidx": _s((b,), torch.int32),
           "cov": _s((_K, _K)), "X": _s((N, _K)), "svar": _s((N,)),
           "bw": _s((_N_BENCH, N))}
    return [Cell(f"bucket{b}", ops, {}, bucket=b)]


def _scenario_cells():
    def ops(s):
        return {"base_cov": _s((s, _K, _K)), "shift": _s((s, _K)),
                "scale": _s((s, _K)), "vol_mult": _s((s,)),
                "corr_beta": _s((s,)), "passthrough": _s((s,), torch.bool)}
    return _ladder(ops, {}, _bucket_for)


#: sweep-cell fixed sizes: the carry is shape-static in (books, top_k,
#: bins) — one representative configuration (the bench's own), the ladder
#: varies only the chunk axis
_SWEEP_B, _SWEEP_TOPK, _SWEEP_BINS, _SWEEP_LIB = 2, 16, 64, 2
_TH = 2 * _K + 2     # theta layout: shift | scale | vol_mult | corr


def _sweep_carry_spec() -> tuple:
    i32 = torch.int32
    return (_s((_SWEEP_B, _SWEEP_TOPK)), _s((_SWEEP_B, _SWEEP_TOPK, _TH)),
            _s((_SWEEP_B, _SWEEP_TOPK), i32), _s((_SWEEP_B, _SWEEP_TOPK), i32),
            _s((_SWEEP_B, _SWEEP_BINS), i32), _s((3,), i32))


def _sweep_chunk_cells():
    def ops(c):
        return {"carry": _sweep_carry_spec(),
                "base_lib": _s((_SWEEP_LIB, _K, _K)), "xs": _s((_SWEEP_B, _K)),
                "thetas": _s((c, _TH)), "base_idx": _s((c,), torch.int32),
                "src": _s((c,), torch.int32), "take": _s((c,), torch.bool),
                "reject": _s((c,), torch.bool),
                "passthrough": _s((c,), torch.bool),
                "lo": _s((_SWEEP_B,)), "width": _s((_SWEEP_B,))}
    return _ladder(ops, {}, _bucket_for, mesh=True)


def _sweep_merge_cells():
    def ops(m):
        return {"carry": _sweep_carry_spec(), "covs": _s((m, _K, _K)),
                "xs": _s((_SWEEP_B, _K)), "thetas": _s((m, _TH)),
                "src": _s((m,), torch.int32),
                "base_idx": _s((m,), torch.int32),
                "take": _s((m,), torch.bool),
                "projected": _s((m,), torch.bool),
                "lo": _s((_SWEEP_B,)), "width": _s((_SWEEP_B,))}
    return _ladder(ops, {}, _bucket_for, mesh=True)


#: the solvers' iteration count: a plain int in the port (the reference
#: traces it), so part of the statics; small, since the audit reads the
#: program's structure, not its convergence
_GRAD_STEPS = 4


def _grad_reverse_cells():
    def ops(b):
        return {"cov": _s((_K, _K)), "xs": _s((b, _K)),
                "theta0": _s((b, _TH)), "lo": _s((_TH,)), "hi": _s((_TH,)),
                "step": _s(())}
    return _ladder(ops, {"steps": _GRAD_STEPS}, _bucket_for, mesh=True)


def _grad_minvol_cells():
    def ops(b):
        return {"xs0": _s((b, _K)), "cov": _s((_K, _K)), "lo": _s((_K,)),
                "hi": _s((_K,)), "eta": _s(())}
    return _ladder(ops, {"steps": _GRAD_STEPS}, _bucket_for, mesh=True)


def _grad_riskparity_cells():
    def ops(b):
        return {"xs0": _s((b, _K)), "cov": _s((_K, _K)), "eta": _s(())}
    return _ladder(ops, {"steps": _GRAD_STEPS}, _bucket_for, mesh=True)


def _grad_hedge_cells():
    def ops(b):
        return {"xs0": _s((b, _K)), "hs0": _s((b, _K)), "cov": _s((_K, _K)),
                "mask": _s((b, _K)), "hmax": _s(()), "eta": _s(())}
    return _ladder(ops, {"steps": _GRAD_STEPS}, _bucket_for, mesh=True)


def _grad_sensitivity_cells():
    def ops(b):
        return {"base_cov": _s((b, _K, _K)), "shift": _s((b, _K)),
                "scale": _s((b, _K)), "vol_mult": _s((b,)),
                "corr_beta": _s((b,)), "x": _s((_K,))}
    return _ladder(ops, {}, _bucket_for, mesh=True)


def _guard_step_cells():
    T, N = AUDIT_MATRIX["T"], AUDIT_MATRIX["N"]
    policy = _guarded_config().quarantine
    ops = {"ret": _s((T, N)), "cap": _s((T, N)),
           "valid": _s((T, N), torch.bool),
           "ring": _s((policy.universe_window,)),
           "ring_pos": _s((), torch.int32),
           "pre_reasons": _s((T,), torch.int32),
           "heal_mask": _s((T,), torch.bool)}
    return [Cell("base", ops, {"policy": policy})]


# -- makers for the serving, scenario and grad cells --------------------------

def _identity_theta(n: int) -> np.ndarray:
    th = np.zeros((n, _TH))
    th[:, _K:2 * _K] = 1.0
    th[:, 2 * _K] = 1.0
    return th


def _shocks(rng, n: int) -> np.ndarray:
    """``n`` mild shock lanes about the identity."""
    th = _identity_theta(n)
    th[:, :_K] = rng.normal(0, 0.002, (n, _K))
    th[:, _K:2 * _K] = rng.uniform(0.8, 1.2, (n, _K))
    th[:, 2 * _K] = rng.uniform(0.9, 1.5, n)
    th[:, 2 * _K + 1] = rng.uniform(0.0, 0.5, n)
    return th


def _sweep_carry(device):
    from mfm_tpu_torch.scenario.kernel import _init_sweep_carry

    return _init_sweep_carry(_SWEEP_B, _SWEEP_TOPK, _TH, _SWEEP_BINS,
                             torch.float32, device)


def _make_serving(cell: Cell, device) -> dict:
    """Operands of the query, scenario, sweep, grad and guard cells, from
    the seed: a well-conditioned covariance, mild shocks about the
    identity, books on the simplex, int32 indices."""
    from mfm_tpu_torch.grad.engine import ShockBall

    rng = _rng()
    f32 = torch.float32
    specs = cell.operands
    out = {}
    lo, hi = ShockBall().bounds(_K)
    panels = _panels(device, 1) if "ret" in specs else {}
    for name, spec in specs.items():
        if name == "carry":
            out[name] = _sweep_carry(device)
            continue
        shape, dt = spec.shape, spec.dtype
        if name in ("ret", "cap", "valid"):
            v = panels[name]
        elif name == "cov":
            v = _cov(rng, device)
        elif name in ("base_cov", "covs", "base_lib"):
            v = _cov(rng, device, shape[:1])
        elif name in ("thetas", "theta0"):
            v = _put(_shocks(rng, shape[0]) if name == "thetas"
                     else _identity_theta(shape[0]), device, f32)
        elif name in ("lo", "hi") and shape == (_TH,):
            v = _put(np.asarray(lo if name == "lo" else hi), device, f32)
        elif name == "lo" and cell.operands.get("width") is not None:
            v = _put(np.full(shape, 0.005), device, f32)
        elif name == "width":
            v = _put(np.full(shape, 0.001), device, f32)
        elif name == "lo":
            v = torch.zeros(shape, dtype=f32, device=device)
        elif name == "hi":
            v = torch.ones(shape, dtype=f32, device=device)
        elif name in ("scale", "vol_mult"):
            v = _put(rng.uniform(0.8, 1.2, shape), device, f32)
        elif name == "shift":
            v = _put(rng.normal(0, 0.002, shape), device, f32)
        elif name == "corr_beta":
            v = _put(rng.uniform(0.0, 0.5, shape), device, f32)
        elif name in ("step", "eta", "hmax"):
            v = torch.tensor({"step": 0.1, "eta": 0.15, "hmax": 1.0}[name],
                             dtype=f32, device=device)
        elif name == "bidx":
            v = _put(rng.integers(0, _N_BENCH, shape), device, torch.int32)
        elif name == "base_idx":
            v = _put(rng.integers(0, _SWEEP_LIB, shape), device, torch.int32)
        elif name == "src":
            v = _put(np.arange(shape[0]), device, torch.int32)
        elif name in ("bx", "bw"):
            rows = rng.dirichlet(np.ones(shape[1]), shape[0])
            rows[0] = 0.0
            v = _put(rows, device, f32)
        elif name in ("x", "xs", "xs0", "w"):
            v = _put(rng.dirichlet(np.ones(shape[-1]), shape[:-1] or None),
                     device, f32)
        elif name == "hs0":
            v = torch.zeros(shape, dtype=f32, device=device)
        elif name == "mask":
            v = _put(rng.random(shape) < 0.5, device, f32)
        elif name == "X":
            v = _put(rng.standard_normal(shape), device, f32)
        elif name == "svar":
            v = _put(rng.uniform(1e-4, 4e-4, shape), device, f32)
        elif name == "heal_mask":
            v = torch.zeros(shape, dtype=dt, device=device)
        elif dt == torch.bool:
            v = _put(rng.random(shape) < 0.5, device)
        elif name == "ring":
            v = _put(np.full(shape, float(AUDIT_MATRIX["N"])), device, f32)
        elif dt == torch.int32:
            v = torch.zeros(shape, dtype=dt, device=device)
        else:
            raise ValueError(f"no maker for operand {name!r} of {cell.name}")
        out[name] = v
    return out


# -- the registry -------------------------------------------------------------

def _build_registry() -> tuple:
    risk_allow = frozenset({"all-reduce", "all-gather"})
    rm = "mfm_tpu_torch.models.risk_model:RiskModel"
    return (
        Entrypoint(
            name="risk.fused",
            qualname="mfm_tpu.models.risk_model:_fused_risk_step",
            port=f"{rm}.run_fused", fn=_risk_fused,
            donate=("ret", "cap", "styles", "industry", "valid"),
            build_cells=_risk_fused_cells, make=_make_risk,
            collectives_allow=risk_allow,
            notes="full-history fit"),
        Entrypoint(
            name="risk.init",
            qualname="mfm_tpu.models.risk_model:_fused_init_step",
            port=f"{rm}.init_state", fn=_risk_init,
            donate=("ret", "cap", "styles", "industry", "valid", "eig_R",
                    "eig_p", "eig_n"),
            build_cells=_risk_init_cells, make=_make_risk,
            collectives_allow=risk_allow,
            notes="fit + resumable carry (plain and incremental-eigen)"),
        Entrypoint(
            name="risk.update",
            qualname="mfm_tpu.models.risk_model:_fused_update_step",
            port=f"{rm}.update", fn=_risk_update,
            donate=("ret", "cap", "styles", "industry", "valid", "nw_carry",
                    "vr_num", "vr_den", "eig_R", "eig_p", "eig_n"),
            build_cells=_risk_update_cells, make=_make_risk,
            ladder="eigen",
            notes="daily append; eigen draw buckets are the ladder"),
        Entrypoint(
            name="risk.update_guarded",
            qualname="mfm_tpu.models.risk_model:_fused_update_guarded_step",
            port=f"{rm}.update_guarded", fn=_risk_update_guarded,
            donate=("ret", "cap", "styles", "industry", "valid", "nw_carry",
                    "vr_num", "vr_den", "last_good", "staleness", "q_count",
                    "ring", "ring_pos", "eig_R", "eig_p", "eig_n"),
            build_cells=_risk_update_guarded_cells, make=_make_risk,
            collectives_allow=risk_allow,
            notes="guards + carried stages + degraded serving"),
        Entrypoint(
            name="query.factor",
            qualname="mfm_tpu.serve.query:_batch_factor",
            port="mfm_tpu_torch.serve.query:QueryEngine._rows",
            fn=_query_factor, donate=("x", "bidx"),
            build_cells=_query_factor_cells, make=_make_serving,
            ladder="query", site=contracts.QUERY_BATCH, padded=("x", "bidx"),
            notes="factor-space portfolio queries, 8*4^i buckets"),
        Entrypoint(
            name="query.stock",
            qualname="mfm_tpu.serve.query:_batch_stock",
            port="mfm_tpu_torch.serve.query:QueryEngine._rows",
            fn=_query_stock, donate=("w", "bidx"),
            build_cells=_query_stock_cells, make=_make_serving,
            site=contracts.QUERY_BATCH, padded=("w", "bidx"),
            notes="stock-space portfolio queries (same buckets)"),
        Entrypoint(
            name="scenario.batch",
            qualname="mfm_tpu.scenario.kernel:scenario_batch",
            port="mfm_tpu_torch.scenario.kernel:scenario_batch",
            fn=_direct("mfm_tpu_torch.scenario.kernel", "scenario_batch"),
            donate=("base_cov", "vol_mult"),
            build_cells=_scenario_cells, make=_make_serving,
            ladder="scenario", site=contracts.SCENARIO_BATCH,
            padded=("base_cov", "shift", "scale", "vol_mult", "corr_beta",
                    "passthrough"),
            notes="S-lane covariance shocks, the query bucket ladder"),
        Entrypoint(
            name="scenario.sweep_chunk",
            qualname="mfm_tpu.scenario.kernel:sweep_chunk",
            port="mfm_tpu_torch.scenario.kernel:sweep_chunk",
            fn=_direct("mfm_tpu_torch.scenario.kernel", "sweep_chunk"),
            donate=("carry",), build_cells=_sweep_chunk_cells,
            make=_make_serving, ladder="scenario", site=contracts.SWEEP_CHUNK,
            padded=("thetas", "base_idx", "src", "take", "reject",
                    "passthrough"),
            replicated=True,
            notes="streaming sweep fold: C certified lanes into the "
                  "top-k/histogram carry"),
        Entrypoint(
            name="scenario.sweep_merge",
            qualname="mfm_tpu.scenario.kernel:sweep_merge",
            port="mfm_tpu_torch.scenario.kernel:sweep_merge",
            fn=_direct("mfm_tpu_torch.scenario.kernel", "sweep_merge"),
            donate=("carry",), build_cells=_sweep_merge_cells,
            make=_make_serving, ladder="scenario", replicated=True,
            notes="offender-lane merge into the same sweep carry"),
        Entrypoint(
            name="grad.reverse",
            qualname="mfm_tpu.grad.reverse:reverse_stress_batch",
            port="mfm_tpu_torch.grad.reverse:reverse_stress_batch",
            fn=_direct("mfm_tpu_torch.grad.reverse", "reverse_stress_batch"),
            donate=("theta0",), build_cells=_grad_reverse_cells,
            make=_make_serving, ladder="query", replicated=True,
            notes="reverse stress: projected ascent over the shock ball"),
        Entrypoint(
            name="grad.minvol",
            qualname="mfm_tpu.grad.construct:minvol_batch",
            port="mfm_tpu_torch.grad.construct:minvol_batch",
            fn=_direct("mfm_tpu_torch.grad.construct", "minvol_batch"),
            donate=("xs0",), build_cells=_grad_minvol_cells,
            make=_make_serving, ladder="query",
            site=f"{contracts.CONSTRUCT_SOLVE}/min_vol", padded=("xs0",),
            replicated=True, notes="min-vol construction"),
        Entrypoint(
            name="grad.riskparity",
            qualname="mfm_tpu.grad.construct:riskparity_batch",
            port="mfm_tpu_torch.grad.construct:riskparity_batch",
            fn=_direct("mfm_tpu_torch.grad.construct", "riskparity_batch"),
            donate=("xs0",), build_cells=_grad_riskparity_cells,
            make=_make_serving, ladder="query",
            site=f"{contracts.CONSTRUCT_SOLVE}/risk_parity", padded=("xs0",),
            replicated=True, notes="equal-risk-contribution construction"),
        Entrypoint(
            name="grad.hedge",
            qualname="mfm_tpu.grad.construct:hedge_batch",
            port="mfm_tpu_torch.grad.construct:hedge_batch",
            fn=_direct("mfm_tpu_torch.grad.construct", "hedge_batch"),
            donate=("xs0", "hs0"), build_cells=_grad_hedge_cells,
            make=_make_serving, ladder="query",
            site=f"{contracts.CONSTRUCT_SOLVE}/hedge", padded=("xs0", "mask"),
            replicated=True, notes="masked hedge-overlay construction"),
        Entrypoint(
            name="grad.sensitivity",
            qualname="mfm_tpu.grad.sensitivity:sensitivity_batch",
            port="mfm_tpu_torch.grad.sensitivity:sensitivity_batch",
            fn=_direct("mfm_tpu_torch.grad.sensitivity",
                       "sensitivity_batch"),
            donate=("shift", "scale"), build_cells=_grad_sensitivity_cells,
            make=_make_serving, ladder="query", replicated=True,
            notes="exact d vol/d shock + d vol/d exposure rows"),
        Entrypoint(
            name="guard.step",
            qualname="mfm_tpu.serve.guard:guard_slab",
            port="mfm_tpu_torch.serve.guard:guard_slab", fn=_guard_step,
            donate=("ring", "ring_pos"), build_cells=_guard_step_cells,
            make=_make_serving,
            notes="standalone slab health screen"),
    )


#: the reference's jit roots that are deliberately NOT audit entrypoints,
#: each with the port's reason.  The completeness test fails on a root of
#: the reference missing from both the registry and this map.
NON_ENTRYPOINT = {
    "mfm_tpu.factors.engine:_run_jit":
        "the factor stage over the prepared field-panel dict "
        "(mfm_tpu_torch/factors/engine.py FactorEngine.run): its operand "
        "set tracks the store schema, not a fixed shape matrix; held by "
        "the factor parity tests and the smoke's factor phases",
    "mfm_tpu.ops.eigh_pallas:jacobi_eigh_tpu":
        "the TPU kernel; the port's CUDA wrapper "
        "(mfm_tpu_torch/ops/eigh_cuda.py jacobi_eigh_cuda) is reached only "
        "through the risk, scenario and grad steps, which the registry "
        "runs end to end",
    "mfm_tpu.ops.eigh_pallas:jacobi_eigh_weighted_diag_tpu":
        "the weighted TPU kernel; its CUDA wrapper "
        "(ops/eigh_cuda.py jacobi_eigh_weighted_diag_cuda) is reached only "
        "through the risk steps, as jacobi_eigh_cuda",
    "mfm_tpu.alpha.dsl:compile_alpha_batch.make_run.run":
        "the per-expression-batch evaluator (mfm_tpu_torch/alpha/dsl.py "
        "compile_alpha_batch): shapes and statics depend on the user's "
        "program, no declarable config matrix (the alpha tests own it)",
    "mfm_tpu.alpha.dsl:compile_alpha_scores.make_run.run":
        "the scored evaluator (alpha/dsl.py compile_alpha_scores); same "
        "reason",
}


@functools.lru_cache(maxsize=1)
def _registry_cached() -> tuple:
    return _build_registry()


def registry() -> tuple:
    """The registered entrypoints (built lazily: importing this module
    imports none of the modules the entry points live in)."""
    return _registry_cached()


def registry_by_name(name: str) -> Entrypoint:
    for ep in registry():
        if ep.name == name:
            return ep
    raise KeyError(f"no audit entrypoint named {name!r}")


class _LazyRegistry:
    """Tuple-like view over :func:`registry` that defers the build to first
    use, so ``from mfm_tpu_torch.analysis import REGISTRY`` has no import
    side effects."""

    def __iter__(self):
        return iter(registry())

    def __len__(self):
        return len(registry())

    def __getitem__(self, i):
        return registry()[i]


REGISTRY = _LazyRegistry()


def flat_donated(ep: Entrypoint, cell: Cell) -> set:
    """The names of the cell's operands the caller contract retires."""
    return {n for n in ep.donate if cell.operands.get(n) is not None}
