"""A small, safe alpha-expression DSL evaluated as masked panel ops
(counterpart of ``mfm_tpu/alpha/dsl.py``).

Grammar: Python expression syntax (parsed with ``ast``, no eval) over panel
field names, numeric literals, arithmetic/comparison operators, and a fixed
op vocabulary in the WorldQuant-alpha style:

  elementwise: abs, log, sign, sqrt, where(cond, a, b), min, max, power,
      signed_power(x, a)
  cross-sectional (per date over valid stocks):
      cs_rank, cs_zscore, cs_demean, cs_scale (unit L1 norm),
      cs_winsorize(x, k), cs_neutralize(x, group_field)
  time-series (per stock, trailing window):
      delay(x, d), delta(x, d), ts_mean(x, w), ts_std(x, w), ts_sum(x, w),
      ts_product(x, w), ts_min(x, w), ts_max(x, w), ts_rank(x, w),
      ts_corr(x, y, w), ts_cov(x, y, w), ts_argmax(x, w), ts_argmin(x, w),
      decay_linear(x, w)

All ops are NaN-masked (missing stays missing; windows require full validity
for corr/rank, count>=1 elsewhere).  A panel is a dict of (T, N) tensors;
the ops run where the tensors lie.  The validator (:func:`compile_alpha`)
is the reference's, rejection for rejection and message for message.

Where plain PyTorch differs from ``jax.numpy`` the port keeps the
reference's behaviour:

- ``sign`` keeps NaN (``torch.sign(nan)`` is 0, ``jnp.sign(nan)`` NaN);
- ``%`` is ``torch.remainder`` (Python's sign rule, as ``jnp.mod``);
- numeric literals evaluate as 0-d tensors of the panel's float dtype, the
  analog of JAX's weakly typed Python scalars (``where(c, 1, 0)`` is a
  float panel, ``min(x, 3.0)`` binds), and every expression's value is
  stacked in that dtype, as ``jnp.stack`` promotes;
- ``cs_rank`` sorts stably (torch's default sort is not stable), and
  inverts the permutation with a scatter of positions;
- ``ts_argmax``/``ts_argmin`` give a tie to the most recent day, through
  the reversed window and argmax's first occurrence;
- ``cs_neutralize`` sums each (date, group) segment in stock order with
  ``torch.segment_reduce`` over a stable sort of the group codes: no
  atomics (a CUDA scatter-add changes its bits from run to run) and no
  (T, N, groups) one-hot.

Windows are ``unfold`` views with the window as the last axis.  The
window sums of ``_winsum`` are cumsum differences; on the CPU the cumsum
adds in the reference's order (:func:`_cumsum`), because ``ts_std``'s
``ss - s*s/n`` and ``ts_corr``'s variances cancel where a window's
variance is small, and any other order moves those values by far more
than an ulp.
"""

from __future__ import annotations

import ast
import dataclasses
import functools
import inspect
from typing import Callable, Dict, Mapping, Sequence

import numpy as np
import torch

from mfm_tpu_torch.obs.trace import stage
from mfm_tpu_torch.ops.masked import winsorize_cs

_NAN = float("nan")
_INF = float("inf")


# ---------------------------------------------------------------------------
# masked panel primitives
# ---------------------------------------------------------------------------

def _nan_like(x):
    return torch.full((), _NAN, dtype=x.dtype, device=x.device)


def _sqrt(x):
    """The correctly rounded square root.  On the CPU ``torch.sqrt`` is
    MKL's vector sqrt, which is off by an ulp on ~1% of float64 inputs
    (~15% at float32); that moves values which are equal in exact
    arithmetic (a 2-point ``ts_corr`` is +-1) apart, and ranks break such
    ties by those bits.  numpy's (and the card's) sqrt is IEEE's."""
    if x.is_cuda:
        return torch.sqrt(x)
    with np.errstate(invalid="ignore"):  # sqrt(<0) is NaN, as torch's
        return torch.from_numpy(np.sqrt(x.numpy()))


def cs_rank(x):
    """Per-date fractional rank in (0, 1] over valid stocks (ties broken by
    position, pandas method='first'); works for any leading batch dims."""
    m = torch.isfinite(x)
    big = torch.where(m, x, _INF)
    order = torch.argsort(big, dim=-1, stable=True)
    pos = torch.arange(x.shape[-1], dtype=x.dtype, device=x.device)
    rank0 = torch.empty_like(x).scatter_(-1, order, pos.expand(x.shape))
    n = m.sum(dim=-1, keepdim=True)
    return torch.where(m, (rank0 + 1.0) / n, _nan_like(x))


def cs_zscore(x):
    m = torch.isfinite(x)
    n = m.sum(dim=-1, keepdim=True)
    mu = torch.where(m, x, 0.0).sum(dim=-1, keepdim=True) / n
    sd = _sqrt(torch.where(m, (x - mu) ** 2, 0.0).sum(
        dim=-1, keepdim=True) / n)
    return torch.where(m, (x - mu) / sd, _nan_like(x))


def cs_demean(x):
    m = torch.isfinite(x)
    n = m.sum(dim=-1, keepdim=True)
    mu = torch.where(m, x, 0.0).sum(dim=-1, keepdim=True) / n
    return torch.where(m, x - mu, _nan_like(x))


def cs_scale(x):
    m = torch.isfinite(x)
    denom = torch.where(m, torch.abs(x), 0.0).sum(dim=-1, keepdim=True)
    return torch.where(m, x / denom, _nan_like(x))


def delay(x, d: int):
    d = int(d)
    if d == 0:
        return x
    if d >= x.shape[0]:
        # lag past the series start: every cell is pre-history
        return torch.full_like(x, _NAN)
    pad = torch.full((d,) + x.shape[1:], _NAN, dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[:-d]], dim=0)


def delta(x, d: int):
    return x - delay(x, d)


def _windows(x, w: int):
    """(T, ..., W) trailing windows, NaN-padded before the series start: a
    view with the window as the last axis, today at position W-1."""
    w = int(w)
    pad = torch.full((w - 1,) + x.shape[1:], _NAN, dtype=x.dtype,
                     device=x.device)
    return torch.cat([pad, x], dim=0).unfold(0, w, 1)


def _ts_reduce(x, w, reducer, min_count=1):
    win = _windows(x, w)
    m = torch.isfinite(win)
    n = m.sum(dim=-1)
    out = reducer(win, m)
    return torch.where(n >= min_count, out, _nan_like(out))


#: the block length of the reference's cumulative sums (see _cumsum)
_CUMSUM_BLOCK = 16


def _cumsum(x):
    """Cumulative sum over the date axis.  On the CPU it adds in the order
    of the reference's ``jnp.cumsum`` on XLA's CPU backend: dates in
    blocks of 16, a running sum inside each block, and the running sum of
    the blocks' totals (the same rule, recursively) added to each block's.
    The window sums below are differences of these prefixes, so a window
    whose variance is (near) zero keeps the reference's value only if the
    prefixes keep its bits; this order does so at float64.  On the card
    it is one ``torch.cumsum`` over the dates laid out as the innermost
    axis, where CUDA scans a row in parallel (over an outer axis it runs
    each column's dates one after another); the card is held to the CPU
    on the summaries, within a tolerance, not bit for bit.  The forms
    are compared by ``tools/cumsum_forms.py``."""
    if x.is_cuda:
        return torch.cumsum(x.movedim(0, -1), dim=-1).movedim(-1, 0)
    T, B = x.shape[0], _CUMSUM_BLOCK
    if T <= B:
        return torch.cumsum(x, dim=0)
    nb = -(-T // B)
    pad = torch.zeros((nb * B - T,) + x.shape[1:], dtype=x.dtype,
                      device=x.device)
    inner = torch.cumsum(torch.cat([x, pad]).reshape((nb, B) + x.shape[1:]),
                         dim=1)
    done = _cumsum(inner[:, -1])
    before = torch.cat([torch.zeros_like(done[:1]), done[:-1]])
    return (before[:, None] + inner).reshape((nb * B,) + x.shape[1:])[:T]


def _winsum(x, w: int):
    """Trailing-window sum via cumsum difference — O(T), no window
    materialization."""
    w = int(w)
    cs = _cumsum(x)
    zeros = torch.zeros((w,) + x.shape[1:], dtype=cs.dtype, device=x.device)
    return cs - torch.cat([zeros, cs[:-w]], dim=0)[: x.shape[0]]


def _moments(x, w, min_count):
    m = torch.isfinite(x)
    n = _winsum(m.to(x.dtype), w)
    s = _winsum(torch.where(m, x, 0.0), w)
    gate = torch.where(n >= min_count, 1.0, _NAN).to(x.dtype)
    return m, n, s, gate


def ts_sum(x, w):
    m, n, s, gate = _moments(x, w, 1)
    return s * gate


def ts_mean(x, w):
    m, n, s, gate = _moments(x, w, 1)
    return s / n * gate


def ts_std(x, w):
    m, n, s, gate = _moments(x, w, 2)
    ss = _winsum(torch.where(m, x * x, 0.0), w)
    var = (ss - s * s / n) / (n - 1.0)
    return _sqrt(torch.clamp_min(var, 0.0)) * gate


def ts_min(x, w):
    return _ts_reduce(
        x, w, lambda win, m: torch.where(m, win, _INF).amin(dim=-1))


def ts_max(x, w):
    return _ts_reduce(
        x, w, lambda win, m: torch.where(m, win, -_INF).amax(dim=-1))


def ts_product(x, w):
    """Trailing-window product over valid entries (count >= 1 like ts_sum;
    a cumprod-ratio formulation would 0/0 on zero values, so the window is
    materialized like ts_min/ts_max)."""
    return _ts_reduce(
        x, w, lambda win, m: torch.where(m, win, 1.0).prod(dim=-1))


def ts_rank(x, w):
    """Fractional rank of today's value within its trailing window."""
    def red(win, m):
        cur = win[..., -1:]
        less = (m & (win <= cur)).sum(dim=-1)
        return less.to(x.dtype) / m.sum(dim=-1)

    return _ts_reduce(x, w, red)


def ts_corr(x, y, w):
    m = torch.isfinite(x) & torch.isfinite(y)
    xz = torch.where(m, x, 0.0)
    yz = torch.where(m, y, 0.0)
    n = _winsum(m.to(x.dtype), w)
    sx = _winsum(xz, w)
    sy = _winsum(yz, w)
    sxy = _winsum(xz * yz, w)
    sxx = _winsum(xz * xz, w)
    syy = _winsum(yz * yz, w)
    cov = sxy - sx * sy / n
    vx = sxx - sx * sx / n
    vy = syy - sy * sy / n
    out = cov / _sqrt(vx * vy)
    return torch.where(n >= 2, out, _nan_like(out))


def decay_linear(x, w):
    """Linearly-decaying weighted mean: weight (p+1) at window position p,
    renormalized over valid points.  Position weights are an affine function
    of the date index, so two cumsum-window sums suffice: with weight
    i - (t - w) for series index i, the weighted sum is
    [sum i*x]_win - (t-w) [sum x]_win."""
    w = int(w)
    m = torch.isfinite(x)
    t_idx = torch.arange(x.shape[0], dtype=x.dtype, device=x.device).reshape(
        (-1,) + (1,) * (x.dim() - 1))
    xz = torch.where(m, x, 0.0)
    mz = m.to(x.dtype)
    s_ix = _winsum(t_idx * xz, w)
    s_x = _winsum(xz, w)
    s_im = _winsum(t_idx * mz, w)
    s_m = _winsum(mz, w)
    base = t_idx - w  # weight of series index i in the window ending t: i-(t-w)
    num = s_ix - base * s_x
    den = s_im - base * s_m
    return torch.where(s_m >= 1, num / den, _nan_like(x))


def ts_cov(x, y, w):
    """Trailing sample covariance (pandas ``rolling.cov`` ddof=1)."""
    m = torch.isfinite(x) & torch.isfinite(y)
    xz = torch.where(m, x, 0.0)
    yz = torch.where(m, y, 0.0)
    n = _winsum(m.to(x.dtype), w)
    cov = _winsum(xz * yz, w) - _winsum(xz, w) * _winsum(yz, w) / n
    return torch.where(n >= 2, cov / (n - 1.0), _nan_like(cov))


def ts_argmax(x, w):
    """Days since the trailing-window maximum (0 = today is the max; ties
    resolve to the most recent occurrence)."""
    def red(win, m):
        rev = torch.where(m, win, -_INF).flip(-1)  # position 0 = today
        return torch.argmax(rev, dim=-1).to(x.dtype)

    return _ts_reduce(x, w, red)


def ts_argmin(x, w):
    """Days since the trailing-window minimum (0 = today; most recent tie)."""
    def red(win, m):
        rev = torch.where(m, win, _INF).flip(-1)
        return torch.argmin(rev, dim=-1).to(x.dtype)

    return _ts_reduce(x, w, red)


def _sign(x):
    """sign(x) that keeps NaN, as ``jnp.sign`` does."""
    return torch.where(torch.isnan(x), x, torch.sign(x))


def signed_power(x, a):
    """sign(x) * |x|**a — the WorldQuant convention for fractional powers
    of signed signals."""
    return _sign(x) * torch.abs(x) ** a


def cs_winsorize(x, k=2.5):
    """Per-date clip at mean ± k·std over valid stocks — the factor
    pipeline's own winsorization (:func:`mfm_tpu_torch.ops.masked.
    winsorize_cs`, ``post_processing.py:12-15``), with the DSL's
    NaN-stays-NaN convention."""
    out = winsorize_cs(x, n_std=k)
    return torch.where(torch.isfinite(x), out, _nan_like(x))


def cs_neutralize(x, g, num_groups: int = 64):
    """Subtract the per-(date, group) mean — industry/sector neutralization.

    ``g`` is a (T, N) panel field of small integer group codes in
    [0, num_groups) (float-encoded is fine).  Cells where x or g is missing
    — or where the code is OUT OF RANGE (e.g. raw 801010-style SW codes
    passed without ordinal-encoding first) — come back NaN rather than
    silently aliasing into a wrong group.

    Each date's cells are stably sorted by group code (out-of-universe
    cells last) and every (date, group) segment is summed in stock order by
    ``torch.segment_reduce``: O(T·N log N), deterministic on the card, no
    one-hot.
    """
    num_groups = int(num_groups)
    m = (torch.isfinite(x) & torch.isfinite(g)
         & (g >= 0) & (g < num_groups))
    gi = torch.where(m, g, 0).to(torch.int64)
    key = torch.where(m, gi, num_groups).reshape(-1, x.shape[-1])
    xs = torch.where(m, x, 0.0).reshape(key.shape)
    order = torch.argsort(key, dim=-1, stable=True)
    skey = torch.gather(key, -1, order)
    bounds = torch.arange(num_groups + 2, dtype=skey.dtype, device=x.device)
    edges = torch.searchsorted(
        skey, bounds.expand(key.shape[0], -1).contiguous())
    lengths = edges[:, 1:] - edges[:, :-1]  # (rows, groups + 1)
    sums = torch.segment_reduce(torch.gather(xs, -1, order), "sum",
                                lengths=lengths, axis=1, initial=0.0)
    cnts = lengths.to(x.dtype)
    mu = (sums / torch.clamp_min(cnts, 1.0))[:, :num_groups]
    mu_cell = torch.gather(mu, -1, gi.reshape(key.shape)).reshape(x.shape)
    return torch.where(m, x - mu_cell, _nan_like(x))


def _where(cond, x, y):
    if cond.dtype != torch.bool:
        cond = cond != 0  # jnp.where reads any nonzero (NaN too) as True
    return torch.where(cond, x, y)


_ELEMENTWISE = {
    # explicit-arity wrappers, so _check_arity binds exactly the
    # reference's signatures (torch builtins hide theirs)
    "abs": lambda x: torch.abs(x),
    "log": lambda x: torch.log(torch.where(x > 0, x, _NAN)),
    "sign": lambda x: _sign(x),
    "sqrt": lambda x: _sqrt(torch.where(x >= 0, x, _NAN)),
    "power": lambda x, y: torch.pow(x, y),
    "min": lambda x, y: torch.minimum(x, y),
    "max": lambda x, y: torch.maximum(x, y),
    "where": lambda cond, x, y: _where(cond, x, y),
}

_OPS: Dict[str, Callable] = {
    **_ELEMENTWISE,
    "cs_rank": cs_rank,
    "cs_zscore": cs_zscore,
    "cs_demean": cs_demean,
    "cs_scale": cs_scale,
    "delay": delay,
    "delta": delta,
    "ts_mean": ts_mean,
    "ts_std": ts_std,
    "ts_sum": ts_sum,
    "ts_min": ts_min,
    "ts_max": ts_max,
    "ts_product": ts_product,
    "ts_rank": ts_rank,
    "ts_corr": ts_corr,
    "ts_cov": ts_cov,
    "ts_argmax": ts_argmax,
    "ts_argmin": ts_argmin,
    "decay_linear": decay_linear,
    "signed_power": signed_power,
    "cs_winsorize": cs_winsorize,
    "cs_neutralize": cs_neutralize,
}

# WorldQuant "101 Formulaic Alphas" vocabulary aliases: LLMs prompted for
# alpha factors overwhelmingly emit these operator names, so the DSL accepts
# them directly — each maps onto the op of matching semantics.  min/max
# deliberately stay ELEMENTWISE (NumPy semantics) — the 101 paper reads
# min(x, d) as ts_min; the validator rejects the ambiguous integer form
# rather than silently picking a meaning.  Op names (incl. aliases) are
# reserved words: a panel field may not use one.
_ALIASES = {
    "rank": "cs_rank",
    "stddev": "ts_std",
    "correlation": "ts_corr",
    "covariance": "ts_cov",
    "sum": "ts_sum",
    "product": "ts_product",
    "signedpower": "signed_power",
    "indneutralize": "cs_neutralize",
    "scale": "cs_scale",
}
_OPS.update({alias: _OPS[target] for alias, target in _ALIASES.items()})

_BINOPS = {
    ast.Add: torch.add,
    ast.Sub: torch.subtract,
    ast.Mult: torch.multiply,
    ast.Div: torch.divide,
    ast.Pow: torch.pow,
    ast.Mod: torch.remainder,
}
_CMPOPS = {
    ast.Gt: torch.greater,
    ast.GtE: torch.greater_equal,
    ast.Lt: torch.less,
    ast.LtE: torch.less_equal,
    ast.Eq: torch.eq,
    ast.NotEq: torch.not_equal,
}

# exactly the node types _eval_node can evaluate (plus the operator classes
# it maps and the Load context every Name carries): validation is a
# WHITELIST, so anything newer/fancier — lists, ternaries, boolean ops,
# f-strings, walrus, ast.keyword, FloorDiv/BitXor/... — fails compile with
# a per-line ValueError instead of surfacing mid-batch.
_ALLOWED_NODES = (ast.Expression, ast.Constant, ast.Name, ast.Load,
                  ast.BinOp, ast.UnaryOp, ast.Compare, ast.Call,
                  ast.USub, ast.UAdd) + tuple(_BINOPS) + tuple(_CMPOPS)

# longest source worth parsing: the 101-alphas corpus tops out around 200
# chars; 4096 leaves room for deep composites while keeping CPython's
# parser clear of the stack overflows of degenerate sampling-loop lines
_MAX_SOURCE_CHARS = 4096


@dataclasses.dataclass
class AlphaExpr:
    """A parsed, validated alpha expression."""

    source: str
    tree: ast.Expression
    fields: tuple

    def __call__(self, panel: Mapping[str, torch.Tensor]) -> torch.Tensor:
        return _eval_node(self.tree.body, _Env(panel))


def _collect_fields(node, fields):
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and n.id not in _OPS:
            fields.add(n.id)


# positional args that must be INTEGER CONSTANTS within a per-op range
# (windows, lags, group counts): {canonical op: {arg index: (lo, hi)}}.
# They size windows and tables, so a non-constant there
# (``delay(close, volume)``) or a non-int (``ts_mean(close, 5.5)``) is
# rejected at compile.  Windows need >= 1 and are capped at 2048: the
# window-materializing reductions build a (T, N, w) tensor, so an
# LLM-emitted ``ts_rank(close, 50000)`` would exhaust the device's memory,
# while every real trading window is <= 504 (RSTR).  delay/delta lags
# support 0 under the same cap; num_groups is capped at 4096 (SW L1 has 31
# industries).  Float-valued constants like cs_winsorize's k or exponents
# are deliberately absent.
_W = (1, 2048)
_STATIC_INT_ARGS = {
    "delay": {1: (0, 2048)}, "delta": {1: (0, 2048)},
    "ts_mean": {1: _W}, "ts_std": {1: _W}, "ts_sum": {1: _W},
    "ts_min": {1: _W}, "ts_max": {1: _W}, "ts_product": {1: _W},
    "ts_rank": {1: _W}, "ts_argmax": {1: _W}, "ts_argmin": {1: _W},
    "decay_linear": {1: _W},
    "ts_corr": {2: _W}, "ts_cov": {2: _W},
    "cs_neutralize": {2: (1, 4096)},
}


def _check_static_int_args(node: ast.Call):
    canon = _ALIASES.get(node.func.id, node.func.id)
    for idx, (lo, hi) in _STATIC_INT_ARGS.get(canon, {}).items():
        if idx >= len(node.args):
            continue  # optional (cs_neutralize's num_groups); arity is
            # checked separately
        a = node.args[idx]
        if not (isinstance(a, ast.Constant) and isinstance(a.value, int)
                and not isinstance(a.value, bool) and lo <= a.value <= hi):
            got = ast.unparse(a)
            raise ValueError(
                f"{node.func.id} argument {idx + 1} must be an integer "
                f"constant in [{lo}, {hi}] (a window/lag/group count), "
                f"got {got!r}")


# deepest expression tree accepted: real alphas nest < 20 levels; beyond
# ~1000 the recursive _eval_node would hit Python's recursion limit at
# evaluation time.  Computed iteratively so the check cannot overflow.
_MAX_AST_DEPTH = 100


def _ast_depth(tree) -> int:
    depth = 0
    stack = [(tree, 1)]
    while stack:
        node, d = stack.pop()
        depth = max(depth, d)
        stack.extend((child, d + 1) for child in ast.iter_child_nodes(node))
    return depth


def _check_arity(name: str, nargs: int):
    """Reject calls whose argument count the op cannot bind — at COMPILE
    time, so a 101-paper signature mismatch (``scale(x, 2)``, ``sum(x)``
    without the window) surfaces as a reportable ValueError instead of a
    TypeError mid-evaluation."""
    try:
        sig = inspect.signature(_OPS[name])
    except (TypeError, ValueError):  # a builtin may hide its signature
        return
    try:
        sig.bind(*([None] * nargs))
    except TypeError:
        raise ValueError(f"{name} does not take {nargs} argument(s)") from None


def compile_alpha(source: str) -> AlphaExpr:
    """Parse an expression string into a callable panel op.

    Raises ValueError on any syntax outside what :func:`_eval_node` can
    evaluate (attribute access, subscripts, lambdas, comprehensions,
    lists/tuples/dicts, ternaries, boolean operators, f-strings,
    ``//``/bitwise operators, ... are all rejected), on a call with
    unbindable arity, on an op name used as a value (op names are reserved
    words), and on the 101-ambiguous ``min(x, d)``/``max(x, d)`` integer
    form (the paper reads it as ts_min/ts_max; this DSL's min/max are
    elementwise).  Everything is checked HERE, so nothing that compiles
    can later fail inside a batch, where one bad expression would abort
    the whole chunk.
    """
    if len(source) > _MAX_SOURCE_CHARS:
        raise ValueError(
            f"expression too long: {len(source)} chars (max "
            f"{_MAX_SOURCE_CHARS}) — degenerate sampling-loop line?")
    try:
        tree = ast.parse(source, mode="eval")
    except (RecursionError, MemoryError):
        # CPython's parser overflows its stack on deep token runs
        # ('-'*3000 + 'close') — per-line handlers expect ValueError
        raise ValueError("expression too deeply nested to parse") from None
    depth = _ast_depth(tree)
    if depth > _MAX_AST_DEPTH:
        raise ValueError(
            f"expression nests {depth} levels deep (max {_MAX_AST_DEPTH}) — "
            "evaluation would overflow the recursion limit mid-batch")
    callees = {id(n.func) for n in ast.walk(tree) if isinstance(n, ast.Call)}
    for node in ast.walk(tree):
        if not isinstance(node, _ALLOWED_NODES):
            raise ValueError(f"disallowed syntax in alpha: "
                             f"{type(node).__name__} in {ast.dump(node)[:60]}")
        if isinstance(node, ast.Constant) and (
                isinstance(node.value, bool)
                or not isinstance(node.value, (int, float))):
            # strings/None/bytes/complex are not panel values; bools are
            # not part of the DSL grammar either
            raise ValueError(
                f"non-numeric constant {str(node.value)[:40]!r} in alpha")
        if isinstance(node, ast.Compare) and len(node.ops) != 1:
            raise ValueError("chained comparisons unsupported in alpha")
        if isinstance(node, ast.Call):
            if not isinstance(node.func, ast.Name) or node.func.id not in _OPS:
                raise ValueError(f"unknown function in alpha: {ast.dump(node.func)[:60]}")
            _check_arity(node.func.id, len(node.args))
            _check_static_int_args(node)
            if (node.func.id in ("min", "max") and len(node.args) == 2
                    and isinstance(node.args[1], ast.Constant)
                    and isinstance(node.args[1].value, int)):
                raise ValueError(
                    f"ambiguous {node.func.id}(x, {node.args[1].value}): the "
                    "101-alphas paper reads this as the windowed "
                    f"ts_{node.func.id}; write ts_{node.func.id}(x, d) for "
                    "the window or use a float (e.g. "
                    f"{node.args[1].value}.0) for an elementwise clamp")
        elif isinstance(node, ast.Name) and node.id in _OPS \
                and id(node) not in callees:
            raise ValueError(f"op name {node.id!r} used as a value "
                             "(op names are reserved words)")
    fields: set = set()
    _collect_fields(tree, fields)
    return AlphaExpr(source=source, tree=tree, fields=tuple(sorted(fields)))


class _Env:
    """A panel being evaluated: its fields, the float dtype and device its
    numeric literals take, and those literals made once each."""

    def __init__(self, panel: Mapping[str, torch.Tensor]):
        self.panel = panel
        tensors = [v for v in panel.values() if torch.is_tensor(v)]
        floats = [v.dtype for v in tensors if v.is_floating_point()]
        self.dtype = (functools.reduce(torch.promote_types, floats)
                      if floats else torch.get_default_dtype())
        self.device = tensors[0].device if tensors else torch.device("cpu")
        self._consts: dict = {}

    def const(self, value) -> torch.Tensor:
        c = self._consts.get(value)
        if c is None:
            c = torch.tensor(value, dtype=self.dtype, device=self.device)
            self._consts[value] = c
        return c


def _eval_node(node, env: _Env):
    if isinstance(node, ast.Constant):
        return env.const(node.value)
    if isinstance(node, ast.Name):
        return env.panel[node.id]
    if isinstance(node, ast.BinOp):
        return _BINOPS[type(node.op)](_eval_node(node.left, env),
                                      _eval_node(node.right, env))
    if isinstance(node, ast.UnaryOp):
        v = _eval_node(node.operand, env)
        if isinstance(node.op, ast.USub):
            return -v
        if isinstance(node.op, ast.UAdd):
            return v
        raise ValueError("unsupported unary op")
    if isinstance(node, ast.Compare):
        if len(node.ops) != 1:
            raise ValueError("chained comparisons unsupported")
        return _CMPOPS[type(node.ops[0])](_eval_node(node.left, env),
                                          _eval_node(node.comparators[0], env))
    if isinstance(node, ast.Call):
        # window/lag/group counts stay Python ints (they size tensors)
        static = _STATIC_INT_ARGS.get(_ALIASES.get(node.func.id,
                                                   node.func.id), {})
        args = [a.value if i in static else _eval_node(a, env)
                for i, a in enumerate(node.args)]
        return _OPS[node.func.id](*args)
    raise ValueError(f"unsupported node {type(node).__name__}")


def _groups(sources: Sequence[str], chunk):
    if not sources:
        # fail at compile time with a real message
        raise ValueError("no sources")
    exprs = [compile_alpha(s) for s in sources]
    chunk = len(exprs) if not chunk else chunk
    return exprs, [exprs[i:i + chunk] for i in range(0, len(exprs), chunk)]


def _stack(group, env: _Env) -> torch.Tensor:
    """One group's values, in source order, stacked in the panel's float
    dtype."""
    return torch.stack([_eval_node(e.tree.body, env).to(env.dtype)
                        for e in group], dim=0)


def compile_alpha_batch(sources: Sequence[str], chunk: int = 1000) -> Callable:
    """Compile a batch of expressions into a panel -> (E, T, N) callable.

    The expressions are evaluated ``chunk`` at a time (``None`` or 0: all
    at once) and each chunk is written into one preallocated (E, T, N)
    tensor, so live memory is the result plus one chunk's values.  Values
    do not depend on ``chunk``.  Reuse the returned callable over panels.
    With stage spans on (``obs/trace.set_stage_tracing``), a call is an
    ``alpha.batch`` span over one ``alpha.eval`` span a chunk (its
    evaluation and its write).
    """
    exprs, groups = _groups(sources, chunk)

    def run(panel):
        env = _Env(panel)
        out, at = None, 0
        with stage("alpha.batch", env.device, exprs=len(exprs),
                   chunks=len(groups)):
            for i, group in enumerate(groups):
                with stage("alpha.eval", env.device, exprs=len(group),
                           chunk=i):
                    vals = _stack(group, env)
                    if out is None:
                        out = torch.empty((len(exprs),) + vals.shape[1:],
                                          dtype=vals.dtype,
                                          device=vals.device)
                    out[at:at + len(group)] = vals
                at += len(group)
                del vals
        return out

    return run


def compile_alpha_scores(sources: Sequence[str], chunk: int = 50) -> Callable:
    """Compile expressions into a fused ``(panel, fwd_ret) -> summary``
    callable that never materializes the full (E, T, N) alpha tensor.

    The all-A memory plan (config 5 at 2500 x 5000): one alpha panel is
    T*N*4 = 50 MB, so 1,000 stacked alphas are 50 GB; the window ops
    (ts_rank/ts_min/ts_argmax materialize (T, N, W)) add up to W x 50 MB
    of transient per expression.  Each chunk of expressions is reduced to
    its (E,)-shaped summary before the next chunk runs, so live memory is
    ``chunk`` panels, the summary's transients over them, and one window
    buffer.  Returns a dict of (E,) tensors in source order
    (:func:`mfm_tpu_torch.alpha.metrics.alpha_summary` keys).
    """
    from mfm_tpu_torch.alpha.metrics import alpha_summary

    _, groups = _groups(sources, chunk)

    def run(panel, fwd):
        env = _Env(panel)
        outs = []
        for group in groups:
            outs.append(alpha_summary(_stack(group, env), fwd))
        return {k: torch.cat([o[k] for o in outs], dim=0) for k in outs[0]}

    return run


def evaluate_alphas(sources: Sequence[str],
                    panel: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """One-shot batch evaluation -> (E, T, N) (config 5).

    For repeated evaluation compile once with :func:`compile_alpha_batch`.
    """
    return compile_alpha_batch(sources)(dict(panel))
