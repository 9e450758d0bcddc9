"""The plain reference of alpha scoring: expressions of the alpha DSL
evaluated over a (T, N) panel from the operators' definitions, and each
scored as ``alpha_summary`` scores it, at the precision it is asked for.

Window sums are differences of prefix sums over the dates, the O(T) form
the DSL's definitions take, or, asked for (``"<precision>-direct"``),
sums over each materialised window; a window rank compares the
materialised window (``unfold``); masks follow the DSL's rules (missing stays missing;
a window counts its finite cells; ranks break ties by position).  It
parses the expression text with ``ast`` itself and imports nothing of the
program.
"""

from __future__ import annotations

import ast
import contextvars
import math

import torch

_NAN = math.nan
#: stock columns a window operator takes at a time, bounding the (T, n, w)
#: window tensors
_WINDOW_CELLS = 1 << 26
#: window sums over each window (True) or as prefix-sum differences
_DIRECT = contextvars.ContextVar("direct_window_sums", default=False)


class Panel:
    def __init__(self, fields: dict, dtype):
        self.fields = {k: v.to(dtype) for k, v in fields.items()}
        self.dtype = dtype
        first = next(iter(self.fields.values()))
        self.T, self.N = first.shape
        self.device = first.device


def _windows(x, w: int, fill):
    """(T, n, w) trailing windows of x (T, n), ``fill`` before the start."""
    pad = torch.full((w - 1,) + x.shape[1:], fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([pad, x]).unfold(0, w, 1)


def _by_columns(fn, w: int, *xs):
    T, N = xs[0].shape
    step = max(1, _WINDOW_CELLS // (T * w))
    return torch.cat([fn(*(x[:, a:a + step] for x in xs))
                      for a in range(0, N, step)], dim=1)


def delay(x, d: int):
    T = x.shape[0]
    out = torch.full_like(x, _NAN)
    if d < T:
        out[d:] = x[:T - d]
    return out


def delta(x, d: int):
    return x - delay(x, d)


def cs_rank(x):
    """Rank / (finite count) over the last axis, 1-based, ties by position."""
    m = torch.isfinite(x)
    order = torch.argsort(torch.where(m, x, math.inf), dim=-1, stable=True)
    pos = torch.arange(1, x.shape[-1] + 1, device=x.device).expand(x.shape)
    rank = torch.empty(x.shape, dtype=torch.int64, device=x.device)
    rank.scatter_(-1, order, pos)
    n = m.sum(dim=-1, keepdim=True)
    return torch.where(m, rank.to(x.dtype) / n.to(x.dtype),
                       torch.full_like(x, _NAN))


def _cs_moments(x):
    m = torch.isfinite(x)
    n = m.sum(dim=-1, keepdim=True).to(x.dtype)
    mu = torch.where(m, x, 0.0).sum(dim=-1, keepdim=True) / n
    return m, n, mu


def cs_demean(x):
    m, _, mu = _cs_moments(x)
    return torch.where(m, x - mu, torch.full_like(x, _NAN))


def cs_zscore(x):
    m, n, mu = _cs_moments(x)
    sd = torch.sqrt(torch.where(m, (x - mu) ** 2, 0.0).sum(
        dim=-1, keepdim=True) / n)
    return torch.where(m, (x - mu) / sd, torch.full_like(x, _NAN))


def _winsum(x, w: int):
    """Trailing-window sums over the dates: differences of prefix sums
    (the O(T) form; its cancellation grows as the precision falls), or
    with direct sums each window's own sum."""
    if _DIRECT.get():
        return _by_columns(lambda xc: _windows(xc, w, 0.0).sum(dim=-1), w, x)
    cs = torch.cumsum(x, dim=0)
    return cs - torch.cat([torch.zeros_like(cs[:w]), cs[:-w]])[:x.shape[0]]


def _moments(x, w: int):
    m = torch.isfinite(x)
    return m, _winsum(m.to(x.dtype), w), _winsum(torch.where(m, x, 0.0), w)


def _gate(n, min_count: int, out):
    return torch.where(n >= min_count, out, torch.full_like(out, _NAN))


def ts_mean(x, w: int):
    _, n, s = _moments(x, w)
    return _gate(n, 1, s / n)


def ts_std(x, w: int):
    m, n, s = _moments(x, w)
    ss = _winsum(torch.where(m, x * x, 0.0), w)
    var = torch.clamp_min((ss - s * s / n) / (n - 1.0), 0.0)
    return _gate(n, 2, torch.sqrt(var))


def ts_corr(x, y, w: int):
    m = torch.isfinite(x) & torch.isfinite(y)
    xz, yz = torch.where(m, x, 0.0), torch.where(m, y, 0.0)
    n = _winsum(m.to(x.dtype), w)
    sx, sy = _winsum(xz, w), _winsum(yz, w)
    cov = _winsum(xz * yz, w) - sx * sy / n
    vx = _winsum(xz * xz, w) - sx * sx / n
    vy = _winsum(yz * yz, w) - sy * sy / n
    return _gate(n, 2, cov / torch.sqrt(vx * vy))


def decay_linear(x, w: int):
    """Weight p + 1 at window position p (oldest 0), over the finite
    cells: with t the date index, the weight of date i in the window
    ending at t is i - (t - w), so two window sums of i x and x give it."""
    m = torch.isfinite(x)
    t = torch.arange(x.shape[0], device=x.device).to(x.dtype)[:, None]
    xz, mz = torch.where(m, x, 0.0), m.to(x.dtype)
    base = t - w
    num = _winsum(t * xz, w) - base * _winsum(xz, w)
    den = _winsum(t * mz, w) - base * _winsum(mz, w)
    return _gate(_winsum(mz, w), 1, num / den)


def ts_rank(x, w: int):
    """Share of the window's finite cells at or below today's value."""
    def cols(xc):
        win = _windows(xc, w, _NAN)
        m = torch.isfinite(win)
        n = m.sum(dim=-1)
        less = (m & (win <= win[..., -1:])).sum(dim=-1)
        return _gate(n, 1, less.to(xc.dtype) / n.to(xc.dtype))
    return _by_columns(cols, w, x)


_OPS = {
    "delay": delay, "delta": delta, "cs_rank": cs_rank,
    "cs_demean": cs_demean, "cs_zscore": cs_zscore,
    "ts_mean": ts_mean, "ts_std": ts_std, "decay_linear": decay_linear,
    "ts_rank": ts_rank, "ts_corr": ts_corr,
    "where": lambda c, a, b: torch.where(c, a, b),
}
#: arguments that are counts (windows, lags), kept as Python ints
_INT_ARGS = {"delay": (1,), "delta": (1,), "ts_mean": (1,), "ts_std": (1,),
             "decay_linear": (1,), "ts_rank": (1,), "ts_corr": (2,)}
_BIN = {ast.Add: torch.add, ast.Sub: torch.sub, ast.Mult: torch.mul,
        ast.Div: torch.div}
_CMP = {ast.Gt: torch.gt, ast.Lt: torch.lt, ast.GtE: torch.ge,
        ast.LtE: torch.le}


def _eval(node, panel: Panel):
    if isinstance(node, ast.Expression):
        return _eval(node.body, panel)
    if isinstance(node, ast.Constant):
        return torch.tensor(float(node.value), dtype=panel.dtype,
                            device=panel.device)
    if isinstance(node, ast.Name):
        return panel.fields[node.id]
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        return -_eval(node.operand, panel)
    if isinstance(node, ast.BinOp):
        return _BIN[type(node.op)](_eval(node.left, panel),
                                   _eval(node.right, panel))
    if isinstance(node, ast.Compare) and len(node.ops) == 1:
        return _CMP[type(node.ops[0])](_eval(node.left, panel),
                                       _eval(node.comparators[0], panel))
    if isinstance(node, ast.Call):
        name = node.func.id
        ints = _INT_ARGS.get(name, ())
        args = [int(a.value) if i in ints else _eval(a, panel)
                for i, a in enumerate(node.args)]
        return _OPS[name](*args)
    raise ValueError(f"the reference has no rule for {ast.dump(node)[:80]}")


def evaluate(source: str, panel: Panel) -> torch.Tensor:
    """One expression's (T, N) values in the panel's dtype."""
    out = _eval(ast.parse(source, mode="eval"), panel)
    return out.to(panel.dtype).expand(panel.T, panel.N)


def _mean(x, m):
    """Mean over the last axis of the cells where ``m`` holds."""
    return torch.where(m, x, 0.0).sum(dim=-1) / m.sum(dim=-1).to(x.dtype)


def _ic(a, f):
    """Per-date Pearson correlation over the stocks finite in both."""
    m = torch.isfinite(a) & torch.isfinite(f)
    n = m.sum(dim=-1)
    da = torch.where(m, a - _mean(a, m)[..., None], 0.0)
    df = torch.where(m, f - _mean(f, m)[..., None], 0.0)
    ic = (da * df).sum(dim=-1) / torch.sqrt(
        (da * da).sum(dim=-1) * (df * df).sum(dim=-1))
    return torch.where(n >= 3, ic, torch.full_like(ic, _NAN))


def _nanmean(x):
    return _mean(x, torch.isfinite(x))


def summary(alpha, fwd, q: float = 0.2) -> dict:
    """The six scores of one (T, N) alpha against forward returns."""
    ic = _ic(alpha, fwd)
    r = cs_rank(alpha)
    m = torch.isfinite(ic)
    mean_ic = _mean(ic, m)
    var_ic = torch.where(m, (ic - mean_ic) ** 2, 0.0).sum() / \
        m.sum().to(ic.dtype)
    prev = delay(r, 1)
    mt = torch.isfinite(r) & torch.isfinite(prev)
    turn = torch.where(mt, (r - prev).abs(), 0.0).sum(dim=-1) / \
        mt.sum(dim=-1).to(r.dtype)
    turn = torch.where(mt.sum(dim=-1) >= 1, turn, torch.full_like(turn, _NAN))
    ms = torch.isfinite(r) & torch.isfinite(fwd)
    top, bot = ms & (r > 1.0 - q), ms & (r <= q)
    spread = _mean(fwd, top) - _mean(fwd, bot)
    spread = torch.where((top.sum(dim=-1) >= 1) & (bot.sum(dim=-1) >= 1),
                         spread, torch.full_like(spread, _NAN))
    cells = alpha.shape[0] * alpha.shape[1]
    return {"mean_ic": mean_ic, "ic_ir": mean_ic / torch.sqrt(var_ic),
            "mean_rank_ic": _nanmean(_ic(r, cs_rank(fwd))),
            "coverage": torch.isfinite(alpha).sum().to(alpha.dtype) / cells,
            "mean_turnover": _nanmean(turn),
            "mean_spread": _nanmean(spread)}


def score(sources: list, fields: dict, fwd, precision: str = "float64") -> dict:
    """Each expression evaluated and scored: ``{key: (E,) float64}``.
    ``precision`` names the arithmetic (:class:`..linalg.Precision`),
    with ``-direct`` after it for window sums over each window."""
    from mfmbench.reference.linalg import Precision

    name, _, sums = precision.partition("-")
    if sums not in ("", "direct"):
        raise ValueError(f"unknown window sums {sums!r}")
    dtype = Precision(name).dtype
    panel = Panel(fields, dtype)
    f = fwd.to(dtype)
    token = _DIRECT.set(sums == "direct")
    try:
        rows = [summary(evaluate(s, panel), f) for s in sources]
    finally:
        _DIRECT.reset(token)
    return {k: torch.stack([r[k] for r in rows]).double() for k in rows[0]}
