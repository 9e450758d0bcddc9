"""Model-health report over a risk results directory (counterpart of
``mfm_tpu/utils/report.py``), numpy-first over ``data/csvio.py``.

One JSON health summary plus one small-multiples PNG, computed from the
result tables the ``risk`` / ``pipeline`` subcommands write
(``factor_returns.csv``, ``r_squared.csv``, ``lambda.csv``, and when
present ``specific_returns.csv`` and the optional JSON artifacts
``bias_stats.json``, ``portfolio_bias.json``, ``portfolio_risk.json``,
``alpha_styles.json``).

The statistics are the reference's pandas reductions, done in numpy the
way pandas does them: ``std(ddof=1)`` skipping NaN (the mean of the
observed values, then the sum of squared deviations over ``count - 1``),
``quantile`` by linear interpolation, ``median``, ``cumsum`` after
``fillna(0)``; every number is rounded to 6 decimals.  Factors are listed
by descending cumulative return, ties in table order.  matplotlib is
needed only by :func:`plot_model_health`.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

# fixed-order categorical palette, assigned over the selected factors in the
# result table's own column order; factors beyond the palette fold into gray
_PALETTE = ["#3b6ccc", "#e2862d", "#2e9e77", "#c4534f", "#8b67c9", "#937264"]
_FOLD_COLOR = "#b8bcc4"
_ACCENT = "#3b6ccc"
_GRID = {"color": "#e4e6ea", "lw": 0.6}


@dataclasses.dataclass
class SeriesTable:
    """A result table: ``dates`` (datetime64[D]), ``columns`` and the
    (dates, columns) float64 ``values``."""

    dates: np.ndarray
    columns: list
    values: np.ndarray

    def take(self, rows) -> "SeriesTable":
        return SeriesTable(self.dates[rows], self.columns, self.values[rows])

    def first_column(self) -> "SeriesTable":
        return SeriesTable(self.dates, self.columns[:1], self.values[:, :1])

    def dropna(self, how: str = "any") -> "SeriesTable":
        """Rows with a NaN (``how="all"``: rows all NaN) dropped."""
        nan = np.isnan(self.values)
        return self.take(~(nan.all(axis=1) if how == "all"
                           else nan.any(axis=1)))


def _read_series_table(results_dir: str, name: str) -> SeriesTable | None:
    from mfm_tpu_torch.data.csvio import read_csv
    from mfm_tpu_torch.pipeline import date_stamp

    path = os.path.join(results_dir, name)
    if not os.path.exists(path):
        return None
    table = read_csv(path)
    names = list(table)
    index = np.asarray(table[names[0]])
    uniq, inv = np.unique(index.astype(str), return_inverse=True)
    days = np.array([date_stamp(s) for s in uniq.tolist()],
                    "datetime64[D]")[inv.reshape(-1)]
    cols = names[1:]
    values = np.empty((len(index), len(cols)))
    for j, c in enumerate(cols):
        col = np.asarray(table[c])
        values[:, j] = (col.astype(np.float64) if col.dtype.kind in "biuf"
                        else np.nan)
    return SeriesTable(days, cols, values)


def load_results(results_dir: str) -> dict:
    """Read whatever result tables exist under ``results_dir``.

    Returns ``factor_returns`` / ``r_squared`` / ``lambda`` /
    ``specific_returns`` :class:`SeriesTable` s (absent keys omitted) plus
    the parsed optional JSON artifacts when present: ``bias_stats`` /
    ``portfolio_bias`` / ``portfolio_risk`` / ``alpha_styles``.
    ``factor_returns`` is required — a directory without it is not a
    risk run's output.
    """
    out = {}
    for key, fname in (("factor_returns", "factor_returns.csv"),
                       ("r_squared", "r_squared.csv"),
                       ("lambda", "lambda.csv"),
                       ("specific_returns", "specific_returns.csv")):
        t = _read_series_table(results_dir, fname)
        if t is not None:
            out[key] = t
    if "factor_returns" not in out:
        raise FileNotFoundError(
            f"{results_dir}/factor_returns.csv not found — run the `risk` or "
            "`pipeline` subcommand into this directory first")
    for key, fname in (("bias_stats", "bias_stats.json"),
                       ("portfolio_bias", "portfolio_bias.json"),
                       ("portfolio_risk", "portfolio_risk.json"),
                       ("alpha_styles", "alpha_styles.json")):
        path = os.path.join(results_dir, fname)
        if os.path.exists(path):
            with open(path) as fh:
                out[key] = json.load(fh)
    return out


def _num(x):
    x = float(x)
    return None if not np.isfinite(x) else round(x, 6)


def nanstd(x: np.ndarray, ddof: int = 1) -> float:
    """pandas' ``std(ddof)`` of one row or column, NaN skipped: the mean
    of the observed values, then the squared deviations' sum over
    ``count - ddof``."""
    x = np.ascontiguousarray(x, np.float64)
    mask = np.isnan(x)
    count = x.size - int(mask.sum())
    if count - ddof <= 0:
        return float("nan")
    vals = np.where(mask, 0.0, x)
    avg = vals.sum() / count
    sqr = np.where(mask, 0.0, (avg - vals) ** 2)
    return float(np.sqrt(sqr.sum() / (count - ddof)))


def _bias_scope(bias_stats: dict) -> tuple[str | None, dict]:
    """The scope to report from a ``bias_stats_summary`` dict: the
    burn-in-excluded one when present (``after_burn_in_{n}``), else all
    valid dates."""
    for key in bias_stats:
        if key.startswith("after_burn_in"):
            return key, bias_stats[key]
    if "all_valid_dates" in bias_stats:
        return "all_valid_dates", bias_stats["all_valid_dates"]
    return None, {}


def _cum_and_vol(valid: SeriesTable, ann_factor: int):
    """Per-column cumulative return (``fillna(0).cumsum()``'s last row)
    and annualized vol (``std(ddof=1) * sqrt(ann)``)."""
    filled = np.where(np.isnan(valid.values), 0.0, valid.values)
    cum = np.cumsum(filled, axis=0)
    last = cum[-1] if len(cum) else np.zeros(len(valid.columns))
    vol = np.array([nanstd(valid.values[:, j])
                    for j in range(len(valid.columns))]) * np.sqrt(ann_factor)
    return cum, last, vol


def model_health_summary(results_dir: str, ann_factor: int = 252,
                         roll_window: int = 63, res: dict | None = None) -> dict:
    """The three model-health metrics the reference tracks (R² per date,
    bias statistics, λ series) plus per-factor return/vol attribution, as
    one JSON-able dict.  ``res``: an already-loaded :func:`load_results`
    dict."""
    res = load_results(results_dir) if res is None else res
    valid = res["factor_returns"].dropna(how="all")
    summary: dict = {
        "results_dir": os.path.abspath(results_dir),
        "dates": {"first": str(valid.dates[0]), "last": str(valid.dates[-1]),
                  "count": int(len(valid.dates))},
    }
    _, last, vol = _cum_and_vol(valid, ann_factor)
    order = np.argsort(-last, kind="stable")
    summary["factors"] = {
        valid.columns[j]: {"cum_return": _num(last[j]),
                           "ann_vol": _num(vol[j])}
        for j in order}

    if "r_squared" in res:
        r2 = res["r_squared"].first_column().dropna().values[:, 0]
        recent = r2[-roll_window:] if roll_window > 0 else r2[:0]
        summary["r2"] = {
            "mean": _num(np.mean(r2)) if len(r2) else None,
            "median": _num(np.median(r2)) if len(r2) else None,
            "p10": _num(np.percentile(r2, 0.10 * 100)) if len(r2) else None,
            "p90": _num(np.percentile(r2, 0.90 * 100)) if len(r2) else None,
            f"last_{roll_window}d_mean": (_num(np.mean(recent))
                                          if len(recent) else None),
        }
    if "lambda" in res:
        lam = res["lambda"].first_column().dropna().values[:, 0]
        summary["lambda"] = {
            "last": _num(lam[-1]) if len(lam) else None,
            "mean": _num(np.mean(lam)) if len(lam) else None,
            "min": _num(np.min(lam)) if len(lam) else None,
            "max": _num(np.max(lam)) if len(lam) else None,
        }
    if "specific_returns" in res:
        sp = res["specific_returns"].values
        disp = np.array([nanstd(sp[i]) for i in range(sp.shape[0])])
        disp = disp[~np.isnan(disp)]
        summary["specific_dispersion"] = {
            "mean_xsec_std": _num(np.mean(disp)) if len(disp) else None,
            "last": _num(disp[-1]) if len(disp) else None,
        }
    if "bias_stats" in res:
        scope_name, scope = _bias_scope(res["bias_stats"])
        summary["bias"] = {
            label: {"mean_abs_dev_from_1": d.get("mean_abs_dev_from_1")}
            for label, d in scope.items() if isinstance(d, dict)
        }
        summary["bias"]["scope"] = scope_name
    if "portfolio_bias" in res:
        scope_name, scope = _bias_scope(res["portfolio_bias"])
        summary["portfolio_bias"] = {
            "scope": scope_name,
            "n_portfolios": res["portfolio_bias"].get("n_portfolios"),
            "mean": scope.get("mean"),
            "median": scope.get("median"),
            "mean_abs_dev_from_1": scope.get("mean_abs_dev_from_1"),
        }
    if "portfolio_risk" in res:
        pr = res["portfolio_risk"]
        summary["portfolio_risk"] = {
            "date": pr.get("date"),
            "total_vol": pr.get("total_vol"),
            "factor_var": pr.get("factor_var"),
            "specific_var": pr.get("specific_var"),
        }
    if "alpha_styles" in res:
        summary["alpha_styles"] = {
            name: {"expression": d.get("expression"),
                   "mean_ic": d.get("mean_ic")}
            for name, d in res["alpha_styles"].items()
        }
    return summary


def _style(ax, title):
    ax.set_title(title, fontsize=9, loc="left")
    ax.grid(True, **_GRID)
    ax.set_axisbelow(True)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    ax.tick_params(labelsize=7)


def _rolling_mean(x: np.ndarray, window: int, min_periods: int) -> np.ndarray:
    """``Series.rolling(window, min_periods).mean()``, NaN skipped."""
    ok = ~np.isnan(x)
    s = np.concatenate([[0.0], np.cumsum(np.where(ok, x, 0.0))])
    n = np.concatenate([[0], np.cumsum(ok)])
    hi = np.arange(1, len(x) + 1)
    lo = np.maximum(hi - window, 0)
    count = n[hi] - n[lo]
    with np.errstate(invalid="ignore", divide="ignore"):
        out = (s[hi] - s[lo]) / count
    return np.where(count >= max(min_periods, 1), out, np.nan)


def plot_model_health(results_dir: str, path: str, top_k: int = 6,
                      roll_window: int = 63, res: dict | None = None) -> None:
    """Render the health report as a 2×2 small-multiples PNG.

    Panels: cumulative factor returns (top ``top_k`` by |cum return|,
    direct-labelled; the rest folded as thin gray), the R² series with its
    rolling mean, the λ multiplier series, and the bias statistic per
    eigenfactor rank when ``bias_stats.json`` exists (per-factor annualized
    vol bars otherwise).  Draws on an explicit Agg canvas, so the
    process-global matplotlib backend is untouched.
    """
    from matplotlib.backends.backend_agg import FigureCanvasAgg
    from matplotlib.figure import Figure
    from matplotlib.ticker import MaxNLocator

    res = load_results(results_dir) if res is None else res
    fr = res["factor_returns"].dropna(how="all")
    cum, last, vol = _cum_and_vol(fr, 252)
    x = fr.dates.astype("datetime64[D]").astype(object)

    fig = Figure(figsize=(11, 7))
    FigureCanvasAgg(fig)
    axes = fig.subplots(2, 2)

    # (a) cumulative factor returns — identity in fixed palette order over
    # the selected factors (kept in the table's column order), the rest
    # folded into gray
    ax = axes[0][0]
    order = np.argsort(-np.abs(last), kind="stable")
    chosen = set(order[:max(top_k, 0)].tolist())
    top = [j for j in range(len(fr.columns)) if j in chosen]
    for j in range(len(fr.columns)):
        if j not in chosen:
            ax.plot(x, cum[:, j], color=_FOLD_COLOR, lw=0.7, zorder=1)
    span = (float(cum[:, top].max() - cum[:, top].min()) or 1.0
            if top else 1.0)
    labelled_ys: list[float] = []
    for i, j in enumerate(top):
        c = _PALETTE[i % len(_PALETTE)]
        name = fr.columns[j]
        ax.plot(x, cum[:, j], color=c, lw=1.6, zorder=2, label=name)
        y = float(cum[-1, j])
        # direct labels are selective: skip any that would collide with an
        # already-placed one (the legend still carries identity)
        if all(abs(y - y0) > 0.04 * span for y0 in labelled_ys):
            ax.annotate(f" {name}", (x[-1], y), fontsize=7, color=c,
                        va="center")
            labelled_ys.append(y)
    if len(fr.columns) > len(top):
        ax.plot([], [], color=_FOLD_COLOR, lw=0.7,
                label=f"other ({len(fr.columns) - len(top)})")
    ax.legend(fontsize=6, loc="upper left", frameon=False)
    _style(ax, f"cumulative factor returns (top {len(top)} by |cum|)")

    # (b) R² per date + rolling mean
    ax = axes[0][1]
    if "r_squared" in res:
        r2t = res["r_squared"]
        r2 = r2t.values[:, 0]
        rx = r2t.dates.astype(object)
        ax.plot(rx, r2, color=_FOLD_COLOR, lw=0.6)
        ax.plot(rx, _rolling_mean(r2, roll_window, roll_window // 3),
                color=_ACCENT, lw=1.6, label=f"{roll_window}d mean")
        ax.legend(fontsize=6, loc="upper left", frameon=False)
        ax.set_ylim(0, 1)
    _style(ax, "cross-sectional regression R²")

    # (c) λ multiplier series
    ax = axes[1][0]
    if "lambda" in res:
        lt = res["lambda"]
        ax.plot(lt.dates.astype(object), lt.values[:, 0], color=_ACCENT,
                lw=1.2)
        ax.axhline(1.0, color="#888", lw=0.8, ls="--")
    _style(ax, "vol-regime multiplier λ")

    # (d) bias per eigen rank when available, else annualized factor vols
    ax = axes[1][1]
    if "bias_stats" in res:
        scope_name, scope = _bias_scope(res["bias_stats"])
        for i, (label, d) in enumerate(sorted(scope.items())):
            if not isinstance(d, dict) or "bias" not in d:
                continue
            b = np.array([np.nan if v is None else v for v in d["bias"]])
            ax.plot(1 + np.arange(b.shape[0]), b, marker="o", ms=2.5, lw=1,
                    color=_PALETTE[i % len(_PALETTE)], label=label)
        ax.axhline(1.0, color="#888", lw=0.8, ls="--")
        ax.xaxis.set_major_locator(MaxNLocator(integer=True))
        ax.set_xlabel("eigenfactor rank", fontsize=7)
        ax.legend(fontsize=6, frameon=False)
        _style(ax, f"eigenfactor bias statistic by rank ({scope_name})")
    else:
        top_vol = np.argsort(-vol, kind="stable")[:10]
        ax.barh(np.arange(len(top_vol))[::-1], vol[top_vol], height=0.62,
                color=_ACCENT)
        ax.set_yticks(np.arange(len(top_vol))[::-1],
                      [fr.columns[j] for j in top_vol], fontsize=6)
        _style(ax, "annualized factor vol (top 10)")

    fig.tight_layout()
    fig.savefig(path, dpi=120)
