"""Exporters: the JSONL event stream and the Prometheus textfile
exposition (counterpart of ``mfm_tpu/obs/exporters.py``).

- :class:`EventLog` / :func:`emit_event` — the structured JSONL event
  stream: one JSON object a line with a stable schema (``ts``, ``level``,
  ``event`` always present, in that key order) and an optional
  append-to-file sink, so a serving loop leaves an auditable trail next to
  its checkpoints.
- :func:`render_prometheus` / :func:`parse_prometheus` — the textfile
  exposition format (``# HELP``/``# TYPE`` + samples, histogram
  ``_bucket{le=...}``/``_sum``/``_count``) and a minimal parser used by the
  round-trip tests and the ``metrics`` subcommand.  No client library:
  node_exporter's textfile collector is the deployment story.
- :func:`write_prometheus_textfile` — atomic write (tmp -> fsync ->
  rename), because the textfile collector may scrape mid-write otherwise.

Host-side only, like everything under ``mfm_tpu_torch.obs``.
"""

from __future__ import annotations

import json
import math
import os
import sys
import threading
import time

from mfm_tpu_torch.obs.metrics import Histogram, MetricsRegistry, REGISTRY

_LEVELS = {"debug": 10, "info": 20, "warn": 30, "error": 40}

#: JSONL schema: these keys open every record, in this order
EVENT_REQUIRED_KEYS = ("ts", "level", "event")


class EventLog:
    """Append-only JSONL event sink (file when ``path`` given, else stderr)."""

    def __init__(self, path: str | None = None, min_level: str = "info"):
        self.path = path
        self.min_level = _LEVELS[min_level]
        self._lock = threading.Lock()
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def set_level(self, level: str) -> None:
        self.min_level = _LEVELS[level]

    def emit(self, level: str, event: str, **fields) -> None:
        if _LEVELS[level] < self.min_level:
            return
        rec = {"ts": round(time.time(), 3), "level": level, "event": event}
        for k in sorted(fields):
            if k not in rec:
                rec[k] = fields[k]
        line = json.dumps(rec, default=str)
        with self._lock:
            if self.path:
                with open(self.path, "a", encoding="utf-8") as fh:
                    fh.write(line + "\n")
            else:
                print(line, file=sys.stderr, flush=True)


#: process-default sink; :func:`route_events_to` repoints it
_DEFAULT_LOG = EventLog()


def emit_event(level: str, event: str, **fields) -> None:
    """Emit to the process-default sink (stderr until routed to a file)."""
    _DEFAULT_LOG.emit(level, event, **fields)


def route_events_to(path: str | None, min_level: str = "info") -> EventLog:
    """Point the process-default event stream at a JSONL file (None -> back
    to stderr).  Returns the new sink."""
    global _DEFAULT_LOG
    _DEFAULT_LOG = EventLog(path, min_level=min_level)
    return _DEFAULT_LOG


def default_event_log() -> EventLog:
    return _DEFAULT_LOG


# -- Prometheus textfile exposition ------------------------------------------

def _esc_label(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_esc_label(str(v))}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    return repr(float(v))


def render_prometheus(registry: MetricsRegistry | None = None) -> str:
    """The registry in Prometheus text exposition format (version 0.0.4)."""
    reg = registry if registry is not None else REGISTRY
    lines = []
    for m in reg.metrics():
        if m.help_text:
            lines.append(f"# HELP {m.name} {m.help_text}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        for key in sorted(m.series()):
            labels = dict(zip(m.labelnames, key))
            if isinstance(m, Histogram):
                st = m.series()[key]
                for le, c in m.cumulative(**labels):
                    bl = dict(labels)
                    bl["le"] = _fmt_value(le) if math.isinf(le) else repr(le)
                    lines.append(
                        f"{m.name}_bucket{_fmt_labels(bl)} {c}")
                lines.append(f"{m.name}_sum{_fmt_labels(labels)} "
                             f"{_fmt_value(st.total)}")
                lines.append(f"{m.name}_count{_fmt_labels(labels)} "
                             f"{st.count}")
            else:
                lines.append(f"{m.name}{_fmt_labels(labels)} "
                             f"{_fmt_value(m.series()[key])}")
    return "\n".join(lines) + ("\n" if lines else "")


def _parse_labels(s: str) -> dict:
    out, i = {}, 0
    while i < len(s):
        eq = s.index("=", i)
        name = s[i:eq].strip().strip(",")
        if s[eq + 1] != '"':
            raise ValueError(f"unquoted label value at {s[eq:eq+8]!r}")
        j, buf = eq + 2, []
        while s[j] != '"':
            if s[j] == "\\":
                nxt = s[j + 1]
                buf.append({"n": "\n", "\\": "\\", '"': '"'}.get(nxt, nxt))
                j += 2
            else:
                buf.append(s[j])
                j += 1
        out[name] = "".join(buf)
        i = j + 1
    return out


def parse_prometheus(text: str) -> dict:
    """Minimal exposition-format parser for round-trip validation.

    Returns ``{family_name: {"type": str, "help": str, "samples":
    [(sample_name, labels_dict, value), ...]}}``.  Raises ValueError on
    malformed lines — which is the point: the textfile we ship must parse.
    """
    families: dict = {}
    current = None
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line:
            continue
        if line.startswith("# HELP "):
            _, _, rest = line.partition("# HELP ")
            name, _, help_text = rest.partition(" ")
            families.setdefault(name, {"type": "untyped", "help": "",
                                       "samples": []})["help"] = help_text
            current = name
            continue
        if line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            name, _, kind = rest.partition(" ")
            if kind not in ("counter", "gauge", "histogram", "summary",
                            "untyped"):
                raise ValueError(f"line {lineno}: unknown metric type "
                                 f"{kind!r}")
            families.setdefault(name, {"type": "untyped", "help": "",
                                       "samples": []})["type"] = kind
            current = name
            continue
        if line.startswith("#"):
            continue
        # sample: name[{labels}] value
        brace = line.find("{")
        if brace != -1:
            close = line.rindex("}")
            sample_name = line[:brace]
            labels = _parse_labels(line[brace + 1:close])
            value_s = line[close + 1:].strip()
        else:
            sample_name, _, value_s = line.partition(" ")
            labels = {}
            value_s = value_s.strip()
        if not sample_name or not value_s:
            raise ValueError(f"line {lineno}: malformed sample {raw!r}")
        value = float(value_s.replace("+Inf", "inf").replace("-Inf", "-inf"))
        fam = sample_name
        for suffix in ("_bucket", "_sum", "_count"):
            base = sample_name[: -len(suffix)]
            if sample_name.endswith(suffix) and base in families \
                    and families[base]["type"] == "histogram":
                fam = base
                break
        if fam not in families:
            families[fam] = {"type": "untyped", "help": "", "samples": []}
        families[fam]["samples"].append((sample_name, labels, value))
        current = fam
    del current
    return families


def write_prometheus_textfile(path: str,
                              registry: MetricsRegistry | None = None) -> str:
    """Atomically write the exposition textfile (tmp -> fsync -> rename);
    returns the rendered text."""
    text = render_prometheus(registry)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        fh.write(text)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    return text
