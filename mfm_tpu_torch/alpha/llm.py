"""Tolerant extraction of DSL expressions from raw LLM output (counterpart
of ``mfm_tpu/alpha/llm.py``; ``ast`` and ``re`` only, no network).

The strict readers (``cli._read_alpha_sources``, ``alpha --exprs``) demand
one clean expression per line and fail fast on anything else — right for
curated files, wrong for the actual output of an LLM asked to "propose 50
alpha factors", which arrives wrapped in markdown fences, numbered lists,
inline backticks, ``alpha_3 = ...`` assignments, and prose paragraphs.
This module pulls every *valid* DSL expression out of such text and reports
what it rejected and why, so the title's loop

    LLM chat dump -> extract -> validate -> dedup -> evaluate/select
        -> style factors of the risk model (``pipeline --alphas``)

needs no hand-cleaning step.  The validator is the DSL compiler itself
(:func:`mfm_tpu_torch.alpha.dsl.compile_alpha` — same vocabulary, same
rejection of non-DSL syntax); extraction only normalizes the surrounding chrome:

- markdown code fences are unwrapped (their language tag line dropped);
- list markers (``1.``, ``-``, ``*``, ``•``) and inline backticks strip.
  NOTE the convention this fixes: a leading ``- `` (dash, space) is read as
  a LIST BULLET, never as negation — a negated alpha must be written
  ``-expr`` with no space (how LLMs overwhelmingly format it).  The report
  counts dash-bullet strips (``n_dash_bullets_stripped``) so a surprising
  sign is traceable;
- ``name = expr`` / ``name: expr`` keeps the right-hand side when the left
  is a bare identifier (the LLM's label, not a DSL field);
- trailing ``,`` / ``;`` strip;
- prose lines simply fail to compile and land in the rejection report; a
  bare identifier or constant (``momentum``, ``42``) — valid DSL but never
  a useful alpha, and exactly what stray prose words look like — is
  rejected as ``trivial`` unless it came from inside backticks/a fence;
- duplicates (structural: same AST after whitespace/parens/label chrome)
  are dropped, first occurrence wins.

``known_fields`` (e.g. the panel's columns) tightens validation: candidates
referencing other names are rejected as ``unknown-field`` instead of
crashing the evaluator later.
"""

from __future__ import annotations

import ast
import re
from typing import Iterable

from mfm_tpu_torch.alpha.dsl import _ALIASES, compile_alpha

_FENCE = re.compile(r"^\s*```")
_INLINE_FENCE = re.compile(r"^\s*```(.*?)```\s*$")
_LIST_MARKER = re.compile(r"^\s*(?:[-*•]|\d+[.)])\s+")
_LABEL = re.compile(r"^\s*[A-Za-z_]\w*\s*[=:]\s*(?![=])")
_TRAILING = re.compile(r"[,;\s]+$")


def _candidates(text: str) -> Iterable[tuple[int, str, bool, bool]]:
    """Yield (lineno, cleaned-candidate, was_code_marked, was_dash_bullet)
    per non-blank line (one per inline-backtick span on span lines)."""
    fenced = False
    for no, raw in enumerate(text.splitlines(), 1):
        m = _INLINE_FENCE.match(raw)
        if m:  # ```expr``` opens AND closes on one line: inline code,
            sp = m.group(1).strip()  # not a fence toggle
            sp = _TRAILING.sub("", _LABEL.sub("", sp))
            if sp:
                yield no, sp, True, False
            continue
        if _FENCE.match(raw):
            fenced = not fenced
            continue
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        # inline backticks: EVERY span is its own candidate (a line may
        # offer several alternatives); the surrounding prose is chrome
        spans = re.findall(r"`([^`]+)`", line)
        if spans:
            for sp in spans:
                sp = _TRAILING.sub("", _LABEL.sub("", sp.strip()))
                if sp:
                    yield no, sp, True, False
            continue
        code_marked = fenced
        dash_bullet = line.startswith("- ")
        line = _LIST_MARKER.sub("", line)
        # the DSL grammar contains no ':' anywhere, so a colon whose prefix
        # holds no expression syntax is label chrome ("**Mean reversion**:")
        head, sep, tail = line.partition(":")
        if sep and not any(c in head for c in "(`="):
            line = tail.strip()
        line = _LABEL.sub("", line)
        line = _TRAILING.sub("", line)
        if line:
            yield no, line, code_marked, dash_bullet


def _canonical_key(body: ast.AST) -> str:
    """Structural dedup key, alias-insensitive: ``rank(close)`` and
    ``cs_rank(close)`` are the same factor (LLM output mixes the 101-Alphas
    and DSL vocabularies — the whole reason the aliases exist)."""
    import copy

    b = copy.deepcopy(body)
    for n in ast.walk(b):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Name):
            n.func.id = _ALIASES.get(n.func.id, n.func.id)
    return ast.dump(b)


def extract_expressions(text: str, known_fields=None):
    """Extract valid DSL expressions from raw LLM output.

    Returns ``(exprs, report)``: ``exprs`` is the deduplicated list of
    expression sources in first-seen order; ``report`` holds
    ``n_candidates`` / ``n_extracted`` / ``n_duplicates`` and ``rejected``
    as a list of ``(lineno, candidate, reason)`` — surfaced by the CLI so a
    silently-dropped factor is visible, not mysterious.
    """
    known = set(known_fields) if known_fields is not None else None
    exprs: list[str] = []
    seen: set[str] = set()
    rejected: list[tuple[int, str, str]] = []
    n_cand = n_dup = n_dash = 0
    def _trunc(s: str, cap: int = 200) -> str:
        return s if len(s) <= cap else s[:cap] + "..."

    def reject(no, cand, reason):
        # truncate BOTH fields: monster candidates, and reasons that embed
        # candidate text (compile_alpha's messages quote the offender)
        rejected.append((no, _trunc(cand), _trunc(reason)))

    for no, cand, code_marked, dash_bullet in _candidates(text):
        n_cand += 1
        try:
            e = compile_alpha(cand)
        except (ValueError, SyntaxError) as err:
            # compile_alpha guarantees this catch suffices: degenerate
            # sampling-loop lines (over-long, parser-overflowing, or
            # depth-capped) all surface as ValueError
            reject(no, cand, f"not DSL: {err}")
            continue
        body = e.tree.body
        if not e.fields:
            # no panel dependency -> a constant signal ('-0.03', '5'),
            # never a factor; also crashes batch stacking downstream
            reject(no, cand, "trivial: no panel fields")
            continue
        if not code_marked and isinstance(body, ast.Name):
            reject(no, cand, "trivial: bare name outside code markup")
            continue
        if known is not None:
            missing = [f for f in e.fields if f not in known]
            if missing:
                reject(no, cand, f"unknown-field: {missing}")
                continue
        key = _canonical_key(body)
        if key in seen:
            n_dup += 1
            continue
        seen.add(key)
        if dash_bullet:
            n_dash += 1
        exprs.append(cand)
    report = {
        "n_candidates": n_cand,
        "n_extracted": len(exprs),
        "n_duplicates": n_dup,
        # dash-space reads as a bullet, never negation (module docstring) —
        # count the strips so a surprising sign is traceable
        "n_dash_bullets_stripped": n_dash,
        "rejected": rejected,
    }
    return exprs, report
