"""The port's tolerant extraction of DSL expressions from raw LLM output
(``mfm_tpu_torch/alpha/llm.py``) against the JAX package's, and its
``alpha --llm`` CLI surface (``--device cpu``).

Every text of ``tests/test_alpha_llm.py`` goes through both packages'
``extract_expressions``, which must return the same expressions and the
same report, rejection reasons included.
"""

import json
import random

import pytest

from mfm_tpu.alpha.llm import extract_expressions as ref_extract
from mfm_tpu_torch.alpha.llm import extract_expressions
from mfm_tpu_torch.cli import main as cli_main

from test_alpha_cli import panel_csv  # noqa: F401  (fixture reuse)
from test_alpha_llm import CHAT

TEXTS = {
    "chat": (CHAT, {"close", "ret", "volume"}),
    "chat_unfenced": (CHAT, None),
    "bare_name": ("- volume\n", None),
    "bare_name_marked": ("`volume`\n", None),
    "backtick_spans": (
        "Try `cs_rank(delta(close, 3))` or `cs_rank(volume)` here\n", None),
    "unknown_field": ("cs_rank(close)\ncs_rank(unknown_thing)\n", {"close"}),
    "labels": ("a1 = cs_rank(close) * (close >= delay(close, 5))\n", None),
    "constants": ("IC: -0.03\nwhere `5` is the lookback\n", None),
    "inline_fence": ("```cs_rank(close)```\nsome prose follows\nvolume\n",
                     {"close", "volume"}),
    "aliases": ("`rank(close)`\n`cs_rank(close)`\n", None),
    "reserved": ("where `rank` is the rank op\n", None),
    "window_float": ("`ts_mean(close, 5.5)`\n", None),
    "degenerate": ("\n".join([
        "`cs_rank(delta(close, 3))`",
        "`" + "-" * 20000 + "close`",
        "`close" + "+close" * 10000 + "`",
        "`" + "-" * 500 + "close`",
        "`" + "(" * 500 + "close" + ")" * 500 + "`",
    ]), {"close"}),
    "dash_bullet": ("- cs_rank(delta(close, 3))\n", None),
    "negation": ("-ts_corr(close, volume, 10)\n", None),
    "worldquant": ("`-1 * correlation(rank(delta(log(volume), 1)), "
                   "rank((close - open) / open), 6)`\n",
                   {"close", "open", "volume"}),
    "hallucinated": ("Two ideas:\n1. `-delta(close, 5)`\n"
                     "2. `cs_rank(market_cap_weighted_sentiment)`\n",
                     {"close"}),
}


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_extraction_matches_reference(name):
    text, known = TEXTS[name]
    assert extract_expressions(text, known_fields=known) == ref_extract(
        text, known_fields=known)


def test_extraction_of_fuzzed_chat_matches_reference():
    """Lines of the chat shuffled with prose and junk fragments."""
    rng = random.Random(0)
    lines = CHAT.splitlines() + [
        "alpha_7: ts_rank(close, 10)", "* `max(close, 5)`", "3) sum(close)",
        "`close // volume`;", "momentum", "42", "x = -delta(close, 2),",
        "```", "decay_linear(ret, 5)", "```"]
    for _ in range(30):
        text = "\n".join(rng.sample(lines, k=len(lines) // 2))
        known = {"close", "volume", "ret"} if rng.random() < 0.5 else None
        assert extract_expressions(text, known) == ref_extract(text, known)


def test_alpha_cli_llm_mode(panel_csv, tmp_path, capsys):  # noqa: F811
    chat = tmp_path / "chat.md"
    chat.write_text(CHAT)
    out = str(tmp_path / "scores.csv")
    cli_main(["alpha", "--llm", "--exprs", str(chat), "--panel", panel_csv,
              "--out", out, "--device", "cpu"])
    cap = capsys.readouterr()
    rec = json.loads(cap.out.strip().splitlines()[-1])
    assert rec["n_exprs"] == 4
    assert rec["llm_extraction"]["n_extracted"] == 4
    assert rec["llm_extraction"]["n_duplicates"] == 1
    assert "skipped" in cap.err


def test_alpha_cli_llm_mode_all_prose_fails(panel_csv, tmp_path):  # noqa: F811
    chat = tmp_path / "chat.md"
    chat.write_text("I could not think of any factors today, sorry.\n")
    with pytest.raises(SystemExit, match="no expressions"):
        cli_main(["alpha", "--llm", "--exprs", str(chat), "--panel",
                  panel_csv, "--device", "cpu"])
