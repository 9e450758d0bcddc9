"""The loop of the ``alpha`` traffic: a closed loop of scoring requests, as
an alpha researcher screens candidate factors in batches.

Each request is the traffic's ``per_request`` expressions, drawn from the
deck (:class:`mfmbench.gen.DeckStream`), compiled and scored in full with
``compile_alpha_scores(exprs, chunk)(panel, fwd)`` against one panel made
on the device from the seed, ended by a synchronize; no result is reused
across requests.  Set-up warms up with the deck's first request in deck
order, which holds every template.  The traced run traces one request on
the device, one more with the host, and times evaluation
(``compile_alpha_batch``) and scoring (``alpha_summary``) apart, per
expression.
"""

from __future__ import annotations

import random
import time

import torch

from mfmbench import compare, gen, tracing
from mfmbench.reference import alpha as reference


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, device
        self.T, self.N = config["alpha_panel"]["T"], config["alpha_panel"]["N"]
        self.answers: list = []

    def _sync(self):
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()

    def setup(self):
        from mfm_tpu_torch.alpha.dsl import (
            compile_alpha_batch,
            compile_alpha_scores,
        )
        from mfm_tpu_torch.alpha.metrics import alpha_summary

        self._scores, self._batch = compile_alpha_scores, compile_alpha_batch
        self._summary = alpha_summary
        self.panel, self.fwd = gen.alpha_panel(self.T, self.N, self.seed,
                                               self.device)
        deck = gen.alpha_deck(self.traffic)
        self.per = self.traffic["per_request"]
        self.stream = gen.DeckStream(deck, self.per, self.seed)
        for _ in range(self.traffic["warmup"]):
            self.score(deck[:self.per])

    def score(self, sources: list) -> dict:
        out = self._scores(sources, chunk=self.traffic["chunk"])(self.panel,
                                                                 self.fwd)
        self._sync()
        return out

    def answer(self):
        """One request of the window, its answer kept for the check."""
        sources = self.stream.next()
        self.answers.append((sources, self.score(sources)))

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        while True:
            self.answer()
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        n = len(self.answers)
        return {"exprs": n * self.per, "window_s": elapsed, "attempted": n}

    def traced(self) -> dict:
        """Evaluation and scoring timed apart first (a tracer once started
        leaves launches slower), then one request traced on the device and
        one traced with the host."""
        chunk = self.traffic["chunk"]
        ev = sc = 0.0
        n = 0
        while ev + sc < self.traffic["span_min_s"] or n == 0:
            sources = self.stream.next()
            t0 = time.perf_counter()
            alphas = self._batch(sources, chunk=chunk)(self.panel)
            self._sync()
            t1 = time.perf_counter()
            self._summary(alphas, self.fwd)
            self._sync()
            ev += t1 - t0
            sc += time.perf_counter() - t1
            n += len(sources)
            del alphas
        traced = self.stream.next()
        out, dev = tracing.device_trace(lambda: self.score(traced),
                                        self.device)
        self.answers.append((traced, out))
        _, idle = tracing.idle_by_host(lambda: self.score(self.stream.next()),
                                       self.device)
        return {"attempted": 1, "spans": {"alpha_eval": ev / n,
                                          "alpha_score": sc / n},
                "alpha_trace": {**dev, "exprs": len(traced)},
                "idle_gaps": idle, "device_ops": dev["device_ops"],
                "busy_s": dev["busy_s"], "traced_window_s": dev["window_s"],
                "notes": {"span_exprs": n}}

    def sample(self) -> list:
        """The answers the reference checks, ``[(sources, summaries)]``:
        ``check_requests`` of the answered requests drawn from the seed."""
        k = min(self.traffic["check_requests"], len(self.answers))
        picks = random.Random(gen.stream_seed(self.seed, 7)).sample(
            range(len(self.answers)), k)
        answers = [self.answers[i] for i in sorted(picks)]
        self.answers = []
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()
        return answers

    def want(self, sources: list, precision: str = "float64") -> dict:
        """The reference's summaries of the expressions ``sources``."""
        return reference.score(sources, self.panel, self.fwd, precision)

    numbers = staticmethod(compare.alpha_numbers)
