"""The loop of the ``rebuild`` traffic: a closed loop of full-history risk
model rebuilds, one after another, each on the next return panel of a
ring, as a risk desk rebuilds its model.

Each rebuild is ``RiskModel(ret_r, ...).run_fused(sim_covs=..., sim_length=
T)`` ended by a synchronize.  Set-up makes every input on the device from
the seed and warms up with the traffic's warm-up rebuilds; the window
copies nothing between host and device.  The traced run traces one
rebuild on the device, one more with the host, times the stages that
``run_fused`` composes through their public methods, and traces the eigen
stage alone for its roofline.
"""

from __future__ import annotations

import random
import time

import torch

from mfmbench import compare, gen, roofline, tracing
from mfmbench.reference import risk as reference


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, device
        shape = config["shape"]
        self.T, self.N = shape["T"], shape["N"]
        self.P, self.Q = shape["P"], shape["Q"]
        self.M = config["risk"]["eigen_n_sims"]
        self.K = 1 + self.P + self.Q
        self.kept: dict = {}

    def _sync(self):
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()

    def setup(self):
        from mfm_tpu_torch import RiskModel, RiskModelConfig

        self._RiskModel = RiskModel
        self.cfg = RiskModelConfig(**self.config["risk"])
        self.inputs = gen.risk_inputs(self.T, self.N, self.P, self.Q,
                                      self.traffic["ring"], self.seed,
                                      self.device)
        self.sim = gen.sim_covs(self.K, self.T, self.M, self.seed,
                                self.device)
        for i in range(self.traffic["warmup"]):
            self.rebuild(i)
        self.next = 0

    def model(self, slot: int):
        i = self.inputs
        return self._RiskModel(i["rets"][slot], i["cap"], i["styles"],
                               i["industry"], i["valid"],
                               n_industries=self.P, config=self.cfg,
                               device=self.device)

    def rebuild(self, n: int):
        slot = n % self.traffic["ring"]
        out = self.model(slot).run_fused(sim_covs=self.sim, sim_length=self.T)
        self._sync()
        return slot, out

    def answer(self):
        """One request of the window, its answer kept for the check."""
        slot, out = self.rebuild(self.next)
        self.next += 1
        self.kept[slot] = out

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        while True:
            self.answer()
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        return {"rebuilds": self.next, "window_s": elapsed,
                "attempted": self.next}

    def traced(self) -> dict:
        """The stages' spans and one untraced rebuild first (a tracer once
        started leaves launches slower), then one rebuild traced on the
        device, one traced with the host, and the eigen stage traced."""
        rm = self.model(self.next % self.traffic["ring"])
        min_s = self.traffic["span_min_s"]
        reg_s, (fr, _, _) = span(rm.reg_by_time, self._sync, min_s)
        nw_s, (nw_cov, nw_valid) = span(
            lambda: rm.newey_west_by_time(fr), self._sync, min_s)

        def eigen():
            return rm.eigen_risk_adj_by_time(nw_cov, nw_valid,
                                             sim_covs=self.sim,
                                             sim_length=self.T)

        eig_s, (ecov, evalid) = span(eigen, self._sync, min_s)
        vr_s, _ = span(lambda: rm.vol_regime_adj_by_time(fr, ecov, evalid),
                       self._sync, min_s)
        wall, _ = span(lambda: self.rebuild(self.next), self._sync, 0.0)
        self.next += 1
        (slot, out), dev = tracing.device_trace(
            lambda: self.rebuild(self.next), self.device)
        self.kept[slot] = out
        self.next += 1
        _, idle = tracing.idle_by_host(lambda: self.rebuild(self.next),
                                       self.device)
        self.next += 1
        _, eig_trace = tracing.device_trace(eigen, self.device)
        spans = {"regression": reg_s, "newey_west": nw_s, "eigen": eig_s,
                 "vol_regime": vr_s}
        bound = roofline.eigen_stage_bound(
            self.T, self.M, self.K, self.config["roofline_sweeps"]["weighted"])
        return {"attempted": self.next, "spans": spans,
                "rebuild_trace": dev, "idle_gaps": idle,
                "device_ops": dev["device_ops"],
                "busy_s": dev["busy_s"], "traced_window_s": dev["window_s"],
                "eigen_device_s": eig_trace["device_s"],
                "roofline_shape": {"T": self.T, "M": self.M, "K": self.K,
                                   "sweeps": self.config["roofline_sweeps"]},
                "notes": {"staged_sum_s": sum(spans.values()),
                          "rebuild_wall_s": wall,
                          "eigen_bound_by": bound["bound_by"]}}

    def sample(self) -> list:
        """The answers the reference checks, ``[(ring slot, outputs)]``:
        one kept rebuild, its slot drawn from the seed.  Every other
        output and return panel is freed."""
        slots = sorted(self.kept)
        slot = random.Random(gen.stream_seed(self.seed, 7)).choice(slots)
        out = self.kept[slot]._asdict()
        self.kept = {}
        self.inputs["rets"] = {slot: self.inputs["rets"][slot]}
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()
        return [(slot, out)]

    def want(self, slot: int, precision: str = "float64") -> dict:
        """The reference's outputs for the rebuild of ring slot ``slot``."""
        return reference.rebuild(self.inputs, self.inputs["rets"][slot],
                                 self.sim, self.config["risk"], self.P,
                                 precision)

    numbers = staticmethod(compare.risk_numbers)


def span(fn, sync, min_s: float) -> tuple:
    """(mean seconds of ``fn()`` ended by ``sync()``, repeated until the
    calls take ``min_s`` together; the last call's result)."""
    total, n = 0.0, 0
    while total < min_s or n == 0:
        t0 = time.perf_counter()
        out = fn()
        sync()
        total += time.perf_counter() - t0
        n += 1
    return total / n, out
