"""The recovery matrix's fleet plans 13-15 (``python -m
mfm_tpu_torch.tools.faultinject``) on the CPU at the reference's geometry:
a worker replica SIGKILLed mid-drain, a simulated host's two workers
SIGKILLed while a third is SIGSTOPped, and one worker wedged.  Each plan
passes — every request id answered bitwise the single-process replay,
the fleet manifest's loss and audit, ``doctor --serve`` green — and a
front end that drops a dead replica's batch instead of re-dispatching it
fails fleet-kill-replica.
"""

import sys
import textwrap

import pytest
import torch

from mfm_tpu_torch.tools import faultinject as fi
from mfm_tpu_torch.utils.chaos import plan_suite

PLANS = [p for p in plan_suite(0)
         if p.kind in ("fleet_kill", "fleet_kill_host", "fleet_wedge")]

#: the SIGKILLed workers, the least completed processes that reported
#: launches (the front end, the workers that wrote a shard, the replay),
#: and the plan's own counts
WANT = {
    "fleet-kill-replica": (1, 4, {"killed_replica": 1, "survivors": 2,
                                  "responses": 96}),
    "fleet-kill-host": (2, 3, {"killed_workers": [2, 3],
                               "wedged_worker": 1, "responses": 96}),
    "fleet-wedge-worker": (0, 4, {"wedged_worker": 1, "survivors": 2,
                                  "responses": 96}),
}


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("faultinject_fleet"))
    return fi.Baseline(root, 0, fi.Geometry(), torch.device("cpu")), root


def _run(plan, harness, name=None):
    base, root = harness
    if name:
        plan = plan.__class__(name, plan.kind, plan.seed, plan.params)
    return fi._run_plan(lambda: fi.RUNNERS[plan.kind](plan, base, root),
                        base, {"plan": plan.name})


@pytest.mark.parametrize("plan", PLANS, ids=[p.name for p in PLANS])
def test_fleet_plan_passes(harness, plan):
    rec = _run(plan, harness)
    assert rec["status"] == "pass", rec.get("error")
    killed, completed, counts = WANT[plan.name]
    assert rec["killed_subprocesses"] == killed
    subs = rec["subprocess_launches"]
    assert len(subs) >= completed
    assert all(not any(s.values()) for s in subs)
    for k, v in counts.items():
        assert rec[k] == v, (k, rec[k])
    if plan.name == "fleet-kill-replica":
        assert rec["redispatches"] >= 8
    else:
        assert rec["heartbeat_misses"] + rec["io_timeouts"] >= 1


def test_sabotage_replica_death_without_redispatch_fails(harness, tmp_path,
                                                         monkeypatch):
    """A front end that answers a dead replica's in-flight batch with
    errors instead of re-dispatching it to a survivor: fleet-kill-replica
    turns red."""
    wrapper = tmp_path / "no_redispatch_cli.py"
    wrapper.write_text(textwrap.dedent("""
        from mfm_tpu_torch.serve import replica

        real = replica.Replica.run_batch

        def run_batch(self, wire):
            try:
                return real(self, wire)
            except replica.ReplicaDeadError:
                self.dead = True
                return {}

        replica.Replica.run_batch = run_batch
        from mfm_tpu_torch import cli
        cli.main()
    """))
    monkeypatch.setattr(fi, "_cli_argv", lambda: [sys.executable,
                                                  str(wrapper)])
    plan = next(p for p in PLANS if p.name == "fleet-kill-replica")
    rec = _run(plan, harness, name="sabotage-fleet-kill")
    assert rec["status"] == "FAIL"
    assert ("redispatched requests" in rec["error"]
            or "diverge from the single-process replay" in rec["error"])
