"""The comparison that decides ``correct`` fails what it has to fail: the
control (the reference at the next precision down in the program's place)
and each fault a cell can have, planted under the timed path, with the
harness's look for a chip skipped.  The cell's own limits are used, at
CPU sizes.  A cell on one chip has no exchange between chips to leave out.
"""

import json
import math
import time

import pytest
import torch

from conftest import ROOT, cell_of
from mfmbench import calibrate, compare, harness

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]
#: each cell with each of its traffic's controls
CONTROLS = [(c, ctl) for c in CELLS for ctl in json.loads(
    (ROOT / "mfmbench" / "traffic" / f"{c.split('.', 1)[1]}.json")
    .read_text())["controls"]]


def _limits(cell: str) -> dict:
    return json.loads((ROOT / "mfmbench" / "limits" / f"{cell}.json")
                      .read_text())["numbers"]


@pytest.mark.parametrize("cell,control", CONTROLS)
def test_control_fails_and_program_passes(tiny, bench, cell, control):
    r = calibrate.readings(cell_of(bench, cell), 2**31 + 21, [control],
                           "cpu", base=tiny)
    assert compare.judge(r["program"], _limits(cell))[0], r["program"]
    got = r["controls"][control]
    assert not compare.judge(got, _limits(cell))[0], got


def _frozen_vol_regime(factor_ret, covs, valid, half_life=42.0, carry=None,
                       skip_mask=None):
    """The vol-regime recursion with a step that returns its state
    unchanged: the multiplier never leaves 1."""
    one = torch.ones(covs.shape[0], dtype=covs.dtype, device=covs.device)
    zero = torch.zeros((), dtype=covs.dtype, device=covs.device)
    return covs, one, (zero, zero) if carry is None else carry


def _half_the_sims(real):
    def bias_ratios(G, d0_c, sim_sweeps, kernels):
        return real(G[:, :G.shape[1] // 2], d0_c, sim_sweeps, kernels)
    return bias_ratios


def _altered_factor_return(real):
    def regress(*args, **kwargs):
        res = real(*args, **kwargs)
        f = res.factor_ret.clone()
        f[f.shape[0] // 2, 0] += 0.01 * float(f.abs().max())
        return res._replace(factor_ret=f)
    return regress


def _rebuild_faults(mp, fault):
    import mfm_tpu_torch.models.eigen as eigen
    import mfm_tpu_torch.models.risk_model as rm

    if fault == "state_unchanged":
        mp.setattr(rm, "vol_regime_adjust_resume", _frozen_vol_regime)
    elif fault == "half_batch":
        mp.setattr(eigen, "_bias_ratios", _half_the_sims(eigen._bias_ratios))
    else:
        mp.setattr(rm, "regress_panel",
                   _altered_factor_return(rm.regress_panel))


def _alpha_faults(mp, fault):
    import mfm_tpu_torch.alpha.dsl as dsl
    import mfm_tpu_torch.alpha.metrics as metrics

    if fault == "state_unchanged":
        # the window sums' running sum never carries: each is its addend
        mp.setattr(dsl, "_cumsum", lambda x: x.clone())
    elif fault == "half_batch":
        real = metrics.information_coefficient

        def half(alpha, fwd_ret):
            n = alpha.shape[-1] // 2
            return real(alpha[..., :n], fwd_ret[..., :n])
        mp.setattr(metrics, "information_coefficient", half)
    else:
        real = metrics.alpha_summary

        def altered(alphas, fwd_ret, spread_q=0.2):
            out = real(alphas, fwd_ret, spread_q)
            out["mean_ic"] = out["mean_ic"].clone()
            out["mean_ic"][0] += 0.01
            return out
        mp.setattr(metrics, "alpha_summary", altered)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "altered_answer"])
def test_a_planted_fault_is_not_correct(tiny, bench, monkeypatch, cell,
                                        fault):
    plant = _rebuild_faults if cell.endswith("rebuild") else _alpha_faults
    plant(monkeypatch, fault)
    r = harness.run_cell(bench, cell_of(bench, cell), 2**31 + 31, 0.2, 0,
                         "cpu", time.time(), base=tiny)
    assert r["correct"] is False, r["checked"]
    assert r["failed"] >= 1


def _verdicts(margins, program_valid):
    """A reference with F0 margins ``margins`` and a program that gave the
    validity ``program_valid``, two factors over four dates."""
    T, K = len(margins), 2
    margin = torch.tensor(margins, dtype=torch.float64)
    base = torch.eye(K, dtype=torch.float64).repeat(T, 1, 1)

    def with_valid(valid):
        cov = torch.where(valid[:, None, None], base, math.nan)
        lamb = valid.to(torch.float64) + 1.0
        return {"eigen_cov": cov, "eigen_valid": valid, "vr_cov": cov,
                "lamb": lamb}

    want = {"factor_ret": torch.ones(T, K), "specific_ret": torch.ones(T, 3),
            "r2": torch.ones(T), "nw_cov": base.clone(),
            "nw_valid": torch.ones(T, dtype=torch.bool),
            **with_valid(margin >= 0), "psd_margin": margin,
            "with_valid": with_valid}
    got = {k: v for k, v in want.items() if isinstance(v, torch.Tensor)}
    got.update(with_valid(torch.tensor(program_valid)))
    return compare.risk_numbers(got, want)


@pytest.mark.parametrize("margins,program_valid,apart,turned", [
    ([0.5, -1e-6, 2e-6, 0.5], [True, True, False, True], 0, 2),
    ([0.5, -1e-6, 2e-4, 0.5], [True, True, False, True], 1, 1),
    ([0.5, -0.2, 0.3, 0.5], [True, False, True, True], 0, 0),
])
def test_a_verdict_within_the_margin_is_either(margins, program_valid,
                                               apart, turned):
    """At a date whose F0 lies within the margin of semi-definite the
    program is held to the reference's outputs under its own verdict; a
    verdict turned at any other date is a date apart."""
    n = _verdicts(margins, program_valid)
    assert n["turned_dates"] == turned
    assert n["valid_apart"] == apart
    assert (n["finite_apart"] > 0) == (apart > 0)
