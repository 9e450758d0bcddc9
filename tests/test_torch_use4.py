"""USE4's factor structure on the port: 1 country, 60 industries and 12
styles (K = 73, odd), on the CPU at small T, N and M.

``RiskModel.run_fused`` is held to the benchmark's plain float64
reference (``mfmbench/reference/risk.rebuild``, which imports nothing of
the program) at odd K with many industries; the eigh dispatch sends every
width of that path to the block design; the benchmark's ``use4``
configuration keeps USE4's widths; and the stage spans' eigh counts by
design read 0 here and, with the CUDA wrappers' counting stood in for on
the CPU, name the design and the padded n each width goes to.
"""

import json
from pathlib import Path

import pytest
import torch

from mfm_tpu_torch import RiskModel, RiskModelConfig
from mfm_tpu_torch.obs import trace
from mfm_tpu_torch.ops import eigh as E
from mfm_tpu_torch.ops import eigh_cuda
from mfmbench import compare, gen
from mfmbench.reference import risk as ref_risk

# several test workers share the cores: few threads each
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
RISK = {"nw_lags": 2, "nw_half_life": 252.0, "eigen_scale_coef": 1.4,
        "vol_regime_half_life": 42.0}
#: T > K dates so that Newey-West has valid dates past its K-date warm-up;
#: N = 600 puts 10 stocks in an industry on average: with fewer, a date's
#: normal matrix can be conditioned past the pseudo-inverse's float32 cut
#: (10 n eps of its largest eigenvalue), where the program's pseudo-inverse
#: and the reference's solve rightly part (at the cell's N = 3,000 its
#: smallest eigenvalue is ~6e-3 of the largest, 70 times the cut)
T, N, M = 96, 600, 3
#: (P, Q): USE4's own widths, and a smaller odd K with many industries
WIDTHS = [(60, 12), (24, 4)]
SEED = 2**31 + 23


def _inputs(P, Q, dtype):
    inp = gen.risk_inputs(T, N, P, Q, 1, seed=SEED, device="cpu")
    sim = gen.sim_covs(1 + P + Q, T, M, SEED, "cpu")
    return inp, sim


def _model(inp, P, dtype):
    return RiskModel(inp["rets"][0].to(dtype), inp["cap"].to(dtype),
                     inp["styles"].to(dtype), inp["industry"], inp["valid"],
                     n_industries=P, config=RiskModelConfig(eigen_n_sims=M),
                     device="cpu")


@pytest.mark.parametrize("P,Q", WIDTHS, ids=["use4_K73", "K29"])
def test_float64_is_the_plain_reference(P, Q):
    """At float64 the program and the reference differ only in how far
    their eighs are taken (a fixed sweep count against convergence) and in
    the order of their sums: 1e-10 of each output's largest entry leaves
    that room and no more (the CPU reading is ~1e-12)."""
    inp, sim = _inputs(P, Q, torch.float64)
    got = _model(inp, P, torch.float64).run_fused(
        sim_covs=sim.double(), sim_length=T)._asdict()
    want = ref_risk.rebuild(inp, inp["rets"][0], sim, RISK, P)
    assert got["factor_ret"].shape == (T, 1 + P + Q)
    assert bool(want["eigen_valid"].any())
    for k, g in got.items():
        w = want[k]
        if k.endswith("_valid"):
            assert torch.equal(g, w), k
            continue
        assert torch.equal(torch.isfinite(g), torch.isfinite(w)), k
        m = torch.isfinite(w)
        err = (g.double()[m] - w[m]).abs().max() / w[m].abs().max()
        assert err <= 1e-10, (k, float(err))


#: the numbers of ``compare.risk_numbers`` that carry a limit in the
#: benchmark's rebuild cells
BANDED = ("factor_ret", "specific_ret", "r2", "nw_cov", "eigen_cov_med",
          "eigen_cov_p90", "vr_cov_med", "vr_cov_p90")
#: the float32 program against the float32 witness (the reference run at
#: float32 arithmetic): both round every operation to float32, in other
#: orders and with other algorithms (the program's fixed-sweep Jacobi and
#: pseudo-inverse against the witness's converged Jacobi and LU solve), so
#: the program's gap to float64 is of the witness's order (1.4 to 6.6
#: times it over six seeds at these sizes, the pseudo-inverse's eighs
#: against the LU solve); 20 times the witness's gap leaves that spread
#: room and stays orders below what a wrong stage gives (1e-1 and more).
#: The floor only guards a witness reading of 0
BAND, FLOOR = 20.0, 1e-8


@pytest.mark.parametrize("P,Q", WIDTHS, ids=["use4_K73", "K29"])
def test_float32_within_the_float32_witness_band(P, Q):
    inp, sim = _inputs(P, Q, torch.float32)
    got = _model(inp, P, torch.float32).run_fused(
        sim_covs=sim, sim_length=T)._asdict()
    want = ref_risk.rebuild(inp, inp["rets"][0], sim, RISK, P)
    witness = ref_risk.rebuild(inp, inp["rets"][0], sim, RISK, P, "float32")
    prog = compare.risk_numbers(got, want)
    wit = compare.risk_numbers(
        {k: v for k, v in witness.items() if k in got}, want)
    assert prog["finite_apart"] == 0 and prog["valid_apart"] == 0
    for k in BANDED:
        assert prog[k] <= BAND * max(wit[k], FLOOR), (k, prog[k], wit[k])


@pytest.mark.parametrize("n,design", [(42, "warp"), (46, "warp"),
                                      (48, "block"), (72, "block"),
                                      (74, "block")])
def test_float32_widths_go_to_their_design(n, design):
    """K = 73's pseudo-inverse (n = 72) and its padded eighs (n = 74) are
    wider than the warp design's largest n (46): the block design."""
    assert eigh_cuda.design_for(n, torch.float32) == design
    assert eigh_cuda.design_for(n, torch.float64) == "block"


def test_use4_config_keeps_the_published_widths():
    cfg = json.loads((ROOT / "mfmbench/configs/use4.json").read_text())
    shape = cfg["shape"]
    assert (shape["P"], shape["Q"]) == (60, 12)
    assert 1 + shape["P"] + shape["Q"] == 73
    assert cfg["risk"]["eigen_n_sims"] == 100
    assert shape["T"] >= 32 * 73    # the Monte-Carlo's 5-sweep tier
    assert cfg["factors"]["industries"] == 60
    assert len(cfg["factors"]["styles"]) == 12
    assert cfg["assumed"] and cfg["source"] and cfg["dtype"] == "float32"
    assert cfg["tf32"] is False
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (entry,) = [c for c in bench["configs"] if c["name"] == "use4"]
    assert entry["reduced"] == [] and entry["source"] == cfg["source"]
    (cell,) = [w for w in bench["workloads"] if w["name"] == "use4.rebuild"]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "use4", "rebuild", 1)
    # the sweeps the roofline reads are those the program resolves
    from mfm_tpu_torch.models.eigen import sim_sweeps_for

    sweeps = cfg["roofline_sweeps"]
    assert sweeps["weighted"] == sim_sweeps_for(73, torch.float32,
                                                shape["T"]) == 5
    assert sweeps["full"] == E._sweeps_for(74, torch.float32) == 8


@pytest.fixture
def stage_spans():
    trace.reset_tracing()
    trace.set_tracing(True)
    trace.set_stage_tracing(True)
    yield
    trace.set_stage_tracing(False)
    trace.reset_tracing()


def _eigh_attrs() -> dict:
    return {s.name: {k: v for k, v in s.attrs.items()
                     if k.startswith("eigh_")}
            for s in trace.spans()
            if s.name in ("risk.regression", "risk.eigen")}


def test_span_counters_read_zero_on_the_cpu(stage_spans):
    inp, sim = _inputs(60, 12, torch.float32)
    _model(inp, 60, torch.float32).run_fused(sim_covs=sim, sim_length=T)
    assert _eigh_attrs() == {
        "risk.regression": {"eigh_warp_launches": 0,
                            "eigh_block_launches": 0},
        "risk.eigen": {"eigh_warp_launches": 0, "eigh_block_launches": 0,
                       "eigh_n": 0}}


@pytest.fixture
def counted_wrappers(monkeypatch):
    """The CUDA wrappers' dispatch and counting on CPU tensors: each call
    counts one launch of the design :func:`eigh_cuda.design_for` names, at
    its shape, and runs the plain version."""
    def full(A, sweeps=None, canonical_signs=True, sort=True):
        n = A.shape[-1]
        sweeps = E._sweeps_for(n, A.dtype) if sweeps is None else sweeps
        eigh_cuda._count_launch("jacobi_eigh", eigh_cuda.design_for(
            n, A.dtype), A.shape[0], n, sweeps)
        w, V = E.jacobi_eigh_slots(A, sweeps)
        return E.sort_and_sign(w, V, sort, canonical_signs)

    def weighted(A, d0, sweeps=None):
        n = A.shape[-1]
        sweeps = E._sweeps_for(n, A.dtype) if sweeps is None else sweeps
        eigh_cuda._count_launch("jacobi_eigh_weighted", eigh_cuda.design_for(
            n, A.dtype), A.shape[0], n, sweeps)
        return E.jacobi_eigh_weighted_diag_slots(A, d0, sweeps)

    eigh_cuda.reset_launches()
    monkeypatch.setattr(E, "_use_kernel", lambda A, kernels: kernels)
    monkeypatch.setattr(eigh_cuda, "jacobi_eigh_cuda", full)
    monkeypatch.setattr(eigh_cuda, "jacobi_eigh_weighted_diag_cuda", weighted)
    yield
    eigh_cuda.reset_launches()


@pytest.mark.parametrize("P,Q,design,n", [(60, 12, "block", 74),
                                          (31, 10, "warp", 42)],
                         ids=["use4_K73", "cne_K42"])
def test_span_counters_name_the_design_and_width(stage_spans,
                                                 counted_wrappers, P, Q,
                                                 design, n):
    """USE4's K = 73 launches the block design only and runs its
    Monte-Carlo at n = 74; the CNE model's K = 42 the warp design only, at
    n = 42."""
    inp, sim = _inputs(P, Q, torch.float32)
    _model(inp, P, torch.float32).run_fused(sim_covs=sim, sim_length=T)
    other = "warp" if design == "block" else "block"
    got = _eigh_attrs()
    reg, eig = got["risk.regression"], got["risk.eigen"]
    assert reg == {f"eigh_{design}_launches": 1, f"eigh_{other}_launches": 0}
    assert eig[f"eigh_{design}_launches"] == 2       # F0, the Monte-Carlo
    assert eig[f"eigh_{other}_launches"] == 0
    assert eig["eigh_n"] == n
    launches = eigh_cuda.launch_counts()
    assert launches[f"jacobi_eigh/{design}"] == 2     # pinv, F0
    assert launches[f"jacobi_eigh_weighted/{design}"] == 1
    assert launches[f"jacobi_eigh/{other}"] == 0
    assert launches[f"jacobi_eigh_weighted/{other}"] == 0
    assert [w for _, w, _ in eigh_cuda.launch_shapes()[
        "jacobi_eigh_weighted"]] == [n]
