"""The plain references against the program on the CPU at small shapes,
the roofline's hand figures, and the reference's Jacobi solver."""

import pytest
import torch

from mfmbench import gen, roofline
from mfmbench.reference import alpha as ref_alpha
from mfmbench.reference import linalg
from mfmbench.reference import risk as ref_risk

RISK = {"nw_lags": 2, "nw_half_life": 252.0, "eigen_scale_coef": 1.4,
        "vol_regime_half_life": 42.0}


@pytest.mark.parametrize("shape,ms", [((139000, 42), 5.41),
                                      ((250000, 42), 9.73)])
def test_roofline_hand_figures(shape, ms):
    T = shape[0] // 100
    b = roofline.eigen_stage_bound(T, 100, shape[1], 4)
    assert b["bound_by"] == "operations"
    assert round(1e3 * b["least_s"], 2) == ms
    assert b["flops"] == roofline.jacobi_flops(shape[0], 42, 4, True)


@pytest.mark.parametrize("n", [2, 9, 10, 42])
def test_jacobi_eigh_matches_lapack(n):
    g = torch.Generator().manual_seed(n)
    A = torch.randn((64, n, n), generator=g, dtype=torch.float64)
    A = A + A.transpose(-1, -2)
    w, V = linalg.eigh(A)
    assert torch.allclose(w, torch.linalg.eigvalsh(A), atol=1e-12)
    assert torch.allclose(V @ torch.diag_embed(w) @ V.transpose(-1, -2), A,
                          atol=1e-12)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -12, 1.0 + 3 * 2 ** -12])
    assert linalg.round_tf32(x).tolist() == [1.0 + 2 ** -10, 1.0,
                                             1.0 + 2 ** -10]


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 5e-5)])
def test_risk_reference_is_the_program(dtype, tol):
    from mfm_tpu_torch import RiskModel, RiskModelConfig

    T, N, P, Q, M = 300, 60, 5, 3, 20
    inp = gen.risk_inputs(T, N, P, Q, 1, seed=2**31 + 3, device="cpu")
    sim = gen.sim_covs(1 + P + Q, T, M, 2**31 + 3, "cpu")
    ret = inp["rets"][0]
    rm = RiskModel(ret.to(dtype), inp["cap"].to(dtype),
                   inp["styles"].to(dtype), inp["industry"], inp["valid"],
                   n_industries=P, config=RiskModelConfig(eigen_n_sims=M),
                   device="cpu")
    got = rm.run_fused(sim_covs=sim.to(dtype), sim_length=T)._asdict()
    want = ref_risk.rebuild(inp, ret, sim, RISK, P)
    for k, g in got.items():
        w = want[k]
        if k.endswith("_valid"):
            assert torch.equal(g, w), k
            continue
        assert torch.equal(torch.isfinite(g), torch.isfinite(w)), k
        m = torch.isfinite(w)
        err = (g.double()[m] - w[m]).abs().max() / w[m].abs().max()
        assert err <= tol, (k, float(err))


#: the rank-based scores break ties by position; values equal in exact
#: arithmetic (a two-point correlation is +-1) tie in one rounding and not
#: in another, and move those scores by up to ~1e-4 at this size
RANK_KEYS = ("mean_rank_ic", "mean_turnover", "mean_spread")


def test_alpha_reference_is_the_program():
    from mfm_tpu_torch.alpha.dsl import compile_alpha_scores

    traffic = {"templates": ["cs_rank(delta(close, {d}))",
                             "-ts_corr(close, volume, {w})",
                             "cs_zscore(ts_std(ret, {w}))",
                             "decay_linear(cs_demean(ret), {w}) * {c}",
                             "where(ret > 0, cs_rank(volume), "
                             "-cs_rank(ts_mean(volume, {d})))",
                             "ts_rank(close, {w}) - cs_rank(delta(volume, {d}))"],
               "lags": [2, 3, 7], "windows": [5, 9, 24], "consts": [0.5, 1.4],
               "deck_size": 12}
    sources = gen.alpha_deck(traffic)
    panel, fwd = gen.alpha_panel(200, 50, 2**31 + 5, "cpu")
    p64 = {k: v.double() for k, v in panel.items()}
    got = compile_alpha_scores(sources, chunk=6)(p64, fwd.double())
    want = ref_alpha.score(sources, panel, fwd)
    for k, w in want.items():
        tol = 2e-4 if k in RANK_KEYS else 1e-6 if k == "coverage" else 1e-10
        assert torch.allclose(got[k].double(), w, atol=tol, rtol=0), k
