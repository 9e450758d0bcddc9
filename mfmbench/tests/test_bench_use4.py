"""``mc_eigh_roofline``: the least time of the eigen Monte-Carlo's weighted
eighs by hand, and its reader on traced records of either design."""

import pytest

from conftest import ROOT
from mfmbench import harness, roofline

READER = harness.load_module(ROOT / "mfmbench" / "metrics" /
                             "mc_eigh_roofline.py")
WARP = "void (anonymous namespace)::warp_weighted_kernel<42>(float const*"
BLOCK = ("void (anonymous namespace)::jacobi_eigh_weighted_kernel<float>("
         "float const*")


def _rec(ops, T=1390, K=42, weighted=4):
    return {"rebuild_trace": {"device_ops": ops, "kernels": len(ops)},
            "roofline_shape": {"T": T, "M": 100, "K": K,
                               "sweeps": {"weighted": weighted, "full": 7}}}


@pytest.mark.parametrize("B,K,sweeps,ms", [(139000, 42, 4, 5.41),
                                           (250000, 42, 4, 9.73),
                                           (250000, 73, 5, 64.5)])
def test_least_time_by_hand(B, K, sweeps, ms):
    """The reader's least time is ``eigen_stage_bound``'s: by hand, 9 K^2
    flop a matrix a round, K - 1 rounds a sweep, 3 K^2 for h, at 67
    TFLOP/s; the bytes take far less."""
    flops = B * (sweeps * (K - 1) * 9 * K * K + 3 * K * K)
    assert round(1e3 * flops / 67e12, 2 if ms < 10 else 1) == ms
    bound = roofline.eigen_stage_bound(B // 100, 100, K, sweeps)
    assert bound["bound_by"] == "operations"
    assert bound["least_s"] == pytest.approx(flops / 67e12, rel=1e-12)
    dev = 2 * flops / 67e12
    assert READER.read(_rec([[BLOCK, dev]], B // 100, K, sweeps)) == \
        pytest.approx(50.0, rel=1e-12)


def test_nothing_to_read_is_no_reading():
    assert READER.read({}) is None
    assert READER.read(_rec([["void at::native::elementwise_kernel", 0.1]])) \
        is None
    assert READER.read({"rebuild_trace": {"device_ops": [[WARP, 0.03]]}}) \
        is None


@pytest.mark.parametrize("name,T,K,weighted", [(WARP, 1390, 42, 4),
                                               (BLOCK, 2500, 73, 5)],
                         ids=["warp", "block"])
def test_reads_the_weighted_kernel_of_either_design(name, T, K, weighted):
    least = roofline.eigen_stage_bound(T, 100, K, weighted)["least_s"]
    rec = _rec([[name, 2 * least / 3], ["void at::native::other", 1.0],
                [name + " second launch", least / 3]], T, K, weighted)
    assert READER.read(rec) == pytest.approx(100.0)
