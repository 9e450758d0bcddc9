"""The port's workload shapes (``mfm_tpu_torch/data/synthetic.py``:
``Universe``, ``UNIVERSES``, ``resolve_universe``) against the JAX
package's."""

import pytest

from mfm_tpu.data import synthetic as ref_synthetic
from mfm_tpu_torch.data import synthetic


def _fields(u):
    return (u.name, u.T, u.N, u.P, u.Q)


def test_named_universes_are_the_reference_shapes():
    assert synthetic.UNIVERSES == ref_synthetic.UNIVERSES
    assert synthetic.UNIVERSES["csi300"] == synthetic.CSI300
    assert synthetic.UNIVERSES["alla"] == (2500, 5000, 31, 10)


@pytest.mark.parametrize("spec, T", [
    ("csi300", None), ("alla", None), (1000, None), ("5000", None), (7, None),
    ("alla", 500), ("alla", 2500), ("csi300", 40), (800, 1390), (800, 90),
    ("alla", "600"),
])
def test_resolve_universe_matches_reference(spec, T):
    got = synthetic.resolve_universe(spec, T=T)
    want = ref_synthetic.resolve_universe(spec, T=T)
    assert _fields(got) == _fields(want)
    assert repr(got) == repr(want)
    assert isinstance(got, synthetic.Universe)


def test_a_shortened_run_carries_its_length_in_the_name():
    assert synthetic.resolve_universe("alla", T=500).name == "alla_t500"
    assert synthetic.resolve_universe("alla", T=2500).name == "alla"
    assert synthetic.resolve_universe(300, T=100).name == "n300_t100"


@pytest.mark.parametrize("spec", ["nasdaq", "", None, 0, -5, "1e3", 2.5j])
def test_resolve_universe_errors_as_the_reference(spec):
    with pytest.raises(ValueError) as ref_err:
        ref_synthetic.resolve_universe(spec)
    with pytest.raises(ValueError) as err:
        synthetic.resolve_universe(spec)
    assert str(err.value) == str(ref_err.value)
