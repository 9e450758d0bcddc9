"""The port's flight-recorder ring capacity (``obs/flightrec.set_capacity``)
against the JAX package's behaviour."""

import pytest

from mfm_tpu.obs import flightrec as ref_flightrec
from mfm_tpu_torch.obs import flightrec


@pytest.fixture(autouse=True)
def _clean():
    flightrec.reset_flightrec()
    ref_flightrec.reset_flightrec()
    yield
    flightrec.reset_flightrec()
    ref_flightrec.reset_flightrec()


def test_ring_keeps_newest_oldest_first():
    for mod in (flightrec, ref_flightrec):
        mod.set_capacity(3)
        for i in range(5):
            mod.record_event("dispatch", replica=i)
    got = flightrec.events()
    assert [ev["replica"] for ev in got] == [2, 3, 4]
    assert [ev["replica"] for ev in got] == [
        ev["replica"] for ev in ref_flightrec.events()]


def test_set_capacity_validates_and_evicts_in_place():
    flightrec.record_event("a")
    flightrec.record_event("b")
    flightrec.set_capacity(1)
    assert [ev["kind"] for ev in flightrec.events()] == ["b"]
    for bad in (0, -2):
        with pytest.raises(ValueError) as err:
            flightrec.set_capacity(bad)
        with pytest.raises(ValueError) as ref_err:
            ref_flightrec.set_capacity(bad)
        assert str(err.value) == str(ref_err.value)


def test_reset_restores_the_default_capacity():
    flightrec.set_capacity(2)
    flightrec.reset_flightrec()
    for i in range(flightrec.DEFAULT_RING_CAPACITY + 5):
        flightrec.record_event("dispatch", replica=i)
    assert len(flightrec.events()) == flightrec.DEFAULT_RING_CAPACITY
