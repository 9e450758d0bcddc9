"""The port's compile-contract counter (``mfm_tpu_torch/utils/contracts.py``),
against the reference's (``mfm_tpu/utils/contracts.py``).

The port runs eager torch: its "compiles" are kernel-library builds and
loads and first calls of a (shape, dtype, device) signature at the eigh
dispatchers.  The same call pattern gives the same count as the reference's
jit lowerings: a cached signature counts 0, a fresh one 1, a shape that
drifts every call is caught, and the listener is gone after the block.
Counts are compared exactly.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from mfm_tpu.utils import contracts as ref_contracts
from mfm_tpu_torch.ops import _build
from mfm_tpu_torch.ops.eigh import batched_eigh, batched_eigh_weighted_diag
from mfm_tpu_torch.utils import contracts
from mfm_tpu_torch.utils.contracts import (
    CompileCounter,
    assert_max_compiles,
    count_compiles,
)


@pytest.fixture(autouse=True)
def fresh_signatures(monkeypatch):
    """Each test from an empty signature set: a ``--metrics-dir`` CLI run
    earlier in the process (``obs/instrument.watch_compiles``) records
    every dispatch's signature for the process, as a jit cache would."""
    monkeypatch.setattr(contracts, "_SEEN", set())


@jax.jit
def _double(x):
    return x * 2.0


def _sym(n, batch=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(batch, n, n, generator=g, dtype=torch.float64)
    return a + a.transpose(-1, -2)


def test_cached_signature_does_not_count():
    A = _sym(5)
    with count_compiles():
        batched_eigh(A)          # warm: the signature is recorded
    with assert_max_compiles(0, what="cache hit"):
        batched_eigh(A.clone())
    x = jnp.ones(3)
    _double(x)
    with ref_contracts.assert_max_compiles(0, what="cache hit"):
        _double(x)


def test_fresh_signature_counts_once_in_both():
    A = _sym(9, batch=3)
    with count_compiles() as c:
        batched_eigh(A)
        batched_eigh(A)
    x = jnp.ones(97)
    with ref_contracts.count_compiles() as rc:
        _double(x)
        _double(x)
    assert c.count == rc.count == 1
    assert "batched_eigh[(3, 9, 9)] torch.float64 cpu" in c.events[0]


def test_shape_polymorphic_call_is_caught():
    with pytest.raises(AssertionError, match="retraced"):
        with assert_max_compiles(1, what="polymorphic loop"):
            for n in (11, 12, 13):
                batched_eigh(_sym(n))
    with pytest.raises(AssertionError, match="retraced"):
        with ref_contracts.assert_max_compiles(1, what="polymorphic loop"):
            for n in (11, 12, 13):
                _double(jnp.ones(n + 100))


def test_count_reports_exact_events_like_the_reference():
    A3, A21 = _sym(3, seed=1), _sym(21, seed=2)
    with count_compiles():
        batched_eigh(A3)                      # warm
    with count_compiles() as c:
        batched_eigh(A3)                      # hit
        batched_eigh(A21)                     # miss
        d0 = torch.ones(2, 21, dtype=torch.float64)
        batched_eigh_weighted_diag(A21, d0)   # the other dispatcher: miss
        batched_eigh_weighted_diag(A21, d0)   # hit
    x3, x21 = jnp.ones(203), jnp.ones(221)
    _double(x3)
    with ref_contracts.count_compiles() as rc:
        _double(x3)
        _double(x21)
    assert (c.count, rc.count) == (2, 1)


def test_dtype_and_device_are_part_of_the_signature():
    A = _sym(7, seed=3)
    with count_compiles() as c:
        batched_eigh(A)
        batched_eigh(A.float())
        batched_eigh(A.float())
    assert c.count == 2


def test_listener_is_unregistered_after_exit():
    with count_compiles() as c:
        batched_eigh(_sym(31))
    seen = c.count
    assert contracts._LISTENERS == []
    batched_eigh(_sym(41))     # outside the context: not counted
    assert c.count == seen == 1


def test_kernel_loads_are_events(monkeypatch):
    """A load of a kernel library counts (its build too, on the card)."""
    monkeypatch.setattr(_build, "build_all",
                        lambda: {"fake": "/nonexistent/libfake.so"})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: object())
    _build.load.cache_clear()
    try:
        with count_compiles() as c:
            _build.load("fake")
            _build.load("fake")   # cached: no second load
    finally:
        _build.load.cache_clear()
    assert c.count == 1 and c.events == [
        f"{contracts.KERNEL_LOAD_EVENT} fake"]


def test_nested_counters_each_see_events():
    with count_compiles() as outer:
        with count_compiles() as inner:
            batched_eigh(_sym(17, batch=4, seed=4))
    assert outer.count == inner.count == 1
    assert isinstance(outer, CompileCounter)


@jax.jit
def _take_rows(w, idx):
    return w, idx


def test_second_operand_dtype_drift_is_a_new_bucket_signature():
    """PR 1's s64 retrace trap at a bucketed entry point: the padded batch
    keeps its shape while its index operand (the second) drifts from int32
    to int64.  The reference's jit keys its cache on every operand's dtype
    and retraces; the port's counter records every operand's dtype, so the
    drift is a new :data:`BUCKET_SIGNATURE_EVENT`."""
    w = torch.ones(8, 3)
    idx32 = torch.zeros(8, dtype=torch.int32)
    with count_compiles() as c:
        contracts.note_bucket(contracts.QUERY_BATCH, w, idx32)
        contracts.note_bucket(contracts.QUERY_BATCH, w, idx32)   # cached
        contracts.note_bucket(contracts.QUERY_BATCH, w, idx32.long())
    assert c.count == 2
    assert c.events[-1].startswith(contracts.BUCKET_SIGNATURE_EVENT)
    assert "torch.int64" in c.events[-1]
    wj = jnp.ones((8, 3), dtype=jnp.float32)
    i32, i64 = jnp.zeros(8, dtype=jnp.int32), jnp.zeros(8, dtype=jnp.int64)
    _take_rows(wj, i32)
    with ref_contracts.count_compiles() as rc:
        _take_rows(wj, i32)                                      # cached
        _take_rows(wj, i64)                                      # retrace
    assert (c.count - 1, rc.count) == (1, 1)
