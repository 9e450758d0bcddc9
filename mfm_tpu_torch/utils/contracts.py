"""Runtime contracts: the compile-contract counter (counterpart of
``mfm_tpu/utils/contracts.py``).

The incremental serving loop is cheap only while its state keeps stable
shapes and dtypes, so tests and the recovery matrix pin the steady state
to a bounded number of "compiles":

    with assert_max_compiles(0):
        for day in days:
            out, report, state = model.update_guarded(state)

The reference counts JAX lowerings.  The port runs eager torch and has no
lowering to count, so it counts the events that stand in a lowering's
place:

- a build or load of a kernel library (``ops/_build.py``):
  :data:`KERNEL_BUILD_EVENT`, :data:`KERNEL_LOAD_EVENT`;
- the first call of a ``(shape, dtype, device)`` signature at the eigh
  dispatchers (``ops/eigh.batched_eigh``, ``batched_eigh_weighted_diag``):
  :data:`NEW_SIGNATURE_EVENT`;
- the first padded-operand signature of a bucketed serving entry point,
  where the reference compiles once per bucket:
  :data:`BUCKET_SIGNATURE_EVENT`, at ``QueryEngine``'s batch step
  (:data:`QUERY_BATCH`), ``ScenarioEngine``'s batch kernel
  (:data:`SCENARIO_BATCH`), ``SweepEngine``'s chunk (:data:`SWEEP_CHUNK`)
  and the construct solve a served ``construct`` line runs
  (:data:`CONSTRUCT_SOLVE`, one signature per solver).

A state that drifts in shape shows up as a new signature, as in JAX it
shows up as a retrace; so does a serving batch that escapes its bucket.
A signature is the operands' shapes, the dtype of every operand and the
device, as a jit's cache key holds every operand's dtype: an index operand
that drifts from int32 to int64 behind a float first operand is a new
signature, as it is a retrace in the reference.  Signatures are recorded
only while a listener is registered — with none, a call pays three
empty-list tests — so a warmup that should make the
steady state free runs under :func:`count_compiles` too (as a JAX warmup
compiles).  A signature recorded once stays recorded for the process,
like a jit cache entry.  A build or load event carries its wall seconds
(``obs/profile.capture_compile_walls`` reads them); a signature event
carries none, as eager torch compiles nothing there.

Besides the scoped :func:`count_compiles` listeners, a process may hold
one *watcher* (:data:`_WATCHERS`), ``obs/instrument.watch_compiles``'s
feed of ``mfm_jit_compiles_total``: like the reference's monitoring
listener it stays registered for the process, and it is kept apart from
:data:`_LISTENERS` so that a scoped counter's exit leaves that list as it
found it.

The reference's ``no_tracer_leaks`` wraps ``jax.checking_leaks``; eager
torch has no tracers to leak, so it has no counterpart here.
"""

from __future__ import annotations

import contextlib

#: the event names a listener receives, in place of the reference's
#: ``/jax/core/compile/jaxpr_to_mlir_module_duration``
KERNEL_BUILD_EVENT = "/mfm_tpu_torch/ops/build"
KERNEL_LOAD_EVENT = "/mfm_tpu_torch/ops/load"
NEW_SIGNATURE_EVENT = "/mfm_tpu_torch/ops/eigh/new_signature"
BUCKET_SIGNATURE_EVENT = "/mfm_tpu_torch/serve/bucket/new_signature"

#: the bucketed serving entry points, as they name their signatures
QUERY_BATCH = "QueryEngine.query"
SCENARIO_BATCH = "ScenarioEngine.run"
SWEEP_CHUNK = "SweepEngine.chunk"
CONSTRUCT_SOLVE = "GradEngine.construct_solve"

#: registered listeners; only :func:`count_compiles` adds to it
_LISTENERS: list = []
#: process-lifetime watchers (``obs/instrument.watch_compiles``)
_WATCHERS: list = []
#: ``(dispatcher, shapes, dtypes, device)`` signatures seen while listening
_SEEN: set = set()
#: the IR audit's probes (``analysis/ir.py``): each is called with
#: ``(where, tensors)`` at every :func:`note_signature`, first call of a
#: signature or not, while it is registered
_PROBES: list = []


def listening() -> bool:
    """Whether any listener, watcher or probe would receive a call: the
    gate a dispatcher tests before :func:`note_signature`."""
    return bool(_LISTENERS or _WATCHERS or _PROBES)


def notify(event: str, detail: str = "",
           seconds: float | None = None) -> None:
    """Tell every registered listener and watcher about ``event``
    (``seconds``: the wall of a build or load, None for a signature)."""
    for fn in list(_LISTENERS) + list(_WATCHERS):
        fn(event, detail, seconds)


def signature_of(where: str, *tensors) -> tuple:
    """The signature :func:`note_signature` records for this call: every
    operand's shape and dtype, and the first operand's device."""
    return (where, tuple(tuple(t.shape) for t in tensors),
            tuple(str(t.dtype) for t in tensors), str(tensors[0].device))


def note_signature(where: str, *tensors,
                   event: str = NEW_SIGNATURE_EVENT) -> None:
    """Record a dispatcher call's signature; the first of each is an
    ``event``.  Callers test :func:`listening` first, so an unobserved
    dispatch costs three empty-list tests."""
    for fn in list(_PROBES):
        fn(where, tensors)
    sig = signature_of(where, *tensors)
    if sig not in _SEEN:
        _SEEN.add(sig)
        notify(event, f"{where}{list(sig[1])} {','.join(sig[2])} {sig[3]}")


def note_bucket(where: str, *tensors) -> None:
    """:func:`note_signature` for a bucketed serving entry point's padded
    operands (:data:`BUCKET_SIGNATURE_EVENT`)."""
    note_signature(where, *tensors, event=BUCKET_SIGNATURE_EVENT)


class CompileCounter:
    """Live count of compile-standing events observed while registered."""

    def __init__(self):
        self.count = 0
        self.events: list[str] = []

    def __call__(self, event: str, detail: str = "",
                 seconds: float | None = None) -> None:
        self.count += 1
        self.events.append(f"{event} {detail}".rstrip())


@contextlib.contextmanager
def count_compiles():
    """Yield a :class:`CompileCounter` tracking events inside the block;
    the listener is unregistered on exit."""
    counter = CompileCounter()
    _LISTENERS.append(counter)
    try:
        yield counter
    finally:
        _LISTENERS.remove(counter)


@contextlib.contextmanager
def assert_max_compiles(n: int, what: str = ""):
    """Fail if the block triggers more than ``n`` compile-standing events.

    Use after a warmup call when asserting steady-state behaviour."""
    with count_compiles() as counter:
        yield counter
    if counter.count > n:
        label = f" in {what}" if what else ""
        raise AssertionError(
            f"expected at most {n} compilation(s){label}, observed "
            f"{counter.count} — a traced step is being retraced "
            "(shape/dtype drift in its inputs or state pytree?): "
            f"{counter.events}")
