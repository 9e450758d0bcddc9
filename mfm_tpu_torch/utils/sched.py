"""Deterministic-interleaving scheduler for race confirmation
(counterpart of ``mfm_tpu/utils/sched.py``).

A :class:`DetScheduler` runs real ``threading.Thread`` workers but fully
serializes them: exactly one thread is ever runnable, and every context
switch happens at an instrumented yield point (lock acquire/release,
condition wait/notify, queue put/get, or an explicit
:meth:`~DetScheduler.yield_point`).  The switch decision is drawn from
``random.Random(seed)``, so a seed IS an interleaving — the same seed
replays the same schedule bit for bit, and the same trace as the
reference's scheduler for that seed — and sweeping seeds explores
adversarial schedules without ``sys.settrace`` overhead or flaky
sleep-based races.

The primitives (:class:`DetLock`, :class:`DetRLock`,
:class:`DetCondition`, :class:`DetQueue`) mirror the stdlib API surface
the serving fleet uses (``with lock:``, ``cond.wait(timeout)``,
``cond.notify_all()``, ``q.put/get``), so a harness can transplant them
into live objects::

    s = DetScheduler(seed=7)
    co._lock = DetRLock(s, "coalesce")
    co._wake = DetCondition(s, co._lock)
    s.spawn(lambda: co.submit(line), name="client-0")
    s.run()

Timed ``wait(timeout=...)`` calls model the adversary's spurious
wakeup: the waiter becomes schedulable immediately, because a timeout
can always fire before the notify.  Untimed waits genuinely require a
notify.  If no thread is runnable and some are still alive, ``run()``
raises :class:`DeadlockError` with a state dump — a deterministic
reproduction of a lock-order deadlock.

Used by the ``sync-schedule-coalescer`` / ``sync-schedule-cache`` plans of
``python -m mfm_tpu_torch.tools.faultinject``.  Stdlib-only.
"""

from __future__ import annotations

import random
import threading
from collections import deque


class DeadlockError(RuntimeError):
    """No runnable thread, but not all threads finished."""


class SchedulerError(RuntimeError):
    """Misuse of the scheduler (step-cap blown, bad release, ...)."""


class DetScheduler:
    """Seeded cooperative scheduler; one runnable thread at a time."""

    #: hard cap on context switches — a livelocked schedule fails loudly
    MAX_STEPS = 1_000_000

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._cv = threading.Condition()
        self._threads: dict[int, threading.Thread] = {}
        self._names: dict[int, str] = {}
        #: tid -> None (unconditionally runnable) or 0-arg predicate
        self._runnable: dict[int, object] = {}
        self._done: set[int] = set()
        self._failures: list = []
        self._current: int | None = None
        self._trace: list[str] = []
        self._labels: dict[int, str] = {}
        self._next_tid = 0
        self._tls = threading.local()

    # -- worker side ---------------------------------------------------------
    def spawn(self, fn, *args, name: str | None = None) -> int:
        """Register a worker.  It starts parked and only ever runs while
        the scheduler has elected it."""
        tid = self._next_tid
        self._next_tid += 1
        self._names[tid] = name or f"t{tid}"

        def body():
            self._tls.tid = tid
            with self._cv:
                while self._current != tid:
                    self._cv.wait()
            try:
                fn(*args)
            except BaseException as exc:  # surfaced by run()
                self._failures.append((self._names[tid], exc))
            finally:
                with self._cv:
                    self._done.add(tid)
                    self._runnable.pop(tid, None)
                    self._current = None
                    self._cv.notify_all()

        t = threading.Thread(target=body, name=self._names[tid], daemon=True)
        self._threads[tid] = t
        # _runnable/_labels are written under _cv by the workers;
        # registration takes the same lock even though no worker has
        # started yet (spawn-while-running stays safe)
        with self._cv:
            self._runnable[tid] = None
            self._labels[tid] = "start"
        return tid

    def _me(self) -> int:
        tid = getattr(self._tls, "tid", None)
        if tid is None:
            raise SchedulerError("yield_point outside a spawned thread")
        return tid

    def yield_point(self, label: str, pred=None) -> None:
        """Park the calling worker and hand control back to the
        scheduler.  With ``pred``, the worker is only electable while
        ``pred()`` is true (lock free, item available, notified...)."""
        tid = self._me()
        with self._cv:
            self._runnable[tid] = pred
            self._labels[tid] = label
            self._current = None
            self._cv.notify_all()
            while self._current != tid:
                self._cv.wait()

    # -- scheduler side ------------------------------------------------------
    def _enabled(self) -> list[int]:
        out = []
        for tid in sorted(self._runnable):
            pred = self._runnable[tid]
            if pred is None or pred():
                out.append(tid)
        return out

    def run(self) -> list:
        """Drive every spawned worker to completion; returns the trace.
        Raises the first worker exception, or DeadlockError."""
        for t in self._threads.values():
            t.start()
        steps = 0
        while True:
            with self._cv:
                if len(self._done) == len(self._threads):
                    break
                enabled = self._enabled()
                if not enabled:
                    dump = ", ".join(
                        f"{self._names[t]}@{self._labels.get(t, '?')}"
                        for t in sorted(self._runnable))
                    raise DeadlockError(
                        f"seed={self.seed}: no runnable thread; "
                        f"blocked: [{dump}]")
                pick = enabled[self._rng.randrange(len(enabled))]
                self._trace.append(
                    f"{self._names[pick]}:{self._labels.get(pick, '?')}")
                self._runnable.pop(pick, None)
                self._current = pick
                self._cv.notify_all()
                while self._current is not None:
                    self._cv.wait()
            steps += 1
            if steps > self.MAX_STEPS:
                raise SchedulerError(f"seed={self.seed}: step cap blown")
        if self._failures:
            name, exc = self._failures[0]
            raise type(exc)(f"[worker {name}] {exc}") from exc
        return self.trace()

    def trace(self) -> list:
        """Decision log so far: 'name:label' per context switch.  Equal
        seeds produce equal traces — the determinism contract."""
        with self._cv:
            return list(self._trace)


class DetLock:
    """Non-reentrant lock with scheduler-visible acquire/release."""

    def __init__(self, sched: DetScheduler, name: str = "lock"):
        self._s = sched
        self.name = name
        self._owner: int | None = None

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        me = self._s._me()
        if self._owner == me:
            raise SchedulerError(f"{self.name}: re-acquire of "
                                 "non-reentrant DetLock (self-deadlock)")
        self._s.yield_point(f"acquire:{self.name}",
                            pred=lambda: self._owner is None)
        self._owner = me
        return True

    def release(self) -> None:
        if self._owner != self._s._me():
            raise SchedulerError(f"{self.name}: release by non-owner")
        self._owner = None
        self._s.yield_point(f"release:{self.name}")

    def locked(self) -> bool:
        return self._owner is not None

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class DetRLock(DetLock):
    """Reentrant variant (the coalescer uses RLock)."""

    def __init__(self, sched: DetScheduler, name: str = "rlock"):
        super().__init__(sched, name)
        self._count = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        me = self._s._me()
        if self._owner == me:
            self._count += 1
            return True
        self._s.yield_point(f"acquire:{self.name}",
                            pred=lambda: self._owner is None)
        self._owner = me
        self._count = 1
        return True

    def release(self) -> None:
        if self._owner != self._s._me():
            raise SchedulerError(f"{self.name}: release by non-owner")
        self._count -= 1
        if self._count == 0:
            self._owner = None
            self._s.yield_point(f"release:{self.name}")

    # condition support: hand the full recursion level over on wait()
    def _release_save(self):
        me, count = self._owner, self._count
        self._owner, self._count = None, 0
        return (me, count)

    def _acquire_restore(self, state) -> None:
        self._s.yield_point(f"reacquire:{self.name}",
                            pred=lambda: self._owner is None)
        self._owner, self._count = state


class DetCondition:
    """Condition over a Det(R)Lock.  Timed waits model the adversarial
    spurious wakeup (schedulable immediately); untimed waits require a
    notify."""

    def __init__(self, sched: DetScheduler, lock: DetLock | None = None):
        self._s = sched
        self._lock = lock if lock is not None else DetRLock(sched, "cond")
        self.name = f"cond({self._lock.name})"
        self._notified: set[int] = set()

    def _check_owned(self):
        if self._lock._owner != self._s._me():
            raise SchedulerError(f"{self.name}: used without holding "
                                 "its lock")

    def wait(self, timeout: float | None = None) -> bool:
        self._check_owned()
        me = self._s._me()
        if isinstance(self._lock, DetRLock):
            state = self._lock._release_save()
        else:
            self._lock._owner = None
            state = None
        if timeout is not None:
            # a timeout may always fire first: immediately electable
            self._s.yield_point(f"timedwait:{self.name}")
        else:
            self._s.yield_point(f"wait:{self.name}",
                                pred=lambda: me in self._notified)
        woke = me in self._notified
        self._notified.discard(me)
        if isinstance(self._lock, DetRLock):
            self._lock._acquire_restore(state)
        else:
            self._s.yield_point(f"reacquire:{self.name}",
                                pred=lambda: self._lock._owner is None)
            self._lock._owner = me
        return woke

    def _waiters(self) -> list[int]:
        pre = f"wait:{self.name}"
        tpre = f"timedwait:{self.name}"
        return [tid for tid, lab in self._s._labels.items()
                if tid in self._s._runnable and lab in (pre, tpre)]

    def notify(self, n: int = 1) -> None:
        self._check_owned()
        for tid in sorted(self._waiters())[:n]:
            self._notified.add(tid)

    def notify_all(self) -> None:
        self.notify(n=len(self._s._threads))

    def acquire(self, *a, **k):
        return self._lock.acquire(*a, **k)

    def release(self):
        return self._lock.release()

    def __enter__(self):
        self._lock.acquire()
        return self

    def __exit__(self, *exc):
        self._lock.release()
        return False


class DetQueue:
    """Minimal instrumented queue: put parks when full (maxsize > 0),
    get parks when empty — each a scheduling decision point."""

    def __init__(self, sched: DetScheduler, maxsize: int = 0,
                 name: str = "queue"):
        self._s = sched
        self._max = maxsize
        self.name = name
        self._items: deque = deque()

    def put(self, item, block: bool = True, timeout=None) -> None:
        if self._max > 0:
            self._s.yield_point(f"put:{self.name}",
                                pred=lambda: len(self._items) < self._max)
        else:
            self._s.yield_point(f"put:{self.name}")
        self._items.append(item)

    def put_nowait(self, item) -> None:
        if self._max > 0 and len(self._items) >= self._max:
            raise SchedulerError(f"{self.name}: put_nowait on full queue")
        self._items.append(item)

    def get(self, block: bool = True, timeout=None):
        self._s.yield_point(f"get:{self.name}",
                            pred=lambda: len(self._items) > 0)
        return self._items.popleft()

    def qsize(self) -> int:
        return len(self._items)

    def empty(self) -> bool:
        return not self._items
