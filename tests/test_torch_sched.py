"""The port's deterministic-interleaving scheduler
(``mfm_tpu_torch/utils/sched.py``) against the JAX package's
(``mfm_tpu/utils/sched.py``): for the same seed and the same workers both
record the same decision trace, step for step, and deadlock on the same
seeds with the same state dump; plus the primitives' contracts (the
counterparts of ``tests/test_mfmsync.py``'s scheduler tests).  All
comparisons are exact.
"""

import pytest

from mfm_tpu.utils import sched as ref_sched
from mfm_tpu_torch.utils import sched
from mfm_tpu_torch.utils.sched import (
    DeadlockError,
    DetCondition,
    DetLock,
    DetQueue,
    DetRLock,
    DetScheduler,
    SchedulerError,
)


def _contended(mod, seed, threads=3, rounds=3):
    s = mod.DetScheduler(seed)
    lk = mod.DetLock(s, "L")
    order = []
    for i in range(threads):
        def worker(i=i):
            for _ in range(rounds):
                with lk:
                    order.append(i)
        s.spawn(worker, name=f"w{i}")
    return s.run(), order


def _producer_consumer(mod, seed):
    s = mod.DetScheduler(seed)
    lk = mod.DetRLock(s, "L")
    cv = mod.DetCondition(s, lk)
    q = mod.DetQueue(s, maxsize=2, name="q")
    log = []

    def producer():
        for i in range(4):
            q.put(i)
            with lk:
                log.append(("put", i))
                cv.notify_all()

    def consumer():
        for _ in range(4):
            with lk:
                while not log:
                    cv.wait(timeout=0.1)
            log.append(("got", q.get()))
    s.spawn(producer, name="p")
    s.spawn(consumer, name="c")
    return s.run(), log


@pytest.mark.parametrize("seed", [0, 1, 7, 42, 1234])
@pytest.mark.parametrize("case", ["contended", "producer_consumer"])
def test_trace_is_the_references_for_a_seed(case, seed):
    run = {"contended": _contended,
           "producer_consumer": _producer_consumer}[case]
    got, want = run(sched, seed), run(ref_sched, seed)
    assert got == want
    assert run(sched, seed) == got     # and replays bit for bit


def test_seeds_explore_different_interleavings():
    orders = {tuple(_contended(sched, seed)[1]) for seed in range(10)}
    assert len(orders) > 1, "seed sweep never changed the schedule"


def _ab_ba(mod, seed):
    s = mod.DetScheduler(seed)
    a, b = mod.DetLock(s, "A"), mod.DetLock(s, "B")

    def ab():
        with a:
            with b:
                pass

    def ba():
        with b:
            with a:
                pass
    s.spawn(ab, name="ab")
    s.spawn(ba, name="ba")
    try:
        s.run()
    except mod.DeadlockError as e:
        return str(e)
    return None


def test_deadlock_detection_on_the_references_seeds():
    got = [_ab_ba(sched, seed) for seed in range(40)]
    want = [_ab_ba(ref_sched, seed) for seed in range(40)]
    assert got == want
    hit = [m for m in got if m is not None]
    assert hit and all("no runnable thread" in m for m in hit)
    # replay: the same seed deadlocks again
    seed = got.index(hit[0])
    with pytest.raises(DeadlockError):
        s = DetScheduler(seed)
        a, b = DetLock(s, "A"), DetLock(s, "B")
        s.spawn(lambda: [a.acquire(), b.acquire()], name="ab")
        s.spawn(lambda: [b.acquire(), a.acquire()], name="ba")
        s.run()


def test_detlock_mutual_exclusion_and_reacquire():
    s = DetScheduler(3)
    lk = DetLock(s, "L")
    depth = {"now": 0, "max": 0}

    def worker():
        for _ in range(5):
            with lk:
                depth["now"] += 1
                depth["max"] = max(depth["max"], depth["now"])
                s.yield_point("critical")
                depth["now"] -= 1
    for i in range(3):
        s.spawn(worker, name=f"w{i}")
    s.run()
    assert depth["max"] == 1, "two workers inside one DetLock"

    s2 = DetScheduler(0)
    lk2 = DetLock(s2, "L2")

    def reacquirer():
        with lk2:
            with lk2:
                pass
    s2.spawn(reacquirer, name="re")
    with pytest.raises(SchedulerError, match="re-acquire"):
        s2.run()


def test_detrlock_is_reentrant_and_condition_needs_notify():
    s = DetScheduler(11)
    lk = DetRLock(s, "L")
    cv = DetCondition(s, lk)
    log = []

    def consumer():
        with lk:
            with lk:
                while not log:
                    cv.wait()
            log.append("consumed")

    def producer():
        with lk:
            log.append("item")
            cv.notify_all()
    s.spawn(consumer, name="c")
    s.spawn(producer, name="p")
    s.run()
    assert log == ["item", "consumed"]


def test_timed_wait_is_spurious_and_queue_hands_off():
    s = DetScheduler(5)
    cv = DetCondition(s, DetRLock(s, "L"))
    q = DetQueue(s, maxsize=1, name="q")
    woke, got = [], []

    def waiter():
        with cv:
            woke.append(cv.wait(timeout=0.5))

    def producer():
        for i in range(3):
            q.put(i)

    def consumer():
        for _ in range(3):
            got.append(q.get())
    for fn, name in ((waiter, "w"), (producer, "p"), (consumer, "c")):
        s.spawn(fn, name=name)
    s.run()
    assert woke == [False] and got == [0, 1, 2]


def test_worker_exception_propagates():
    s = DetScheduler(2)

    def boomer():
        raise ValueError("boom")
    s.spawn(boomer, name="boomer")
    with pytest.raises(ValueError, match="boomer.*boom"):
        s.run()
