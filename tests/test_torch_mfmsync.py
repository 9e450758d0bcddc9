"""The port's lock-discipline pass (``mfm_tpu_torch/analysis/sync.py``)
beside the JAX package's (``tests/test_mfmsync.py``), test for test.

- the port's package analyzes strict-clean against its committed
  baseline: the reference's two entries' counterparts (S3 at
  ``Coalescer._flush_locked``, S4 at ``DetScheduler.spawn``'s ``body``);
- every fixture without a JAX call (S1's guarded fields, the ``_locked``
  convention and the private-method fixpoint, condition aliasing, S2's
  cycles and re-acquires, S3 on sleep, subprocess, join, get and a
  foreign wait, the baseline and strict behaviour) goes through both
  packages' passes on the same tree and gives the same findings (file,
  line, rule, qualname);
- a fixture with a JAX call is translated to torch line for line, and the
  port on the translation gives the findings the reference gives on the
  original;
- injection drills on scratch copies of the port flip the CLI to exit 1;
- ``doctor --sync`` is clean and names the baselined finding.
"""

import json
import shutil
import textwrap
from pathlib import Path

import pytest

from mfm_tpu.analysis import sync as ref_sync
from mfm_tpu_torch.analysis import sync
from mfm_tpu_torch.analysis.sync import (
    DEFAULT_BASELINE,
    REPO_ROOT,
    load_baseline,
    main,
    run_sync,
)
from mfm_tpu_torch.cli import main as cli_main

REPO = Path(REPO_ROOT)


def _write(root, files):
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))


def _sync(tmp_path, files, baseline=None, pkg=sync):
    _write(tmp_path, files)
    return pkg.run_sync([str(tmp_path)], baseline=baseline,
                        root=str(tmp_path))


def _keys(res):
    return sorted((v.file.replace("\\", "/"), v.line, v.rule, v.qualname)
                  for v in res.new)


def _found(res):
    return sorted((v.rule, v.qualname) for v in res.new)


# -- layer 1: the real tree ---------------------------------------------------

def test_repo_syncs_clean_with_committed_baseline():
    baseline = load_baseline(str(REPO / DEFAULT_BASELINE))
    assert 0 < len(baseline) <= 5, "baseline creep: fix, don't excuse"
    for b in baseline:
        assert b.get("justification"), f"unjustified baseline entry: {b}"
        assert "reference" in b["justification"]   # names its counterpart
    ref = load_baseline(str(REPO / ref_sync.DEFAULT_BASELINE))
    assert sorted((b["rule"], b["qualname"]) for b in baseline) == \
        sorted((b["rule"], b["qualname"]) for b in ref)
    res = run_sync(baseline=baseline)
    assert not res.new, "\n".join(v.render() for v in res.new)
    assert not res.stale, f"stale baseline entries: {res.stale}"
    assert [(v.rule, v.qualname) for v in res.baselined] == \
        [("S3", "Coalescer._flush_locked")]
    _, uncovered = res.analyzer.thread_target_coverage()
    assert [(u["file"], u["expr"]) for u in uncovered] == [
        ("mfm_tpu_torch/utils/sched.py", "Name(id='body', ctx=Load())")]
    assert main(["--strict"]) == 0


def test_the_port_finds_what_the_reference_finds_on_its_own_package():
    """Both packages' serving modules, each through its own pass: the
    same findings by rule and qualname."""
    got = run_sync()
    want = ref_sync.run_sync()
    assert sorted((v.rule, v.qualname) for v in got.new + got.baselined) \
        == sorted((v.rule, v.qualname) for v in want.new + want.baselined)


def test_doctor_sync_is_clean_without_a_path(capsys):
    with pytest.raises(SystemExit) as exc:
        cli_main(["doctor", "--sync"])
    assert exc.value.code == 0
    out = json.loads(capsys.readouterr().out)
    (rec,) = out["records"]
    assert out["unhealthy"] == 0 and rec["kind"] == "sync_analysis"
    assert rec["problems"] == [] and rec["baselined"] == 1
    assert rec["warnings"] == ["baselined: mfm_tpu_torch/serve/coalesce.py "
                               "S3 [Coalescer._flush_locked]"]


def test_doctor_without_path_or_sync_names_both(capsys):
    with pytest.raises(SystemExit) as exc:
        cli_main(["doctor"])
    assert "PATH is required unless --audit or --sync" in str(exc.value.code)


def test_cli_sync_subcommand_is_the_pass(capsys):
    with pytest.raises(SystemExit) as exc:
        cli_main(["sync", "--strict", "--json"])
    assert exc.value.code == 0
    out = json.loads(capsys.readouterr().out)
    assert out["new"] == [] and out["stale"] == []
    assert [b["qualname"] for b in out["baselined"]] == [
        "Coalescer._flush_locked"]


# -- layer 2: fixtures without a JAX call, through both passes ----------------

SHARED = {
    "s1_guarded_field_inference": """
        import threading

        class Box:
            def __init__(self):
                self._lock = threading.Lock()
                self._n = 0
                self.tag = "x"

            def bump(self):
                with self._lock:
                    self._n += 1      # the guarding write

            def reset(self):
                self._n = 0           # S1: unguarded write

            def peek(self):
                return self._n        # S1: unguarded read

            def label(self):
                self.tag = "y"        # clean: tag is never lock-guarded
    """,
    "s1_locked_suffix_and_private_fixpoint": """
        import threading

        class Pool:
            def __init__(self):
                self._lock = threading.Lock()
                self._items = []

            def add_item(self, x):
                with self._lock:
                    self._items.append(x)

            def _drain_locked(self):
                return list(self._items)

            def _size(self):
                return len(self._items)

            def snapshot(self):
                with self._lock:
                    return self._size()

            def racy(self):
                return len(self._items)     # S1: public, lock-free
    """,
    "condition_alias_and_held_wait_allowed": """
        import threading

        class W:
            def __init__(self):
                self._lock = threading.Lock()
                self._wake = threading.Condition(self._lock)
                self._evt = threading.Event()
                self._q = []

            def put_item(self, x):
                with self._wake:          # aliases to _lock
                    self._q.append(x)
                    self._wake.notify()

            def take(self):
                with self._wake:
                    while not self._q:
                        self._wake.wait()  # wait on the HELD cond: legal
                    return self._q.pop(0)

            def bad_wait(self):
                with self._lock:
                    self._evt.wait()       # S3: foreign wait under lock
    """,
    "s2_lock_order_cycle": """
        import threading

        L1 = threading.Lock()
        L2 = threading.Lock()

        def fwd():
            with L1:
                with L2:
                    pass

        def rev():
            with L2:
                with L1:
                    pass
    """,
    "s2_consistent_order": """
        import threading

        L1 = threading.Lock()
        L2 = threading.Lock()

        def fwd():
            with L1:
                with L2:
                    pass

        def also_fwd():
            with L1:
                with L2:
                    pass
    """,
    "s2_nonreentrant_reacquire": """
        import threading

        class Plain:
            def __init__(self):
                self._lock = threading.Lock()

            def oops(self):
                with self._lock:
                    with self._lock:     # S2: plain Lock self-deadlock
                        pass

        class Reentrant:
            def __init__(self):
                self._lock = threading.RLock()

            def fine(self):
                with self._lock:
                    with self._lock:     # RLock: legal
                        pass
    """,
    "s3_blocking_catalog": """
        import socket
        import subprocess
        import threading
        import time

        LOCK = threading.Lock()

        def bad_sleep():
            with LOCK:
                time.sleep(0.1)

        def ok_sleep():
            time.sleep(0.1)

        def bad_spawn():
            with LOCK:
                subprocess.run(["true"])

        def bad_join(t):
            with LOCK:
                t.join()                  # zero-arg join: blocking

        def ok_strjoin(xs):
            with LOCK:
                return ", ".join(xs)      # has an argument: str.join

        def bad_get(q):
            with LOCK:
                return q.get()            # zero-arg get: queue.get

        def ok_dictget(d):
            with LOCK:
                return d.get("k")

        def bad_socket(addr):
            with LOCK:
                s = socket.create_connection(addr)
                s.sendall(b"x")           # socket I/O under the lock
                return s.recv(1)
    """,
    "s3_one_level_transitive": """
        import threading
        import time

        class Pump:
            def __init__(self):
                self._lock = threading.Lock()

            def _nap(self):
                time.sleep(0.01)

            def drain(self, other):
                with self._lock:
                    other.nap_helper()

        def nap_helper():
            time.sleep(0.01)
    """,
    "threads_and_queues": """
        import queue
        import threading

        class Fleet:
            def __init__(self):
                self._lock = threading.RLock()
                self._inbox = queue.Queue()
                self._seen = 0
                self._t = threading.Thread(target=self._loop, daemon=True)

            def _loop(self):
                while True:
                    item = self._inbox.get(timeout=1.0)
                    with self._lock:
                        self._seen += 1

            def seen(self):
                return self._seen        # S1: the loop writes under lock
    """,
}


@pytest.mark.parametrize("name", list(SHARED))
def test_fixtures_without_jax_give_the_references_findings(tmp_path, name):
    got = _sync(tmp_path, {"mod.py": SHARED[name]})
    want = ref_sync.run_sync([str(tmp_path)], root=str(tmp_path))
    assert _keys(got) == _keys(want)
    assert got.analyzer.thread_target_coverage() == \
        want.analyzer.thread_target_coverage()


@pytest.mark.parametrize("name,found", [
    ("s1_guarded_field_inference", [("S1", "Box.peek"), ("S1", "Box.reset")]),
    ("s1_locked_suffix_and_private_fixpoint", [("S1", "Pool.racy")]),
    ("condition_alias_and_held_wait_allowed", [("S3", "W.bad_wait")]),
    ("s2_nonreentrant_reacquire", [("S2", "Plain.oops")]),
    ("s3_blocking_catalog", [("S3", "bad_get"), ("S3", "bad_join"),
                             ("S3", "bad_sleep"), ("S3", "bad_socket"),
                             ("S3", "bad_socket"), ("S3", "bad_spawn")]),
    ("s2_consistent_order", []),
])
def test_fixture_findings(tmp_path, name, found):
    assert _found(_sync(tmp_path, {"mod.py": SHARED[name]})) == found


def test_s2_cycle_is_one_finding(tmp_path):
    res = _sync(tmp_path, {"mod.py": SHARED["s2_lock_order_cycle"]})
    assert [r for r, _q in _found(res)] == ["S2"]
    assert "cycle" in res.new[0].message


def test_baseline_and_strict_stale(tmp_path):
    files = {"mod.py": """
        import threading
        import time

        LOCK = threading.Lock()

        def bad_sleep():
            with LOCK:
                time.sleep(0.1)
    """}
    for pkg in (sync, ref_sync):
        root = tmp_path / pkg.__name__
        res = _sync(root, files, pkg=pkg)
        assert len(res.new) == 1
        bl = [{"file": "mod.py", "rule": "S3", "qualname": "bad_sleep",
               "justification": "fixture"}]
        res2 = pkg.run_sync([str(root)], baseline=bl, root=str(root))
        assert not res2.new and len(res2.baselined) == 1 and not res2.stale
        blp = root / "bl.json"
        blp.write_text(json.dumps(bl + [{"file": "mod.py", "rule": "S2",
                                         "qualname": "ghost"},
                                        {"file": "mod.py", "rule": "S4",
                                         "qualname": "never stale"}]))
        args = [str(root), "--baseline", str(blp), "--root", str(root)]
        assert pkg.main(args) == 0
        assert pkg.main(args + ["--strict"]) == 1


def test_json_output(tmp_path, capsys):
    _write(tmp_path, {"mod.py": SHARED["s2_nonreentrant_reacquire"]})
    rc = main([str(tmp_path), "--baseline", "none", "--root", str(tmp_path),
               "--json"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 1 and out["stale"] == [] and out["baselined"] == []
    assert [(v["rule"], v["qualname"]) for v in out["new"]] == [
        ("S2", "Plain.oops")]


# -- layer 2: JAX fixtures translated to torch ---------------------------------

TRANSLATED = {
    "jit_dispatch_under_lock": ("""
        import threading

        import jax
        import jax.numpy as jnp

        LOCK = threading.Lock()

        @jax.jit
        def kernel(x):
            return jnp.sum(x)

        def bad_dispatch(x):
            with LOCK:
                return kernel(x)          # S3: jit dispatch under lock

        def ok_dispatch(x):
            return kernel(x)

        def bad_direct(x):
            with LOCK:
                return jnp.dot(x, x)      # S3: direct jax call
    """, """
        import threading

        import torch
        import torch

        LOCK = threading.Lock()

        # eager: the call itself launches
        def kernel(x):
            return torch.sum(x)

        def bad_dispatch(x):
            with LOCK:
                return kernel(x)          # S3: device work under lock

        def ok_dispatch(x):
            return kernel(x)

        def bad_direct(x):
            with LOCK:
                return torch.dot(x, x)    # S3: direct torch call
    """),
    "os_handle_receiver_is_not_a_device_edge": ("""
        import subprocess
        import threading

        import jax.numpy as jnp

        LOCK = threading.Lock()

        class Engine:
            def poll(self):
                return jnp.zeros(3)       # genuine jax toucher named poll

        class Worker:
            def __init__(self):
                self.proc = subprocess.Popen(["true"])

            def alive(self):
                return self.proc.poll() is None   # OS handle, not Engine.poll

        def route(w):
            with LOCK:
                return w.alive()          # must NOT be S3
    """, """
        import subprocess
        import threading

        import torch

        LOCK = threading.Lock()

        class Engine:
            def poll(self):
                return torch.zeros(3)     # genuine torch toucher named poll

        class Worker:
            def __init__(self):
                self.proc = subprocess.Popen(["true"])

            def alive(self):
                return self.proc.poll() is None   # OS handle, not Engine.poll

        def route(w):
            with LOCK:
                return w.alive()          # must NOT be S3
    """),
    "local_handle_and_container_receivers": ("""
        import threading

        import jax.numpy as jnp

        LOCK = threading.Lock()

        class Engine:
            def update(self, x):
                return jnp.sum(x)

            def flush(self):
                return jnp.zeros(2)

            def refit(self, x):
                return jnp.dot(x, x)

        def record(**fields):
            ev = {"kind": "x"}
            ev.update(fields)
            return ev

        def dump(path, text):
            with open(path, "w") as fh:
                fh.write(text)
                fh.flush()
            rows = list(text)
            rows.append("eof")

        def locked_writer(path):
            with LOCK:
                record(a=1)               # must NOT be S3
                dump(path, "x")           # must NOT be S3

        def rebound(x):
            ev = {}
            ev = Engine()                 # rebind untracks the name
            with LOCK:
                return ev.refit(x)        # IS S3: a real Engine.refit
    """, """
        import threading

        import torch

        LOCK = threading.Lock()

        class Engine:
            def update(self, x):
                return torch.sum(x)

            def flush(self):
                return torch.zeros(2)

            def refit(self, x):
                return torch.dot(x, x)

        def record(**fields):
            ev = {"kind": "x"}
            ev.update(fields)
            return ev

        def dump(path, text):
            with open(path, "w") as fh:
                fh.write(text)
                fh.flush()
            rows = list(text)
            rows.append("eof")

        def locked_writer(path):
            with LOCK:
                record(a=1)               # must NOT be S3
                dump(path, "x")           # must NOT be S3

        def rebound(x):
            ev = {}
            ev = Engine()                 # rebind untracks the name
            with LOCK:
                return ev.refit(x)        # IS S3: a real Engine.refit
    """),
}


@pytest.mark.parametrize("name", list(TRANSLATED))
def test_jax_fixtures_translated_to_torch_give_the_references_findings(
        tmp_path, name):
    original, translation = TRANSLATED[name]
    want = _sync(tmp_path / "ref", {"mod.py": original}, pkg=ref_sync)
    got = _sync(tmp_path / "port", {"mod.py": translation})
    assert _keys(got) == _keys(want)
    expect = {"jit_dispatch_under_lock": {("S3", "bad_direct"),
                                          ("S3", "bad_dispatch")},
              "os_handle_receiver_is_not_a_device_edge": set(),
              "local_handle_and_container_receivers": {("S3", "rebound")}}
    assert set(_found(got)) == expect[name]


# -- layer 3: injection drills against scratch copies of the port --------------

def _scratch_package(tmp_path):
    shutil.copytree(REPO / "mfm_tpu_torch", tmp_path / "mfm_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "*.so"))
    return [str(tmp_path / "mfm_tpu_torch"),
            "--baseline", str(REPO / DEFAULT_BASELINE),
            "--root", str(tmp_path), "--strict"]


def test_injected_unguarded_write_fails_cli(tmp_path):
    args = _scratch_package(tmp_path)
    assert main(args) == 0, "pristine scratch package should be clean"
    mod = tmp_path / "mfm_tpu_torch" / "serve" / "coalesce.py"
    mod.write_text(mod.read_text() + textwrap.dedent("""

        class _DrillPoker(Coalescer):
            def poke(self):
                self._oldest_t = None
    """))
    assert main(args) == 1
    res = run_sync([str(tmp_path / "mfm_tpu_torch")], root=str(tmp_path))
    assert any(v.rule == "S1" and v.qualname == "_DrillPoker.poke"
               for v in res.new)


def test_injected_lock_inversion_fails_cli(tmp_path):
    """Taking the coalescer's lock while holding the cache's reverses a
    real edge (Coalescer._emit -> ResponseCache.absorb), closing a cycle
    the CLI must refuse."""
    args = _scratch_package(tmp_path)
    mod = tmp_path / "mfm_tpu_torch" / "serve" / "cache.py"
    mod.write_text(mod.read_text() + textwrap.dedent("""

        class _DrillInverse(ResponseCache):
            def poke(self, co):
                with self._lock:
                    co.flush()
    """))
    assert main(args) == 1
    res = run_sync([str(tmp_path / "mfm_tpu_torch")], root=str(tmp_path))
    assert any(v.rule == "S2" and "cycle" in v.message for v in res.new)


def test_injected_device_work_under_the_admission_lock_fails_cli(tmp_path):
    """A request path that reaches torch under the coalescer's lock is S3
    (the request guard's MAD check runs in numpy for that reason)."""
    args = _scratch_package(tmp_path)
    mod = tmp_path / "mfm_tpu_torch" / "serve" / "coalesce.py"
    mod.write_text(mod.read_text() + textwrap.dedent("""

        import torch


        class _DrillDevice(Coalescer):
            def submit_checked(self, line):
                with self._lock:
                    return torch.tensor([len(line)]).sum()
    """))
    assert main(args) == 1
    res = run_sync([str(tmp_path / "mfm_tpu_torch")], root=str(tmp_path),
                   baseline=load_baseline(str(REPO / DEFAULT_BASELINE)))
    assert [(v.rule, v.qualname) for v in res.new] == [
        ("S3", "_DrillDevice.submit_checked")]


def test_the_tools_stay_out_of_the_pass(tmp_path):
    """``mfm_tpu_torch/tools`` (the reference's top-level ``tools/``) is
    left out by path, whatever the paths given."""
    _write(tmp_path, {"mfm_tpu_torch/tools/t.py": """
        import threading
        import time

        LOCK = threading.Lock()

        def bad_sleep():
            with LOCK:
                time.sleep(0.1)
    """})
    assert run_sync([str(tmp_path)], root=str(tmp_path)).new == []
