"""The port's serving fleet (``mfm_tpu_torch/serve/{coalesce,frontend,
replica,transport}.py``) on the CPU at float64: the counterpart of
``tests/test_fleet.py``, test for test, and the port held against the JAX
package on the same inputs.

Inside the port: coalesced mixed-type batches bitwise-equal to the
single-threaded loop, the linger/full/eof flush triggers, a steady state
that launches no kernel, the worker wire protocol (pipe AND TCP parity),
death re-dispatch + fence-audit quarantine + the merged-manifest delivery
audit, heartbeat-miss wedge detection before dispatch, rolling
zero-downtime rollouts, live /metrics and /healthz worker-shard merging,
the thread-safety hammers for the breaker and the metrics registry,
fsync-on-emit, the socket front end under concurrent clients, the trace
prologue and piggyback, flight-recorder dumps and the manifests' SLO
blocks.

Against the reference: ``run_worker`` over the same input text gives the
same frames in the same order (ids and outcomes equal, numbers within
rtol 1e-10, the tolerance of ``tests/test_torch_server.py``), and the two
packages' front ends and workers talk over the wire in both directions.
Every socket read and thread join carries a timeout.
"""

import io
import json
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

from mfm_tpu.obs import trace as ref_trace
from mfm_tpu.serve import QueryEngine as RefEngine
from mfm_tpu.serve import QueryServer as RefServer
from mfm_tpu.serve import ServePolicy as RefPolicy
from mfm_tpu.serve import replica as ref_replica
from mfm_tpu.serve import transport as ref_transport
from mfm_tpu_torch.obs import instrument as _obs
from mfm_tpu_torch.serve import (
    CircuitBreaker,
    Coalescer,
    FleetServer,
    QueryEngine,
    QueryServer,
    ReplicaDeadError,
    ReplicaWedgedError,
    ServePolicy,
    SocketFrontend,
)
from mfm_tpu_torch.serve.replica import (
    CONTROL_KEY,
    Replica,
    build_fleet_manifest,
    replica_env,
    run_worker,
)
from mfm_tpu_torch.serve.transport import serve_worker_socket

torch.set_num_threads(2)

K = 4
RTOL = 1e-10


def _engine(scale=1.0, ref=False):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((K, K)) / 2
    cov = (a @ a.T + 1e-3 * np.eye(K)) * 1e-4 * scale
    kw = {"factor_names": ["country", "ind0", "size", "mom"],
          "benchmarks": {"idx": rng.standard_normal(K)}}
    if ref:
        return RefEngine(cov, **kw)
    return QueryEngine(cov, device="cpu", **kw)


def _server(batch_max=64, ref=False, **kw):
    policy = (RefPolicy if ref else ServePolicy)(
        batch_max=batch_max, queue_max=4096, default_deadline_s=600.0)
    return (RefServer if ref else QueryServer)(
        _engine(ref=ref), policy, health="ok",
        scenarios={"stress": _engine(scale=1.44, ref=ref)}, **kw)


def _mixed_lines(n, seed=3):
    """Seeded mixed request stream: plain, benchmark, scenario-tagged and
    both construct solvers, ids m0..m{n-1}."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        req = {"id": f"m{i}",
               "weights": np.round(0.2 * rng.standard_normal(K), 6).tolist(),
               "deadline_s": 600.0}
        kind = i % 5
        if kind == 1:
            req["benchmark"] = "idx"
        elif kind == 2:
            req["scenario"] = "stress"
        elif kind == 3:
            req["construct"] = {"solver": "min_vol"}
        elif kind == 4:
            req["construct"] = {"solver": "risk_parity"}
        lines.append(json.dumps(req, sort_keys=True))
    return lines


def _sequential_by_id(lines, batch_max=64, ref=False):
    out = io.StringIO()
    _server(batch_max=batch_max, ref=ref).run(list(lines), out, gulp=True)
    return {json.loads(ln)["id"]: ln for ln in out.getvalue().splitlines()}


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


# -- coalescer: bitwise equality + triggers ----------------------------------

@pytest.mark.parametrize("batch_max", [4, 64])
def test_coalescer_mixed_bitwise_vs_sequential(batch_max):
    # batch_max=4 exercises repeated full-trigger flushes (several
    # bucket-8 rounds); 64 exercises one eof flush spanning buckets
    lines = _mixed_lines(22)
    ref = _sequential_by_id(lines, batch_max=batch_max)
    co = Coalescer(_server(batch_max=batch_max), linger_s=10.0)
    got = {}
    for i, ln in enumerate(lines):
        for origin, resp in co.submit(ln, origin=i):
            got[origin] = resp
    for origin, resp in co.stop():
        got[origin] = resp
    assert len(got) == len(lines)
    for i, ln in enumerate(lines):
        rid = json.loads(ln)["id"]
        assert json.dumps(got[i], sort_keys=True) == ref[rid], \
            f"coalesced response for {rid} diverges from sequential loop"


def test_coalescer_full_linger_eof_triggers():
    clk = Clock()
    co = Coalescer(_server(batch_max=4), linger_s=0.5, clock=clk)
    t0 = _obs.fleet_summary_from_registry()["coalesce_flushes"]
    # full: the 4th admitted request flushes immediately
    pairs = []
    for i, ln in enumerate(_mixed_lines(4, seed=5)):
        pairs += co.submit(ln, origin=i)
    assert len(pairs) == 4 and co.queued() == 0
    # linger: one queued request, poll is a no-op until the budget expires
    co.submit(_mixed_lines(1, seed=6)[0], origin=99)
    assert co.poll() == [] and co.queued() == 1
    assert co.next_deadline() == pytest.approx(clk.t + 0.5)
    clk.t += 0.6
    lingered = co.poll()
    assert [o for o, _ in lingered] == [99]
    # eof: stop drains the tail
    co.submit(_mixed_lines(1, seed=7)[0], origin=7)
    assert [o for o, _ in co.stop()] == [7]
    t1 = _obs.fleet_summary_from_registry()["coalesce_flushes"]

    def delta(trig):
        return t1.get(trig, 0) - t0.get(trig, 0)
    assert delta("full") == 1 and delta("linger") == 1 and delta("eof") == 1


def test_coalescer_steady_state_launches_no_kernel():
    """With the coalescer on, warmed (type, bucket) shapes stay steady:
    repeated same-shape flushes launch no CUDA kernel and load no kernel
    library, and each round answers bitwise as the sequential loop (read
    from the launch counts and the library loads directly; the port's
    compile counter, ``utils/contracts.assert_max_compiles``, holds the
    buckets in ``tests/test_torch_bucket_contracts.py``)."""
    from mfm_tpu_torch.ops import _build
    from mfm_tpu_torch.ops.eigh_cuda import launch_counts

    co = Coalescer(_server(batch_max=64), linger_s=10.0)
    lines = _mixed_lines(20, seed=11)   # all five kinds, buckets warmed
    for i, ln in enumerate(lines):
        co.submit(ln, origin=i)
    co.flush()
    before = (launch_counts(), _build.load.cache_info().currsize)
    for round_ in range(3):
        round_lines = _mixed_lines(20, seed=20 + round_)
        got = {}
        for i, ln in enumerate(round_lines):
            got.update(co.submit(ln, origin=i))
        got.update(co.flush())
        ref = _sequential_by_id(round_lines)
        assert len(got) == len(round_lines)
        for i, ln in enumerate(round_lines):
            assert json.dumps(got[i], sort_keys=True) \
                == ref[json.loads(ln)["id"]]
    assert (launch_counts(), _build.load.cache_info().currsize) == before
    co.stop()


# -- thread-safety hammers ----------------------------------------------------

def test_breaker_thread_hammer():
    """8 threads x 300 failures each: no lost increment — the breaker must
    be OPEN long before the end, and the final failure count is exact when
    kept below the threshold."""
    br = CircuitBreaker(failures=8 * 300, cooldown_s=1e9)
    n_threads, per = 8, 300

    def hammer():
        for _ in range(per - 1):
            br.record_failure()

    ts = [threading.Thread(target=hammer) for _ in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    # (per - 1) * n failures < threshold: every increment must have landed
    # and none may have tripped it early
    assert br.state == "closed"
    assert br._consecutive == n_threads * (per - 1)
    br.record_failure()
    for _ in range(n_threads - 1):
        br.record_failure()
    assert br.state == "open" and br.open_reason == "failures"


def test_metrics_registry_thread_hammer():
    """Concurrent counter bumps and histogram observes tally exactly."""
    before = _obs.fleet_summary_from_registry()
    n_threads, per = 8, 250

    def hammer(idx):
        for i in range(per):
            _obs.record_fleet_dispatch(idx % 2, 1)
            _obs.record_coalesce_flush(4, 8, "full", 0.001)

    ts = [threading.Thread(target=hammer, args=(i,))
          for i in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    after = _obs.fleet_summary_from_registry()
    assert after["dispatch_total"] - before["dispatch_total"] \
        == n_threads * per
    assert (after["coalesce_flushes_total"]
            - before["coalesce_flushes_total"]) == n_threads * per


# -- fsync on emit ------------------------------------------------------------

def test_fsync_emits_policy(tmp_path, monkeypatch):
    calls = []
    real_fsync = os.fsync

    def counting_fsync(fd):
        calls.append(fd)
        return real_fsync(fd)

    monkeypatch.setattr(os, "fsync", counting_fsync)
    lines = _mixed_lines(4, seed=9)
    out_path = tmp_path / "resp.jsonl"
    policy = ServePolicy(batch_max=4, queue_max=64,
                         default_deadline_s=600.0, fsync_emits=True)
    server = QueryServer(_engine(), policy, health="ok")
    with open(out_path, "w") as fh:
        server.run(list(lines), fh, gulp=True)
    assert calls, "fsync_emits=True must fsync the response stream"
    assert len(out_path.read_text().splitlines()) == 4
    # a non-file sink (StringIO raises UnsupportedOperation) is tolerated
    server2 = QueryServer(_engine(), policy, health="ok")
    buf = io.StringIO()
    server2.run(list(_mixed_lines(2, seed=10)), buf, gulp=True)
    assert len(buf.getvalue().splitlines()) == 2


# -- worker wire protocol -----------------------------------------------------

def test_run_worker_wire_protocol():
    """Envelopes carry per-batch ordinals, every flush ends with the
    sentinel, seq resets between batches, and an EOF without a final flush
    still answers the tail."""
    lines = _mixed_lines(7, seed=13)
    flush = json.dumps({CONTROL_KEY: "flush"})
    in_text = "\n".join(lines[:3] + [flush] + lines[3:5] + [flush]
                        + lines[5:]) + "\n"   # tail: EOF, no flush
    out = io.StringIO()
    summary = run_worker(_server(batch_max=8), io.StringIO(in_text), out)
    assert isinstance(summary, dict) and "requests_total" in summary
    envs = [json.loads(ln) for ln in out.getvalue().splitlines()]
    sentinels = [e for e in envs if e.get(CONTROL_KEY) == "flushed"]
    assert [s["n"] for s in sentinels] == [3, 2]
    resps = [e for e in envs if CONTROL_KEY not in e]
    assert [e["seq"] for e in resps] == [0, 1, 2, 0, 1, 0, 1]
    ref = _sequential_by_id(lines, batch_max=8)
    for env, ln in zip(resps, lines[:3] + lines[3:5] + lines[5:]):
        rid = json.loads(ln)["id"]
        assert json.dumps(env["resp"], sort_keys=True) == ref[rid]


def test_control_key_rejected_at_admission():
    """A request smuggling the reserved __fleet__ key dead-letters at
    admission (never forwarded to a worker), with the schema reason."""
    server = _server()
    spoof = json.dumps({"id": "evil", "weights": [0.1] * K,
                        "__fleet__": "flush"}, sort_keys=True)
    resps = server.submit_line(spoof)
    assert len(resps) == 1
    assert resps[0]["outcome"] == "dead_letter"
    assert resps[0]["id"] == "evil"
    assert "schema" in resps[0]["reasons"]
    assert not server._queue


def test_worker_control_frame_not_spoofable():
    """Only an object that is EXACTLY {__fleet__: ...} is a control frame:
    a request line carrying the key among other keys consumes its seq
    ordinal and answers dead_letter — no mid-batch flush, no ordinal
    shift, no cross-client response misrouting."""
    lines = _mixed_lines(2, seed=31)
    spoof = json.dumps({"__fleet__": "flush", "id": "evil",
                        "weights": [0.1] * K}, sort_keys=True)
    assert spoof.startswith('{"__fleet__"')   # worst case for the prefix scan
    flush = json.dumps({CONTROL_KEY: "flush"})
    in_text = "\n".join([lines[0], spoof, lines[1], flush]) + "\n"
    out = io.StringIO()
    run_worker(_server(batch_max=8), io.StringIO(in_text), out)
    envs = [json.loads(ln) for ln in out.getvalue().splitlines()]
    sentinels = [e for e in envs if e.get(CONTROL_KEY) == "flushed"]
    assert [s["n"] for s in sentinels] == [3]
    resps = {e["seq"]: e["resp"] for e in envs if CONTROL_KEY not in e}
    assert set(resps) == {0, 1, 2}
    assert resps[1]["outcome"] == "dead_letter"
    assert resps[0]["outcome"] == "ok" and resps[2]["outcome"] == "ok"
    ref = _sequential_by_id(lines, batch_max=8)
    for seq, ln in ((0, lines[0]), (2, lines[1])):
        rid = json.loads(ln)["id"]
        assert json.dumps(resps[seq], sort_keys=True) == ref[rid]


def test_hold_fence_worker_refences_only_on_reload_frame():
    """A --hold-fence worker (poll_on_flush=False) must not move its
    generation on flush, and MUST re-fence and report the NEW generation
    on the frontend's reload frame — if the reply carried the startup
    generation instead, _roll_fleet would treat it as disagreement and
    re-roll forever while the worker kept pricing the old engine."""
    pending = {"gen": None}
    polls = []

    def reload_fn():
        polls.append(1)
        if pending["gen"] is None:
            return None
        return {"generation": pending["gen"]}

    server = _server(batch_max=8, reload_fn=reload_fn)
    server.generation = 1
    flush = json.dumps({CONTROL_KEY: "flush"})
    reload_frame = json.dumps({CONTROL_KEY: "reload"})
    lines = _mixed_lines(2, seed=37)
    in_text = "\n".join([lines[0], flush, reload_frame,
                         lines[1], flush]) + "\n"
    pending["gen"] = 2
    out = io.StringIO()
    run_worker(server, io.StringIO(in_text), out, poll_on_flush=False)
    envs = [json.loads(ln) for ln in out.getvalue().splitlines()]
    reloaded = [e for e in envs if e.get(CONTROL_KEY) == "reloaded"]
    assert len(reloaded) == 1
    assert reloaded[0]["ok"] is True
    # the frame reply must carry the PENDING generation, not the startup
    # one: this is what the frontend's agreement check reads
    assert reloaded[0]["generation"] == 2
    assert server.generation == 2
    # flushes (two of them) and EOF never polled: ONLY the reload frame
    assert len(polls) == 1


# -- fleet dispatch: death, quarantine, outage, manifest ----------------------

class _StubProc:
    def __init__(self):
        self.rc = None

    def poll(self):
        return self.rc


class _StubReplica:
    """Duck-typed Replica: answers through a real in-process worker server
    (so responses stay bitwise-comparable), or fails on demand."""

    def __init__(self, idx, mode="ok"):
        self.idx = idx
        self.mode = mode
        self.quarantined = False
        self.delivered = {}
        self.proc = _StubProc()
        self._wserver = _server(batch_max=64)

    @property
    def alive(self):
        return not self.quarantined and self.proc.poll() is None

    def run_batch(self, lines):
        if self.mode == "dead":
            self.proc.rc = -9
            raise ReplicaDeadError(f"replica {self.idx}: EOF mid-batch")
        if self.mode == "fence":
            return {i: {"id": json.loads(ln)["id"], "ok": False,
                        "outcome": "rejected", "breaker": "fence_audit"}
                    for i, ln in enumerate(lines)}
        resps = {}
        for i, ln in enumerate(lines):
            for o, r in self._wserver.submit_line_routed(ln, origin=i):
                resps[o] = r
        while self._wserver._queue:
            for o, r in self._wserver.drain_routed():
                resps[o] = r
        return resps

    def close(self, timeout=None):
        if self.proc.rc is None:
            self.proc.rc = 0
        return self.proc.rc


def _fleet_run(replicas, n=8, batch_max=4):
    fleet = FleetServer(_server(batch_max=batch_max), replicas,
                        linger_s=10.0)
    lines = _mixed_lines(n, seed=17)
    got = {}
    for i, ln in enumerate(lines):
        for o, r in fleet.submit(ln, origin=i):
            got[o] = r
    for o, r in fleet.stop():
        got[o] = r
    return fleet, lines, got


def test_fleet_death_redispatch_bitwise(tmp_path):
    """A replica dying mid-batch loses nothing: its batch re-dispatches to
    a survivor and every response matches the single-process loop."""
    dead = _StubReplica(0, mode="dead")
    ok = _StubReplica(1)
    fleet, lines, got = _fleet_run([dead, ok])
    assert len(got) == len(lines)
    ref = _sequential_by_id(lines, batch_max=4)
    for i, ln in enumerate(lines):
        rid = json.loads(ln)["id"]
        assert json.dumps(got[i], sort_keys=True) == ref[rid]
    fleet.close_replicas()
    fm = build_fleet_manifest({}, fleet, str(tmp_path))
    assert fm["audit"]["consistent"]
    assert fm["audit"]["accepted_total"] == len(lines)
    by_idx = {r["replica"]: r for r in fm["replicas"]}
    assert by_idx[0]["lost"] and by_idx[0]["outcomes_total"] == 0
    assert by_idx[0]["manifest_shard"] is None
    assert by_idx[1]["outcomes_total"] == len(lines)


def test_fleet_quarantine_on_fence_audit(tmp_path):
    """An all-fence_audit batch quarantines the replica WITHOUT delivering
    the rejections; the batch re-dispatches to a healthy replica."""
    fenced = _StubReplica(0, mode="fence")
    ok = _StubReplica(1)
    fleet, lines, got = _fleet_run([fenced, ok])
    assert fenced.quarantined and not fenced.alive
    assert all(r.get("breaker") != "fence_audit" for r in got.values())
    assert len(got) == len(lines)
    fleet.close_replicas()
    fm = build_fleet_manifest({}, fleet, str(tmp_path))
    assert fm["audit"]["consistent"]
    by_idx = {r["replica"]: r for r in fm["replicas"]}
    assert by_idx[0]["quarantined"] and by_idx[0]["outcomes_total"] == 0


def test_fleet_no_healthy_replicas_local_error(tmp_path):
    dead = _StubReplica(0, mode="dead")
    fleet, lines, got = _fleet_run([dead], n=4)
    assert len(got) == 4
    for r in got.values():
        assert r["outcome"] == "error" and "no healthy replicas" in r["detail"]
    # locally-answered outage responses land in the frontend's own ledger,
    # so the delivery audit still balances (clients DID get responses)
    fleet.close_replicas()
    fm = build_fleet_manifest({}, fleet, str(tmp_path))
    assert fm["frontend_local"]["outcomes"] == {"error": 4}
    assert fm["audit"]["consistent"]
    assert fm["audit"]["frontend_local_total"] == 4
    assert fm["audit"]["delivered_total"] == 4


def test_fleet_frontend_enforces_deadline(tmp_path):
    """Time queued at the front end (linger + dispatch backlog) counts
    against deadline_s: a request whose budget expires before dispatch
    answers `deadline` locally — never shipped to a worker, which would
    re-stamp the deadline at its own enqueue time — and the audit
    balances across the replica + frontend-local ledgers."""
    clk = Clock()
    ok = _StubReplica(1)
    fleet = FleetServer(_server(clock=clk), [ok], linger_s=5.0, clock=clk)
    fleet.submit(json.dumps({"id": "d0", "weights": [0.1] * K,
                             "deadline_s": 1.0}), origin=0)
    fleet.submit(json.dumps({"id": "d1", "weights": [0.1] * K,
                             "deadline_s": 600.0}), origin=1)
    clk.t += 2.0   # linger past d0's budget, inside d1's
    got = {o: r for o, r in fleet.stop()}
    assert got[0]["outcome"] == "deadline"
    assert got[1]["outcome"] == "ok"
    assert fleet.local_delivered == {"deadline": 1}
    assert sum(ok.delivered.values()) == 1
    fleet.close_replicas()
    fm = build_fleet_manifest({}, fleet, str(tmp_path))
    assert fm["audit"]["consistent"]
    assert fm["audit"]["accepted_total"] == 2


def test_build_fleet_manifest_inconsistent_audit(tmp_path):
    """A delivery shortfall (responses lost between dispatch and
    delivery) must break the audit invariant the doctor checks."""
    ok = _StubReplica(1)
    fleet, lines, got = _fleet_run([ok], n=6)
    fleet.close_replicas()
    fleet.accepted_total += 1   # simulate a dropped response
    fm = build_fleet_manifest({}, fleet, str(tmp_path))
    assert not fm["audit"]["consistent"]
    assert fm["audit"]["replica_outcomes_sum"] == 6
    assert fm["audit"]["accepted_total"] == 7


def test_replica_env_chaos_targeting():
    base = {"MFM_CHAOS_KILL": "serve.after_batch",
            "MFM_CHAOS_KILL_MATCH": "batch1",
            "MFM_CHAOS_KILL_REPLICA": "1", "KEEP": "x"}
    victim = replica_env(1, base)
    clean = replica_env(0, base)
    assert victim["MFM_CHAOS_KILL"] == "serve.after_batch"
    assert "MFM_CHAOS_KILL" not in clean
    assert "MFM_CHAOS_KILL_MATCH" not in clean
    # the targeting var itself never reaches any worker
    assert "MFM_CHAOS_KILL_REPLICA" not in victim
    assert clean["KEEP"] == "x"


# -- socket front end ---------------------------------------------------------

def _client_roundtrip(addr, lines):
    """One raw JSONL client: send all lines, half-close, read to EOF."""
    with socket.create_connection(addr, timeout=30) as s:
        s.sendall(("\n".join(lines) + "\n").encode())
        s.shutdown(socket.SHUT_WR)
        buf = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
    return [json.loads(ln) for ln in buf.decode().splitlines()]


def test_socket_frontend_concurrent_clients():
    """3 concurrent connections: each reads exactly its own responses,
    coalesced across connections but routed by origin."""
    fe = SocketFrontend("127.0.0.1", 0)
    backend = Coalescer(_server(batch_max=64), linger_s=0.02,
                        deliver=fe.deliver)
    fe.backend = backend
    addr = fe.listen()
    fe.start()
    try:
        all_lines = _mixed_lines(12, seed=23)
        per_client = [all_lines[i::3] for i in range(3)]
        results = [None] * 3

        def go(ci):
            results[ci] = _client_roundtrip(addr, per_client[ci])

        ts = [threading.Thread(target=go, args=(ci,)) for ci in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        ref = _sequential_by_id(all_lines, batch_max=64)
        for ci in range(3):
            want_ids = [json.loads(ln)["id"] for ln in per_client[ci]]
            got = results[ci]
            assert got is not None and len(got) == len(want_ids)
            assert sorted(r["id"] for r in got) == sorted(want_ids)
            for r in got:
                assert json.dumps(r, sort_keys=True) == ref[r["id"]]
    finally:
        fe.stop()


def test_conn_delivery_never_blocks_on_slow_client(monkeypatch):
    """Delivery runs under the coalescer lock, so it must never block on
    a client socket: sends go through the per-connection outbox, and a
    client that stops reading overflows its outbox and is dropped —
    without ever stalling the delivering thread."""
    from mfm_tpu_torch.serve.frontend import _Conn

    monkeypatch.setattr(_Conn, "OUTBOX_MAX", 8)
    a, b = socket.socketpair()
    try:
        a.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 4096)
        conn = _Conn(a, 0)
        payload = "x" * 65536
        t0 = time.monotonic()
        results = [conn.send_line(payload) for _ in range(64)]
        elapsed = time.monotonic() - t0
        # enqueues are put_nowait: even with the peer never reading and
        # the writer thread wedged in sendall, no call blocked
        assert elapsed < 5.0
        assert results[0] and not results[-1]
        assert conn.closed
    finally:
        b.close()


def test_http_frontend_post_and_healthz():
    fe = SocketFrontend("127.0.0.1", 0, http=True)
    backend = Coalescer(_server(batch_max=64), linger_s=0.02,
                        deliver=fe.deliver)
    fe.backend = backend
    addr = fe.listen()
    fe.start()
    try:
        lines = _mixed_lines(3, seed=29)
        body = ("\n".join(lines) + "\n").encode()
        with socket.create_connection(addr, timeout=30) as s:
            s.sendall(b"POST / HTTP/1.1\r\nHost: x\r\n"
                      + f"Content-Length: {len(body)}\r\n".encode()
                      + b"Connection: close\r\n\r\n" + body)
            raw = b""
            while True:
                chunk = s.recv(65536)
                if not chunk:
                    break
                raw += chunk
        head, _, payload = raw.partition(b"\r\n\r\n")
        assert head.startswith(b"HTTP/1.1 200")
        resps = [json.loads(ln) for ln in payload.decode().splitlines()]
        assert [r["id"] for r in resps] \
            == [json.loads(ln)["id"] for ln in lines]
        with socket.create_connection(addr, timeout=30) as s:
            s.sendall(b"GET /healthz HTTP/1.1\r\nHost: x\r\n"
                      b"Connection: close\r\n\r\n")
            raw = b""
            while True:
                chunk = s.recv(65536)
                if not chunk:
                    break
                raw += chunk
        head, _, payload = raw.partition(b"\r\n\r\n")
        assert head.startswith(b"HTTP/1.1 200")
        assert "requests_total" in json.loads(payload.decode())
    finally:
        fe.stop()


def test_doctor_serve_accepts_fleet_manifest(tmp_path, capsys):
    """A fleet-only dir has no serve_manifest.json — the merged fleet
    manifest carries the front end's serve summary and doctor --serve must
    audit THAT instead of flagging the single-process file as missing."""
    from mfm_tpu_torch import cli
    from mfm_tpu_torch.data.artifacts import save_artifact
    from mfm_tpu_torch.obs.manifest import build_run_manifest, write_run_manifest
    from mfm_tpu_torch.serve.replica import FLEET_MANIFEST_NAME

    d = str(tmp_path)
    save_artifact(os.path.join(d, "x.npz"), {"a": np.zeros(2)})

    def rc(args):
        with pytest.raises(SystemExit) as exc:
            cli.main(["doctor", *args])
        return exc.value.code

    assert rc([d, "--serve"]) == 1        # nothing to audit at all
    ok = _StubReplica(0)
    fleet, lines, got = _fleet_run([ok], n=4)
    fleet.close_replicas()
    fm = build_fleet_manifest({}, fleet, d)
    serve_block = {"breaker_state": "closed", "breaker_open_total": 0,
                   "shed_total": 0, "shed_rate": 0.0,
                   "requests_total": fleet.accepted_total}
    write_run_manifest(
        os.path.join(d, FLEET_MANIFEST_NAME),
        build_run_manifest(backend="cpu",
                           health={"status": "ok", "checks": {}},
                           extra={"serve": serve_block, "fleet": fm,
                                  "trace_id": "a" * 32}))
    capsys.readouterr()
    assert rc([d, "--serve"]) == 0
    recs = {r["kind"]: r for r in
            json.loads(capsys.readouterr().out)["records"]}
    srec = recs["serve_manifest"]
    assert srec["status"] == "ok"
    assert srec["file"].endswith(FLEET_MANIFEST_NAME)
    assert srec["breaker_state"] == "closed"
    frec = recs["fleet_manifest"]
    assert frec["status"] == "ok" and frec["accepted_total"] == 4


# -- TCP transport: parity, heartbeat, rollout, live /metrics merge -----------

def test_tcp_replica_parity_with_pipe():
    """A worker reached over TCP is byte-for-byte the in-process loop:
    same wire protocol, same envelopes, and the live probes (ping,
    metrics scrape) answer between batches without disturbing parity."""
    addr_box, ready, summary_box = [], threading.Event(), []

    def announce(addr):
        addr_box.append(addr)
        ready.set()

    def worker():
        summary_box.append(
            serve_worker_socket(_server(batch_max=64), "127.0.0.1", 0,
                                announce=announce))

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    assert ready.wait(timeout=30)
    rep = Replica.connect(0, addr_box[0], io_timeout_s=30.0)
    lines = _mixed_lines(10, seed=31)
    ref = _sequential_by_id(lines)
    got = dict(rep.run_batch(lines[:6]))
    rep.ping(10.0)
    shard = rep.scrape(10.0)
    assert "summary" in shard and "metrics" in shard
    for seq, resp in rep.run_batch(lines[6:]).items():
        got[6 + seq] = resp
    assert len(got) == len(lines)
    for i, ln in enumerate(lines):
        rid = json.loads(ln)["id"]
        assert json.dumps(got[i], sort_keys=True) == ref[rid], \
            f"TCP response for {rid} diverges from the in-process loop"
    assert rep.close() is None     # TCP: the process belongs to its host
    t.join(timeout=30)
    # the summary reads the process-global registry (the in-process
    # reference run above counts too) — assert shape, not an absolute
    assert summary_box and summary_box[0]["requests_total"] >= len(lines)
    assert "breaker_state" in summary_box[0]
    tc = rep.transport_counters()
    assert tc["connect_attempts"] >= 1 and tc["heartbeat_misses"] == 0


class _WedgedStub(_StubReplica):
    """SIGSTOP stand-in: alive by every process-level check, silent on
    the wire — only a heartbeat ping can expose it."""

    def __init__(self, idx):
        super().__init__(idx)
        self.wedged = False
        self.heartbeat_misses = 0
        self.last_io_t = time.monotonic() - 60.0   # long idle: ping is due

    @property
    def alive(self):
        return (not self.quarantined and not self.wedged
                and self.proc.poll() is None)

    def ping(self, timeout_s=None):
        self.heartbeat_misses += 1
        self.wedged = True
        raise ReplicaWedgedError(f"replica {self.idx}: heartbeat miss")

    def run_batch(self, lines):
        raise AssertionError("a wedged replica must never see a batch")

    def transport_counters(self):
        return {"reconnects": 0, "heartbeat_misses": self.heartbeat_misses,
                "redispatches": 0, "send_timeouts": 0, "recv_timeouts": 0,
                "failure_phases": {}}


def test_fleet_heartbeat_miss_quarantines_before_dispatch(tmp_path):
    """A long-idle replica is pinged before it is trusted with a batch:
    the miss quarantines it PRE-dispatch (no batch lost, no redispatch),
    every response still matches the single-process loop, and the miss
    is on the manifest's books."""
    wedged = _WedgedStub(0)
    ok = _StubReplica(1)
    fleet = FleetServer(_server(batch_max=4), [wedged, ok], linger_s=10.0,
                        heartbeat_s=0.5, heartbeat_timeout_s=1.0)
    lines = _mixed_lines(8, seed=17)
    got = {}
    for i, ln in enumerate(lines):
        for o, r in fleet.submit(ln, origin=i):
            got[o] = r
    for o, r in fleet.stop():
        got[o] = r
    ref = _sequential_by_id(lines, batch_max=4)
    assert len(got) == len(lines)
    for i, ln in enumerate(lines):
        assert json.dumps(got[i], sort_keys=True) == ref[json.loads(ln)["id"]]
    assert wedged.wedged and not wedged.alive
    assert wedged.heartbeat_misses == 1   # one ping, never re-picked
    assert wedged.delivered == {}
    fleet.close_replicas()
    fm = build_fleet_manifest({}, fleet, str(tmp_path))
    by_idx = {r["replica"]: r for r in fm["replicas"]}
    assert by_idx[0]["wedged"] and by_idx[0]["outcomes_total"] == 0
    assert fm["transport"]["heartbeat_misses"] == 1
    assert fm["transport"]["redispatches"] == 0
    assert fm["audit"]["consistent"]


class _RollStub(_StubReplica):
    """Worker that re-fences only when told (``--hold-fence`` semantics):
    ``reload_worker`` adopts the pointed-at generation; every batch logs
    (replica, generation) into a shared timeline."""

    def __init__(self, idx, pointer, timeline, ok=True):
        super().__init__(idx)
        self._pointer = pointer
        self._timeline = timeline
        self._ok = ok
        self.generation = pointer[0]
        self.reloads = 0

    def run_batch(self, lines):
        self._timeline.append((self.idx, self.generation))
        return super().run_batch(lines)

    def reload_worker(self, timeout_s=None):
        self.reloads += 1
        if not self._ok:
            return {"ok": False, "generation": None}
        self.generation = self._pointer[0]
        return {"ok": True, "generation": self.generation}


def test_rollout_rolls_workers_without_dropping_requests():
    """The pointer flips mid-stream: the fleet rolls every worker between
    batches, zero requests are dropped, every response stays bitwise, and
    once any batch runs on the new generation no later batch anywhere in
    the fleet runs on the old one (no mixed-generation batches)."""
    pointer, timeline = ["gen-a"], []
    reps = [_RollStub(0, pointer, timeline), _RollStub(1, pointer, timeline)]
    fleet = FleetServer(_server(batch_max=4), reps, linger_s=10.0,
                        rollout_check=lambda: pointer[0])
    assert fleet._fleet_generation == "gen-a"
    lines = _mixed_lines(16, seed=17)
    got = {}
    for i, ln in enumerate(lines):
        if i == 8:
            pointer[0] = "gen-b"
        for o, r in fleet.submit(ln, origin=i):
            got[o] = r
    for o, r in fleet.stop():
        got[o] = r
    ref = _sequential_by_id(lines, batch_max=4)
    assert len(got) == len(lines)          # zero dropped across the roll
    for i, ln in enumerate(lines):
        assert json.dumps(got[i], sort_keys=True) == ref[json.loads(ln)["id"]]
    assert [r.reloads for r in reps] == [1, 1]
    assert fleet._fleet_generation == "gen-b"
    gens = [g for _, g in timeline]
    assert "gen-a" in gens and "gen-b" in gens
    first_b = gens.index("gen-b")
    assert all(g == "gen-b" for g in gens[first_b:])


def test_rollout_failed_fence_audit_quarantines_worker():
    """A worker whose new generation fails its fence audit is drained
    out of the rotation; the survivor finishes the roll, the fence still
    moves, and every request is answered bitwise."""
    pointer, timeline = ["gen-a"], []
    bad = _RollStub(0, pointer, timeline, ok=False)
    good = _RollStub(1, pointer, timeline)
    fleet = FleetServer(_server(batch_max=4), [bad, good], linger_s=10.0,
                        rollout_check=lambda: pointer[0])
    lines = _mixed_lines(12, seed=17)
    got = {}
    for i, ln in enumerate(lines):
        if i == 4:
            pointer[0] = "gen-b"
        for o, r in fleet.submit(ln, origin=i):
            got[o] = r
    for o, r in fleet.stop():
        got[o] = r
    ref = _sequential_by_id(lines, batch_max=4)
    assert len(got) == len(lines)
    for i, ln in enumerate(lines):
        assert json.dumps(got[i], sort_keys=True) == ref[json.loads(ln)["id"]]
    assert bad.quarantined and not bad.alive
    assert good.reloads == 1 and good.generation == "gen-b"
    assert fleet._fleet_generation == "gen-b"
    # after the roll the quarantined worker never saw another batch
    assert all(g == "gen-a" for ix, g in timeline if ix == 0)


def test_http_metrics_merges_live_worker_shards():
    """GET /metrics and /healthz on a fleet frontend carry one live
    entry per worker (scraped mid-run over the transport), not just the
    frontend's own registry."""
    ok = _StubReplica(0)
    ok.scrape = lambda timeout_s=None: {"summary": {"requests_total": 3},
                                        "metrics": {"fleet_probe": 1.0}}
    ok.transport_counters = lambda: {"reconnects": 0, "heartbeat_misses": 0,
                                     "redispatches": 0, "send_timeouts": 0,
                                     "recv_timeouts": 0, "failure_phases": {}}
    fe = SocketFrontend("127.0.0.1", 0, http=True)
    backend = FleetServer(_server(batch_max=64), [ok], linger_s=0.02,
                          deliver=fe.deliver)
    fe.backend = backend
    addr = fe.listen()
    fe.start()
    try:
        def get(path):
            with socket.create_connection(addr, timeout=30) as s:
                s.sendall(f"GET {path} HTTP/1.1\r\nHost: x\r\n"
                          "Connection: close\r\n\r\n".encode())
                raw = b""
                while True:
                    chunk = s.recv(65536)
                    if not chunk:
                        break
                    raw += chunk
            head, _, payload = raw.partition(b"\r\n\r\n")
            assert head.startswith(b"HTTP/1.1 200")
            return json.loads(payload.decode())

        snap = get("/metrics")
        (w0,) = snap["workers"]
        assert w0["replica"] == 0 and w0["alive"]
        assert w0["metrics"] == {"fleet_probe": 1.0}
        assert w0["transport"]["heartbeat_misses"] == 0
        hz = get("/healthz")
        (h0,) = hz["workers"]
        assert h0["summary"] == {"requests_total": 3}
        assert not h0["wedged"]
    finally:
        fe.stop()


# -- distributed tracing over the fleet wire ----------------------------------

def test_worker_trace_prologue_opens_child_spans_and_piggybacks():
    """The structured batch prologue consumes no seq ordinal; the worker
    opens worker.recv spans parented to the shipped frontend spans and a
    worker.batch span under the dispatch span, then ships them all back
    on the flushed reply — leaving its own ring empty and the response
    bytes untouched."""
    from mfm_tpu_torch.obs import trace as _trace
    from mfm_tpu_torch.serve.server import _line_trace_id

    _trace.reset_tracing()
    try:
        lines = _mixed_lines(2, seed=41)
        parents = [["11" * 16, "22" * 8], ["33" * 16, "44" * 8]]
        prologue = json.dumps({CONTROL_KEY: {"op": "batch", "trace": {
            "dispatch": ["fd" * 16, "55" * 8], "parents": parents}}},
            sort_keys=True)
        flush = json.dumps({CONTROL_KEY: "flush"})
        in_text = "\n".join([prologue] + lines + [flush]) + "\n"
        out = io.StringIO()
        run_worker(_server(batch_max=8), io.StringIO(in_text), out)
        envs = [json.loads(ln) for ln in out.getvalue().splitlines()]
        (sent,) = [e for e in envs if e.get(CONTROL_KEY) == "flushed"]
        assert sent["n"] == 2              # the prologue took no ordinal
        assert isinstance(sent["clock_us"], float)
        shipped = sent["spans"]
        recvs = [s for s in shipped if s["name"] == "worker.recv"]
        assert [(s["trace_id"], s["parent_id"], s["attrs"]["seq"])
                for s in recvs] == [("11" * 16, "22" * 8, 0),
                                    ("33" * 16, "44" * 8, 1)]
        (batch,) = [s for s in shipped if s["name"] == "worker.batch"]
        assert batch["trace_id"] == "fd" * 16
        assert batch["parent_id"] == "55" * 8
        assert batch["attrs"]["n"] == 2
        # the worker's own admission spans derive the SAME sha trace ids
        # the frontend derives, so the processes join without a lookup
        reqs = {s["trace_id"] for s in shipped
                if s["name"] == "serve.request"}
        assert reqs == {_line_trace_id(ln) for ln in lines}
        # spans ship exactly once: the worker ring is drained
        assert _trace.spans() == []
        resps = {e["seq"]: e["resp"] for e in envs if CONTROL_KEY not in e}
        ref = _sequential_by_id(lines, batch_max=8)
        for i, ln in enumerate(lines):
            rid = json.loads(ln)["id"]
            assert json.dumps(resps[i], sort_keys=True) == ref[rid], \
                f"traced response for {rid} diverges from sequential loop"
    finally:
        _trace.reset_tracing()


def test_worker_ignores_unknown_structured_control_op():
    """Forward compatibility: a structured control frame with an op this
    worker does not know is skipped — no crash, no ordinal shift."""
    lines = _mixed_lines(2, seed=43)
    mystery = json.dumps({CONTROL_KEY: {"op": "hologram", "x": 1}},
                         sort_keys=True)
    flush = json.dumps({CONTROL_KEY: "flush"})
    in_text = "\n".join([mystery] + lines + [flush]) + "\n"
    out = io.StringIO()
    run_worker(_server(batch_max=8), io.StringIO(in_text), out)
    envs = [json.loads(ln) for ln in out.getvalue().splitlines()]
    (sent,) = [e for e in envs if e.get(CONTROL_KEY) == "flushed"]
    assert sent["n"] == 2
    resps = {e["seq"]: e["resp"] for e in envs if CONTROL_KEY not in e}
    assert set(resps) == {0, 1}
    ref = _sequential_by_id(lines, batch_max=8)
    for i, ln in enumerate(lines):
        rid = json.loads(ln)["id"]
        assert json.dumps(resps[i], sort_keys=True) == ref[rid]


def test_piggyback_omits_spans_when_tracing_disabled():
    from mfm_tpu_torch.obs.trace import reset_tracing, set_tracing

    set_tracing(False)
    try:
        lines = _mixed_lines(2, seed=47)
        flush = json.dumps({CONTROL_KEY: "flush"})
        out = io.StringIO()
        run_worker(_server(batch_max=8),
                   io.StringIO("\n".join(lines + [flush]) + "\n"), out)
        envs = [json.loads(ln) for ln in out.getvalue().splitlines()]
        (sent,) = [e for e in envs if e.get(CONTROL_KEY) == "flushed"]
        assert "clock_us" in sent         # the clock probe always rides
        assert "spans" not in sent        # the span payload never does
    finally:
        reset_tracing()
        set_tracing(True)


def test_replica_clock_estimate_tightens_and_ingests_spans():
    """A loose batch-wall probe seeds the offset; a tight ping refines
    it; a later LOOSER probe must not clobber the tight estimate; spans
    shipped on a reply ingest shifted by the negated offset, stamped
    with the worker ordinal."""
    from mfm_tpu_torch.obs import trace as _trace

    _trace.reset_tracing()
    try:
        rep = Replica.__new__(Replica)
        rep.idx = 5
        rep._init_ledger()
        rep._absorb_reply_telemetry({"clock_us": 2_000_000.0}, 1.0, 1.2)
        assert rep.clock_offset_us == pytest.approx(900_000.0)
        assert rep.clock_uncertainty_us == pytest.approx(100_000.0)
        rep._absorb_reply_telemetry({"clock_us": 1_951_000.0}, 1.0, 1.002)
        assert rep.clock_offset_us == pytest.approx(950_000.0)
        assert rep.clock_uncertainty_us == pytest.approx(1_000.0)
        rep._absorb_reply_telemetry({"clock_us": 3_000_000.0}, 1.0, 1.5)
        assert rep.clock_uncertainty_us == pytest.approx(1_000.0)
        rep._absorb_reply_telemetry(
            {"clock_us": 1_951_000.0, "spans": [
                {"name": "worker.batch", "trace_id": "ab" * 16,
                 "span_id": "cd" * 8, "parent_id": None,
                 "start_us": 1_951_000.0, "dur_us": 500.0,
                 "wall_ts": 1.0, "tid": 1, "attrs": {}}]},
            1.0, 1.002)
        (sp,) = [s for s in _trace.spans() if s.name == "worker.batch"]
        assert sp.start_us == pytest.approx(1_001_000.0)
        assert sp.attrs["worker"] == 5
        assert "clock_skew" not in sp.attrs
    finally:
        _trace.reset_tracing()


def test_fleet_dispatch_spans_and_stub_replicas_get_plain_lines():
    """The dispatcher opens a fleet.dispatch span per attempt, keyed by
    the batch head's sha-derived trace id — and a replica without the
    accepts_trace_frames capability (every duck-typed stub) receives the
    batch WITHOUT a prologue, so its responses stay bitwise."""
    from mfm_tpu_torch.obs import trace as _trace
    from mfm_tpu_torch.serve.server import _line_trace_id

    _trace.reset_tracing()
    try:
        ok = _StubReplica(0)
        fleet, lines, got = _fleet_run([ok], n=6)
        assert len(got) == len(lines)
        dsp = [s for s in _trace.spans() if s.name == "fleet.dispatch"]
        assert dsp, "dispatch opened no spans with tracing on"
        tids = {_line_trace_id(ln) for ln in lines}
        for s in dsp:
            assert s.attrs["outcome"] == "ok"
            assert s.attrs["replica"] == 0
            assert s.trace_id in tids
        ref = _sequential_by_id(lines, batch_max=4)
        for i, ln in enumerate(lines):
            rid = json.loads(ln)["id"]
            assert json.dumps(got[i], sort_keys=True) == ref[rid]
    finally:
        _trace.reset_tracing()


# -- flight recorder + SLO wiring through the fleet ---------------------------

class _WedgeOnceStub(_StubReplica):
    """Wedges (transport deadline) on its first batch, then is drained."""

    def __init__(self, idx):
        super().__init__(idx)
        self.wedged = False

    def run_batch(self, lines):
        if not self.wedged:
            self.wedged = True
            self.quarantined = True
            raise ReplicaWedgedError(f"replica {self.idx}: silent mid-batch")
        return super().run_batch(lines)


def test_wedge_quarantine_triggers_flightrec_dump(tmp_path):
    """An armed recorder dumps on wedge quarantine: the postmortem
    carries the triggering batch head's trace id, the dispatch history
    and the live replica ledgers — and the survivors still answer
    everything bitwise."""
    from mfm_tpu_torch.obs import flightrec as frec
    from mfm_tpu_torch.serve.server import _line_trace_id

    frec.reset_flightrec()
    path = str(tmp_path / "flightrec.json")
    frec.arm(path)
    try:
        wedgy = _WedgeOnceStub(0)
        ok = _StubReplica(1)
        fleet, lines, got = _fleet_run([wedgy, ok])
        assert len(got) == len(lines)
        rec = frec.read_flightrec(path)
        assert rec["trigger"] == "wedge_quarantine"
        assert rec["trace_id"] in {_line_trace_id(ln) for ln in lines}
        kinds = [e["kind"] for e in rec["events"]]
        assert "wedge_quarantine" in kinds and "dispatch" in kinds
        byidx = {r["replica"]: r for r in rec["state"]["replicas"]}
        assert byidx[0]["wedged"] or byidx[0]["quarantined"]
        ref = _sequential_by_id(lines, batch_max=4)
        for i, ln in enumerate(lines):
            rid = json.loads(ln)["id"]
            assert json.dumps(got[i], sort_keys=True) == ref[rid]
    finally:
        frec.reset_flightrec()


def test_fleet_manifest_carries_slo_and_flightrec_blocks(tmp_path):
    from mfm_tpu_torch.obs import flightrec as frec
    from mfm_tpu_torch.obs import slo as slo_mod

    frec.reset_flightrec()
    slo_mod.install(slo_mod.SloEngine())
    try:
        frec.arm(str(tmp_path / "flightrec.json"))
        frec.record_event("dispatch", replica=0)
        ok = _StubReplica(0)
        fleet, lines, got = _fleet_run([ok], n=4)
        fleet.close_replicas()
        fm = build_fleet_manifest(_obs.serve_summary_from_registry(),
                                  fleet, str(tmp_path))
        assert fm["flightrec"]["armed"] is True
        assert fm["flightrec"]["events"] >= 1
        assert fm["slo"] is not None and fm["slo"]["schema"] == 1
        assert fm["slo"]["worst_state"] in ("ok", "slow_burn", "fast_burn")
    finally:
        slo_mod.reset_slo()
        frec.reset_flightrec()


def test_doctor_serve_fails_on_fast_burning_slo(tmp_path, capsys):
    """A fast-burn state persisted in the shutdown manifest is a missed
    page: doctor --serve must FAIL, naming the burning objective."""
    from mfm_tpu_torch import cli
    from mfm_tpu_torch.data.artifacts import save_artifact
    from mfm_tpu_torch.obs.manifest import build_run_manifest, write_run_manifest
    from mfm_tpu_torch.serve.replica import FLEET_MANIFEST_NAME

    d = str(tmp_path)
    save_artifact(os.path.join(d, "x.npz"), {"a": np.zeros(2)})
    ok = _StubReplica(0)
    fleet, lines, got = _fleet_run([ok], n=4)
    fleet.close_replicas()
    fm = build_fleet_manifest({}, fleet, d)
    slo_block = {"schema": 1, "window_fast_s": 300.0,
                 "window_slow_s": 3600.0, "fast_burn_threshold": 14.4,
                 "slow_burn_threshold": 3.0, "worst_state": "fast_burn",
                 "slos": [{"name": "availability", "kind": "availability",
                           "objective": 0.99, "budget": 0.01,
                           "burn_fast": 50.0, "burn_slow": 5.0,
                           "state": "fast_burn"}]}
    serve_block = {"breaker_state": "closed", "breaker_open_total": 0,
                   "shed_total": 0, "shed_rate": 0.0,
                   "requests_total": fleet.accepted_total,
                   "slo": slo_block}
    write_run_manifest(
        os.path.join(d, FLEET_MANIFEST_NAME),
        build_run_manifest(backend="cpu",
                           health={"status": "ok", "checks": {}},
                           extra={"serve": serve_block, "fleet": fm,
                                  "trace_id": "a" * 32}))
    capsys.readouterr()
    with pytest.raises(SystemExit) as exc:
        cli.main(["doctor", d, "--serve"])
    assert exc.value.code == 1
    recs = {r["kind"]: r for r in
            json.loads(capsys.readouterr().out)["records"]}
    srec = recs["serve_manifest"]
    assert srec["status"] == "unhealthy"
    assert srec["slo_worst_state"] == "fast_burn"
    assert any("FAST-BURNING" in p for p in srec["problems"])


def test_doctor_surfaces_and_validates_flightrec_dumps(tmp_path, capsys):
    """A parseable dump beside the artifacts is a warning (the run hit a
    postmortem trigger); a torn one is a doctor FAILURE."""
    from mfm_tpu_torch import cli
    from mfm_tpu_torch.data.artifacts import save_artifact
    from mfm_tpu_torch.obs import flightrec as frec
    from mfm_tpu_torch.obs.manifest import build_run_manifest, write_run_manifest
    from mfm_tpu_torch.serve.replica import FLEET_MANIFEST_NAME

    d = str(tmp_path)
    save_artifact(os.path.join(d, "x.npz"), {"a": np.zeros(2)})
    ok = _StubReplica(0)
    fleet, lines, got = _fleet_run([ok], n=4)
    fleet.close_replicas()
    fm = build_fleet_manifest({}, fleet, d)
    serve_block = {"breaker_state": "closed", "breaker_open_total": 0,
                   "shed_total": 0, "shed_rate": 0.0,
                   "requests_total": fleet.accepted_total}
    write_run_manifest(
        os.path.join(d, FLEET_MANIFEST_NAME),
        build_run_manifest(backend="cpu",
                           health={"status": "ok", "checks": {}},
                           extra={"serve": serve_block, "fleet": fm,
                                  "trace_id": "a" * 32}))
    frec.reset_flightrec()
    frec.record_event("breaker_open", trace_id="ab" * 16)
    fr_path = os.path.join(d, frec.FLIGHTREC_NAME)
    frec.dump_flightrec(fr_path, trigger="breaker_open")
    frec.reset_flightrec()

    def rc(args):
        with pytest.raises(SystemExit) as exc:
            cli.main(["doctor", *args])
        return exc.value.code

    capsys.readouterr()
    assert rc([d, "--serve"]) == 0        # a valid dump only warns
    recs = {r["kind"]: r for r in
            json.loads(capsys.readouterr().out)["records"]}
    frrec = recs["flightrec"]
    assert frrec["trigger"] == "breaker_open"
    assert frrec["trace_id"] == "ab" * 16
    assert any("postmortem trigger" in w for w in frrec["warnings"])
    with open(fr_path, encoding="utf-8") as fh:
        text = fh.read()
    with open(fr_path, "w", encoding="utf-8") as fh:
        fh.write(text[: len(text) // 2])  # tear it
    capsys.readouterr()
    assert rc([d, "--serve"]) == 1
    recs = {r["kind"]: r for r in
            json.loads(capsys.readouterr().out)["records"]}
    assert recs["flightrec"]["status"] == "corrupt"


def test_metrics_diff_accepts_fleet_manifests(tmp_path, capsys):
    """`metrics diff` takes merged fleet manifests on either side
    and reports per-replica shard deltas, not just merged totals."""
    import copy

    from mfm_tpu_torch import cli

    ok = _StubReplica(0)
    fleet, lines, got = _fleet_run([ok], n=4)
    fleet.close_replicas()
    fm_a = build_fleet_manifest({}, fleet, str(tmp_path))
    fm_b = copy.deepcopy(fm_a)
    fm_b["accepted_total"] += 2
    fm_b["replicas"][0]["outcomes"]["ok"] = \
        fm_b["replicas"][0]["outcomes"].get("ok", 0) + 2
    fm_b["replicas"][0]["outcomes_total"] += 2
    a_path, b_path = str(tmp_path / "fa.json"), str(tmp_path / "fb.json")
    for p, fmx in ((a_path, fm_a), (b_path, fm_b)):
        with open(p, "w", encoding="utf-8") as fh:
            json.dump(fmx, fh)
    capsys.readouterr()
    try:
        cli.main(["metrics", "diff", a_path, b_path])
    except SystemExit as exc:
        assert exc.code in (0, None)
    out = json.loads(capsys.readouterr().out)
    series = out["series"]
    assert series["fleet:accepted_total"]["delta"] == 2
    assert series["r0:outcomes:ok"]["delta"] == 2
    assert series["r0:outcomes_total"]["delta"] == 2


def test_fleet_cache_coherent_across_replicas():
    """The cache sits in the front end, so which replica computed a miss
    is invisible: a repeat round over a 2-replica fleet is all hits and
    every response matches the single-process no-cache loop per id (the
    counterpart of ``tests/test_response_cache.py``'s)."""
    from mfm_tpu_torch.serve import ResponseCache

    def line(i, body_seed):
        rng = np.random.default_rng(body_seed)
        return json.dumps({"id": f"c{i}", "weights": np.round(
            0.2 * rng.standard_normal(K), 6).tolist(), "deadline_s": 600.0},
            sort_keys=True)

    cache = ResponseCache(64, 1 << 20)
    fleet = FleetServer(_server(batch_max=4),
                        [_StubReplica(0), _StubReplica(1)],
                        linger_s=10.0, cache=cache)
    round1 = [line(i, 500 + i) for i in range(8)]
    round2 = [line(100 + i, 500 + i) for i in range(8)]
    got = {}
    for i, ln in enumerate(round1):
        for _, r in fleet.submit(ln, origin=i):
            got[r["id"]] = r
    for _, r in fleet.flush():
        got[r["id"]] = r
    for i, ln in enumerate(round2):
        for _, r in fleet.submit(ln, origin=100 + i):
            got[r["id"]] = r
    for _, r in fleet.stop():
        got[r["id"]] = r
    fleet.close_replicas()
    assert cache.stats()["hits"] == 8

    out = io.StringIO()
    _server(batch_max=4).run(round1 + round2, out, gulp=True)
    ref = {json.loads(ln)["id"]: ln for ln in out.getvalue().splitlines()}
    assert set(got) == set(ref)
    for rid, r in got.items():
        assert json.dumps(r, sort_keys=True) == ref[rid]


# -- the port against the reference -------------------------------------------

def _hold_value(got, want, what):
    if isinstance(want, float) and isinstance(got, float):
        assert got == pytest.approx(want, rel=RTOL, abs=1e-300), what
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _hold_value(g, w, f"{what}[{i}]")
    elif isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), what
        for k in want:
            _hold_value(got[k], want[k], f"{what}.{k}")
    else:
        assert type(got) is type(want) and got == want, what


def _hold_response(got, want, what):
    """:func:`_hold_value`, but a construct answer's ``diag`` (the KKT
    residual, the contributions' spread: residuals near rounding) is held
    to 1e-12 absolute, as ``tests/test_torch_server.py`` holds it."""
    if "diag" in want:
        assert got["diag"] == pytest.approx(want["diag"], rel=1e-6,
                                            abs=1e-12), what
        got = dict(got, diag=want["diag"])
    _hold_value(got, want, what)


def _hold_frames(got_text, want_text):
    """Frame by frame: envelopes with the same seq and responses held by
    :func:`_hold_response`; control frames with the same keys and values
    but for ``clock_us`` and the shipped spans' values (their names and
    count must agree)."""
    got = [json.loads(ln) for ln in got_text.splitlines()]
    want = [json.loads(ln) for ln in want_text.splitlines()]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w), (i, g, w)
        if CONTROL_KEY not in w:
            assert g["seq"] == w["seq"]
            _hold_response(g["resp"], w["resp"], f"frame {i}")
            continue
        for k in w:
            if k == "clock_us":
                assert isinstance(g[k], float)
            elif k == "spans":
                assert [s["name"] for s in g[k]] \
                    == [s["name"] for s in w[k]], i
            else:
                assert g[k] == w[k], (i, k)


@pytest.mark.parametrize("tracing", [True, False])
def test_run_worker_frames_are_the_reference(tracing):
    """The same input text — a trace prologue, two flushed batches with
    probes between them and an unflushed tail — through the port's and the
    reference's ``run_worker``, each with its own float64 CPU server:
    the same frames in the same order."""
    lines = _mixed_lines(9, seed=53)
    flush = json.dumps({CONTROL_KEY: "flush"})
    prologue = json.dumps({CONTROL_KEY: {"op": "batch", "trace": {
        "dispatch": ["fd" * 16, "55" * 8],
        "parents": [["11" * 16, "22" * 8], ["33" * 16, "44" * 8]]}}},
        sort_keys=True)
    probes = [json.dumps({CONTROL_KEY: k}) for k in ("ping", "reload")]
    in_text = "\n".join([prologue] + lines[:4] + [flush] + probes
                        + lines[4:7] + [flush] + lines[7:]) + "\n"
    outs = []
    for mod, trace_mod, ref in ((None, None, False),
                                (ref_replica, ref_trace, True)):
        from mfm_tpu_torch.obs import trace as port_trace
        tr = trace_mod or port_trace
        tr.reset_tracing()
        tr.set_tracing(tracing)
        try:
            out = io.StringIO()
            (mod.run_worker if mod else run_worker)(
                _server(batch_max=8, ref=ref), io.StringIO(in_text), out)
            outs.append(out.getvalue())
        finally:
            tr.reset_tracing()
            tr.set_tracing(True)
    _hold_frames(*outs)
    sent = [json.loads(ln) for ln in outs[0].splitlines()
            if CONTROL_KEY in json.loads(ln)]
    assert [f[CONTROL_KEY] for f in sent] \
        == ["flushed", "pong", "reloaded", "flushed"]
    assert all(("spans" in f) == tracing for f in sent
               if f[CONTROL_KEY] == "flushed")


@pytest.mark.parametrize("front", ["port", "reference"])
def test_cross_package_wire(front):
    """The port's front end drives a reference ``serve_worker_socket``
    worker over TCP, and the reference's drives the port's: the traced
    fleet dispatch, a heartbeat and a live scrape between batches, every
    response byte for byte the worker package's own sequential loop, and
    the worker's spans merged into the front end's ring."""
    from mfm_tpu_torch.obs import trace as port_trace
    from mfm_tpu_torch.serve import replica as port_replica

    worker_is_ref = front == "port"
    worker_sock = (ref_transport.serve_worker_socket if worker_is_ref
                   else serve_worker_socket)
    front_mod = port_replica if front == "port" else ref_replica
    front_trace = port_trace if front == "port" else ref_trace
    addr_box, ready, summary_box = [], threading.Event(), []

    def announce(addr):
        addr_box.append(addr)
        ready.set()

    def worker():
        summary_box.append(worker_sock(
            _server(batch_max=64, ref=worker_is_ref), "127.0.0.1", 0,
            announce=announce))

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    assert ready.wait(timeout=30)
    front_trace.reset_tracing()
    try:
        rep = front_mod.Replica.connect(0, addr_box[0], io_timeout_s=30.0)
        fleet = front_mod.FleetServer(
            _server(batch_max=4, ref=front != "port"), [rep],
            linger_s=10.0)
        lines = _mixed_lines(10, seed=59)
        got = {}
        for i, ln in enumerate(lines[:6]):
            got.update(fleet.submit(ln, origin=i))
        got.update(fleet.flush())
        rep.ping(10.0)
        shard = rep.scrape(10.0)
        assert shard[CONTROL_KEY] == "metrics"
        assert "requests_total" in shard["summary"]
        for i, ln in enumerate(lines[6:], start=6):
            got.update(fleet.submit(ln, origin=i))
        got.update(fleet.stop())
        merged = [s for s in front_trace.spans() if "worker" in s.attrs]
        assert {s.name for s in merged} >= {"worker.batch", "worker.recv"}
    finally:
        front_trace.reset_tracing()
    assert rep.close() is None
    t.join(timeout=30)
    assert not t.is_alive() and summary_box
    ref = _sequential_by_id(lines, ref=worker_is_ref)
    assert len(got) == len(lines)
    for i, ln in enumerate(lines):
        assert json.dumps(got[i], sort_keys=True) \
            == ref[json.loads(ln)["id"]], i
    tc = rep.transport_counters()
    assert tc["heartbeat_misses"] == 0 and tc["redispatches"] == 0


@pytest.mark.parametrize("kw", [{}, {"exponential": True},
                                {"exponential": True, "jitter": 0.5,
                                 "seed": 3, "max_backoff_s": 0.15}])
def test_with_retry_is_the_reference(kw):
    """The retry schedule, its telemetry-free result and the history
    stamped on the exhausted error are the reference's."""
    from mfm_tpu.data.etl import with_retry as ref_with_retry
    from mfm_tpu_torch.data.etl import with_retry

    runs = []
    for fn in (with_retry, ref_with_retry):
        slept, calls = [], []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("down")
            return "up"

        assert fn(flaky, attempts=4, backoff_s=0.1, sleep=slept.append,
                  retryable=(OSError,), **kw) == "up"

        def dead():
            raise OSError("gone")

        with pytest.raises(OSError) as exc:
            fn(dead, attempts=3, backoff_s=0.1, sleep=slept.append,
               retryable=(OSError,), phase="connect", **kw)
        with pytest.raises(TypeError):
            fn(lambda: 1 + "x", attempts=3, sleep=slept.append,
               retryable=(OSError,))
        runs.append((slept, exc.value.attempts, exc.value.total_backoff_s,
                     exc.value.phase))
    assert runs[0] == runs[1]


def test_connect_exhaustion_is_stamped_as_the_reference():
    """Dialing a port nobody listens on exhausts the retries with the
    last OSError stamped ``phase="connect"`` and its history, in both
    packages."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]      # closed again: nothing listens
    got = []
    for mod in (Replica, ref_replica.Replica):
        slept = []
        with pytest.raises(OSError) as exc:
            mod.connect(0, ("127.0.0.1", port), io_timeout_s=5.0,
                        attempts=3, backoff_s=0.01, sleep=slept.append)
        got.append((exc.value.phase, exc.value.attempts, slept))
    assert got[0] == got[1] == ("connect", 3, [0.01, 0.02])
