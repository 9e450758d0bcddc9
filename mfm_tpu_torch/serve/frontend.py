"""Async socket (and optional HTTP/1.1) front end for the query service
(counterpart of ``mfm_tpu/serve/frontend.py``).

Replaces the single-reader stdin pipe with a listener that accepts
CONCURRENT connections, each feeding the same thread-safe coalescing
backend (:class:`~mfm_tpu_torch.serve.coalesce.Coalescer` locally, or
:class:`~mfm_tpu_torch.serve.replica.FleetServer` with ``--replicas N``).  Every
existing per-request semantic survives unchanged because admission still
runs through ``QueryServer.submit_line_routed``: guards and dead-letter
quarantine, per-request deadlines, shed-oldest backpressure (a shed
notice routes to the DISPLACED request's connection, which may not be the
one that triggered it) and the circuit breaker.

Raw socket protocol (the default): JSONL both ways.  A client writes one
request per line and reads one response line per request — every
submitted line produces exactly one response eventually (immediate
reject/dead-letter/shed, or a drained answer within the linger budget),
so a client that sent N lines reads exactly N lines.  Half-closing the
write side says "no more requests"; the front end finishes delivering the
tail, then closes.

HTTP/1.1 mode (``--http``): ``POST /`` with a JSONL body (one or many
request lines) answers ``200`` with a JSONL body of the matching
responses, in submission order.  ``GET /healthz`` returns the live serve
summary; ``GET /metrics`` returns the registry snapshot JSON.

Threads: one acceptor + one reader thread per connection + one WRITER
thread per connection + the backend's linger flusher.  Delivery (which
the coalescer invokes under its lock) never touches a socket: it only
enqueues onto the connection's outbox, and the writer thread does the
blocking sends — a client that stops reading stalls (and eventually
drops) only its own connection, never admission or dispatch for the
fleet.  Backend access serializes under the coalescer lock.  This is
deliberately NOT an event loop — connection counts here are bounded by
the replica fan-in, and blocking reads keep the deadline/backpressure
story identical to the pipe loop.
"""

from __future__ import annotations

import json
import queue
import socket
import threading

from mfm_tpu_torch.obs import instrument as _obs


class _Conn:
    """One client connection: the routing origin for its requests.

    All socket writes go through :attr:`outbox`, drained by a dedicated
    writer thread, so the backend's delivery callback (which runs under
    the coalescer lock) never blocks on a slow client.  A client whose
    outbox fills (it stopped reading) is dropped — its responses were
    already tallied; stalling the whole fleet for it is never an option."""

    #: queued-writes bound per connection; overflow drops the connection
    OUTBOX_MAX = 4096
    _CLOSE = object()   # outbox sentinel: drain queued writes, then close

    __slots__ = ("sock", "outbox", "writer", "outstanding", "eof",
                 "closed", "cid")

    def __init__(self, sock, cid: int):
        self.sock = sock
        self.outbox: queue.Queue = queue.Queue(maxsize=self.OUTBOX_MAX)
        self.outstanding = 0   # guarded by the frontend's _lock
        self.eof = False
        self.closed = False
        self.cid = cid
        self.writer = threading.Thread(target=self._write_loop,
                                       daemon=True,
                                       name=f"mfm-frontend-write{cid}")
        self.writer.start()

    def send_line(self, text: str) -> bool:
        return self.send_bytes((text + "\n").encode("utf-8"))

    def send_bytes(self, data: bytes) -> bool:
        """Enqueue one write — never blocks.  A full outbox means the
        client stopped reading: drop it."""
        if self.closed:
            return False
        try:
            self.outbox.put_nowait(data)
            return True
        except queue.Full:
            self._abort()
            return False

    def close(self) -> None:
        """Close AFTER the writer drains everything already queued (a
        direct socket close would lose delivered-but-unsent responses)."""
        try:
            self.outbox.put_nowait(self._CLOSE)
        except queue.Full:
            self._abort()

    def _abort(self) -> None:
        self.closed = True
        try:
            self.sock.close()
        except OSError:
            pass

    def _write_loop(self) -> None:
        while True:
            item = self.outbox.get()
            if item is self._CLOSE:
                break
            if self.closed:
                continue   # discard until the close sentinel arrives
            try:
                self.sock.sendall(item)
            except OSError:
                self.closed = True
        self._abort()


class _HttpPending:
    """Origin for one HTTP POST: collects its responses, in order."""

    __slots__ = ("expected", "got", "done")

    def __init__(self, expected: int):
        self.expected = expected
        self.got: list = []
        self.done = threading.Event()

    def deliver(self, resp: dict) -> None:
        self.got.append(resp)
        if len(self.got) >= self.expected:
            self.done.set()


class SocketFrontend:
    """The listener.  Wire a backend whose ``deliver`` is
    :meth:`deliver`, then :meth:`serve` (blocking) or :meth:`start`.

    Args:
      host/port: bind address (port 0 = ephemeral; :attr:`address` has
        the bound port once listening).
      http: speak HTTP/1.1 instead of raw JSONL.
      deadline_wait_s: HTTP-mode cap on waiting for a batch to flush.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 http: bool = False, deadline_wait_s: float = 30.0):
        self.host, self.port = host, int(port)
        self.http = bool(http)
        self.deadline_wait_s = float(deadline_wait_s)
        self.backend = None
        self._lsock: socket.socket | None = None
        self._lock = threading.Lock()
        self._conns: set[_Conn] = set()
        self._threads: list[threading.Thread] = []
        self._next_cid = 0
        self._stopping = False
        self.address: tuple[str, int] | None = None

    # -- delivery (the backend's `deliver` callback) -------------------------
    def deliver(self, pairs) -> None:
        """Route ``(origin, resp)`` pairs back to their connections.
        Responses for dead/unknown origins are dropped — the client hung
        up; the outcome counters already tallied the work."""
        for origin, resp in pairs:
            if isinstance(origin, _HttpPending):
                origin.deliver(resp)
                continue
            if not isinstance(origin, _Conn):
                continue
            origin.send_line(json.dumps(resp, sort_keys=True))
            with self._lock:
                origin.outstanding -= 1
                finished = origin.eof and origin.outstanding <= 0
            if finished:
                origin.close()

    # -- lifecycle -----------------------------------------------------------
    def listen(self) -> tuple[str, int]:
        ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        ls.bind((self.host, self.port))
        ls.listen(64)
        self._lsock = ls
        self.address = ls.getsockname()[:2]
        return self.address

    def serve(self, backend) -> None:
        """Accept loop (blocking until :meth:`stop`).  ``backend`` must
        have been constructed with ``deliver=self.deliver``."""
        self.backend = backend
        if self._lsock is None:
            self.listen()
        backend.start()
        try:
            while not self._stopping:
                try:
                    csock, _addr = self._lsock.accept()
                except OSError:
                    break   # listener closed by stop()
                _obs.record_frontend_connection()
                with self._lock:
                    conn = _Conn(csock, self._next_cid)
                    self._next_cid += 1
                    self._conns.add(conn)
                t = threading.Thread(
                    target=(self._http_reader if self.http
                            else self._jsonl_reader),
                    args=(conn,), daemon=True,
                    name=f"mfm-frontend-conn{conn.cid}")
                t.start()
                self._threads.append(t)
        finally:
            self._drain_and_close()

    def start(self) -> threading.Thread:
        """:meth:`serve` on a daemon thread (tests / embedded use)."""
        if self._lsock is None:
            self.listen()
        backend = self.backend
        t = threading.Thread(target=self.serve, args=(backend,),
                             daemon=True, name="mfm-frontend-accept")
        t.start()
        return t

    def stop(self) -> None:
        self._stopping = True
        if self._lsock is not None:
            try:
                # close() alone leaves a blocked accept() waiting on Linux;
                # shutdown() wakes it
                self._lsock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._lsock.close()
            except OSError:
                pass

    def _drain_and_close(self) -> None:
        for t in self._threads:
            t.join(timeout=5.0)
        if self.backend is not None:
            self.backend.stop()
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            c.close()

    def _fleet_shards(self):
        """Live per-worker shards off a fleet backend (None for a plain
        coalescer).  The scrape serializes under the coalescer lock —
        never mid-batch — and each probe carries its own deadline, so a
        wedged worker costs one bounded timeout, not a hung endpoint."""
        scrape = getattr(self.backend, "scrape_fleet", None)
        if not callable(scrape):
            return None
        return scrape()

    # -- raw JSONL connections ----------------------------------------------
    def _jsonl_reader(self, conn: _Conn) -> None:
        try:
            rfile = conn.sock.makefile("r", encoding="utf-8")
            for line in rfile:
                line = line.strip()
                if not line:
                    continue
                with self._lock:
                    conn.outstanding += 1
                self.backend.submit(line, origin=conn)
        except OSError:
            pass
        finally:
            with self._lock:
                conn.eof = True
                finished = conn.outstanding <= 0
            if finished:
                conn.close()
            with self._lock:
                self._conns.discard(conn)

    # -- HTTP/1.1 connections -------------------------------------------------
    def _http_reader(self, conn: _Conn) -> None:
        try:
            rfile = conn.sock.makefile("rb")
            while True:
                req = _read_http_request(rfile)
                if req is None:
                    break
                method, path, headers, body = req
                if method == "GET" and path == "/healthz":
                    summary = _obs.serve_summary_from_registry()
                    shards = self._fleet_shards()
                    if shards is not None:
                        # live mid-run merge: one entry per worker,
                        # marked by replica ordinal — no waiting for
                        # shutdown manifests
                        summary["workers"] = [
                            {"replica": s["replica"],
                             "host": s.get("host"),
                             "alive": s["alive"],
                             "wedged": s.get("wedged", False),
                             "summary": s.get("summary")}
                            for s in shards]
                    payload = json.dumps(summary, sort_keys=True)
                    self._http_reply(conn, 200, payload,
                                     "application/json")
                elif method == "GET" and path == "/metrics":
                    from mfm_tpu_torch.obs import slo as _slo
                    from mfm_tpu_torch.obs.metrics import snapshot_json

                    # evaluate BEFORE the snapshot so the burn gauges in
                    # it are current; the structured block rides beside
                    slo_block = _slo.installed_summary()
                    body = snapshot_json()
                    shards = self._fleet_shards()
                    if shards is not None or slo_block is not None:
                        snap = json.loads(body)
                        if slo_block is not None:
                            snap["slo"] = slo_block
                        if shards is not None:
                            snap["workers"] = [
                                {"replica": s["replica"],
                                 "host": s.get("host"),
                                 "alive": s["alive"],
                                 "metrics": s.get("metrics"),
                                 "transport": s.get("transport")}
                                for s in shards]
                        body = json.dumps(snap, sort_keys=True)
                    self._http_reply(conn, 200, body,
                                     "application/json")
                elif method == "POST":
                    lines = [ln for ln in
                             body.decode("utf-8").splitlines()
                             if ln.strip()]
                    if not lines:
                        self._http_reply(conn, 400, "empty body\n")
                        continue
                    pend = _HttpPending(len(lines))
                    for ln in lines:
                        self.backend.submit(ln, origin=pend)
                    pend.done.wait(timeout=self.deadline_wait_s)
                    out = "".join(json.dumps(r, sort_keys=True) + "\n"
                                  for r in pend.got)
                    self._http_reply(conn, 200, out,
                                     "application/jsonl")
                else:
                    self._http_reply(conn, 404, "not found\n")
                if headers.get("connection", "").lower() == "close":
                    break
        except OSError:
            pass
        finally:
            conn.close()
            with self._lock:
                self._conns.discard(conn)

    def _http_reply(self, conn: _Conn, status: int, body: str,
                    ctype: str = "text/plain") -> None:
        reason = {200: "OK", 400: "Bad Request", 404: "Not Found"}.get(
            status, "Error")
        data = body.encode("utf-8")
        head = (f"HTTP/1.1 {status} {reason}\r\n"
                f"Content-Type: {ctype}\r\n"
                f"Content-Length: {len(data)}\r\n\r\n").encode("ascii")
        conn.send_bytes(head + data)


def _read_http_request(rfile):
    """Minimal HTTP/1.1 request parser: (method, path, headers, body) or
    None at EOF.  Enough for the JSONL POST + healthz/metrics surface —
    no chunked encoding, no continuations."""
    start = rfile.readline()
    if not start:
        return None
    try:
        method, path, _version = start.decode("ascii").split(None, 2)
    except ValueError:
        return None
    headers = {}
    while True:
        h = rfile.readline()
        if not h or h in (b"\r\n", b"\n"):
            break
        name, _, val = h.decode("latin-1").partition(":")
        headers[name.strip().lower()] = val.strip()
    length = int(headers.get("content-length", 0) or 0)
    body = rfile.read(length) if length else b""
    return method.upper(), path, headers, body
