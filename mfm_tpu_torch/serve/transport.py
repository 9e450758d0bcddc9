"""Deadline-bearing worker transports: the fleet's machine boundary
(counterpart of ``mfm_tpu/serve/transport.py``; the same wire bytes, so a
port front end drives a reference worker and the other way round).

Every worker read and write goes through a transport whose single I/O
primitive carries a deadline, so a worker that is alive but wedged
(SIGSTOP, a hung device call, a full pipe) cannot freeze a flush, and the
same JSONL wire protocol runs over either

- :class:`PipeTransport` — the stdin/stdout pipe pair of a spawned
  ``serve --worker`` subprocess (same-host fleet), with the pipe fds
  switched to non-blocking so writes against a full pipe time out instead
  of wedging the flush loop; or
- :class:`TcpTransport` — a socket to a worker started elsewhere with
  ``serve --worker --listen HOST:PORT`` (multi-host fleet).  Connection
  establishment reuses :func:`mfm_tpu_torch.data.etl.with_retry`
  exponential backoff, and the raised exception is stamped
  ``phase="connect"`` so a "never connected" failure reads differently
  from a mid-batch loss (``phase="batch"``) in the fleet manifest's
  transport counters.

Failure taxonomy (what :class:`~mfm_tpu_torch.serve.replica.FleetServer`
keys its quarantine/re-dispatch decisions on):

- :class:`TransportClosed` — the peer is GONE: EOF, broken pipe,
  connection reset.  The worker is dead; its in-flight batch
  re-dispatches to a survivor.
- :class:`TransportTimeout` — the peer is WEDGED: the deadline expired
  with the worker still nominally alive.  Treated exactly like a death
  (quarantine + re-dispatch), except that the process may need killing at
  shutdown, which ``Replica.close`` handles.

Both carry a ``phase`` attribute ("connect" or "batch") and feed the
``mfm_fleet_transport_*`` counters.  Deadlines are per-I/O, not
per-batch: a worker legitimately crunching a large batch keeps the read
alive by emitting envelopes as sub-batches drain, while a wedged one
produces silence and trips the timeout within one ``io_timeout_s``.

The transports are NOT internally locked: the fleet serializes all worker
I/O under the coalescer's admission lock, and the worker side of a socket
is owned by one ``run_worker`` loop.
"""

from __future__ import annotations

import json
import os
import select
import socket
import time

#: default per-I/O deadline — generous against real batch walls, tight
#: enough that a wedged worker cannot stall a flush for long
DEFAULT_IO_TIMEOUT_S = 30.0


class TransportError(RuntimeError):
    """Base worker-transport failure; ``phase`` says when it happened."""

    phase = "batch"

    def __init__(self, msg: str, *, phase: str = "batch"):
        super().__init__(msg)
        self.phase = phase


class TransportClosed(TransportError):
    """Peer gone: EOF, broken pipe, connection reset."""


class TransportTimeout(TransportError):
    """Deadline expired with the peer still nominally alive (wedged)."""


def _new_counters() -> dict:
    return {
        "frames_sent": 0,
        "frames_recv": 0,
        "send_timeouts": 0,
        "recv_timeouts": 0,
        "connect_attempts": 0,
        "reconnects": 0,
        "failure_phases": {},   # phase -> count, off raised errors
    }


class LineTransport:
    """Deadline-bearing JSONL framing over a byte stream.

    Subclasses supply four primitives — readable/writable fds and
    non-blocking chunk read/write — and this base runs the framed
    ``send_lines`` / ``recv_line`` loops with one deadline per I/O wait.
    A ``None`` from :meth:`recv_line` means clean EOF (the worker drained
    and exited); torn/blocked I/O raises the taxonomy above.
    """

    def __init__(self, io_timeout_s: float = DEFAULT_IO_TIMEOUT_S):
        self.io_timeout_s = float(io_timeout_s)
        self.closed = False
        self.counters = _new_counters()
        self._rbuf = bytearray()

    # -- subclass surface ----------------------------------------------------
    def _recv_fd(self) -> int:
        raise NotImplementedError

    def _send_fd(self) -> int:
        raise NotImplementedError

    def _read_chunk(self, n: int) -> bytes:
        """Non-blocking read after readability; b'' = EOF."""
        raise NotImplementedError

    def _write_chunk(self, data: bytes) -> int:
        """Non-blocking write after writability; returns bytes written."""
        raise NotImplementedError

    def close(self) -> None:
        self.closed = True

    # -- deadline plumbing ---------------------------------------------------
    def _fail(self, exc: TransportError) -> TransportError:
        ph = exc.phase
        self.counters["failure_phases"][ph] = \
            self.counters["failure_phases"].get(ph, 0) + 1
        return exc

    def _await(self, fd: int, deadline: float, *, read: bool) -> None:
        remaining = deadline - time.monotonic()
        if remaining > 0:
            try:
                r, w, _ = select.select([fd] if read else [],
                                        [] if read else [fd], [],
                                        remaining)
            except (OSError, ValueError) as e:
                raise self._fail(TransportClosed(
                    f"transport fd gone: {e}")) from e
            if r or w:
                return
        op = "recv" if read else "send"
        self.counters[f"{op}_timeouts"] += 1
        raise self._fail(TransportTimeout(
            f"worker {op} exceeded {self.io_timeout_s:.3f}s deadline "
            "(peer wedged?)"))

    # -- framing -------------------------------------------------------------
    def send_lines(self, lines) -> None:
        """Write each line + newline, one deadline per I/O wait."""
        data = memoryview(("".join(ln + "\n" for ln in lines))
                          .encode("utf-8"))
        deadline = time.monotonic() + self.io_timeout_s
        while data:
            self._await(self._send_fd(), deadline, read=False)
            try:
                n = self._write_chunk(data)
            except (BlockingIOError, InterruptedError):
                continue
            except (BrokenPipeError, ConnectionError, OSError) as e:
                raise self._fail(TransportClosed(
                    f"worker pipe/socket broke mid-send: {e}")) from e
            data = data[n:]
            # progress resets the clock: the deadline bounds SILENCE,
            # not total batch size
            deadline = time.monotonic() + self.io_timeout_s
        self.counters["frames_sent"] += len(lines)

    def send_frame(self, obj: dict) -> None:
        self.send_lines([json.dumps(obj, sort_keys=True)])

    def recv_line(self, timeout_s: float | None = None) -> str | None:
        """One newline-terminated frame, or None on clean EOF."""
        deadline = time.monotonic() + (self.io_timeout_s
                                       if timeout_s is None
                                       else float(timeout_s))
        while True:
            nl = self._rbuf.find(b"\n")
            if nl >= 0:
                line = self._rbuf[:nl].decode("utf-8")
                del self._rbuf[:nl + 1]
                self.counters["frames_recv"] += 1
                return line
            self._await(self._recv_fd(), deadline, read=True)
            try:
                chunk = self._read_chunk(1 << 16)
            except (BlockingIOError, InterruptedError):
                continue
            except (ConnectionError, OSError) as e:
                raise self._fail(TransportClosed(
                    f"worker pipe/socket broke mid-recv: {e}")) from e
            if not chunk:
                if self._rbuf:
                    raise self._fail(TransportClosed(
                        "EOF with a torn partial line buffered"))
                return None
            self._rbuf += chunk


class PipeTransport(LineTransport):
    """The stdin/stdout pipe pair of a spawned worker subprocess.

    Takes ownership of the fds: they are switched to non-blocking and
    all I/O bypasses the ``subprocess`` file objects (mixing buffered
    writes with raw fd writes would tear frames)."""

    def __init__(self, proc, io_timeout_s: float = DEFAULT_IO_TIMEOUT_S):
        super().__init__(io_timeout_s)
        self.proc = proc
        self._wfd = proc.stdin.fileno()
        self._rfd = proc.stdout.fileno()
        os.set_blocking(self._wfd, False)
        os.set_blocking(self._rfd, False)
        self.counters["connect_attempts"] = 1

    def _recv_fd(self) -> int:
        return self._rfd

    def _send_fd(self) -> int:
        return self._wfd

    def _read_chunk(self, n: int) -> bytes:
        return os.read(self._rfd, n)

    def _write_chunk(self, data) -> int:
        return os.write(self._wfd, data)

    def close(self) -> None:
        """Half-close the worker's stdin (EOF = graceful drain-out);
        stdout stays open so the tail responses remain readable."""
        if not self.closed:
            self.closed = True
            try:
                self.proc.stdin.close()
            except (BrokenPipeError, OSError):
                pass


class TcpTransport(LineTransport):
    """A socket to a ``serve --worker --listen`` process on any host."""

    def __init__(self, sock: socket.socket,
                 io_timeout_s: float = DEFAULT_IO_TIMEOUT_S):
        super().__init__(io_timeout_s)
        self.sock = sock
        self.sock.setblocking(False)

    @classmethod
    def connect(cls, addr: tuple, *,
                io_timeout_s: float = DEFAULT_IO_TIMEOUT_S,
                attempts: int = 5, backoff_s: float = 0.05,
                sleep=time.sleep) -> "TcpTransport":
        """Dial a worker with exponential backoff (the worker may still
        be loading its checkpoint).  Exhaustion raises the last
        ``OSError`` stamped ``phase="connect"`` plus ``with_retry``'s
        ``attempts``/``total_backoff_s`` history."""
        from mfm_tpu_torch.data.etl import with_retry

        host, port = addr[0], int(addr[1])
        made: list = []

        def dial():
            made.append(1)
            return socket.create_connection((host, port),
                                            timeout=io_timeout_s)
        try:
            sock = with_retry(dial, attempts=attempts,
                              backoff_s=backoff_s, sleep=sleep,
                              exponential=True, retryable=(OSError,),
                              phase="connect")
        except OSError:
            raise
        t = cls(sock, io_timeout_s)
        t.counters["connect_attempts"] = len(made)
        t.counters["reconnects"] = max(0, len(made) - 1)
        return t

    def _recv_fd(self) -> int:
        return self.sock.fileno()

    def _send_fd(self) -> int:
        return self.sock.fileno()

    def _read_chunk(self, n: int) -> bytes:
        return self.sock.recv(n)

    def _write_chunk(self, data) -> int:
        return self.sock.send(data)

    def close(self) -> None:
        """Half-close the write side (EOF = graceful drain-out) so the
        worker's tail responses remain readable, like the pipe path."""
        if not self.closed:
            self.closed = True
            try:
                self.sock.shutdown(socket.SHUT_WR)
            except OSError:
                pass

    def abort(self) -> None:
        self.closed = True
        try:
            self.sock.close()
        except OSError:
            pass


def serve_worker_socket(server, host: str, port: int, *,
                        run_worker=None, announce=None,
                        poll_on_flush: bool = True) -> dict:
    """Worker side of the TCP transport: bind, accept ONE frontend,
    run the ordinary :func:`~mfm_tpu_torch.serve.replica.run_worker` loop over
    the connection's file objects, and return the worker's serve
    summary when the frontend hangs up (EOF = drain-out, exactly like a
    closed stdin).  One connection per worker process keeps the process
    model identical to the pipe fleet — a frontend that needs the
    worker again restarts it, it does not reattach."""
    if run_worker is None:
        from mfm_tpu_torch.serve.replica import run_worker
    ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        ls.bind((host, int(port)))
        ls.listen(1)
        if announce is not None:
            announce(ls.getsockname()[:2])
        conn, _addr = ls.accept()
    finally:
        ls.close()
    try:
        rfile = conn.makefile("r", encoding="utf-8")
        wfile = conn.makefile("w", encoding="utf-8")
        return run_worker(server, rfile, wfile,
                          poll_on_flush=poll_on_flush)
    finally:
        try:
            conn.close()
        except OSError:
            pass
