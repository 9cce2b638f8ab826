"""RPC client: one multiplexed connection per remote address with a demux
reader thread; blocking unary calls and streaming iterators, with bounded
retry + exponential backoff + seeded jitter on connection failure.

Retry is idempotency-aware. A *dial* failure (the connection could not
be established, so nothing reached the server) is retried for every
method. Once a request frame may have left the socket — a send error or
a connection that died before the reply — only methods registered as
idempotent (:data:`DEFAULT_IDEMPOTENT` plus :meth:`RPCClient.mark_idempotent`)
are retried; everything else, plan/job submission above all, stays
at-most-once and surfaces the ``ConnectionError`` to the caller.
Admission throttling is the exception: a :class:`RPCThrottled` reply
means the server refused the request before executing it, so every
method retries, sleeping the server's ``Retry-After`` hint (or the
normal backoff if longer).

Reference: helper/pool (ConnPool — the server-to-server connection pool,
nomad/rpc.go uses it for forwarding) and client/rpc.go (client→server
calls with retry/rebalance on connection failure; server-list rebalance
lives one layer up in ``server/cluster.py`` RemoteClientRPC).
"""

from __future__ import annotations

import itertools
import logging
import queue
import random
import socket
import threading
import time
from typing import Any, Callable, Iterator, Optional

from .framing import FramingError, recv_frame, send_frame

#: Methods safe to retry after the request may have reached the server:
#: reads, anti-entropy merges, and TTL touches. Raft RPCs are duplicate-
#: safe by protocol but keep their own retry cadence (election timing),
#: and all write forwarding (job/plan submission) is at-most-once.
DEFAULT_IDEMPOTENT = frozenset({
    "Nomad.heartbeat",
    "Nomad.pull_allocs",
    "Nomad.gossip_sync",
    "FS.list",
    "FS.stat",
    "FS.read",
    "FS.logs",
})


class RPCError(Exception):
    """Error raised by the remote handler (crossed the wire)."""


class RPCThrottled(RPCError):
    """Remote admission control refused the request (429-equivalent).

    Carries the server's ``Retry-After`` hint in seconds. A throttled
    request was rejected BEFORE execution, so retrying it is safe for
    every method — idempotent or not — and the client honors the hint
    in its backoff."""

    def __init__(self, message: str, retry_after: float):
        super().__init__(message)
        self.retry_after = float(retry_after)


class _Conn:
    def __init__(self, address: str, timeout: float):
        host, port = address.rsplit(":", 1)
        self.sock = socket.create_connection((host, int(port)), timeout=timeout)
        # TCP self-connect guard: dialing a free port can land on a socket
        # whose ephemeral local port equals the target, yielding a
        # connection to ourselves that then squats the server's port.
        if self.sock.getsockname() == self.sock.getpeername():
            self.sock.close()
            raise ConnectionError(f"self-connect dialing {address}")
        self.sock.settimeout(None)  # reader blocks; callers time out on queues
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.send_lock = threading.Lock()
        self.pending: dict[int, queue.Queue] = {}
        self.pending_lock = threading.Lock()
        self.dead = threading.Event()
        self.reader = threading.Thread(
            target=self._read_loop, name="rpc-demux", daemon=True
        )
        self.reader.start()

    def _read_loop(self) -> None:
        try:
            while True:
                msg = recv_frame(self.sock, expect_server=True)
                with self.pending_lock:
                    q = self.pending.get(msg.get("seq"))
                if q is not None:
                    q.put(msg)
        except FramingError as e:
            # protocol violation (bad auth, disallowed global, torn frame):
            # drop the connection — callers see "connection closed"
            logging.getLogger(__name__).warning("rpc: protocol violation: %s", e)
        except (ConnectionError, OSError):
            pass
        finally:
            self.dead.set()
            with self.pending_lock:
                for q in self.pending.values():
                    q.put({"error": "connection closed"})
                self.pending.clear()
            try:
                self.sock.close()
            except OSError:
                pass

    def close(self) -> None:
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


class RPCClient:
    def __init__(
        self,
        address: str,
        timeout: float = 10.0,
        max_attempts: int = 3,
        backoff_base: float = 0.05,
        backoff_cap: float = 2.0,
        idempotent: tuple[str, ...] = (),
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.address = address
        self.timeout = timeout
        self.max_attempts = max(1, max_attempts)
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self._idempotent: set[str] = set(DEFAULT_IDEMPOTENT) | set(idempotent)
        self._sleep = sleep
        # seeded jitter: retry timing is a function of the target, not
        # of process entropy — chaos runs stay reproducible
        self._rng = random.Random(f"rpc-retry:{address}")
        self._seq = itertools.count(1)
        self._conn: Optional[_Conn] = None
        self._conn_lock = threading.Lock()

    def mark_idempotent(self, *methods: str) -> None:
        """Register methods as safe to retry after a possible send."""
        self._idempotent.update(methods)

    def is_idempotent(self, method: str) -> bool:
        return method in self._idempotent

    def _get_conn(self) -> _Conn:
        with self._conn_lock:
            if self._conn is None or self._conn.dead.is_set():
                self._conn = _Conn(self.address, self.timeout)
            return self._conn

    def close(self) -> None:
        with self._conn_lock:
            if self._conn is not None:
                self._conn.close()
                self._conn = None

    def _retry_sleep(self, method: str, attempt: int) -> None:
        from ..utils.metrics import global_metrics

        global_metrics.incr("nomad.resilience.rpc.retries")
        delay = min(
            self.backoff_cap, self.backoff_base * (2.0 ** (attempt - 1))
        )
        self._sleep(delay * self._rng.uniform(0.5, 1.5))

    def _throttle_sleep(self, retry_after: float, attempt: int) -> None:
        from ..utils.metrics import global_metrics

        global_metrics.incr("nomad.admission.rpc_throttled_retries")
        backoff = min(
            self.backoff_cap, self.backoff_base * (2.0 ** (attempt - 1))
        )
        self._sleep(max(float(retry_after), backoff) * self._rng.uniform(1.0, 1.25))

    def _send(
        self, conn: _Conn, method: str, args: Any
    ) -> tuple[_Conn, int, queue.Queue]:
        seq = next(self._seq)
        q: queue.Queue = queue.Queue()
        with conn.pending_lock:
            conn.pending[seq] = q
        try:
            with conn.send_lock:
                send_frame(conn.sock, {"seq": seq, "method": method, "args": args})
        except (ConnectionError, OSError) as e:
            with conn.pending_lock:
                conn.pending.pop(seq, None)
            conn.dead.set()
            raise ConnectionError(f"rpc send to {self.address}: {e}") from e
        from ..chaos.plane import chaos_site

        # the frame has left the socket: a drop here models the network
        # yanking the connection after the server may have processed the
        # request — exactly the window where idempotency matters
        if chaos_site("rpc.conn_drop") == "drop":
            conn.close()
            # the response is lost even if the kernel already buffered
            # it — discard any raced-in reply so the fault is
            # deterministic regardless of scheduler timing; mark the
            # conn dead now so the retry dials fresh instead of racing
            # the reader thread's own dead.set()
            conn.dead.set()
            with conn.pending_lock:
                conn.pending.pop(seq, None)
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            q.put({"error": "connection closed"})
        return conn, seq, q

    def _call_once(
        self, conn: _Conn, method: str, args: Any, timeout: Optional[float]
    ) -> Any:
        conn, seq, q = self._send(conn, method, args)
        try:
            msg = q.get(timeout=timeout if timeout is not None else self.timeout)
        except queue.Empty:
            raise TimeoutError(f"rpc {method} to {self.address} timed out") from None
        finally:
            with conn.pending_lock:
                conn.pending.pop(seq, None)
        if "error" in msg:
            if msg["error"] == "connection closed":
                raise ConnectionError(f"rpc {method}: connection closed")
            if "retry_after" in msg:
                raise RPCThrottled(msg["error"], msg["retry_after"])
            raise RPCError(msg["error"])
        return msg.get("result")

    def call(self, method: str, args: Any = None,
             timeout: Optional[float] = None) -> Any:
        attempt = 0
        while True:
            try:
                conn = self._get_conn()
            except OSError as e:
                # dial failure: nothing reached the server, every method
                # is safe to retry
                attempt += 1
                if attempt >= self.max_attempts:
                    raise ConnectionError(
                        f"rpc dial {self.address}: {e}"
                    ) from e
                self._retry_sleep(method, attempt)
                continue
            try:
                return self._call_once(conn, method, args, timeout)
            except RPCThrottled as e:
                # server-side admission refusal: the request never
                # executed, so EVERY method retries — honoring the
                # server's Retry-After over our own backoff when it's
                # longer (jittered so a shed wave doesn't resync)
                attempt += 1
                if attempt >= self.max_attempts:
                    raise
                self._throttle_sleep(e.retry_after, attempt)
            except ConnectionError:
                # the request may have executed remotely: at-most-once
                # unless the method is registered idempotent
                attempt += 1
                if (
                    method not in self._idempotent
                    or attempt >= self.max_attempts
                ):
                    raise
                self._retry_sleep(method, attempt)

    def stream(self, method: str, args: Any = None,
               timeout: Optional[float] = None) -> Iterator[Any]:
        """Iterate streamed chunks until the server marks the end.
        Dial failures retry like :meth:`call`; once a chunk has been
        yielded a dead connection is surfaced, never re-spliced."""
        per_chunk = timeout if timeout is not None else self.timeout
        attempt = 0
        yielded = False
        while True:
            try:
                conn = self._get_conn()
            except OSError as e:
                attempt += 1
                if attempt >= self.max_attempts:
                    raise ConnectionError(
                        f"rpc dial {self.address}: {e}"
                    ) from e
                self._retry_sleep(method, attempt)
                continue
            try:
                conn, seq, q = self._send(conn, method, args)
            except ConnectionError:
                attempt += 1
                if (
                    method not in self._idempotent
                    or attempt >= self.max_attempts
                ):
                    raise
                self._retry_sleep(method, attempt)
                continue
            try:
                while True:
                    try:
                        msg = q.get(timeout=per_chunk)
                    except queue.Empty:
                        raise TimeoutError(
                            f"rpc stream {method} to {self.address} timed out"
                        ) from None
                    if "error" in msg:
                        if msg["error"] == "connection closed":
                            if (
                                not yielded
                                and method in self._idempotent
                                and attempt + 1 < self.max_attempts
                            ):
                                break  # restart the stream from scratch
                            raise ConnectionError(
                                f"rpc stream {method}: closed"
                            )
                        raise RPCError(msg["error"])
                    if not msg.get("more", False):
                        return
                    yielded = True
                    yield msg.get("chunk")
            finally:
                with conn.pending_lock:
                    conn.pending.pop(seq, None)
            attempt += 1
            self._retry_sleep(method, attempt)
