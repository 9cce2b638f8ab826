"""RPC server: TCP listener, per-connection reader, per-request worker
threads, streaming generator support.

Reference: nomad/rpc.go handleConn (:195) / handleNomadConn, and the
streaming registry (structs.StreamingRpcRegistry, nomad/server.go:158).
A connection carries many concurrent requests distinguished by ``seq`` —
the role yamux streams play in the reference.
"""

from __future__ import annotations

import logging
import socket
import threading
from typing import Any, Callable, Dict, Iterator, Optional

from .framing import FramingError, recv_frame, send_frame

log = logging.getLogger(__name__)


class _PeerGone(Exception):
    """A reply could not be sent: the peer closed the connection."""


class RPCServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host = host
        self.port = port
        self._handlers: Dict[str, Callable[[Any], Any]] = {}
        self._sock: Optional[socket.socket] = None
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._conns: set[socket.socket] = set()
        self._lock = threading.Lock()

    def register(self, method: str, handler: Callable[[Any], Any]) -> None:
        """Handler returns a value (unary) or an iterator (streaming)."""
        self._handlers[method] = handler

    def register_all(self, prefix: str, obj: object) -> None:
        """Register every public method of ``obj`` as ``prefix.name`` —
        the endpoint-registration analog of nomad/server.go:262-289."""
        for name in dir(obj):
            if name.startswith("_"):
                continue
            fn = getattr(obj, name)
            if callable(fn):
                self.register(f"{prefix}.{name}", fn)

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> None:
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self.host, self.port))
        self.port = self._sock.getsockname()[1]
        self._sock.listen(128)
        # a blocking accept() is not reliably woken by close() from another
        # thread on Linux, and the zombie listener would squat the port;
        # poll so the accept thread notices _stop and releases the socket
        self._sock.settimeout(0.25)
        t = threading.Thread(target=self._accept_loop, name="rpc-accept",
                             daemon=True)
        t.start()
        self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.settimeout(None)  # accepted sockets must block normally
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                self._conns.add(conn)
            t = threading.Thread(
                target=self._conn_loop, args=(conn,), name="rpc-conn",
                daemon=True,
            )
            t.start()

    def _conn_loop(self, conn: socket.socket) -> None:
        send_lock = threading.Lock()  # interleave whole frames only
        try:
            while not self._stop.is_set():
                try:
                    msg = recv_frame(conn, expect_server=False)
                except FramingError as e:
                    log.warning("rpc: protocol violation from peer: %s", e)
                    return
                except (ConnectionError, OSError):
                    return
                threading.Thread(
                    target=self._dispatch,
                    args=(conn, send_lock, msg),
                    daemon=True,
                ).start()
        finally:
            with self._lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch(self, conn, send_lock, msg) -> None:
        seq = msg.get("seq")
        method = msg.get("method", "")
        handler = self._handlers.get(method)

        def reply(payload: dict) -> None:
            payload["seq"] = seq
            try:
                with send_lock:
                    send_frame(conn, payload, server_side=True)
            except OSError as e:
                raise _PeerGone() from e

        if handler is None:
            try:
                reply({"error": f"unknown method {method!r}"})
            except _PeerGone:
                pass
            return
        try:
            result = handler(msg.get("args"))
            if isinstance(result, Iterator):
                for chunk in result:
                    reply({"chunk": chunk, "more": True})
                reply({"chunk": None, "more": False})
            else:
                reply({"result": result})
        except _PeerGone:
            pass  # peer went away mid-reply
        # a handler's own OSError (a path that escapes the alloc dir, a
        # missing file) crosses the wire like any other error; the JAX
        # package's server swallows it and the caller waits out its
        # timeout (ROADMAP C-R8)
        except Exception as e:  # noqa: BLE001 — errors cross the wire
            log.debug("rpc handler %s failed", method, exc_info=True)
            payload = {"error": f"{type(e).__name__}: {e}"}
            # admission throttling (server/admission.py AdmissionRejected
            # or anything else carrying retry_after): ship the hint so
            # the client can honor it in its backoff
            retry_after = getattr(e, "retry_after", None)
            if retry_after is not None:
                payload["retry_after"] = float(retry_after)
            try:
                reply(payload)
            except _PeerGone:
                pass
