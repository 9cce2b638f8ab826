"""Shared NDJSON-stdio plugin transport (host side).

The device (client/device_plugin.py) and CSI (client/csi_plugin.py)
plugin clients speak the same wire: spawn a subprocess, read one
handshake line under a deadline, then serial request/response JSON
lines. This base owns that machinery once — transport fixes (handshake
deadlines, zombie reaping, respawn) apply everywhere. The DRIVER plugin
client (client/plugin.py) keeps its own pipelined transport: it
multiplexes long-blocking calls (wait) concurrently, which this serial
base deliberately does not."""

from __future__ import annotations

import json
import os
import select
import subprocess
import sys
import threading
import time
from typing import Optional

HANDSHAKE_TIMEOUT_S = 10.0


def serve_stdio_plugin(
    magic: str,
    version: int,
    plugin_name: str,
    methods: dict,
    stdin=None,
    stdout=None,
) -> None:
    """Plugin-side serve loop shared by the device and CSI plugins:
    handshake line, then serial id/method/params dispatch with error
    replies; ``shutdown`` exits. ``methods`` maps method name → callable
    taking the params dict."""
    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout
    wlock = threading.Lock()

    def send(obj: dict) -> None:
        with wlock:
            stdout.write(json.dumps(obj) + "\n")
            stdout.flush()

    send(
        {
            "type": "handshake",
            "magic": magic,
            "version": version,
            "plugin": plugin_name,
        }
    )
    for line in stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
        except json.JSONDecodeError:
            continue
        rid = req.get("id")
        method = req.get("method", "")
        if method == "shutdown":
            send({"id": rid, "result": True})
            return
        fn = methods.get(method)
        if fn is None:
            send({"id": rid, "error": f"unknown method {method!r}"})
            continue
        try:
            send({"id": rid, "result": fn(req.get("params") or {})})
        except Exception as e:  # noqa: BLE001 — report, don't die
            send({"id": rid, "error": str(e)})


class StdioPluginClient:
    """Serial request/response client over a plugin subprocess's stdio."""

    #: subclasses set these
    MAGIC = ""
    VERSION = 0

    def __init__(self, name: str, argv: Optional[list[str]] = None):
        self.name = name
        self._argv = argv or self.default_argv(name)
        self._proc: Optional[subprocess.Popen] = None
        self._lock = threading.Lock()
        self._next_id = 0

    def default_argv(self, name: str) -> list[str]:  # pragma: no cover
        raise NotImplementedError

    def _ensure(self) -> None:
        with self._lock:
            if self._proc is not None and self._proc.poll() is None:
                return
            self._proc = subprocess.Popen(
                self._argv,
                stdin=subprocess.PIPE,
                stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL,
                text=True,
                env={**os.environ, "PYTHONPATH": os.pathsep.join(sys.path)},
            )
            # bounded handshake covering partial lines: a hung or
            # misbehaving plugin must not wedge the caller
            deadline = time.monotonic() + HANDSHAKE_TIMEOUT_S
            fd = self._proc.stdout.fileno()
            buf = b""
            while b"\n" not in buf:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self._proc.kill()
                    self._proc.wait()
                    raise RuntimeError(
                        f"plugin {self.name!r} handshake timeout"
                    )
                ready, _, _ = select.select([fd], [], [], remaining)
                if not ready:
                    continue
                chunk = os.read(fd, 4096)
                if not chunk:
                    break
                buf += chunk
            try:
                hs = json.loads(buf.partition(b"\n")[0] or b"{}")
            except ValueError:
                hs = {}  # garbage banner: fail the magic check below
            if hs.get("magic") != self.MAGIC or (
                hs.get("version") != self.VERSION
            ):
                self._proc.kill()
                self._proc.wait()  # reap — no zombie on mismatch
                raise RuntimeError(
                    f"plugin {self.name!r} handshake failed: {hs!r}"
                )

    def _call(self, method: str, params: Optional[dict] = None):
        self._ensure()
        with self._lock:
            self._next_id += 1
            rid = self._next_id
            self._proc.stdin.write(
                json.dumps(
                    {"id": rid, "method": method, "params": params or {}}
                )
                + "\n"
            )
            self._proc.stdin.flush()
            line = self._proc.stdout.readline()
        if not line:
            raise RuntimeError(f"plugin {self.name!r} exited")
        try:
            msg = json.loads(line)
        except ValueError as e:
            # a stray non-JSON line must surface through the transport's
            # RuntimeError contract, not as a JSONDecodeError callers
            # don't expect
            raise RuntimeError(
                f"plugin {self.name!r} sent invalid response: "
                f"{line[:120]!r}"
            ) from e
        if msg.get("error"):
            raise RuntimeError(msg["error"])
        return msg.get("result")

    def close(self) -> None:
        p = self._proc
        if p is None:
            return
        if p.poll() is None:
            # only a LIVE plugin gets the polite shutdown — calling
            # _call() here would respawn a dead one just to kill it
            try:
                self._call("shutdown")
            except Exception:  # noqa: BLE001
                pass
        try:
            p.terminate()
            p.wait(timeout=2)
        except Exception:  # noqa: BLE001
            p.kill()
            try:
                p.wait(timeout=2)
            except Exception:  # noqa: BLE001
                pass
        self._proc = None
