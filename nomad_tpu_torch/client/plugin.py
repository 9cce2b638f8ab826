"""Out-of-process driver plugins — the subprocess driver contract.

Reference: plugins/drivers/proto/driver.proto (TaskDriver gRPC service:
Fingerprint/StartTask/WaitTask/StopTask/RecoverTask) + plugins/base
(handshake with a magic cookie + protocol version) +
plugins/drivers/task_handle.go (reattach handles that survive both task
and client restarts).

Transport: NDJSON request/response over the plugin's stdin/stdout with
pipelined request ids — the reference's gRPC-over-unix-socket carries the
same five verbs; JSON framing keeps the protocol dependency-free (no
protoc/grpc codegen in this toolchain) while preserving the contract:

  plugin → host  {"type":"handshake","magic":...,"version":1,
                  "driver":name,"fingerprint":bool}
  host → plugin  {"id":N,"method":"start|wait|stop|recover|inspect|
                  fingerprint|shutdown","params":{...}}
  plugin → host  {"id":N,"result":...} | {"id":N,"error":"..."}

``wait`` blocks server-side per task, so requests are handled on one
thread per request and responses are matched by id host-side — several
tasks run concurrently through one plugin process, as with the
reference's multiplexed gRPC connection.

Reattach: task processes are started in their own sessions (setsid), so
they survive BOTH the plugin process and the client dying; a restarted
client spawns a fresh plugin and hands it the persisted TaskHandle via
``recover`` (pid + kernel start time identity, drivers.py)."""

from __future__ import annotations

import json
import os
import select
import subprocess
import sys
import threading
import time
from dataclasses import asdict
from typing import Optional

from .drivers import DriverError, TaskDriver, TaskHandle

PLUGIN_MAGIC = "NOMAD_TPU_DRIVER_V1"
PROTO_VERSION = 1
# a spawned plugin must write its handshake line within this window or be
# killed (a hung plugin would otherwise block every driver call)
HANDSHAKE_TIMEOUT_S = 10.0


def _handle_to_wire(h: TaskHandle) -> dict:
    return asdict(h)


def _handle_from_wire(d: dict) -> TaskHandle:
    return TaskHandle(**d)


class _WireRes:
    __slots__ = ("cpu", "memory_mb")

    def __init__(self, cpu: int, memory_mb: int):
        self.cpu = cpu
        self.memory_mb = memory_mb


class _WireTask:
    """Minimal task view the plugin needs (name/driver/config/resources —
    the exec driver derives its rlimits from the memory ask)."""

    __slots__ = ("name", "driver", "config", "resources")

    def __init__(self, name: str, driver: str, config: dict, resources=None):
        self.name = name
        self.driver = driver
        self.config = config
        self.resources = resources


# -- plugin (server) side ----------------------------------------------------


def serve_driver(driver: TaskDriver, stdin=None, stdout=None) -> None:
    """Serve one driver over stdio until EOF/shutdown. Run via
    ``python -m nomad_tpu_torch.client.plugin <driver_name>``."""
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
            "magic": PLUGIN_MAGIC,
            "version": PROTO_VERSION,
            "driver": driver.name,
            "fingerprint": bool(driver.fingerprint()),
        }
    )

    # handles live server-side; the host addresses them by wire dicts
    handles: dict[str, TaskHandle] = {}
    hlock = threading.Lock()
    shutdown = threading.Event()

    def dispatch(req: dict) -> None:
        rid = req.get("id")
        method = req.get("method")
        p = req.get("params") or {}
        try:
            if method == "fingerprint":
                result = bool(driver.fingerprint())
            elif method == "start":
                res = p.get("resources") or {}
                task = _WireTask(
                    p["task_name"],
                    driver.name,
                    p.get("config") or {},
                    _WireRes(
                        int(res.get("cpu", 0)),
                        int(res.get("memory_mb", 0)),
                    ),
                )
                h = driver.start(task, p.get("env") or {}, p["task_dir"])
                with hlock:
                    handles[h.id] = h
                result = _handle_to_wire(h)
            elif method in ("wait", "stop", "inspect", "recover"):
                wire = p["handle"]
                with hlock:
                    h = handles.get(wire["id"])
                if h is None:
                    h = _handle_from_wire(wire)
                    with hlock:
                        handles[h.id] = h
                if method == "wait":
                    code = driver.wait(h, timeout=p.get("timeout"))
                    result = {"exit_code": code, "handle": _handle_to_wire(h)}
                elif method == "stop":
                    driver.stop(h, kill_timeout=p.get("kill_timeout", 5.0))
                    result = _handle_to_wire(h)
                elif method == "recover":
                    result = {
                        "ok": bool(driver.recover(h)),
                        "handle": _handle_to_wire(h),
                    }
                else:
                    result = _handle_to_wire(driver.inspect(h))
            elif method == "shutdown":
                result = True
                shutdown.set()
            else:
                raise DriverError(f"unknown method {method!r}")
            send({"id": rid, "result": result})
        except Exception as e:  # noqa: BLE001 — errors cross the wire
            send({"id": rid, "error": f"{type(e).__name__}: {e}"})

    for line in stdin:
        if shutdown.is_set():
            break
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
        except json.JSONDecodeError:
            continue
        # one thread per request: wait() blocks for its task's lifetime
        threading.Thread(target=dispatch, args=(req,), daemon=True).start()


# -- host (client) side ------------------------------------------------------


class PluginDriverClient(TaskDriver):
    """TaskDriver implemented by a driver plugin subprocess. Spawns the
    plugin lazily, performs the handshake, and pipelines requests."""

    def __init__(self, driver_name: str):
        self.name = driver_name
        self._proc: Optional[subprocess.Popen] = None
        self._lock = threading.Lock()
        self._pending: dict[int, threading.Event] = {}
        self._results: dict[int, dict] = {}
        self._next_id = 0
        self._fingerprint = False
        self._handshake_rest = b""

    def default_argv(self, name: str) -> list[str]:
        """The plugin host's command line: this package's launcher."""
        return [sys.executable, "-m", "nomad_tpu_torch.client.plugin", name]

    # -- plugin lifecycle --------------------------------------------------
    def _ensure_plugin(self) -> None:
        with self._lock:
            if self._proc is not None and self._proc.poll() is None:
                return
            self._proc = subprocess.Popen(
                self.default_argv(self.name),
                stdin=subprocess.PIPE,
                stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL,
                text=True,
                env={**os.environ, "PYTHONPATH": os.pathsep.join(sys.path)},
            )
            # bounded handshake: a plugin that spawns but hangs before
            # completing its handshake LINE must not wedge every driver
            # call behind self._lock — kill it and report unhealthy. The
            # deadline covers partial lines too (a crashing child can
            # flush a truncated banner with no newline), so read raw
            # bytes under select until newline or deadline rather than
            # readline() (which would block past the first byte).
            deadline = time.monotonic() + HANDSHAKE_TIMEOUT_S
            raw_fd = self._proc.stdout.fileno()
            buf = b""
            while b"\n" not in buf:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self._proc.kill()
                    self._proc.wait()
                    raise DriverError(
                        f"driver plugin {self.name!r} handshake timed "
                        f"out after {HANDSHAKE_TIMEOUT_S}s"
                    )
                ready, _, _ = select.select([raw_fd], [], [], remaining)
                if not ready:
                    continue
                chunk = os.read(raw_fd, 4096)
                if not chunk:  # EOF before a full handshake line
                    break
                buf += chunk
            line, _, rest = buf.partition(b"\n")
            # hand any over-read bytes back ahead of the reader thread's
            # stream (requests are dispatched only after the handshake,
            # so over-read can only happen from a misbehaving plugin —
            # push it through the same JSON-line parser for symmetry)
            self._handshake_rest = rest
            line = line.decode("utf-8", "replace")
            if not line.strip():
                # plugin died before the handshake (import failure etc.)
                self._proc.kill()
                raise DriverError(
                    f"driver plugin {self.name!r} exited before handshake"
                )
            hs = json.loads(line)
            if (
                hs.get("magic") != PLUGIN_MAGIC
                or hs.get("version") != PROTO_VERSION
            ):
                self._proc.kill()
                raise DriverError(
                    f"driver plugin handshake failed: {hs!r}"
                )
            self._fingerprint = bool(hs.get("fingerprint"))
            t = threading.Thread(
                target=self._read_loop,
                args=(self._proc, self._handshake_rest),
                daemon=True,
            )
            t.start()

    def _read_loop(self, proc: subprocess.Popen, rest: bytes = b"") -> None:
        import itertools

        # bytes over-read past the handshake newline bypass the buffered
        # stream — feed them through the same line parser first
        head = (
            [ln + "\n" for ln in rest.decode("utf-8", "replace").split("\n") if ln]
            if rest
            else []
        )
        for line in itertools.chain(head, proc.stdout):
            try:
                msg = json.loads(line)
            except json.JSONDecodeError:
                continue
            rid = msg.get("id")
            with self._lock:
                entry = self._pending.pop(rid, None)
                if entry is not None:
                    self._results[rid] = msg
            if entry is not None:
                entry[0].set()
        # this plugin died: fail only the requests issued to IT — a
        # respawned plugin's in-flight requests must survive
        with self._lock:
            dead = [
                (rid, evt)
                for rid, (evt, p) in self._pending.items()
                if p is proc
            ]
            for rid, evt in dead:
                self._pending.pop(rid, None)
                self._results[rid] = {
                    "id": rid, "error": "driver plugin exited"
                }
            for _rid, evt in dead:
                evt.set()

    def _call(self, method: str, params: dict, timeout: Optional[float] = None):
        self._ensure_plugin()
        with self._lock:
            self._next_id += 1
            rid = self._next_id
            evt = threading.Event()
            self._pending[rid] = (evt, self._proc)
            try:
                self._proc.stdin.write(
                    json.dumps({"id": rid, "method": method, "params": params})
                    + "\n"
                )
                self._proc.stdin.flush()
            except (BrokenPipeError, OSError) as e:
                self._pending.pop(rid, None)
                raise DriverError(f"driver plugin unreachable: {e}") from e
        if not evt.wait(timeout):
            with self._lock:
                self._pending.pop(rid, None)
            return None  # caller-visible timeout (wait() contract)
        with self._lock:
            msg = self._results.pop(rid)
        if "error" in msg:
            raise DriverError(msg["error"])
        return msg["result"]

    def close(self) -> None:
        with self._lock:
            proc = self._proc
            self._proc = None
        if proc is not None and proc.poll() is None:
            try:
                proc.stdin.write(
                    json.dumps({"id": 0, "method": "shutdown", "params": {}})
                    + "\n"
                )
                proc.stdin.flush()
                # EOF releases serve_driver's stdin loop so the graceful
                # path actually completes (the loop only re-checks the
                # shutdown flag on its next line otherwise)
                proc.stdin.close()
            except (BrokenPipeError, OSError):
                pass
            try:
                proc.wait(timeout=2)
            except subprocess.TimeoutExpired:
                proc.kill()

    # -- TaskDriver contract ----------------------------------------------
    def fingerprint(self) -> bool:
        try:
            self._ensure_plugin()
        except (DriverError, OSError, ValueError):
            # ValueError covers a garbled handshake (JSONDecodeError):
            # an unhealthy plugin is an unhealthy driver, not a crash
            return False
        return self._fingerprint

    def start(self, task, env, task_dir) -> TaskHandle:
        res = getattr(task, "resources", None)
        result = self._call(
            "start",
            {
                "task_name": task.name,
                "config": dict(task.config or {}),
                "env": dict(env),
                "task_dir": task_dir,
                "resources": {
                    "cpu": getattr(res, "cpu", 0) or 0,
                    "memory_mb": getattr(res, "memory_mb", 0) or 0,
                }
                if res is not None
                else {},
            },
        )
        return _handle_from_wire(result)

    def wait(self, handle, timeout=None):
        # no host-side deadline beyond the caller's: the plugin blocks
        result = self._call(
            "wait",
            {"handle": _handle_to_wire(handle), "timeout": timeout},
            timeout=None if timeout is None else timeout + 5.0,
        )
        if result is None:
            return None
        fresh = result["handle"]
        handle.state = fresh["state"]
        handle.exit_code = fresh["exit_code"]
        handle.completed_at = fresh["completed_at"]
        return result["exit_code"]

    def stop(self, handle, kill_timeout=5.0):
        self._call(
            "stop",
            {"handle": _handle_to_wire(handle), "kill_timeout": kill_timeout},
            timeout=kill_timeout + 10.0,
        )

    def recover(self, handle: TaskHandle) -> bool:
        try:
            result = self._call(
                "recover", {"handle": _handle_to_wire(handle)}, timeout=10.0
            )
        except DriverError:
            return False
        if not result or not result.get("ok"):
            return False
        handle.meta.update(result["handle"].get("meta") or {})
        return True


def plugin_drivers(names=("raw_exec", "exec", "mock_driver")) -> dict:
    """Out-of-process driver catalog — one plugin subprocess per driver,
    spawned lazily (helper/pluginutils/catalog with external plugins)."""
    return {n: PluginDriverClient(n) for n in names}


def _main() -> None:
    from .drivers import builtin_drivers

    name = sys.argv[1] if len(sys.argv) > 1 else "raw_exec"
    catalog = builtin_drivers()
    driver = catalog.get(name)
    if driver is None:
        print(f"unknown driver {name!r}", file=sys.stderr)
        raise SystemExit(2)
    serve_driver(driver)


if __name__ == "__main__":
    _main()
