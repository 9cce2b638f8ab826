"""Container driver — docker/podman over the Engine HTTP API.

Reference: drivers/docker/ (10.8k LoC; driver.go StartTask/WaitTask/
StopTask/RecoverTask, driver_linux.go resource plumbing). The reference
links the Docker SDK; this driver speaks the Engine REST API directly
over the daemon's unix socket (podman serves the same API at
/run/podman/podman.sock), so it needs no vendored SDK and works against
either runtime.

Key properties matched to the reference:

- **Reattach by container id** (docker/handle.go): the container id IS
  the durable handle — after a client (or plugin subprocess) restart,
  ``recover()`` re-inspects the id; a still-running container re-attaches
  losslessly, an exited one yields its REAL exit code from the daemon
  (the daemon plays the role the native C++ supervisor plays for exec
  tasks: the process that outlives the agent and owns the exit status).
- **Resource plumbing** (driver_linux.go): the task's cpu/memory ask maps
  to HostConfig.NanoCpus / Memory — enforced by the runtime's cgroups.
- **Alloc dir bind** (docker/driver.go allocDir mounts): the task dir is
  bind-mounted at /alloc inside the container.
- **Log capture**: on exit the daemon's log endpoint is drained into the
  task dir's ``<task>.stdout`` / ``.stderr`` so the fs/logs HTTP
  endpoints serve container logs exactly like exec-task logs.

Out-of-process: the driver is registered in the builtin catalog; the
NDJSON stdio plugin host that serves catalog drivers out of process
(``client/plugin.py``) is not ported yet (ROADMAP A16).

Socket discovery order: $NOMAD_CONTAINER_SOCK, /var/run/docker.sock,
/run/podman/podman.sock. Fingerprint is unhealthy when none answers
``GET /version`` — the driver is always present, never schedulable
without a live daemon (fingerprint.go semantics).
"""

from __future__ import annotations

import http.client
import json
import os
import socket
import time
from typing import Optional

from .drivers import (
    DriverError,
    TASK_STATE_DEAD,
    TASK_STATE_RUNNING,
    TaskDriver,
    TaskHandle,
)

DEFAULT_SOCKETS = (
    "/var/run/docker.sock",
    "/run/podman/podman.sock",
)


class _UnixHTTPConnection(http.client.HTTPConnection):
    """http.client over AF_UNIX (the Engine API listens on a socket,
    not TCP)."""

    def __init__(self, sock_path: str, timeout: float = 60.0):
        super().__init__("localhost", timeout=timeout)
        self._sock_path = sock_path

    def connect(self) -> None:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(self.timeout)
        s.connect(self._sock_path)
        self.sock = s


class ContainerAPI:
    """Minimal Engine API client: exactly the endpoints the driver's
    lifecycle needs."""

    def __init__(self, sock_path: str, timeout: float = 60.0):
        self.sock_path = sock_path
        self.timeout = timeout

    def _request(
        self,
        method: str,
        path: str,
        body: Optional[dict] = None,
        timeout: Optional[float] = None,
        raw: bool = False,
    ):
        conn = _UnixHTTPConnection(
            self.sock_path, timeout=timeout or self.timeout
        )
        try:
            data = json.dumps(body).encode() if body is not None else None
            headers = {"Content-Type": "application/json"} if data else {}
            conn.request(method, path, body=data, headers=headers)
            resp = conn.getresponse()
            payload = resp.read()
            if resp.status >= 400:
                try:
                    msg = json.loads(payload).get("message", "")
                except (ValueError, AttributeError):
                    msg = payload[:200].decode("utf-8", "replace")
                raise DriverError(
                    f"container daemon {method} {path}: "
                    f"{resp.status} {msg}"
                )
            if raw:
                return payload
            if not payload:
                return None
            try:
                return json.loads(payload)
            except ValueError:
                return payload
        finally:
            conn.close()

    def version(self) -> dict:
        return self._request("GET", "/version") or {}

    def pull(self, image: str) -> None:
        # POST /images/create streams progress; drain it
        self._request(
            "POST",
            f"/images/create?fromImage={image}",
            raw=True,
            timeout=600.0,
        )

    def create(self, spec: dict, name: str = "") -> str:
        q = f"?name={name}" if name else ""
        out = self._request("POST", f"/containers/create{q}", body=spec)
        return out["Id"]

    def start(self, cid: str) -> None:
        self._request("POST", f"/containers/{cid}/start")

    def wait(self, cid: str, timeout: Optional[float] = None) -> Optional[int]:
        try:
            out = self._request(
                "POST", f"/containers/{cid}/wait", timeout=timeout
            )
        except (socket.timeout, TimeoutError):
            return None
        except OSError as e:
            raise DriverError(f"container wait failed: {e}") from e
        return int(out.get("StatusCode", 0)) if out else 0

    def stop(self, cid: str, grace_s: float) -> None:
        self._request(
            "POST",
            f"/containers/{cid}/stop?t={int(grace_s)}",
            timeout=grace_s + 15.0,
        )

    def remove(self, cid: str) -> None:
        self._request("DELETE", f"/containers/{cid}?force=1&v=1")

    def inspect(self, cid: str) -> Optional[dict]:
        try:
            return self._request("GET", f"/containers/{cid}/json")
        except DriverError as e:
            if "404" in str(e):
                return None
            raise

    def logs(self, cid: str, stderr: bool = False) -> bytes:
        which = "stderr=1" if stderr else "stdout=1"
        return (
            self._request(
                "GET", f"/containers/{cid}/logs?{which}", raw=True
            )
            or b""
        )


def discover_socket() -> Optional[str]:
    env = os.environ.get("NOMAD_CONTAINER_SOCK")
    candidates = (env,) + DEFAULT_SOCKETS if env else DEFAULT_SOCKETS
    for path in candidates:
        if path and os.path.exists(path):
            return path
    return None


class ContainerDriver(TaskDriver):
    """drivers/docker analog over the Engine REST API."""

    name = "container"

    def __init__(self, sock_path: Optional[str] = None):
        self._sock_override = sock_path
        self._api: Optional[ContainerAPI] = None

    def _resolve_api(self) -> Optional[ContainerAPI]:
        if self._api is not None:
            return self._api
        path = self._sock_override or discover_socket()
        if path is None:
            return None
        self._api = ContainerAPI(path)
        return self._api

    @property
    def api(self) -> ContainerAPI:
        api = self._resolve_api()
        if api is None:
            raise DriverError(
                "no container daemon socket (set NOMAD_CONTAINER_SOCK or "
                "run docker/podman)"
            )
        return api

    def fingerprint(self) -> bool:
        api = self._resolve_api()
        if api is None:
            return False
        try:
            api.version()
            return True
        except (DriverError, OSError):
            # a vanished socket must re-resolve on the next probe
            self._api = None
            return False

    # -- lifecycle ---------------------------------------------------------
    def start(self, task, env, task_dir) -> TaskHandle:
        cfg = task.config or {}
        image = cfg.get("image")
        if not image:
            raise DriverError("container driver requires config['image']")
        cmd = []
        if cfg.get("command"):
            cmd = [cfg["command"]] + list(cfg.get("args", []))

        if cfg.get("force_pull") or cfg.get("pull", True):
            try:
                self.api.pull(image)
            except DriverError:
                # image may exist locally; create() is the authority
                pass

        res = getattr(task, "resources", None)
        host_config: dict = {
            # alloc/task dir visible in-container (docker/driver.go mounts)
            "Binds": [f"{task_dir}:/alloc"],
        }
        if res is not None:
            if getattr(res, "memory_mb", 0):
                host_config["Memory"] = int(res.memory_mb) * 1024 * 1024
            if getattr(res, "cpu", 0):
                # MHz ask → proportional NanoCpus share (1000 MHz ≈ 1 cpu)
                host_config["NanoCpus"] = int(res.cpu * 1e6)
        spec = {
            "Image": image,
            "Cmd": cmd or None,
            "Env": [f"{k}={v}" for k, v in (env or {}).items()],
            "WorkingDir": "/alloc",
            "HostConfig": host_config,
            "Labels": {
                "com.nomad-tpu.task": task.name,
            },
        }
        cid = self.api.create(spec, name=f"nomad-{task.name}-{os.getpid()}-{int(time.time()*1000) % 1_000_000}")
        try:
            self.api.start(cid)
        except DriverError:
            try:
                self.api.remove(cid)
            except DriverError:
                pass
            raise
        h = TaskHandle(id=cid, driver=self.name)
        h.meta["image"] = image
        h.meta["task_dir"] = task_dir
        h.meta["task_name"] = task.name
        return h

    def wait(self, handle, timeout=None):
        code = self.api.wait(handle.id, timeout=timeout)
        if code is None:
            return None
        handle.state = TASK_STATE_DEAD
        handle.exit_code = code
        handle.completed_at = time.time()
        self._drain_logs(handle)
        return code

    def stop(self, handle, kill_timeout=5.0):
        try:
            self.api.stop(handle.id, grace_s=kill_timeout)
        except DriverError:
            pass  # already stopped/removed
        st = self.api.inspect(handle.id)
        if st is not None:
            code = (st.get("State") or {}).get("ExitCode")
            handle.exit_code = int(code) if code is not None else None
            handle.state = TASK_STATE_DEAD
            handle.completed_at = time.time()
            self._drain_logs(handle)
        try:
            self.api.remove(handle.id)
        except DriverError:
            pass

    def inspect(self, handle: TaskHandle) -> TaskHandle:
        st = self.api.inspect(handle.id)
        if st is None:
            handle.state = TASK_STATE_DEAD
            return handle
        state = st.get("State") or {}
        if state.get("Running"):
            handle.state = TASK_STATE_RUNNING
        else:
            handle.state = TASK_STATE_DEAD
            code = state.get("ExitCode")
            handle.exit_code = int(code) if code is not None else None
        return handle

    def recover(self, handle: TaskHandle) -> bool:
        """Reattach by container id (docker/handle.go RecoverTask): the
        daemon outlives both the plugin subprocess and the client, so a
        restart re-binds to the same container — and an exit that
        happened while we were away still yields its REAL code."""
        st = self.api.inspect(handle.id)
        if st is None:
            return False
        state = st.get("State") or {}
        if state.get("Running"):
            handle.state = TASK_STATE_RUNNING
            handle.meta["recovered"] = True
            return True
        # exited while the client was down: report the true exit status
        code = state.get("ExitCode")
        handle.exit_code = int(code) if code is not None else None
        handle.state = TASK_STATE_DEAD
        handle.meta["recovered"] = True
        self._drain_logs(handle)
        return True

    # -- helpers -----------------------------------------------------------
    @staticmethod
    def _demux_log_stream(data: bytes) -> bytes:
        """Strip the Engine's stdcopy multiplexing, if present.

        A non-TTY container's log endpoint returns stdcopy frames:
        ``[stream_type, 0, 0, 0, len_be32][payload]``. Writing that raw
        into the task's log files would interleave 8-byte binary headers
        with the output. A TTY container (and some daemons) return raw
        bytes — so only strip when the ENTIRE buffer walks cleanly as
        frames (raw output that happens to start with 0x00-0x02 is
        astronomically unlikely to frame-walk to an exact end)."""
        out = []
        i = 0
        n = len(data)
        while i + 8 <= n:
            if data[i] not in (0, 1, 2) or data[i + 1 : i + 4] != b"\x00\x00\x00":
                return data  # not framed
            ln = int.from_bytes(data[i + 4 : i + 8], "big")
            if i + 8 + ln > n:
                return data  # truncated/not framed
            out.append(data[i + 8 : i + 8 + ln])
            i += 8 + ln
        if i != n:
            return data
        return b"".join(out)

    def _drain_logs(self, handle: TaskHandle) -> None:
        """Copy daemon-held logs into the task dir so fs/logs endpoints
        serve container output like any exec task's."""
        task_dir = handle.meta.get("task_dir")
        task_name = handle.meta.get("task_name")
        if not task_dir or not task_name or not os.path.isdir(task_dir):
            return
        for is_err, suffix in ((False, "stdout"), (True, "stderr")):
            try:
                data = self.api.logs(handle.id, stderr=is_err)
            except (DriverError, OSError):
                continue
            if not data:
                continue
            data = self._demux_log_stream(data)
            path = os.path.join(task_dir, f"{task_name}.{suffix}")
            try:
                with open(path, "ab") as f:
                    f.write(data)
            except OSError:
                pass
