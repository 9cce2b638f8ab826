"""Task drivers — the execution plugins.

Reference: the TaskDriver gRPC contract (plugins/drivers/driver.go,
plugins/drivers/proto/driver.proto: Start/Wait/Stop/Inspect/Recover) and
the built-in drivers (drivers/{mock,rawexec,exec}). The contract here is
the same shape, in-process for the built-ins; out-of-process gRPC plugins
slot in behind the same ``TaskDriver`` interface (the executor subprocess
the reference re-execs, drivers/shared/executor, maps to the C++ executor
planned for the native runtime layer).

- ``mock_driver``: deterministic fake (run_for / exit_code / start_error)
  — the workhorse of client tests, mirroring drivers/mock.
- ``raw_exec`` / ``exec``: fork/exec of task.config["command"]+["args"]
  with env + alloc dir plumbing. (``exec`` currently shares raw_exec's
  no-isolation path; chroot/cgroup isolation is the C++ executor's job.)
"""

from __future__ import annotations

import os
import resource as _resource  # imported pre-fork: preexec_fn must not import
import shutil
import signal
import subprocess
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Optional

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_EXECUTOR_SRC = os.path.join(_REPO_ROOT, "native", "executor.cpp")
_EXECUTOR_BIN = os.path.join(_REPO_ROOT, "build", "nomad_tpu_torch", "executor")
_executor_checked = False
_executor_lock = threading.Lock()


def native_executor() -> Optional[str]:
    """Path to the C++ task supervisor (the repo's native/executor.cpp —
    the drivers/shared/executor analog), built lazily with ``g++`` into
    ``build/nomad_tpu_torch/`` like the WAL store (``native/wal.py``,
    same serialized-build discipline: a concurrent caller must never exec
    a half-linked binary). None when the toolchain is unavailable
    (pure-Python isolation then applies)."""
    global _executor_checked
    src = _EXECUTOR_SRC
    with _executor_lock:
        if not _executor_checked:
            if os.path.exists(src) and (
                not os.path.exists(_EXECUTOR_BIN)
                or os.path.getmtime(_EXECUTOR_BIN) < os.path.getmtime(src)
            ):
                try:
                    os.makedirs(os.path.dirname(_EXECUTOR_BIN), exist_ok=True)
                    # built beside its final name and renamed into place;
                    # the pid keeps two processes' builds apart
                    tmp = f"{_EXECUTOR_BIN}.{os.getpid()}.tmp"
                    subprocess.run(
                        ["g++", "-O2", "-std=c++17", "-Wall", "-o", tmp, src],
                        check=True,
                        capture_output=True,
                        timeout=120,
                    )
                    os.replace(tmp, _EXECUTOR_BIN)
                except Exception:
                    # cache the failure: re-attempting a broken build on
                    # every task start would stall starts behind the lock
                    _executor_checked = True
                    return None
            _executor_checked = True
        return _EXECUTOR_BIN if os.path.exists(_EXECUTOR_BIN) else None


def _proc_start_time(pid: int):
    """Kernel start time (clock ticks since boot) from /proc — the
    identity that distinguishes a live task from a recycled PID."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            data = f.read()
        # field 22, counting from 1 after the parenthesized comm
        return int(data.rsplit(b")", 1)[1].split()[19])
    except (OSError, ValueError, IndexError):
        return None


TASK_STATE_PENDING = "pending"
TASK_STATE_RUNNING = "running"
TASK_STATE_DEAD = "dead"


@dataclass
class TaskHandle:
    """Reattachable task handle (plugins/drivers/task_handle.go)."""

    id: str
    driver: str
    pid: int = 0
    state: str = TASK_STATE_RUNNING
    exit_code: Optional[int] = None
    started_at: float = field(default_factory=time.time)
    completed_at: float = 0.0
    meta: dict = field(default_factory=dict)


class DriverError(Exception):
    pass


class TaskDriver:
    name = "base"

    def fingerprint(self) -> bool:
        return True

    def start(self, task, env: dict, task_dir: str) -> TaskHandle:
        raise NotImplementedError

    def wait(self, handle: TaskHandle, timeout: Optional[float] = None) -> Optional[int]:
        """Block until exit; returns exit code (None on timeout)."""
        raise NotImplementedError

    def stop(self, handle: TaskHandle, kill_timeout: float = 5.0) -> None:
        raise NotImplementedError

    def inspect(self, handle: TaskHandle) -> TaskHandle:
        return handle

    def recover(self, handle: TaskHandle) -> bool:
        """Re-attach to a task that survived a client restart
        (plugins/drivers/task_handle.go reattach tokens; client/state
        restore path task_runner.go:488-519). Returns False when the task
        cannot be recovered (caller restarts it per policy)."""
        return False


class MockDriver(TaskDriver):
    """drivers/mock: configurable timing/failure knobs via task.config:
    run_for (s), exit_code, start_error, start_block_for (s)."""

    name = "mock_driver"

    def __init__(self):
        self._events: dict[str, threading.Event] = {}
        self._handles: dict[str, TaskHandle] = {}

    def start(self, task, env, task_dir) -> TaskHandle:
        cfg = task.config or {}
        if cfg.get("start_error"):
            raise DriverError(str(cfg["start_error"]))
        if cfg.get("start_block_for"):
            time.sleep(float(cfg["start_block_for"]))
        h = TaskHandle(id=str(uuid.uuid4()), driver=self.name)
        h.meta["run_for"] = float(cfg.get("run_for", 0.0))
        h.meta["exit_code"] = int(cfg.get("exit_code", 0))
        h.meta["deadline"] = h.started_at + h.meta["run_for"]
        self._events[h.id] = threading.Event()
        self._handles[h.id] = h
        return h

    def wait(self, handle, timeout=None):
        remaining = handle.meta["deadline"] - time.time()
        stop_evt = self._events.get(handle.id)
        waited = stop_evt.wait(max(remaining, 0)) if stop_evt else False
        if timeout is not None and remaining > timeout:
            return None
        handle.state = TASK_STATE_DEAD
        handle.completed_at = time.time()
        handle.exit_code = 130 if waited else handle.meta["exit_code"]
        return handle.exit_code

    def stop(self, handle, kill_timeout=5.0):
        evt = self._events.get(handle.id)
        if evt:
            evt.set()


class RawExecDriver(TaskDriver):
    """drivers/rawexec: no isolation, direct fork/exec."""

    name = "raw_exec"

    def __init__(self):
        self._procs: dict[str, subprocess.Popen] = {}

    def fingerprint(self) -> bool:
        return os.name == "posix"

    def start(self, task, env, task_dir) -> TaskHandle:
        cfg = task.config or {}
        command = cfg.get("command")
        if not command:
            raise DriverError("raw_exec requires config['command']")
        argv = [command] + list(cfg.get("args", []))
        stdout = open(os.path.join(task_dir, f"{task.name}.stdout"), "ab")
        stderr = open(os.path.join(task_dir, f"{task.name}.stderr"), "ab")
        try:
            proc = subprocess.Popen(
                argv,
                cwd=task_dir,
                env={**os.environ, **env},
                stdout=stdout,
                stderr=stderr,
                start_new_session=True,  # own process group for clean kill
            )
        except OSError as e:
            raise DriverError(f"failed to exec {command}: {e}") from e
        finally:
            stdout.close()
            stderr.close()
        h = TaskHandle(id=str(uuid.uuid4()), driver=self.name, pid=proc.pid)
        h.meta["proc_start"] = _proc_start_time(proc.pid)
        self._procs[h.id] = proc
        return h

    def recover(self, handle: TaskHandle) -> bool:
        """Re-attach by pid + kernel start time: a recycled PID must not
        re-attach to (and later SIGTERM) an unrelated process. (The
        reference re-attaches to its executor subprocess, which owns the
        child and its eventual exit status; without an owning process a
        recovered task's exit code is unobservable and reads as 0.)"""
        if handle.pid <= 0:
            return False
        try:
            os.kill(handle.pid, 0)
        except (ProcessLookupError, PermissionError):
            return False
        want = handle.meta.get("proc_start")
        if want is not None and _proc_start_time(handle.pid) != want:
            return False  # same pid, different process: recycled
        handle.meta["recovered"] = True
        return True

    def wait(self, handle, timeout=None):
        proc = self._procs.get(handle.id)
        if proc is None:
            if handle.meta.get("recovered") and handle.pid > 0:
                # not our child: poll for process-group exit
                deadline = None if timeout is None else time.time() + timeout
                while True:
                    try:
                        os.kill(handle.pid, 0)
                    except ProcessLookupError:
                        handle.state = TASK_STATE_DEAD
                        handle.exit_code = 0  # unobservable post-reattach
                        handle.completed_at = time.time()
                        return 0
                    if deadline is not None and time.time() >= deadline:
                        return None
                    time.sleep(0.1)
            return handle.exit_code
        try:
            code = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            return None
        handle.state = TASK_STATE_DEAD
        handle.exit_code = code
        handle.completed_at = time.time()
        return code

    def stop(self, handle, kill_timeout=5.0):
        proc = self._procs.get(handle.id)
        if proc is None:
            if handle.meta.get("recovered") and handle.pid > 0:
                try:
                    os.killpg(handle.pid, signal.SIGTERM)
                except (ProcessLookupError, PermissionError):
                    pass
            return
        if proc.poll() is not None:
            return
        try:
            os.killpg(proc.pid, signal.SIGTERM)
        except ProcessLookupError:
            return
        try:
            proc.wait(timeout=kill_timeout)
        except subprocess.TimeoutExpired:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass


class ExecDriver(RawExecDriver):
    """drivers/exec — isolated execution.

    The reference's exec driver runs tasks under a libcontainer-based
    executor subprocess (drivers/shared/executor: chroot, cgroups,
    namespaces). This build applies the portable subset of that
    isolation in-process: own session (setsid, inherited from raw_exec's
    start_new_session), resource rlimits derived from the task's
    resource ask (address space from memory_mb, no core dumps, bounded
    fd/proc counts), and a scrubbed environment — the task sees only its
    Nomad env plus a minimal PATH, not the agent's environment.
    cgroup/chroot confinement belongs to the native executor layer."""

    name = "exec"

    def start(self, task, env, task_dir) -> TaskHandle:
        cfg = task.config or {}
        command = cfg.get("command")
        if not command:
            raise DriverError("exec requires config['command']")
        argv = [command] + list(cfg.get("args", []))
        mem_mb = 256
        res = getattr(task, "resources", None)
        if res is not None and getattr(res, "memory_mb", 0):
            mem_mb = int(res.memory_mb)

        supervisor = native_executor()
        if supervisor:
            return self._start_supervised(
                supervisor, task, argv, env, task_dir, mem_mb
            )

        def _isolate():
            # post-fork pre-exec: no imports, no locks (the agent is
            # multithreaded; only async-signal-safe-ish work is allowed)
            rl = _resource
            # headroom over the ask: AS counts virtual, not resident,
            # memory — a tight bound would kill interpreters at startup
            limit = (mem_mb + 512) * 1024 * 1024
            rl.setrlimit(rl.RLIMIT_AS, (limit, limit))
            rl.setrlimit(rl.RLIMIT_CORE, (0, 0))
            try:
                rl.setrlimit(rl.RLIMIT_NPROC, (512, 512))
            except (ValueError, OSError):
                pass  # lower hard limit already in place

        stdout = open(os.path.join(task_dir, f"{task.name}.stdout"), "ab")
        stderr = open(os.path.join(task_dir, f"{task.name}.stderr"), "ab")
        try:
            proc = subprocess.Popen(
                argv,
                cwd=task_dir,
                env={
                    "PATH": "/usr/local/bin:/usr/bin:/bin",
                    "HOME": task_dir,
                    "TMPDIR": task_dir,
                    **env,
                },
                stdout=stdout,
                stderr=stderr,
                start_new_session=True,
                preexec_fn=_isolate,
            )
        except OSError as e:
            raise DriverError(f"failed to exec {command}: {e}") from e
        finally:
            stdout.close()
            stderr.close()
        h = TaskHandle(id=str(uuid.uuid4()), driver=self.name, pid=proc.pid)
        h.meta["proc_start"] = _proc_start_time(proc.pid)
        self._procs[h.id] = proc
        return h

    # -- native supervisor path (drivers/shared/executor analog) ----------
    def _start_supervised(
        self, supervisor, task, argv, env, task_dir, mem_mb
    ) -> TaskHandle:
        """Run through the C++ executor: it owns the task child, applies
        the isolation, and records the exit status durably, so re-attach
        after an agent restart observes real exit codes."""
        status_file = os.path.join(task_dir, f"{task.name}.status")
        # a prior run of the same task left its record at the same path;
        # it must never be read as THIS run's status
        try:
            os.unlink(status_file)
        except OSError:
            pass
        grace = int(getattr(task, "kill_timeout_s", 5.0) or 5.0)
        handle_id = str(uuid.uuid4())
        extra: list[str] = []
        # per-task cgroup (drivers/shared/executor cgroup confinement):
        # only meaningful when this process may create cgroups — probe
        # once per driver instance
        if self._cgroups_available():
            extra += ["--cgroup", handle_id[:18]]
            res = getattr(task, "resources", None)
            if res is not None and getattr(res, "cpu", 0):
                extra += ["--cpu-mhz", str(int(res.cpu))]
        try:
            proc = subprocess.Popen(
                [
                    supervisor,
                    task_dir,
                    os.path.join(task_dir, f"{task.name}.stdout"),
                    os.path.join(task_dir, f"{task.name}.stderr"),
                    status_file,
                    str(mem_mb),
                    str(grace),
                ]
                + extra
                + ["--"]
                + argv,
                cwd=task_dir,
                env={
                    "PATH": "/usr/local/bin:/usr/bin:/bin",
                    "HOME": task_dir,
                    "TMPDIR": task_dir,
                    **env,
                },
                stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL,
                start_new_session=True,
            )
        except OSError as e:
            raise DriverError(f"failed to exec supervisor: {e}") from e
        h = TaskHandle(id=handle_id, driver=self.name, pid=proc.pid)
        h.meta["proc_start"] = _proc_start_time(proc.pid)
        h.meta["status_file"] = status_file
        h.meta["supervised"] = True
        h.meta["grace_s"] = float(grace)
        self._procs[h.id] = proc
        return h

    @staticmethod
    def _cgroups_available() -> bool:
        """Can this agent create task cgroups? v2 unified with memory
        delegated, or v1 memory hierarchy, writable by us."""
        try:
            with open("/sys/fs/cgroup/cgroup.controllers") as f:
                if "memory" in f.read():
                    return os.access("/sys/fs/cgroup", os.W_OK)
        except OSError:
            pass
        return os.access("/sys/fs/cgroup/memory", os.W_OK)

    def _read_status_raw(self, handle) -> tuple[str, Optional[int], Optional[int]]:
        """The supervisor's durable status record:
        ('running', child_pid, child_start_ticks) or ('exit', code, None)
        or ('', None, None) when absent/unreadable."""
        try:
            with open(handle.meta["status_file"]) as f:
                parts = f.read().strip().split()
            word = parts[0]
            val = int(parts[1])
            extra = int(parts[2]) if len(parts) > 2 else None
            return word, val, extra
        except (OSError, KeyError, ValueError, IndexError):
            return "", None, None

    def _read_status(self, handle) -> Optional[int]:
        word, val, _ = self._read_status_raw(handle)
        return val if word == "exit" else None

    def recover(self, handle: TaskHandle) -> bool:
        if handle.meta.get("supervised"):
            # supervisor alive → live re-attach; dead → the status file
            # still tells us how the task ended (the durability the
            # reference gets from its executor process, task_handle.go)
            if super().recover(handle):
                return True
            word, val, start_ticks = self._read_status_raw(handle)
            if word == "exit":
                handle.state = TASK_STATE_DEAD
                handle.exit_code = val
                handle.completed_at = handle.completed_at or time.time()
                handle.meta["recovered"] = True
                return True
            if word == "running" and val:
                # supervisor died out from under a live task: reap the
                # orphan before the restart policy launches a fresh copy
                # (two concurrent runs of the workload otherwise) — but
                # ONLY if the pid still belongs to that task (a recycled
                # pid must never be signalled; the supervisor recorded
                # the child's kernel start time for exactly this check —
                # records without usable ticks fall back to a liveness
                # check, accepting the small recycled-pid risk over a
                # guaranteed dual-run of the workload)
                now_ticks = _proc_start_time(val)
                if now_ticks is not None and (
                    not start_ticks or now_ticks == start_ticks
                ):
                    try:
                        os.killpg(val, signal.SIGKILL)
                    except (ProcessLookupError, PermissionError):
                        pass
            return False
        return super().recover(handle)

    def wait(self, handle, timeout=None):
        if not handle.meta.get("supervised"):
            return super().wait(handle, timeout)
        if handle.state == TASK_STATE_DEAD:
            return handle.exit_code
        proc = self._procs.get(handle.id)
        if proc is not None:
            try:
                code = proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                return None
            # the supervisor exits with the child's code; prefer the
            # status file (survives supervisor signals)
            rec = self._read_status(handle)
            code = rec if rec is not None else code
            handle.state = TASK_STATE_DEAD
            handle.exit_code = code
            handle.completed_at = time.time()
            return code
        # re-attached: poll the status file while the supervisor lives
        deadline = None if timeout is None else time.time() + timeout
        while True:
            code = self._read_status(handle)
            if code is not None:
                handle.state = TASK_STATE_DEAD
                handle.exit_code = code
                handle.completed_at = time.time()
                return code
            try:
                os.kill(handle.pid, 0)
            except ProcessLookupError:
                # the supervisor may have written its exit record in the
                # window between the read above and this probe
                code = self._read_status(handle)
                handle.state = TASK_STATE_DEAD
                handle.exit_code = (
                    code if code is not None else (handle.exit_code or 0)
                )
                handle.completed_at = handle.completed_at or time.time()
                return handle.exit_code
            if deadline is not None and time.time() >= deadline:
                return None
            time.sleep(0.1)

    def stop(self, handle, kill_timeout=5.0):
        if not handle.meta.get("supervised"):
            return super().stop(handle, kill_timeout)
        if handle.state == TASK_STATE_DEAD:
            return  # already terminal (e.g. recovered via status record)
        proc = self._procs.get(handle.id)
        if proc is None:
            # re-attached: verify pid identity before signalling — the
            # recorded pid may have been recycled by an unrelated process
            want = handle.meta.get("proc_start")
            if want is None or _proc_start_time(handle.pid) != want:
                return
        # SIGTERM the supervisor; it forwards to the task's process group
        # with the configured grace period (executor.cpp forward_term)
        try:
            os.kill(handle.pid, signal.SIGTERM)
        except (ProcessLookupError, PermissionError):
            return
        grace = max(kill_timeout, handle.meta.get("grace_s", 5.0)) + 6.0
        proc = self._procs.get(handle.id)
        if proc is not None:
            try:
                proc.wait(timeout=grace)
            except subprocess.TimeoutExpired:
                self._hard_kill_supervised(handle)
        else:
            deadline = time.time() + grace
            while time.time() < deadline:
                # the durable status record is authoritative — the pid
                # may linger as a zombie under another holder
                if self._read_status(handle) is not None:
                    return
                try:
                    os.kill(handle.pid, 0)
                except ProcessLookupError:
                    return
                time.sleep(0.1)
            self._hard_kill_supervised(handle)

    def _hard_kill_supervised(self, handle) -> None:
        """Escalation targets the TASK's process group (from the status
        record) — SIGKILLing only the supervisor would orphan a live
        child in its own session and freeze the status at 'running'."""
        word, val, start_ticks = self._read_status_raw(handle)
        if word == "running" and val and (
            not start_ticks or _proc_start_time(val) == start_ticks
        ):
            try:
                os.killpg(val, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
        try:
            os.kill(handle.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass


class JavaDriver(ExecDriver):
    """drivers/java — JVM workloads under the shared executor.

    The reference driver (drivers/java/driver.go) synthesizes the java
    argv from the task config and hands it to the isolated executor; so
    does this one: ``jar_path`` (→ ``-jar``) or ``class``/``class_path``
    (→ ``-cp``), plus ``jvm_options`` and ``args``. JVM heap defaults to
    the task's memory ask (-Xmx) as the reference does."""

    name = "java"

    def fingerprint(self) -> bool:
        return shutil.which("java") is not None

    def start(self, task, env, task_dir) -> TaskHandle:
        import copy

        cfg = task.config or {}
        java = shutil.which("java")
        if java is None:
            raise DriverError("java runtime not found")
        # absolute path: the executor runs tasks with a scrubbed PATH
        argv = [java]
        res = getattr(task, "resources", None)
        if res is not None and getattr(res, "memory_mb", 0):
            # heap gets ~80% of the ask, capped at ask−32MB: the
            # executor's cgroup limit is the FULL ask, and heap == limit
            # leaves no room for metaspace/stacks — the kernel would
            # SIGKILL instead of the JVM raising OutOfMemoryError
            mem = int(res.memory_mb)
            heap = max(32, min(int(mem * 0.8), mem - 32))
            argv.append(f"-Xmx{heap}m")
        argv += list(cfg.get("jvm_options", []))
        if cfg.get("jar_path"):
            argv += ["-jar", cfg["jar_path"]]
        elif cfg.get("class"):
            if cfg.get("class_path"):
                argv += ["-cp", cfg["class_path"]]
            argv.append(cfg["class"])
        else:
            raise DriverError(
                "java requires config['jar_path'] or config['class']"
            )
        argv += list(cfg.get("args", []))
        synth = copy.copy(task)
        synth.config = {"command": argv[0], "args": argv[1:]}
        return super().start(synth, env, task_dir)


class QemuDriver(ExecDriver):
    """drivers/qemu — VM images under the shared executor.

    The reference (drivers/qemu/driver.go) execs qemu-system-x86_64 with
    the image, the task's memory ask, -nographic, and optional
    accelerator/port args; the VM process is supervised exactly like any
    exec task (the executor's cgroup/rlimit bounds apply to the VMM)."""

    name = "qemu"
    QEMU_BIN = "qemu-system-x86_64"

    def fingerprint(self) -> bool:
        return shutil.which(self.QEMU_BIN) is not None

    def start(self, task, env, task_dir) -> TaskHandle:
        import copy

        cfg = task.config or {}
        image = cfg.get("image_path")
        if not image:
            raise DriverError("qemu requires config['image_path']")
        mem_mb = 512
        res = getattr(task, "resources", None)
        if res is not None and getattr(res, "memory_mb", 0):
            mem_mb = int(res.memory_mb)
        # guest RAM below the cgroup cap: the VMM's own overhead
        # (~100-200MB) rides inside the same limit; small asks keep a
        # proportional margin instead of a fixed floor that would eat
        # the whole cap
        guest_mb = (
            mem_mb - 128 if mem_mb >= 256 else max(32, mem_mb // 2)
        )
        qemu = shutil.which(self.QEMU_BIN)
        if qemu is None:
            raise DriverError(f"{self.QEMU_BIN} not found")
        argv = [
            qemu,  # absolute: the executor scrubs PATH
            "-machine", "type=pc,accel=" + cfg.get("accelerator", "tcg"),
            "-m", f"{guest_mb}M",
            "-drive", f"file={image}",
            "-nographic",
        ]
        argv += list(cfg.get("args", []))
        synth = copy.copy(task)
        synth.config = {"command": argv[0], "args": argv[1:]}
        return super().start(synth, env, task_dir)


def builtin_drivers() -> dict[str, TaskDriver]:
    """The in-process driver catalog (helper/pluginutils/catalog analog)."""
    from .container import ContainerDriver

    return {
        d.name: d
        for d in (
            MockDriver(),
            RawExecDriver(),
            ExecDriver(),
            ContainerDriver(),
            JavaDriver(),
            QemuDriver(),
        )
    }
