"""TaskRunner — per-task lifecycle state machine.

Reference: client/allocrunner/taskrunner/task_runner.go (the MAIN/RESTART
loop :480-640): prestart hooks → driver start → wait → restart decision
per RestartPolicy (attempts within interval, delay, fail/delay modes) →
terminal state. Hook phases are collapsed to env build + task dir here;
artifact/template/vault hooks attach in later layers.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from ..structs import Task
from ..structs.job import RestartPolicy
from .drivers import DriverError, TaskDriver, TaskHandle

TASK_EVENT_STARTED = "Started"
TASK_EVENT_TERMINATED = "Terminated"
TASK_EVENT_RESTARTING = "Restarting"
TASK_EVENT_NOT_RESTARTING = "Not Restarting"
TASK_EVENT_DRIVER_ERROR = "Driver Failure"
TASK_EVENT_KILLING = "Killing"


@dataclass
class TaskEvent:
    type: str
    time_unix: float = field(default_factory=time.time)
    message: str = ""
    exit_code: Optional[int] = None


@dataclass
class TaskState:
    """structs.TaskState: the client-reported per-task status."""

    state: str = "pending"  # pending | running | dead
    failed: bool = False
    restarts: int = 0
    events: list[TaskEvent] = field(default_factory=list)
    started_at: float = 0.0
    finished_at: float = 0.0

    def record(self, ev: TaskEvent) -> None:
        self.events.append(ev)
        if len(self.events) > 10:  # bounded event history
            self.events = self.events[-10:]


class TaskRunner:
    def __init__(
        self,
        task: Task,
        driver: TaskDriver,
        task_dir: str,
        env: dict[str, str],
        restart_policy: Optional[RestartPolicy] = None,
        on_state_change=None,
        attach_handle: Optional[TaskHandle] = None,
        on_handle=None,
    ):
        self.task = task
        self.driver = driver
        self.task_dir = task_dir
        self.env = env
        self.restart_policy = restart_policy or RestartPolicy()
        self.state = TaskState()
        self.handle: Optional[TaskHandle] = None
        self.on_state_change = on_state_change
        # restore path (task_runner.go:488-519): a persisted handle the
        # driver successfully recovered — skip the first driver.start
        self.attach_handle = attach_handle
        self.on_handle = on_handle  # persists handles for restart restore
        self._kill = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._restart_times: list[float] = []

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(
            target=self.run, name=f"task-{self.task.name}", daemon=True
        )
        self._thread.start()

    def kill(self, timeout: float = 5.0) -> None:
        self._kill.set()
        self.state.record(TaskEvent(TASK_EVENT_KILLING))
        if self.handle is not None:
            self.driver.stop(self.handle, kill_timeout=self.task.kill_timeout_s)
        if self._thread is not None:
            self._thread.join(timeout=timeout + 1)

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    # -- main loop (task_runner.go:480 MAIN) -------------------------------
    def run(self) -> None:
        os.makedirs(self.task_dir, exist_ok=True)
        while not self._kill.is_set():
            if self.attach_handle is not None:
                self.handle = self.attach_handle
                self.attach_handle = None  # restarts go through start()
            else:
                try:
                    self.handle = self.driver.start(
                        self.task, self._task_env(), self.task_dir
                    )
                except DriverError as e:
                    self.state.record(
                        TaskEvent(TASK_EVENT_DRIVER_ERROR, message=str(e))
                    )
                    if not self._should_restart(failed=True):
                        break
                    continue
            if self.on_handle is not None and self.handle is not None:
                self.on_handle(self.task.name, self.handle)

            self.state.state = "running"
            self.state.started_at = self.state.started_at or time.time()
            self.state.record(TaskEvent(TASK_EVENT_STARTED))
            self._notify()

            exit_code = self.driver.wait(self.handle)
            self.state.record(
                TaskEvent(TASK_EVENT_TERMINATED, exit_code=exit_code)
            )
            if self._kill.is_set():
                break
            if exit_code == 0:
                self.state.failed = False
                break
            if not self._should_restart(failed=True):
                break

        self.state.state = "dead"
        self.state.finished_at = time.time()
        # a deliberately killed task (stop/drain) is not a failure —
        # mirrors task_runner.go's kill-vs-fail distinction
        if (
            not self._kill.is_set()
            and self.state.events
            and self.state.events[-1].type == TASK_EVENT_TERMINATED
            and self.state.events[-1].exit_code not in (0, None)
        ):
            self.state.failed = True
        self._notify()

    def _task_env(self) -> dict[str, str]:
        """Task env interpolation (client/taskenv)."""
        env = dict(self.env)
        env.update(self.task.env)
        env["NOMAD_TASK_NAME"] = self.task.name
        env["NOMAD_TASK_DIR"] = os.path.join(self.task_dir, "local")
        os.makedirs(env["NOMAD_TASK_DIR"], exist_ok=True)
        return env

    def _should_restart(self, failed: bool) -> bool:
        """RestartPolicy window check (task_runner.go restart tracking):
        up to ``attempts`` restarts per ``interval``; mode=fail ⇒ give up,
        mode=delay ⇒ wait out the interval."""
        pol = self.restart_policy
        now = time.time()
        window_start = now - pol.interval_s
        self._restart_times = [t for t in self._restart_times if t >= window_start]
        if len(self._restart_times) >= pol.attempts:
            if pol.mode == "delay":
                self.state.record(
                    TaskEvent(TASK_EVENT_RESTARTING, message="delaying past window")
                )
                if self._kill.wait(pol.interval_s):
                    return False
                self._restart_times.clear()
            else:
                self.state.record(TaskEvent(TASK_EVENT_NOT_RESTARTING))
                self.state.failed = True
                return False
        self._restart_times.append(now)
        self.state.restarts += 1
        self.state.record(TaskEvent(TASK_EVENT_RESTARTING))
        if self._kill.wait(pol.delay_s):
            return False
        return True

    def _notify(self) -> None:
        if self.on_state_change is not None:
            self.on_state_change(self.task.name, self.state)
