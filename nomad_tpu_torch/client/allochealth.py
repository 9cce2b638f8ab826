"""Alloc health tracking — client/allochealth's Tracker analog.

Reference: client/allochealth/tracker.go — watches task states AND
service check results and sets ``DeploymentStatus.Healthy``, which the
deployment watcher consumes for canary auto-promotion / auto-revert
(nomad/deploymentwatcher). Without it, "running" is the only health bar
and a crash-looping-but-restarting task passes canary gates.

Semantics matched to the reference:

- healthy ⇔ every task is ``running`` AND every check has been passing
  CONTINUOUSLY for ``min_healthy_time`` (tracker.go's healthy timer);
- any task restart or check failure RESETS the clock (a flapping task
  never accumulates the window);
- a task reaching ``dead`` (restarts exhausted), or the
  ``healthy_deadline`` expiring before the window completes, reports
  UNHEALTHY — terminal for this alloc's deployment health (the reference
  only flips healthy→unhealthy on failure, never back);
- checks: tcp connect / http GET (2xx-3xx) / script exit-0 — evaluated
  in-process (the reference delegates to Consul; this build has no
  Consul, matching SURVEY's de-scope, so the client evaluates directly).

The tracker reports through a callback the client wires into its alloc
sync batch — the health verdict rides the same Node.UpdateAlloc path as
task states, and the FSM merges it onto the server copy
(state/store.update_allocs_from_client).
"""

from __future__ import annotations

import http.client
import socket
import subprocess
import threading
import time
from typing import Callable, Optional

POLL_INTERVAL = 0.2


def evaluate_check(check) -> bool:
    """One check evaluation. Returns True when passing."""
    try:
        if check.type == "tcp":
            with socket.create_connection(
                (check.address, check.port), timeout=check.timeout_s
            ):
                return True
        if check.type == "http":
            conn = http.client.HTTPConnection(
                check.address, check.port, timeout=check.timeout_s
            )
            try:
                conn.request("GET", check.path or "/")
                resp = conn.getresponse()
                resp.read()
                return 200 <= resp.status < 400
            finally:
                conn.close()
        if check.type == "script":
            out = subprocess.run(
                [check.command] + list(check.args),
                timeout=check.timeout_s,
                stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL,
            )
            return out.returncode == 0
    except (OSError, subprocess.TimeoutExpired, ValueError):
        return False
    return False


def group_checks(job, group_name: str) -> list:
    tg = job.lookup_task_group(group_name) if job else None
    if tg is None:
        return []
    out = []
    for task in tg.tasks:
        for svc in getattr(task, "services", None) or []:
            out.extend(svc.checks or [])
    return out


class AllocHealthTracker:
    """Watches one alloc runner until a health verdict is reached."""

    def __init__(
        self,
        runner,
        update_strategy,
        on_health: Callable[[str, bool], None],
        min_healthy_time_s: Optional[float] = None,
        healthy_deadline_s: Optional[float] = None,
    ):
        self.runner = runner
        self.alloc = runner.alloc
        self.checks = group_checks(self.alloc.job, self.alloc.task_group)
        self.on_health = on_health
        u = update_strategy
        self.min_healthy = (
            min_healthy_time_s
            if min_healthy_time_s is not None
            else (u.min_healthy_time_s if u else 10.0)
        )
        self.deadline = (
            healthy_deadline_s
            if healthy_deadline_s is not None
            else (u.healthy_deadline_s if u else 300.0)
        )
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.result: Optional[bool] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run,
            name=f"allochealth-{self.alloc.id[:8]}",
            daemon=True,
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def join(self, timeout=None) -> None:
        if self._thread:
            self._thread.join(timeout)

    # -- internals ---------------------------------------------------------
    def _tasks_running(self) -> tuple[bool, bool, int]:
        """(all_running, any_dead, total_restarts) from the runner's live
        task states."""
        states = self.runner.task_states
        if not states:
            return False, False, 0
        all_running = all(s.state == "running" for s in states.values())
        any_dead = any(
            s.state == "dead" and s.failed for s in states.values()
        )
        restarts = sum(s.restarts for s in states.values())
        return all_running, any_dead, restarts

    def _checks_pass(self) -> bool:
        return all(evaluate_check(c) for c in self.checks)

    def _run(self) -> None:
        deadline = time.time() + self.deadline
        window_start: Optional[float] = None
        baseline_restarts = 0
        next_check_at = 0.0
        checks_ok = not self.checks
        check_interval = min(
            [c.interval_s for c in self.checks] or [1.0]
        )
        while not self._stop.is_set():
            now = time.time()
            all_running, any_dead, restarts = self._tasks_running()
            if any_dead:
                return self._report(False)
            if now >= next_check_at and self.checks:
                checks_ok = self._checks_pass()
                next_check_at = now + check_interval
            if all_running and checks_ok:
                if window_start is None:
                    window_start = now
                    baseline_restarts = restarts
                elif restarts != baseline_restarts:
                    # a restart mid-window: flapping — start over
                    window_start = now
                    baseline_restarts = restarts
                elif now - window_start >= self.min_healthy:
                    return self._report(True)
            else:
                window_start = None  # failure resets the clock
            if now >= deadline:
                return self._report(False)
            self._stop.wait(POLL_INTERVAL)

    def _report(self, healthy: bool) -> None:
        self.result = healthy
        try:
            self.on_health(self.alloc.id, healthy)
        except Exception:  # pragma: no cover — callback owns its errors
            import logging

            logging.getLogger(__name__).exception(
                "alloc health callback failed"
            )
