"""Periodic dispatcher — cron-style job launching (leader-only).

Reference: nomad/periodic.go (PeriodicDispatch): tracks registered
periodic jobs, sleeps until the next launch time, derives a child job
``<parent>/periodic-<epoch>`` and registers it, honoring
prohibit_overlap. Restored from durable state on leadership
(leader.go:287).
"""

from __future__ import annotations

import copy
import threading
import time
from typing import Optional

from ..structs import Job
from ..utils.cron import Cron, CronParseError


class PeriodicDispatch:
    def __init__(self, server, tick: float = 0.5):
        self.server = server
        self.tick = tick
        self._tracked: dict[tuple[str, str], tuple[Job, Cron]] = {}
        self._next_launch: dict[tuple[str, str], float] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="periodic-dispatch", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)

    # -- tracking ----------------------------------------------------------
    def add(self, job: Job) -> None:
        if not job.is_periodic() or not job.periodic.enabled or job.stopped():
            self.remove(job.namespace, job.id)
            return
        try:
            cron = Cron(job.periodic.spec)
        except CronParseError:
            return
        with self._lock:
            key = job.namespaced_id()
            self._tracked[key] = (job, cron)
            self._next_launch[key] = cron.next_after(time.time())

    def remove(self, namespace: str, job_id: str) -> None:
        with self._lock:
            self._tracked.pop((namespace, job_id), None)
            self._next_launch.pop((namespace, job_id), None)

    def restore(self) -> None:
        for job in self.server.store.jobs():
            if job.is_periodic():
                self.add(job)

    def tracked_count(self) -> int:
        with self._lock:
            return len(self._tracked)

    # -- launch loop -------------------------------------------------------
    def _run(self) -> None:
        while not self._stop.wait(self.tick):
            now = time.time()
            due = []
            with self._lock:
                for key, when in list(self._next_launch.items()):
                    if when <= now:
                        job, cron = self._tracked[key]
                        due.append((key, job, cron))
            for key, job, cron in due:
                try:
                    self.force_launch(job, launch_time=now)
                finally:
                    with self._lock:
                        if key in self._tracked:
                            self._next_launch[key] = cron.next_after(now)

    def force_launch(self, job: Job, launch_time: Optional[float] = None) -> Optional[Job]:
        """Derive and register the child for one launch
        (periodic.go createEval / derivedJob)."""
        launch_time = launch_time or time.time()
        store = self.server.store
        child_id = f"{job.id}/periodic-{int(launch_time)}"
        while store.job_by_id(job.namespace, child_id) is not None:
            # same-second launches must not silently upsert the prior child
            import uuid as _uuid

            child_id = f"{job.id}/periodic-{int(launch_time)}-{_uuid.uuid4().hex[:6]}"
        if job.periodic.prohibit_overlap:
            prefix = job.id + "/periodic-"
            for child_job in store.jobs():
                if (
                    child_job.namespace != job.namespace
                    or not child_job.id.startswith(prefix)
                    or child_job.stopped()
                    or child_job.status == "dead"
                ):
                    continue
                # a child is "still running" if any of its allocs OR evals
                # are non-terminal — a blocked eval with zero allocs still
                # means the previous launch hasn't finished
                allocs = store.allocs_by_job(child_job.namespace, child_job.id)
                evs = store.evals_by_job(child_job.namespace, child_job.id)
                if (allocs or evs) and (
                    any(not a.terminal_status() for a in allocs)
                    or any(not e.terminal_status() for e in evs)
                ):
                    return None  # previous launch still in flight
        child = copy.deepcopy(job)
        child.id = child_id
        child.name = child_id
        child.periodic = None
        child.parent_id = job.id
        self.server.register_job(child)
        return child
