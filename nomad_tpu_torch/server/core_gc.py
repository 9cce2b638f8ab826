"""Core scheduler — internal GC jobs.

Reference: nomad/core_sched.go (CoreScheduler :26-41): terminal evals and
their allocs, dead jobs, empty down nodes, and terminal deployments are
reaped once older than their thresholds; in the reference these run as
``_core`` evals through the normal worker path on leader GC timers
(leader.go:292-307). Here the same reaping runs on a leader timer loop
with per-kind thresholds; limits per pass mirror maxIdsPerReap.
"""

from __future__ import annotations

import threading

from .fsm import MsgType
import time
from typing import Optional

MAX_IDS_PER_REAP = 4096  # core_sched.go:18-22


class GCConfig:
    def __init__(
        self,
        eval_gc_threshold_s: float = 3600.0,
        job_gc_threshold_s: float = 4 * 3600.0,
        node_gc_threshold_s: float = 24 * 3600.0,
        deployment_gc_threshold_s: float = 3600.0,
        interval_s: float = 60.0,
    ):
        self.eval_gc_threshold_s = eval_gc_threshold_s
        self.job_gc_threshold_s = job_gc_threshold_s
        self.node_gc_threshold_s = node_gc_threshold_s
        self.deployment_gc_threshold_s = deployment_gc_threshold_s
        self.interval_s = interval_s


class CoreScheduler:
    def __init__(self, server, config: Optional[GCConfig] = None):
        self.server = server
        self.config = config or GCConfig()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # modify-time bookkeeping: store indexes are logical, so GC age is
        # tracked by wall-clock observation of terminal records
        self._first_seen_terminal: dict[str, float] = {}
        self._seen_this_pass: set[str] = set()
        self._force_pass = False
        self._pass_lock = threading.Lock()

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="core-gc", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)

    def _run(self) -> None:
        while not self._stop.wait(self.config.interval_s):
            try:
                self.gc_all()
            except Exception:  # noqa: BLE001
                import logging

                logging.getLogger("nomad_tpu_torch.gc").exception("gc pass failed")

    def _aged(self, key: str, threshold: float, now: float) -> bool:
        self._seen_this_pass.add(key)
        if self._force_pass:
            # operator-forced sweep (`nomad system gc`): thresholds are
            # waived, and first-seen stamps must NOT be fabricated with
            # the forced clock — a fake future stamp would exempt the
            # object from every later periodic pass
            self._first_seen_terminal.setdefault(key, now)
            return True
        first = self._first_seen_terminal.setdefault(key, now)
        return now - first >= threshold

    # -- passes ------------------------------------------------------------
    def gc_all(
        self, now: Optional[float] = None, force: bool = False
    ) -> dict[str, int]:
        # one pass at a time: the periodic thread and an operator-forced
        # sweep share the _seen/_first_seen bookkeeping
        with self._pass_lock:
            now = now or time.time()
            self._seen_this_pass = set()
            self._force_pass = force
            try:
                stats = {
                    "evals": self.gc_evals(now),
                    "jobs": self.gc_jobs(now),
                    "nodes": self.gc_nodes(now),
                    "deployments": self.gc_deployments(now),
                }
            finally:
                self._force_pass = False
            # prune bookkeeping for records that are gone (reaped or
            # deleted) — the observation clock must not grow with
            # lifetime object count
            self._first_seen_terminal = {
                k: v
                for k, v in self._first_seen_terminal.items()
                if k in self._seen_this_pass
            }
            return stats

    def gc_evals(self, now: float) -> int:
        """Terminal evals + their terminal allocs (core_sched.go evalGC)."""
        store = self.server.store
        reap_evals: list[str] = []
        reap_allocs: list[str] = []
        for ev in store.evals():
            if not ev.terminal_status():
                continue
            if not self._aged(f"eval:{ev.id}", self.config.eval_gc_threshold_s, now):
                continue
            allocs = store.allocs_by_eval(ev.id)
            if any(not a.terminal_status() for a in allocs):
                continue  # eval still referenced by live work
            reap_evals.append(ev.id)
            reap_allocs.extend(a.id for a in allocs)
            if len(reap_evals) >= MAX_IDS_PER_REAP:
                break
        if reap_evals:
            self.server.raft_apply(
                MsgType.JOB_BATCH_GC,
                {"eval_ids": reap_evals, "alloc_ids": reap_allocs},
            )
        return len(reap_evals)

    def gc_jobs(self, now: float) -> int:
        """Dead jobs with no live evals/allocs (core_sched.go jobGC)."""
        store = self.server.store
        reaped = 0
        for job in list(store.jobs()):
            if not (job.stop or (job.type == "batch" and job.status == "dead")):
                continue
            if not self._aged(
                f"job:{job.namespace}/{job.id}", self.config.job_gc_threshold_s, now
            ):
                continue
            allocs = store.allocs_by_job(job.namespace, job.id)
            if any(not a.terminal_status() for a in allocs):
                continue
            evs = store.evals_by_job(job.namespace, job.id)
            if any(not e.terminal_status() for e in evs):
                continue
            self.server.raft_apply(
                MsgType.JOB_BATCH_GC,
                {
                    "eval_ids": [x.id for x in evs],
                    "alloc_ids": [x.id for x in allocs],
                    "jobs": [(job.namespace, job.id)],
                },
            )
            reaped += 1
        return reaped

    def gc_nodes(self, now: float) -> int:
        """Down nodes with no allocs (core_sched.go nodeGC)."""
        store = self.server.store
        reaped = 0
        for node in list(store.nodes()):
            if not node.terminal_status():
                continue
            if not self._aged(
                f"node:{node.id}", self.config.node_gc_threshold_s, now
            ):
                continue
            if any(
                not a.terminal_status() for a in store.allocs_by_node(node.id)
            ):
                continue
            self.server.raft_apply(
                MsgType.JOB_BATCH_GC, {"node_ids": [node.id]}
            )
            reaped += 1
        return reaped

    def gc_deployments(self, now: float) -> int:
        store = self.server.store
        reaped = 0
        for d in list(store.deployments()):
            if d.active():
                continue
            if not self._aged(
                f"deploy:{d.id}", self.config.deployment_gc_threshold_s, now
            ):
                continue
            self.server.raft_apply(
                MsgType.JOB_BATCH_GC, {"deployment_ids": [d.id]}
            )
            reaped += 1
        return reaped
