"""NodeDrainer — wave-by-wave migration of allocs off draining nodes.

Reference: nomad/drainer/ (drainer.go NodeDrainer, watch_jobs.go
DrainingJobWatcher, watch_nodes.go, drain_heap.go deadline notifier).
Semantics kept:

- A draining node's allocs are NOT all stopped at once. The drainer marks
  batches of allocs with ``DesiredTransition.Migrate`` respecting each
  task group's ``migrate.max_parallel`` (watch_jobs.go handleTaskGroup:
  in-flight = allocs already marked whose replacement isn't healthy yet;
  mark at most max_parallel − in_flight more).
- System (and sysbatch) jobs stay until everything else has left the
  node; skipped entirely with ``ignore_system_jobs``
  (watch_nodes.go deadlineReached / IsDone).
- When the drain deadline passes, all remaining allocs are force-marked
  (drain_heap.go + drainer.go handleDeadlinedNodes).
- When nothing migratable remains, the node's DrainStrategy is cleared
  but the node stays ineligible (drainer.go handleDoneNodeDrains,
  NodeDrainEventComplete).
"""

from __future__ import annotations

import logging

from .fsm import MsgType
import threading
import time
from typing import Optional

from ..structs import Evaluation
from ..structs.alloc import DesiredTransition
from ..structs.evaluation import EVAL_STATUS_PENDING, TRIGGER_NODE_DRAIN
from ..utils.metrics import global_metrics as metrics

log = logging.getLogger("nomad_tpu_torch.drainer")


class NodeDrainer:
    """Polling drainer bound to a Server (the reference's watcher trio
    collapsed into one scan — blocking-query watches become one pass over
    draining nodes per interval)."""

    def __init__(self, server, interval: float = 0.25):
        self.server = server
        self.interval = interval
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="node-drainer", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.scan()
            except Exception:  # noqa: BLE001
                log.exception("drainer scan failed")

    # -- one pass ----------------------------------------------------------
    def scan(self) -> None:
        store = self.server.store
        draining = [n for n in store.nodes() if n.drain is not None]
        for node in draining:
            self._drain_node(node)

    @staticmethod
    def _alloc_healthy(a) -> bool:
        """Counts toward the group's serving capacity: an explicitly
        healthy deployment/migration status, or a running task set
        (watch_jobs.go handleTaskGroup uses DeploymentStatus.IsHealthy;
        outside deployments the client's alloc-health watcher reports
        migration health the same way — client_status is our analog)."""
        if a.deployment_status is not None and a.deployment_status.healthy:
            return True
        return a.client_status == "running"

    def _drain_node(self, node) -> None:
        store = self.server.store
        drain = node.drain
        now = time.time()
        deadlined = 0 < drain.force_deadline_unix <= now or drain.deadline_s < 0

        allocs = [
            a for a in store.allocs_by_node(node.id) if not a.terminal_status()
        ]
        system, normal = [], []
        for a in allocs:
            job = store.job_by_id(a.namespace, a.job_id)
            if job is not None and job.type in ("system", "sysbatch"):
                system.append((a, job))
            else:
                normal.append((a, job))

        remaining = list(normal)
        if not drain.ignore_system_jobs:
            # system allocs drain only after all others are gone, or at
            # the deadline (watch_nodes.go IsDone / deadlineReached)
            if not normal or deadlined:
                remaining += system

        if not remaining:
            self._complete(node, deadlined)
            return

        transitions: dict[str, DesiredTransition] = {}
        jobs_touched: dict[tuple[str, str], object] = {}
        if deadlined:
            for a, job in remaining:
                if not a.desired_transition.migrate:
                    transitions[a.id] = DesiredTransition(migrate=True)
                    # deadline expiry is a forced exit, not a graceful
                    # wave — the SLO surface tracks the ratio
                    metrics.incr("nomad.drain.force_stops")
                jobs_touched[(a.namespace, a.job_id)] = job
        else:
            # Wave scheduling per (job, group) — watch_jobs.go
            # handleTaskGroup: numToDrain = healthy − (count − max_parallel)
            # where healthy counts serving allocs (incl. unmarked ones on
            # draining nodes) but NOT yet-unhealthy replacements, so a new
            # wave starts only as replacements come up.
            by_group: dict[tuple[str, str, str], list] = {}
            for a, job in remaining:
                by_group.setdefault((a.namespace, a.job_id, a.task_group), []).append(
                    (a, job)
                )
            for (ns, job_id, tg_name), pairs in by_group.items():
                job = pairs[0][1]
                if job is None:
                    # purged job: nothing reconciles these allocs via
                    # normal paths; drain them in one wave (the eval's
                    # job-is-None branch stops everything)
                    for a, _ in pairs:
                        if not a.desired_transition.migrate:
                            transitions[a.id] = DesiredTransition(migrate=True)
                            metrics.incr("nomad.drain.migrated")
                    jobs_touched[(ns, job_id)] = None
                    continue
                tg = job.lookup_task_group(tg_name)
                max_parallel = (
                    tg.migrate.max_parallel
                    if tg is not None and tg.migrate is not None
                    else 1
                )
                count = tg.count if tg is not None else len(pairs)
                healthy = 0
                for ja in store.allocs_by_job(ns, job_id):
                    if ja.task_group != tg_name or ja.terminal_status():
                        continue
                    if ja.desired_transition.migrate:
                        continue  # marked: on its way out
                    if ja.node_id == node.id or self._alloc_healthy(ja):
                        healthy += 1
                num_to_mark = healthy - (count - max_parallel)
                for a, _ in pairs:
                    if num_to_mark <= 0:
                        break
                    if a.desired_transition.migrate:
                        continue
                    transitions[a.id] = DesiredTransition(migrate=True)
                    metrics.incr("nomad.drain.migrated")
                    jobs_touched[(ns, job_id)] = job
                    num_to_mark -= 1

        if not transitions:
            return
        evals = [
            Evaluation(
                namespace=ns,
                priority=job.priority if job is not None else 50,
                type=job.type if job is not None else "service",
                triggered_by=TRIGGER_NODE_DRAIN,
                job_id=job_id,
                node_id=node.id,
                status=EVAL_STATUS_PENDING,
            )
            for (ns, job_id), job in jobs_touched.items()
        ]

        self.server.raft_apply(
            MsgType.ALLOC_DESIRED_TRANSITION,
            {"transitions": transitions, "evals": evals},
        )
        if evals:
            self.server.eval_broker.enqueue_all(
                self.server._fresh_evals(evals)
            )

    def _complete(self, node, deadlined: bool) -> None:
        """Drain finished: clear the strategy, stay ineligible
        (drainer.go handleDoneNodeDrains → Node.UpdateDrain with nil)."""
        from ..structs import NODE_SCHED_INELIGIBLE

        self.server.raft_apply(
            MsgType.NODE_DRAIN,
            {"node_id": node.id, "drain": None,
             "eligibility": NODE_SCHED_INELIGIBLE},
        )
        self.server._publish(
            "Node",
            "NodeDrainComplete",
            node.id,
            "default",
            {"deadline_reached": deadlined},
        )
        log.info("node %s drain complete (deadlined=%s)", node.id, deadlined)
        # a freed node is prime repacking space — nudge the defrag
        # controller (no-op unless continuous defrag is enabled)
        defrag = getattr(self.server, "defrag", None)
        if defrag is not None:
            defrag.notify_drain_complete()
