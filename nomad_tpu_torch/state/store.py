"""StateStore — MVCC snapshot store with index watermarks.

Reference: nomad/state/state_store.go (6,446 LoC on go-memdb) and
nomad/fsm.go (Raft log application). The semantics that matter and are
kept here:

- **Snapshot isolation.** Schedulers run against an immutable snapshot
  while writers proceed (memdb MVCC). Implemented as copy-on-first-write-
  after-snapshot: ``snapshot()`` freezes the current table dicts; the next
  write to a frozen table copies it. Secondary-index values are immutable
  ``frozenset``s so snapshots share them safely.
- **Index watermarks.** Every write carries a monotonically increasing
  index (the Raft log index analog). ``wait_for_index`` is the worker's
  ``snapshotMinIndex`` barrier (nomad/worker.go:536-549): don't schedule
  an eval against state older than the index that created it.
- **UpsertPlanResults** applies a committed plan atomically: stops,
  placements, preemptions, eval updates (state_store.go UpsertPlanResults).
- **Blocking queries.** A condition variable broadcast on every index bump
  backs blocking/watch reads (memdb WatchSet analog).
"""

from __future__ import annotations

import threading
import time as _time
from typing import Callable, Iterable, Optional

from ..structs import (
    ALLOC_CLIENT_LOST,
    ALLOC_DESIRED_STOP,
    Allocation,
    Evaluation,
    Job,
    Node,
    PlanResult,
)

JOB_TRACKED_VERSIONS = 6  # structsJobTrackedVersions


class SchedulerConfiguration:
    """Runtime scheduler config stored in state (the Raft-resident knob the
    TPU algorithm registers under). Reference: structs.SchedulerConfiguration
    (nomad/structs/operator.go:128-220, default binpack :164-169)."""

    # class-level defaults double as the fallback for configs restored
    # from older snapshots (pickle skips __init__)
    placement_explanations = True
    throughput_source = "declared"

    def __init__(
        self,
        scheduler_algorithm: str = "binpack",
        preemption_system_enabled: bool = True,
        preemption_batch_enabled: bool = False,
        preemption_service_enabled: bool = False,
        memory_oversubscription_enabled: bool = False,
        pause_eval_broker: bool = False,
        placement_explanations: bool = True,
        throughput_source: str = "declared",
    ):
        self.scheduler_algorithm = scheduler_algorithm
        self.preemption_system_enabled = preemption_system_enabled
        self.preemption_batch_enabled = preemption_batch_enabled
        self.preemption_service_enabled = preemption_service_enabled
        self.memory_oversubscription_enabled = memory_oversubscription_enabled
        self.pause_eval_broker = pause_eval_broker
        # score provenance (obs/explain.py): when off, placements are
        # bit-identical (the gate is Python-level) but no explanations
        # are built, recorded, or served
        self.placement_explanations = placement_explanations
        # hetero throughput matrix source (obs/calibrate.py): "declared"
        # = jobspec coefficients (byte-identical pre-calibration path),
        # "learned" = the ThroughputEstimator's online telemetry values
        self.throughput_source = throughput_source


class _Tables:
    """The raw table/index dict bundle shared between store and snapshots."""

    __slots__ = (
        "nodes",
        "jobs",
        "job_versions",
        "evals",
        "allocs",
        "allocs_by_node",
        "allocs_by_job",
        "evals_by_job",
        "deployments",
        "deployments_by_job",
        "acl_policies",
        "acl_tokens",
        "acl_tokens_by_secret",
        "csi_volumes",
        "namespaces",
        "scaling_events",
        "indexes",
        "scheduler_config",
    )

    def __init__(self):
        self.nodes: dict[str, Node] = {}
        self.jobs: dict[tuple[str, str], Job] = {}
        self.job_versions: dict[tuple[str, str], tuple] = {}
        self.evals: dict[str, Evaluation] = {}
        self.allocs: dict[str, Allocation] = {}
        self.allocs_by_node: dict[str, frozenset[str]] = {}
        self.allocs_by_job: dict[tuple[str, str], frozenset[str]] = {}
        self.evals_by_job: dict[tuple[str, str], frozenset[str]] = {}
        self.deployments: dict[str, object] = {}
        self.deployments_by_job: dict[tuple[str, str], frozenset[str]] = {}
        self.acl_policies: dict[str, object] = {}
        self.acl_tokens: dict[str, object] = {}  # accessor_id → ACLToken
        self.acl_tokens_by_secret: dict[str, str] = {}  # secret → accessor
        self.csi_volumes: dict[str, object] = {}  # volume id → CSIVolume
        self.namespaces: dict[str, object] = {}  # name → Namespace
        # (ns, job_id) → tuple of scaling event dicts, newest first
        self.scaling_events: dict[tuple[str, str], tuple] = {}
        self.indexes: dict[str, int] = {}
        self.scheduler_config: SchedulerConfiguration = SchedulerConfiguration()

    TABLE_NAMES = (
        "nodes",
        "jobs",
        "job_versions",
        "evals",
        "allocs",
        "allocs_by_node",
        "allocs_by_job",
        "evals_by_job",
        "deployments",
        "deployments_by_job",
        "acl_policies",
        "acl_tokens",
        "acl_tokens_by_secret",
        "csi_volumes",
        "namespaces",
        "scaling_events",
        "indexes",
    )


class ChangeJournal:
    """Bounded append-only log of (index, table, key) write records — the
    watch-set analog (nomad/state/state_store.go WatchSet) that lets the
    device-state cache refresh resident tensors incrementally instead of
    re-flattening the cluster per eval (SURVEY.md §7 'latency floor').

    Only the tables the flattening layer consumes are journaled (nodes,
    allocs). Readers ask for changes in an index interval; ``None`` means
    the journal was trimmed past the interval and the reader must rebuild.
    """

    def __init__(self, cap: int = 500_000):
        self._entries: list[tuple[int, str, object]] = []
        self._cap = cap
        self._floor = 0  # records with index <= floor may have been trimmed
        self._lock = threading.Lock()

    def note(self, index: int, table: str, key) -> None:
        with self._lock:
            self._entries.append((index, table, key))
            if len(self._entries) > self._cap:
                drop = len(self._entries) // 2
                self._floor = self._entries[drop - 1][0]
                del self._entries[:drop]

    def since(self, after_index: int, upto_index: int):
        """Changes with after_index < index <= upto_index, as
        {table: set(keys)}, or None if the interval fell off the journal."""
        with self._lock:
            if after_index < self._floor:
                return None
            out: dict[str, set] = {}
            # entries are appended in index order; scan from the back
            for idx, table, key in reversed(self._entries):
                if idx <= after_index:
                    break
                if idx <= upto_index:
                    out.setdefault(table, set()).add(key)
            return out


class StateSnapshot:
    """An immutable point-in-time view. All read methods of StateStore are
    defined on this class; the store itself reads through a live view."""

    def __init__(self, tables: _Tables, index: int, journal=None):
        self._t = tables
        self.index = index
        self.journal = journal

    # -- namespaces --------------------------------------------------------
    def namespace_by_name(self, name: str):
        return self._t.namespaces.get(name)

    def namespaces(self) -> list:
        return list(self._t.namespaces.values())

    def scaling_events(self, namespace: str, job_id: str) -> list:
        return list(self._t.scaling_events.get((namespace, job_id), ()))

    # -- nodes ------------------------------------------------------------
    def node_by_id(self, node_id: str) -> Optional[Node]:
        return self._t.nodes.get(node_id)

    def nodes(self) -> Iterable[Node]:
        return self._t.nodes.values()

    def ready_nodes_in_dcs(self, datacenters: Iterable[str]) -> list[Node]:
        """readyNodesInDCs (scheduler/util.go:279)."""
        dcs = set(datacenters)
        return [n for n in self._t.nodes.values() if n.ready() and n.datacenter in dcs]

    # -- jobs -------------------------------------------------------------
    def job_by_id(self, namespace: str, job_id: str) -> Optional[Job]:
        return self._t.jobs.get((namespace, job_id))

    def jobs(self) -> Iterable[Job]:
        return self._t.jobs.values()

    def job_version(self, namespace: str, job_id: str, version: int) -> Optional[Job]:
        for j in self._t.job_versions.get((namespace, job_id), ()):
            if j.version == version:
                return j
        return None

    def job_versions_list(self, namespace: str, job_id: str) -> list[Job]:
        return list(self._t.job_versions.get((namespace, job_id), ()))

    # -- evals ------------------------------------------------------------
    def eval_by_id(self, eval_id: str) -> Optional[Evaluation]:
        return self._t.evals.get(eval_id)

    def evals(self) -> Iterable[Evaluation]:
        return self._t.evals.values()

    def evals_by_job(self, namespace: str, job_id: str) -> list[Evaluation]:
        ids = self._t.evals_by_job.get((namespace, job_id), frozenset())
        return [self._t.evals[i] for i in ids if i in self._t.evals]

    # -- allocs -----------------------------------------------------------
    def alloc_by_id(self, alloc_id: str) -> Optional[Allocation]:
        return self._t.allocs.get(alloc_id)

    def allocs(self) -> Iterable[Allocation]:
        return self._t.allocs.values()

    def allocs_by_node(self, node_id: str) -> list[Allocation]:
        ids = self._t.allocs_by_node.get(node_id, frozenset())
        return [self._t.allocs[i] for i in ids if i in self._t.allocs]

    def allocs_by_node_terminal(self, node_id: str, terminal: bool) -> list[Allocation]:
        return [
            a for a in self.allocs_by_node(node_id) if a.terminal_status() == terminal
        ]

    def allocs_by_job(self, namespace: str, job_id: str) -> list[Allocation]:
        ids = self._t.allocs_by_job.get((namespace, job_id), frozenset())
        return [self._t.allocs[i] for i in ids if i in self._t.allocs]

    def allocs_by_eval(self, eval_id: str) -> list[Allocation]:
        return [a for a in self._t.allocs.values() if a.eval_id == eval_id]

    # -- deployments ------------------------------------------------------
    def deployment_by_id(self, deployment_id: str):
        return self._t.deployments.get(deployment_id)

    def deployments(self):
        return self._t.deployments.values()

    def latest_deployment_by_job(self, namespace: str, job_id: str):
        ids = self._t.deployments_by_job.get((namespace, job_id), frozenset())
        best = None
        for i in ids:
            d = self._t.deployments.get(i)
            if d is not None and (best is None or d.create_index > best.create_index):
                best = d
        return best

    # -- ACL ---------------------------------------------------------------
    def acl_policy_by_name(self, name: str):
        return self._t.acl_policies.get(name)

    def acl_policies(self) -> Iterable:
        return self._t.acl_policies.values()

    def acl_token_by_accessor(self, accessor_id: str):
        return self._t.acl_tokens.get(accessor_id)

    def acl_token_by_secret(self, secret_id: str):
        accessor = self._t.acl_tokens_by_secret.get(secret_id)
        return self._t.acl_tokens.get(accessor) if accessor else None

    def acl_tokens(self) -> Iterable:
        return self._t.acl_tokens.values()

    def acl_bootstrapped(self) -> bool:
        return self._t.indexes.get("acl_bootstrap", 0) > 0

    # -- CSI volumes -------------------------------------------------------
    def csi_volume_by_id(self, volume_id: str):
        return self._t.csi_volumes.get(volume_id)

    def csi_volumes(self) -> Iterable:
        return self._t.csi_volumes.values()

    def csi_plugins(self) -> dict:
        """Derived CSI plugin aggregate health: plugin id → CSIPlugin,
        counting healthy node-plugin instances across the node table
        (structs.CSIPlugin is derived state in the reference too)."""
        from ..structs.volumes import CSIPlugin

        out: dict[str, CSIPlugin] = {}
        for node in self._t.nodes.values():
            for pid, info in node.csi_node_plugins.items():
                p = out.setdefault(pid, CSIPlugin(id=pid))
                if info.healthy:
                    p.nodes_healthy += 1
        return out

    # -- meta -------------------------------------------------------------
    def scheduler_config(self) -> SchedulerConfiguration:
        return self._t.scheduler_config

    def table_index(self, table: str) -> int:
        return self._t.indexes.get(table, 0)


class StateStore(StateSnapshot):
    """The live, writable store. Reads see the latest committed state."""

    def __init__(self):
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._frozen: set[str] = set()
        self._latest_index = 0
        self._listeners: list[Callable[[str, int], None]] = []
        super().__init__(_Tables(), 0, journal=ChangeJournal())

    # -- snapshot machinery ----------------------------------------------
    @property
    def latest_index(self) -> int:
        return self._latest_index

    def snapshot(self) -> StateSnapshot:
        """Freeze current tables; writers copy-on-first-write after this."""
        with self._lock:
            self._frozen = set(_Tables.TABLE_NAMES)
            return StateSnapshot(
                self._shallow_tables(), self._latest_index, journal=self.journal
            )

    def _shallow_tables(self) -> _Tables:
        t = _Tables.__new__(_Tables)
        for name in _Tables.TABLE_NAMES:
            setattr(t, name, getattr(self._t, name))
        t.scheduler_config = self._t.scheduler_config
        return t

    def _own(self, table: str) -> dict:
        d = getattr(self._t, table)
        if table in self._frozen:
            d = dict(d)
            setattr(self._t, table, d)
            self._frozen.discard(table)
        return d

    def _bump(self, index: int, *tables: str) -> None:
        self._latest_index = max(self._latest_index, index)
        idx = self._own("indexes")
        for tb in tables:
            idx[tb] = index
        self._cond.notify_all()
        for fn in self._listeners:
            for tb in tables:
                fn(tb, index)

    def bump_index(self, index: int) -> None:
        """Advance latest_index without touching tables — raft NOOP/barrier
        entries consume log indexes that must stay visible to blocking
        queries (SnapshotMinIndex semantics, worker.go:536)."""
        with self._lock:
            self._latest_index = max(self._latest_index, index)
            self._cond.notify_all()

    def add_listener(self, fn: Callable[[str, int], None]) -> None:
        """Table-change listener (the event-broker / blocked-evals hook)."""
        with self._lock:
            self._listeners.append(fn)

    def wait_for_index(self, index: int, timeout: float = 5.0) -> bool:
        """snapshotMinIndex barrier (worker.go:536-549)."""
        deadline = _time.monotonic() + timeout
        with self._lock:
            while self._latest_index < index:
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(remaining)
            return True

    # -- index maintenance helpers ---------------------------------------
    @staticmethod
    def _idx_add(d: dict, key, value: str) -> None:
        d[key] = d.get(key, frozenset()) | {value}

    @staticmethod
    def _idx_del(d: dict, key, value: str) -> None:
        cur = d.get(key)
        if cur is None:
            return
        nxt = cur - {value}
        if nxt:
            d[key] = nxt
        else:
            d.pop(key, None)

    # -- nodes ------------------------------------------------------------
    def upsert_node(self, index: int, node: Node) -> None:
        with self._lock:
            nodes = self._own("nodes")
            existing = nodes.get(node.id)
            if existing is not None:
                node.create_index = existing.create_index
            else:
                node.create_index = index
            node.modify_index = index
            if not node.computed_class:
                node.compute_class()
            nodes[node.id] = node
            self.journal.note(index, "nodes", node.id)
            self._bump(index, "nodes")

    def delete_node(self, index: int, node_id: str) -> None:
        with self._lock:
            self._own("nodes").pop(node_id, None)
            self.journal.note(index, "nodes", node_id)
            self._bump(index, "nodes")

    def update_node_status(self, index: int, node_id: str, status: str) -> None:
        with self._lock:
            nodes = self._own("nodes")
            n = nodes.get(node_id)
            if n is None:
                raise KeyError(f"node {node_id} not found")
            import copy

            n2 = copy.copy(n)
            n2.status = status
            n2.modify_index = index
            nodes[node_id] = n2
            self.journal.note(index, "nodes", node_id)
            self._bump(index, "nodes")

    def update_node_eligibility(self, index: int, node_id: str, elig: str) -> None:
        with self._lock:
            nodes = self._own("nodes")
            n = nodes.get(node_id)
            if n is None:
                raise KeyError(f"node {node_id} not found")
            import copy

            n2 = copy.copy(n)
            n2.scheduling_eligibility = elig
            n2.modify_index = index
            nodes[node_id] = n2
            self.journal.note(index, "nodes", node_id)
            self._bump(index, "nodes")

    def update_node_drain(
        self, index: int, node_id: str, drain, eligibility: str = ""
    ) -> None:
        """Set/clear the drain strategy. ``eligibility`` overrides the
        default (draining ⇒ ineligible, cleared ⇒ eligible) — the drainer
        clears the strategy but keeps the node ineligible."""
        from ..structs import NODE_SCHED_INELIGIBLE, NODE_SCHED_ELIGIBLE

        with self._lock:
            nodes = self._own("nodes")
            n = nodes.get(node_id)
            if n is None:
                raise KeyError(f"node {node_id} not found")
            import copy

            n2 = copy.copy(n)
            n2.drain = drain
            n2.scheduling_eligibility = eligibility or (
                NODE_SCHED_INELIGIBLE if drain is not None else NODE_SCHED_ELIGIBLE
            )
            n2.modify_index = index
            nodes[node_id] = n2
            self.journal.note(index, "nodes", node_id)
            self._bump(index, "nodes")

    # -- jobs -------------------------------------------------------------
    def upsert_job(self, index: int, job: Job) -> None:
        """UpsertJob: bump version on change, retain bounded version history."""
        with self._lock:
            jobs = self._own("jobs")
            key = job.namespaced_id()
            existing = jobs.get(key)
            if existing is not None:
                job.create_index = existing.create_index
                job.version = existing.version + 1
            else:
                job.create_index = index
                job.version = 0
            job.modify_index = index
            job.job_modify_index = index
            if job.status not in ("dead",):
                job.status = "pending" if existing is None else job.status
            jobs[key] = job
            versions = self._own("job_versions")
            hist = (job,) + versions.get(key, ())
            versions[key] = hist[:JOB_TRACKED_VERSIONS]
            self._bump(index, "jobs", "job_versions")

    def delete_job(self, index: int, namespace: str, job_id: str) -> None:
        with self._lock:
            self._own("jobs").pop((namespace, job_id), None)
            self._own("job_versions").pop((namespace, job_id), None)
            self._bump(index, "jobs", "job_versions")

    def mark_job_stable(self, index: int, job: Job) -> None:
        """Record a job version as a known-good rollback target
        (UpdateJobStability in the reference)."""
        with self._lock:
            jobs = self._own("jobs")
            key = job.namespaced_id()
            if jobs.get(key) is not None and jobs[key].version == job.version:
                jobs[key] = job
            versions = self._own("job_versions")
            hist = tuple(
                job if j.version == job.version else j
                for j in versions.get(key, ())
            )
            versions[key] = hist
            self._bump(index, "jobs", "job_versions")

    def update_job_status(self, index: int, namespace: str, job_id: str, status: str):
        with self._lock:
            jobs = self._own("jobs")
            j = jobs.get((namespace, job_id))
            if j is None:
                return
            import copy

            j2 = copy.copy(j)
            j2.status = status
            j2.modify_index = index
            jobs[(namespace, job_id)] = j2
            self._bump(index, "jobs")

    # -- evals ------------------------------------------------------------
    def upsert_evals(self, index: int, evals: Iterable[Evaluation]) -> None:
        with self._lock:
            table = self._own("evals")
            by_job = self._own("evals_by_job")
            for ev in evals:
                existing = table.get(ev.id)
                ev.create_index = existing.create_index if existing else index
                ev.modify_index = index
                table[ev.id] = ev
                self._idx_add(by_job, (ev.namespace, ev.job_id), ev.id)
            self._bump(index, "evals")

    def delete_evals(self, index: int, eval_ids: Iterable[str]) -> None:
        with self._lock:
            table = self._own("evals")
            by_job = self._own("evals_by_job")
            for eid in eval_ids:
                ev = table.pop(eid, None)
                if ev is not None:
                    self._idx_del(by_job, (ev.namespace, ev.job_id), eid)
            self._bump(index, "evals")

    # -- allocs -----------------------------------------------------------
    def upsert_allocs(self, index: int, allocs: Iterable[Allocation]) -> None:
        with self._lock:
            self._upsert_allocs_locked(index, allocs)
            self._bump(index, "allocs")

    def _upsert_allocs_locked(self, index: int, allocs: Iterable[Allocation]) -> None:
        import copy as _copy

        table = self._own("allocs")
        by_node = self._own("allocs_by_node")
        by_job = self._own("allocs_by_job")
        for a in allocs:
            # Denormalize: plans ship with alloc.job stripped
            # (Plan.normalize); re-attach the stored job at the alloc's
            # version so version diffing / device asks keep working —
            # mirrors StateStore.DenormalizeAllocationsMap.
            if a.job is None:
                j = self._t.jobs.get((a.namespace, a.job_id))
                if j is not None and j.version != a.job_version:
                    for old in self._t.job_versions.get((a.namespace, a.job_id), ()):
                        if old.version == a.job_version:
                            j = old
                            break
                a.job = j
            # Maintain the replacement chain: the previous alloc learns its
            # successor (state_store.go UpsertAllocs sets NextAllocation).
            if a.previous_allocation:
                prev = table.get(a.previous_allocation)
                if prev is not None and prev.next_allocation != a.id:
                    prev2 = _copy.copy(prev)
                    prev2.next_allocation = a.id
                    prev2.modify_index = index
                    table[prev.id] = prev2
            existing = table.get(a.id)
            if existing is not None:
                a.create_index = existing.create_index
                # Preserve client-reported fields on server-side updates
                # (state_store.go UpsertAllocs keeps ClientStatus unless
                # the update sets it).
                if a.client_status == "" and existing.client_status:
                    a.client_status = existing.client_status
                if existing.node_id and existing.node_id != a.node_id:
                    self._idx_del(by_node, existing.node_id, a.id)
                    self.journal.note(index, "node_allocs", existing.node_id)
            else:
                a.create_index = index
            a.modify_index = index
            table[a.id] = a
            if a.node_id:
                self._idx_add(by_node, a.node_id, a.id)
                self.journal.note(index, "node_allocs", a.node_id)
            self._idx_add(by_job, (a.namespace, a.job_id), a.id)

    def delete_allocs(self, index: int, alloc_ids: Iterable[str]) -> None:
        with self._lock:
            table = self._own("allocs")
            by_node = self._own("allocs_by_node")
            by_job = self._own("allocs_by_job")
            for aid in alloc_ids:
                a = table.pop(aid, None)
                if a is not None:
                    if a.node_id:
                        self._idx_del(by_node, a.node_id, aid)
                        self.journal.note(index, "node_allocs", a.node_id)
                    self._idx_del(by_job, (a.namespace, a.job_id), aid)
            self._bump(index, "allocs")

    def delete_deployment(self, index: int, deployment_id: str) -> None:
        with self._lock:
            table = self._own("deployments")
            d = table.pop(deployment_id, None)
            if d is not None:
                self._idx_del(
                    self._own("deployments_by_job"),
                    (d.namespace, d.job_id),
                    deployment_id,
                )
            self._bump(index, "deployments")

    def update_allocs_from_client(self, index: int, updates: Iterable[Allocation]):
        """Client status sync (Node.UpdateAlloc): merge client-owned fields
        onto the server copy."""
        import copy

        with self._lock:
            table = self._own("allocs")
            for upd in updates:
                existing = table.get(upd.id)
                if existing is None:
                    continue
                a = copy.copy(existing)
                a.client_status = upd.client_status
                a.client_description = upd.client_description
                a.task_states = upd.task_states or a.task_states
                # client-side health verdict (allochealth tracker): the
                # deployment watcher consumes it for canary gating; the
                # first verdict wins (tracker.go never flips a verdict)
                if upd.deployment_status is not None and (
                    existing.deployment_status is None
                    or existing.deployment_status.healthy is None
                ):
                    a.deployment_status = upd.deployment_status
                a.modify_index = index
                table[a.id] = a
                if a.node_id:
                    self.journal.note(index, "node_allocs", a.node_id)
            self._bump(index, "allocs")

    # -- deployments -------------------------------------------------------
    def upsert_deployment(self, index: int, deployment) -> None:
        with self._lock:
            table = self._own("deployments")
            existing = table.get(deployment.id)
            if (
                existing is not None
                and not existing.active()
                and deployment.active()
            ):
                # same-id upsert flipping a TERMINAL deployment back to
                # active can only be a racing pause/resume (new rollouts
                # mint new ids) — refuse the resurrection
                return
            deployment.create_index = existing.create_index if existing else index
            deployment.modify_index = index
            table[deployment.id] = deployment
            self._idx_add(
                self._own("deployments_by_job"),
                (deployment.namespace, deployment.job_id),
                deployment.id,
            )
            self._bump(index, "deployments")

    # -- plan results (the FSM's ApplyPlanResults) -------------------------
    def upsert_plan_results(self, index: int, result: PlanResult, eval_id: str = ""):
        """Apply a committed plan atomically: stops/evictions, preempted
        allocs, then placements (state_store.go UpsertPlanResults)."""
        with self._lock:
            self._apply_plan_result_locked(index, result)
            self._bump(index, "allocs", "deployments")

    def upsert_merged_plan_results(
        self, index: int, results: list[PlanResult]
    ) -> None:
        """Apply a whole batched pass's committed member results as ONE
        store transaction: every member's stops/preemptions/placements
        land under a single lock acquisition and a single index bump, so
        a batch of B plans costs one listener fan-out instead of B."""
        with self._lock:
            for result in results:
                self._apply_plan_result_locked(index, result)
            self._bump(index, "allocs", "deployments")

    def _apply_plan_result_locked(self, index: int, result: PlanResult) -> None:
        updates: list[Allocation] = []
        for allocs in result.node_update.values():
            updates.extend(allocs)
        for allocs in result.node_preemptions.values():
            updates.extend(allocs)
        for allocs in result.node_allocation.values():
            updates.extend(allocs)
        self._upsert_allocs_locked(index, updates)
        for allocs in result.node_allocation.values():
            for a in allocs:
                self._csi_claim_for_alloc_locked(index, a)
        for du in result.deployment_updates:
            self._update_deployment_status_locked(
                index,
                du["deployment_id"],
                du["status"],
                du.get("description", ""),
            )
        if result.deployment is not None:
            table = self._own("deployments")
            d = result.deployment
            existing = table.get(d.id)
            d.create_index = existing.create_index if existing else index
            d.modify_index = index
            table[d.id] = d
            self._idx_add(
                self._own("deployments_by_job"),
                (d.namespace, d.job_id),
                d.id,
            )

    # -- CSI volume writers ------------------------------------------------
    def upsert_csi_volume(self, index: int, vol) -> None:
        with self._lock:
            table = self._own("csi_volumes")
            existing = table.get(vol.id)
            if existing is not None:
                # the reference refuses spec changes on an in-use volume
                # (csi_endpoint.go Register → vol.Validate + claim check)
                if existing.in_use():
                    for f in ("namespace", "plugin_id", "access_mode",
                              "attachment_mode"):
                        if getattr(vol, f) != getattr(existing, f):
                            raise ValueError(
                                f"volume {vol.id} is in use; cannot change "
                                f"{f} from {getattr(existing, f)!r} to "
                                f"{getattr(vol, f)!r}"
                            )
                # re-registration must not wipe live claim state
                vol.read_claims = dict(existing.read_claims)
                vol.write_claims = dict(existing.write_claims)
                vol.past_claims = dict(existing.past_claims)
                vol.external_claims = set(existing.external_claims)
                vol.create_index = existing.create_index
            else:
                vol.create_index = index
            vol.modify_index = index
            table[vol.id] = vol
            self._bump(index, "csi_volumes")

    def restore_csi_volume(self, vol) -> None:
        """Snapshot restore: insert verbatim, preserving indexes."""
        with self._lock:
            self._own("csi_volumes")[vol.id] = vol
            self._latest_index = max(self._latest_index, vol.modify_index)

    def deregister_csi_volume(
        self, index: int, volume_id: str, force: bool = False
    ) -> None:
        with self._lock:
            table = self._own("csi_volumes")
            vol = table.get(volume_id)
            if vol is None:
                raise KeyError(f"volume not found: {volume_id}")
            if vol.in_use() and not force:
                raise ValueError(f"volume in use: {volume_id}")
            del table[volume_id]
            self._bump(index, "csi_volumes")

    def csi_claim(
        self,
        index: int,
        volume_id: str,
        alloc_id: str,
        node_id: str,
        read_only: bool,
        external: bool = False,
    ) -> bool:
        with self._lock:
            return self._csi_claim_locked(
                index, volume_id, alloc_id, node_id, read_only,
                external=external,
            )

    def _csi_claim_locked(
        self, index, volume_id, alloc_id, node_id, read_only, external=False
    ) -> bool:
        import copy as _copy

        table = self._own("csi_volumes")
        vol = table.get(volume_id)
        if vol is None:
            return False
        vol = _copy.deepcopy(vol)  # snapshots keep the old claim state
        if not vol.claim(alloc_id, node_id, read_only):
            return False
        if external:
            vol.external_claims.add(alloc_id)
        vol.modify_index = index
        table[volume_id] = vol
        self._bump(index, "csi_volumes")
        return True

    def _csi_claim_for_alloc_locked(self, index: int, alloc) -> None:
        """Claim the CSI volumes a freshly-placed alloc's group requests
        (the reference claims via the client Claim RPC at alloc start;
        claiming at plan commit keeps claim counts correct for the very
        next scheduling pass)."""
        if alloc.client_status != "pending" or alloc.job is None:
            return
        tg = alloc.job.lookup_task_group(alloc.task_group)
        if tg is None or not tg.volumes:
            return
        for req in tg.volumes.values():
            if req.type != "csi":
                continue
            vid = req.source
            if req.per_alloc:
                per = f"{req.source}[{alloc.index()}]"
                if per in self._t.csi_volumes:
                    vid = per
            if not self._csi_claim_locked(
                index, vid, alloc.id, alloc.node_id, req.read_only
            ):
                # plan-apply verification should make this unreachable;
                # an external claim racing the commit can still surface
                import logging

                logging.getLogger(__name__).warning(
                    "csi claim failed at plan commit: volume=%s alloc=%s",
                    vid,
                    alloc.id,
                )

    def csi_release(self, index: int, volume_id: str, alloc_id: str) -> bool:
        with self._lock:
            import copy as _copy

            table = self._own("csi_volumes")
            vol = table.get(volume_id)
            if vol is None:
                return False
            vol = _copy.deepcopy(vol)
            if not vol.release(alloc_id):
                return False
            vol.modify_index = index
            table[volume_id] = vol
            self._bump(index, "csi_volumes")
            return True

    def _update_deployment_status_locked(
        self, index: int, deployment_id: str, status: str, desc: str
    ) -> None:
        import copy as _copy

        table = self._own("deployments")
        d = table.get(deployment_id)
        if d is None:
            return
        if not d.active() and status in ("paused", "running"):
            # a pause/resume that raced a terminal transition must not
            # resurrect the deployment (deployment_endpoint.go rejects
            # state changes on terminal deployments; the applier-side
            # guard makes the race benign for every submitter)
            return
        d2 = _copy.deepcopy(d)
        d2.status = status
        d2.status_description = desc
        d2.modify_index = index
        table[deployment_id] = d2

    def update_deployment_status(
        self, index: int, deployment_id: str, status: str, desc: str = ""
    ) -> None:
        with self._lock:
            self._update_deployment_status_locked(index, deployment_id, status, desc)
            self._bump(index, "deployments")

    def update_deployment(self, index: int, deployment) -> None:
        """Replace a deployment record (watcher count refresh)."""
        with self._lock:
            table = self._own("deployments")
            existing = table.get(deployment.id)
            if (
                existing is not None
                and not existing.active()
                and deployment.active()
            ):
                # a replace flipping a TERMINAL deployment back to active
                # can only be a racing pause/resume or a stale watcher
                # refresh — refuse the resurrection (the endpoint-side
                # active() check is advisory; this guard is authoritative)
                self._bump(index, "deployments")
                return
            deployment.modify_index = index
            table[deployment.id] = deployment
            self._bump(index, "deployments")

    def update_alloc_health(
        self, index: int, healthy_ids: list[str], unhealthy_ids: list[str]
    ) -> None:
        """Set AllocDeploymentStatus health verdicts
        (UpsertDeploymentAllocHealth in the reference)."""
        import copy as _copy
        import time as _t

        from ..structs.deployment import AllocDeploymentStatus

        with self._lock:
            table = self._own("allocs")
            for ids, verdict in ((healthy_ids, True), (unhealthy_ids, False)):
                for aid in ids:
                    a = table.get(aid)
                    if a is None:
                        continue
                    a2 = _copy.copy(a)
                    a2.deployment_status = AllocDeploymentStatus(
                        healthy=verdict,
                        timestamp_unix=_t.time(),
                        canary=a.canary,
                    )
                    a2.modify_index = index
                    table[aid] = a2
            self._bump(index, "allocs")

    def update_allocs_desired_transition(
        self, index: int, transitions: dict[str, object]
    ) -> None:
        """Set DesiredTransition per alloc (the drainer's migrate marks —
        state_store.go UpdateAllocsDesiredTransitions)."""
        import copy as _copy

        with self._lock:
            table = self._own("allocs")
            for aid, tr in transitions.items():
                a = table.get(aid)
                if a is None:
                    continue
                a2 = _copy.copy(a)
                a2.desired_transition = tr
                a2.modify_index = index
                table[aid] = a2
            self._bump(index, "allocs")

    # -- ACL ---------------------------------------------------------------
    def upsert_acl_policies(self, index: int, policies: Iterable) -> None:
        with self._lock:
            table = self._own("acl_policies")
            for p in policies:
                existing = table.get(p.name)
                p.create_index = existing.create_index if existing else index
                p.modify_index = index
                table[p.name] = p
            self._bump(index, "acl_policies")

    def delete_acl_policies(self, index: int, names: Iterable[str]) -> None:
        with self._lock:
            table = self._own("acl_policies")
            for name in names:
                table.pop(name, None)
            self._bump(index, "acl_policies")

    def upsert_acl_tokens(self, index: int, tokens: Iterable) -> None:
        with self._lock:
            table = self._own("acl_tokens")
            by_secret = self._own("acl_tokens_by_secret")
            for t in tokens:
                existing = table.get(t.accessor_id)
                if existing is not None:
                    t.create_index = existing.create_index
                    if existing.secret_id != t.secret_id:
                        by_secret.pop(existing.secret_id, None)
                else:
                    t.create_index = index
                t.modify_index = index
                table[t.accessor_id] = t
                by_secret[t.secret_id] = t.accessor_id
            self._bump(index, "acl_tokens")

    def delete_acl_tokens(self, index: int, accessor_ids: Iterable[str]) -> None:
        with self._lock:
            table = self._own("acl_tokens")
            by_secret = self._own("acl_tokens_by_secret")
            for aid in accessor_ids:
                t = table.pop(aid, None)
                if t is not None:
                    by_secret.pop(t.secret_id, None)
            self._bump(index, "acl_tokens")

    def bootstrap_acl_token(self, index: int, token) -> None:
        """One-shot bootstrap (acl_endpoint.go Bootstrap): guarded by the
        acl_bootstrap index sentinel."""
        with self._lock:
            if self._t.indexes.get("acl_bootstrap", 0) > 0:
                raise PermissionError("ACL bootstrap already done")
            table = self._own("acl_tokens")
            by_secret = self._own("acl_tokens_by_secret")
            token.create_index = index
            token.modify_index = index
            table[token.accessor_id] = token
            by_secret[token.secret_id] = token.accessor_id
            idx = self._own("indexes")
            idx["acl_bootstrap"] = index
            self._bump(index, "acl_tokens")

    # -- scheduler config --------------------------------------------------
    def set_scheduler_config(self, index: int, cfg: SchedulerConfiguration) -> None:
        with self._lock:
            self._t.scheduler_config = cfg
            self._bump(index, "scheduler_config")

    # -- namespaces (nomad/state namespace table) --------------------------
    def upsert_namespace(self, index: int, ns) -> None:
        with self._lock:
            table = self._own("namespaces")
            existing = table.get(ns.name)
            ns.create_index = existing.create_index if existing else index
            ns.modify_index = index
            table[ns.name] = ns
            self._bump(index, "namespaces")

    def delete_namespace(self, index: int, name: str) -> None:
        """Refuses deletion of a non-empty namespace (namespace_endpoint.go
        DeleteNamespaces: namespaces with jobs cannot be removed)."""
        with self._lock:
            if name == "default":
                raise ValueError("default namespace cannot be deleted")
            if name not in self._t.namespaces:
                raise KeyError(f"namespace not found: {name}")
            in_use = [
                jid for (jns, jid) in self._t.jobs if jns == name
            ]
            if in_use:
                raise ValueError(
                    f"namespace {name!r} has {len(in_use)} job(s); "
                    "deregister them first"
                )
            table = self._own("namespaces")
            del table[name]
            self._bump(index, "namespaces")

    def restore_namespace(self, ns) -> None:
        with self._lock:
            self._own("namespaces")[ns.name] = ns
            self._latest_index = max(self._latest_index, ns.modify_index)

    # -- scaling events (structs.JobScalingEvents) -------------------------
    MAX_SCALING_EVENTS = 20

    def add_scaling_event(self, index: int, namespace: str, job_id: str,
                          event: dict) -> None:
        with self._lock:
            table = self._own("scaling_events")
            key = (namespace, job_id)
            event = {**event, "index": index}
            table[key] = ((event,) + table.get(key, ()))[
                : self.MAX_SCALING_EVENTS
            ]
            self._bump(index, "scaling_events")
