"""Plan — a scheduler's proposed state mutation, and its applied result.

Reference: structs.Plan / structs.PlanResult (nomad/structs/structs.go
~:10400). Plans are optimistic: built against a possibly-stale snapshot,
re-verified node-by-node by the leader's serialized plan applier
(nomad/plan_apply.go:400-689) which may partially commit and hand back a
``refresh_index`` so the worker can retry the remainder on fresher state.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .alloc import (
    ALLOC_CLIENT_LOST,
    ALLOC_DESIRED_EVICT,
    ALLOC_DESIRED_STOP,
    Allocation,
)
from .job import Job


@dataclass(slots=True)
class DesiredUpdates:
    """Per-task-group annotation counts for dry-run plans
    (scheduler/annotate.go)."""

    ignore: int = 0
    place: int = 0
    migrate: int = 0
    stop: int = 0
    in_place_update: int = 0
    destructive_update: int = 0
    canary: int = 0
    preemptions: int = 0


@dataclass(slots=True)
class PlanAnnotations:
    desired_tg_updates: dict[str, DesiredUpdates] = field(default_factory=dict)
    preempted_allocs: list[Allocation] = field(default_factory=list)


@dataclass(slots=True)
class Plan:
    eval_id: str = ""
    eval_token: str = ""
    priority: int = 50
    all_at_once: bool = False
    job: Optional[Job] = None
    # node id → allocs to stop/evict on that node
    node_update: dict[str, list[Allocation]] = field(default_factory=dict)
    # node id → new/updated allocs on that node
    node_allocation: dict[str, list[Allocation]] = field(default_factory=dict)
    # node id → allocs preempted to make room
    node_preemptions: dict[str, list[Allocation]] = field(default_factory=dict)
    deployment: Optional[object] = None
    deployment_updates: list = field(default_factory=list)
    annotations: Optional[PlanAnnotations] = None
    snapshot_index: int = 0

    def append_stopped_alloc(
        self, alloc: Allocation, desired_desc: str, client_status: str = ""
    ) -> None:
        """Plan.AppendStoppedAlloc — record a stop with its reason."""
        a = alloc.copy_for_update()
        a.desired_status = ALLOC_DESIRED_STOP
        a.desired_description = desired_desc
        if client_status:
            a.client_status = client_status
        self.node_update.setdefault(alloc.node_id, []).append(a)

    def append_alloc(self, alloc: Allocation) -> None:
        self.node_allocation.setdefault(alloc.node_id, []).append(alloc)

    def append_preempted_alloc(self, alloc: Allocation, preempting_id: str) -> None:
        a = alloc.copy_for_update()
        a.desired_status = ALLOC_DESIRED_EVICT
        a.desired_description = f"Preempted by alloc ID {preempting_id}"
        a.preempted_by_allocation = preempting_id
        self.node_preemptions.setdefault(alloc.node_id, []).append(a)

    def append_lost_alloc(self, alloc: Allocation) -> None:
        self.append_stopped_alloc(
            alloc, "alloc lost since node is down", ALLOC_CLIENT_LOST
        )

    def is_no_op(self) -> bool:
        return (
            not self.node_update
            and not self.node_allocation
            and not self.node_preemptions
            and self.deployment is None
            and not self.deployment_updates
        )

    def placed_allocs(self) -> list[Allocation]:
        return [a for allocs in self.node_allocation.values() for a in allocs]

    def normalize(self) -> None:
        """Strip the heavyweight Job pointer from every alloc before
        shipping the plan over the wire — mirrors Plan.Normalize /
        Allocation.Stub to keep plan-apply payloads small."""
        for bucket in (self.node_allocation, self.node_update, self.node_preemptions):
            for allocs in bucket.values():
                for a in allocs:
                    a.job = None


@dataclass(slots=True)
class MergedPlan:
    """One batched pass's plans coalesced into a single commit unit.

    Member plans stay intact — per-eval attribution on every placement,
    update, and preemption is the member plan itself — so the applier can
    verify the UNION of touched nodes once, yet still reject (and hand a
    ``refresh_index`` retry to) exactly the member whose placements went
    stale, without failing its batch siblings. The whole merged result
    lands as ONE FSM entry and one store index bump, which is the entire
    point: a batched device pass that scored B evals in one kernel call
    no longer pays B serialized verify/commit round trips.
    """

    plans: list[Plan] = field(default_factory=list)
    # lane mode: the batching worker that built this commit. With lanes
    # active the applier ASSERTS every touched node is either owned by
    # this worker or covered by one of the attached (confirmed)
    # cross-lane claims — a violation is a structural bug, counted as
    # nomad.plan.lane_conflicts and pinned at zero by invariant law 9.
    owner_worker: int = -1
    # confirmed LaneClaim objects riding this commit. Host-side only:
    # never serialized into the raft entry (commit_merged ships results).
    claims: list = field(default_factory=list)

    @property
    def priority(self) -> int:
        """Queue priority: a merged entry sorts by its most urgent member
        (the batch dequeue already grouped by readiness, not priority)."""
        return max((p.priority for p in self.plans), default=50)

    def eval_ids(self) -> list[str]:
        return [p.eval_id for p in self.plans]

    def normalize(self) -> None:
        for p in self.plans:
            p.normalize()


@dataclass(slots=True)
class PlanResult:
    """What the applier actually committed."""

    node_update: dict[str, list[Allocation]] = field(default_factory=dict)
    node_allocation: dict[str, list[Allocation]] = field(default_factory=dict)
    node_preemptions: dict[str, list[Allocation]] = field(default_factory=dict)
    rejected_nodes: list[str] = field(default_factory=list)
    deployment: Optional[object] = None
    deployment_updates: list = field(default_factory=list)
    refresh_index: int = 0
    alloc_index: int = 0
    # set by the applier when the plan's broker token was no longer the
    # eval's outstanding token at apply time (unack-deadline redelivery
    # handed the eval to another worker) — nothing was committed and the
    # submitter must NOT retry: the redelivered copy owns the eval now
    token_stale: bool = False

    def is_no_op(self) -> bool:
        return (
            not self.node_update
            and not self.node_allocation
            and not self.node_preemptions
        )

    def full_commit(self, plan: Plan) -> tuple[bool, int, int]:
        """Did every proposed alloc commit? Returns (full, expected, actual).
        Mirrors PlanResult.FullCommit (used at generic_sched.go:317-324)."""
        expected = sum(len(v) for v in plan.node_allocation.values())
        actual = sum(len(v) for v in self.node_allocation.values())
        return expected == actual, expected, actual
