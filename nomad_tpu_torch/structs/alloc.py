"""Allocation model + per-placement explainability metrics.

Reference: structs.Allocation (nomad/structs/structs.go ~:8700),
structs.AllocMetric (:10034-10079 — nodes evaluated/filtered/exhausted and
per-node score breakdown surfaced by ``alloc status``), RescheduleTracker.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

from .job import Job, ReschedulePolicy
from .resources import ComparableResources

ALLOC_DESIRED_RUN = "run"
ALLOC_DESIRED_STOP = "stop"
ALLOC_DESIRED_EVICT = "evict"

ALLOC_CLIENT_PENDING = "pending"
ALLOC_CLIENT_RUNNING = "running"
ALLOC_CLIENT_COMPLETE = "complete"
ALLOC_CLIENT_FAILED = "failed"
ALLOC_CLIENT_LOST = "lost"

TERMINAL_CLIENT_STATUSES = frozenset(
    {ALLOC_CLIENT_COMPLETE, ALLOC_CLIENT_FAILED, ALLOC_CLIENT_LOST}
)


@dataclass(slots=True)
class NodeScoreMeta:
    """Per-node score breakdown recorded into AllocMetric.ScoreMetaData."""

    node_id: str = ""
    scores: dict[str, float] = field(default_factory=dict)
    norm_score: float = 0.0


@dataclass(slots=True)
class AllocMetric:
    """Why an allocation landed where it did (or why placement failed).
    Reference: structs.AllocMetric (structs.go:10034-10079)."""

    nodes_evaluated: int = 0
    nodes_filtered: int = 0
    nodes_available: dict[str, int] = field(default_factory=dict)  # dc → count
    class_filtered: dict[str, int] = field(default_factory=dict)
    constraint_filtered: dict[str, int] = field(default_factory=dict)
    nodes_exhausted: int = 0
    class_exhausted: dict[str, int] = field(default_factory=dict)
    dimension_exhausted: dict[str, int] = field(default_factory=dict)
    quota_exhausted: list[str] = field(default_factory=list)
    scores: dict[str, float] = field(default_factory=dict)
    score_meta: list[NodeScoreMeta] = field(default_factory=list)
    allocation_time_ns: int = 0
    coalesced_failures: int = 0
    # structured feasibility-rejection histogram from the explain seam
    # (obs/explain.py): reason key → node count, e.g. "exhausted:cpu",
    # "class-infeasible", "penalty-excluded". Finer-grained than the
    # reference's DimensionExhausted strings; rides blocked evals so
    # `eval status` can say what to drain or resize.
    rejections: dict[str, int] = field(default_factory=dict)

    def exhausted_node(self, node_id: str, dimension: str) -> None:
        self.nodes_exhausted += 1
        if dimension:
            self.dimension_exhausted[dimension] = (
                self.dimension_exhausted.get(dimension, 0) + 1
            )

    def filter_node(self, constraint: str) -> None:
        self.nodes_filtered += 1
        if constraint:
            self.constraint_filtered[constraint] = (
                self.constraint_filtered.get(constraint, 0) + 1
            )


@dataclass(slots=True)
class RescheduleEvent:
    reschedule_time_ns: int = 0
    prev_alloc_id: str = ""
    prev_node_id: str = ""
    delay_s: float = 0.0


@dataclass(slots=True)
class RescheduleTracker:
    events: list[RescheduleEvent] = field(default_factory=list)


@dataclass(slots=True)
class DesiredTransition:
    migrate: bool = False
    reschedule: bool = False
    force_reschedule: bool = False


@dataclass(slots=True)
class Allocation:
    """An instance of a task group placed on a node."""

    id: str = ""
    namespace: str = "default"
    eval_id: str = ""
    name: str = ""  # "<job>.<group>[<index>]"
    node_id: str = ""
    node_name: str = ""
    job_id: str = ""
    job: Optional[Job] = None
    job_version: int = 0
    task_group: str = ""
    resources: ComparableResources = field(default_factory=ComparableResources)
    # Concrete port/bandwidth assignments made by the plan applier's
    # NetworkIndex (list of structs.network.AllocatedNetwork).
    allocated_networks: list = field(default_factory=list)
    # Concrete device instances assigned by the scheduler's device
    # allocator (list of resources.AllocatedDeviceResource).
    allocated_devices: list = field(default_factory=list)
    desired_status: str = ALLOC_DESIRED_RUN
    desired_description: str = ""
    desired_transition: DesiredTransition = field(default_factory=DesiredTransition)
    client_status: str = ALLOC_CLIENT_PENDING
    client_description: str = ""
    task_states: dict[str, object] = field(default_factory=dict)
    deployment_id: str = ""
    deployment_status: Optional[object] = None
    canary: bool = False
    previous_allocation: str = ""
    next_allocation: str = ""
    reschedule_tracker: Optional[RescheduleTracker] = None
    followup_eval_id: str = ""
    preempted_by_allocation: str = ""
    preempted_allocations: list[str] = field(default_factory=list)
    metrics: AllocMetric = field(default_factory=AllocMetric)
    create_time_ns: int = 0
    modify_time_ns: int = 0
    create_index: int = 0
    modify_index: int = 0
    alloc_modify_index: int = 0

    def comparable_resources(self) -> ComparableResources:
        return self.resources

    def device_asks(self) -> dict[str, int]:
        """device id → requested instance count. Prefers the concrete
        assignment made at placement (full vendor/type/name ids); falls
        back to the attached job's asks (possibly partial ids)."""
        if self.allocated_devices:
            out: dict[str, int] = {}
            for ad in self.allocated_devices:
                out[ad.id()] = out.get(ad.id(), 0) + len(ad.device_ids)
            return out
        tg = self.job.lookup_task_group(self.task_group) if self.job else None
        if tg is None:
            return {}
        out = {}
        for t in tg.tasks:
            for d in t.resources.devices:
                out[d.name] = out.get(d.name, 0) + d.count
        return out

    def device_instance_ids(self) -> dict[str, set]:
        """device full-id → concrete instance ids held by this alloc."""
        out: dict[str, set] = {}
        for ad in self.allocated_devices:
            out.setdefault(ad.id(), set()).update(ad.device_ids)
        return out

    def terminal_status(self) -> bool:
        """Desired-or-actual terminal — structs.Allocation.TerminalStatus."""
        if self.desired_status in (ALLOC_DESIRED_STOP, ALLOC_DESIRED_EVICT):
            return True
        return self.client_terminal_status()

    def client_terminal_status(self) -> bool:
        return self.client_status in TERMINAL_CLIENT_STATUSES

    def index(self) -> int:
        """Alloc name index: "job.group[3]" → 3."""
        lb = self.name.rfind("[")
        rb = self.name.rfind("]")
        if lb == -1 or rb == -1:
            return -1
        try:
            return int(self.name[lb + 1 : rb])
        except ValueError:
            return -1

    def job_namespaced_id(self) -> tuple[str, str]:
        return (self.namespace, self.job_id)

    def should_reschedule(
        self, policy: Optional[ReschedulePolicy], now_ns: Optional[int] = None
    ) -> bool:
        """Eligibility for replacement on another node after failure.
        Mirrors structs.Allocation.ShouldReschedule + RescheduleEligible."""
        if self.desired_status != ALLOC_DESIRED_RUN:
            return False
        if self.client_status not in (ALLOC_CLIENT_FAILED, ALLOC_CLIENT_LOST):
            return False
        if policy is None or (policy.attempts == 0 and not policy.unlimited):
            return False
        if policy.unlimited:
            return True
        now_ns = now_ns if now_ns is not None else time.time_ns()
        window_start = now_ns - int(policy.interval_s * 1e9)
        attempted = 0
        if self.reschedule_tracker:
            attempted = sum(
                1
                for ev in self.reschedule_tracker.events
                if ev.reschedule_time_ns >= window_start
            )
        return attempted < policy.attempts

    def next_reschedule_delay(self, policy: ReschedulePolicy) -> float:
        """Backoff delay for the followup eval (constant/exponential/fib).
        Mirrors structs.Allocation.NextDelay."""
        n = len(self.reschedule_tracker.events) if self.reschedule_tracker else 0
        base = policy.delay_s
        if policy.delay_function == "constant":
            delay = base
        elif policy.delay_function == "exponential":
            delay = base * (2**n)
        elif policy.delay_function == "fibonacci":
            a, b = base, base
            for _ in range(n):
                a, b = b, a + b
            delay = a
        else:
            delay = base
        if policy.max_delay_s > 0:
            delay = min(delay, policy.max_delay_s)
        return delay

    def copy_for_update(self) -> "Allocation":
        import copy

        return copy.copy(self)
