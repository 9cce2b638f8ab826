"""Deployment model — tracks the rollout of one job version.

Reference: structs.Deployment / DeploymentState / AllocDeploymentStatus
(nomad/structs/structs.go ~:9200) driven by the deployment watcher
(nomad/deploymentwatcher/). A deployment exists per (job, version) while a
rolling update / canary release is in flight; per-group state carries the
canary and health bookkeeping the reconciler gates on.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from typing import Optional

DEPLOYMENT_STATUS_RUNNING = "running"
DEPLOYMENT_STATUS_PAUSED = "paused"
DEPLOYMENT_STATUS_FAILED = "failed"
DEPLOYMENT_STATUS_SUCCESSFUL = "successful"
DEPLOYMENT_STATUS_CANCELLED = "cancelled"

TERMINAL_DEPLOYMENT_STATUSES = frozenset(
    {
        DEPLOYMENT_STATUS_FAILED,
        DEPLOYMENT_STATUS_SUCCESSFUL,
        DEPLOYMENT_STATUS_CANCELLED,
    }
)

DESC_PROGRESS_DEADLINE = "Failed due to progress deadline"
DESC_UNHEALTHY_ALLOCS = "Failed due to unhealthy allocations"
DESC_AUTO_REVERT = "Failed; auto-reverting to previous stable version"
DESC_SUCCESSFUL = "Deployment completed successfully"
DESC_NEW_VERSION = "Cancelled due to newer version of job"


@dataclass(slots=True)
class DeploymentState:
    """Per task-group rollout state (structs.DeploymentState)."""

    auto_revert: bool = False
    auto_promote: bool = False
    promoted: bool = False
    placed_canaries: list[str] = field(default_factory=list)  # alloc ids
    desired_canaries: int = 0
    desired_total: int = 0
    placed_allocs: int = 0
    healthy_allocs: int = 0
    unhealthy_allocs: int = 0
    progress_deadline_s: float = 600.0
    require_progress_by_unix: float = 0.0


@dataclass(slots=True)
class AllocDeploymentStatus:
    """Health verdict for one alloc within a deployment
    (structs.AllocDeploymentStatus)."""

    healthy: Optional[bool] = None
    timestamp_unix: float = 0.0
    canary: bool = False

    def is_healthy(self) -> bool:
        return self.healthy is True

    def is_unhealthy(self) -> bool:
        return self.healthy is False


@dataclass(slots=True)
class Deployment:
    id: str = field(default_factory=lambda: str(uuid.uuid4()))
    namespace: str = "default"
    job_id: str = ""
    job_version: int = 0
    job_modify_index: int = 0
    task_groups: dict[str, DeploymentState] = field(default_factory=dict)
    status: str = DEPLOYMENT_STATUS_RUNNING
    status_description: str = "Deployment is running"
    is_multiregion: bool = False
    create_index: int = 0
    modify_index: int = 0

    def active(self) -> bool:
        return self.status in (DEPLOYMENT_STATUS_RUNNING, DEPLOYMENT_STATUS_PAUSED)

    def requires_promotion(self) -> bool:
        return any(
            s.desired_canaries > 0 and not s.promoted
            for s in self.task_groups.values()
        )

    def healthy_by_group(self) -> dict[str, int]:
        return {name: s.healthy_allocs for name, s in self.task_groups.items()}
