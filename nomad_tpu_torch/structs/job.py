"""Job / TaskGroup / Task model with constraints, affinities and spreads.

Reference shapes: nomad/structs/structs.go (Job ~:3900, TaskGroup ~:5610,
Task ~:6090, Constraint ~:7600, Affinity ~:7700, Spread ~:7800). Only the
scheduling-relevant surface is modeled; service discovery, vault/consul
blocks, and template hooks are client-side concerns added in later layers.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Optional

from .resources import Resources

# Job types — structs.go JobTypeService/Batch/System/SysBatch + core GC jobs.
JOB_TYPE_SERVICE = "service"
JOB_TYPE_BATCH = "batch"
JOB_TYPE_SYSTEM = "system"
JOB_TYPE_SYSBATCH = "sysbatch"
JOB_TYPE_CORE = "_core"

JOB_STATUS_PENDING = "pending"
JOB_STATUS_RUNNING = "running"
JOB_STATUS_DEAD = "dead"

JOB_DEFAULT_PRIORITY = 50
JOB_MIN_PRIORITY = 1
JOB_MAX_PRIORITY = 100

DEFAULT_NAMESPACE = "default"

# Constraint operands — scheduler/feasible.go:785-820 checkConstraint dispatch.
CONSTRAINT_DISTINCT_HOSTS = "distinct_hosts"
CONSTRAINT_DISTINCT_PROPERTY = "distinct_property"
CONSTRAINT_REGEX = "regexp"
CONSTRAINT_VERSION = "version"
CONSTRAINT_SEMVER = "semver"
CONSTRAINT_SET_CONTAINS = "set_contains"
CONSTRAINT_SET_CONTAINS_ALL = "set_contains_all"
CONSTRAINT_SET_CONTAINS_ANY = "set_contains_any"
CONSTRAINT_ATTRIBUTE_IS_SET = "is_set"
CONSTRAINT_ATTRIBUTE_IS_NOT_SET = "is_not_set"

COMPARISON_OPERANDS = ("=", "==", "is", "!=", "not", "<", "<=", ">", ">=")


@dataclass(slots=True)
class Constraint:
    """Hard placement constraint. Reference: structs.Constraint."""

    l_target: str = ""
    r_target: str = ""
    operand: str = "="

    def key(self) -> tuple:
        return (self.l_target, self.r_target, self.operand)


@dataclass(slots=True)
class Affinity:
    """Soft placement preference with weight in [-100, 100].
    Reference: structs.Affinity; scored in scheduler/rank.go:650-737."""

    l_target: str = ""
    r_target: str = ""
    operand: str = "="
    weight: int = 50


@dataclass(slots=True)
class SpreadTarget:
    value: str = ""
    percent: int = 0


@dataclass(slots=True)
class Spread:
    """Spread allocations over values of an attribute, optionally with
    per-value target percentages. Reference: structs.Spread; scored in
    scheduler/spread.go."""

    attribute: str = ""
    weight: int = 50
    targets: list[SpreadTarget] = field(default_factory=list)


@dataclass(slots=True)
class RestartPolicy:
    attempts: int = 2
    interval_s: float = 1800.0
    delay_s: float = 15.0
    mode: str = "fail"  # fail | delay


@dataclass(slots=True)
class ReschedulePolicy:
    """Controls replacement of failed allocs on new nodes.
    Reference: structs.ReschedulePolicy; consumed by the reconciler and
    generic_sched.go:718-753 (followup evals with backoff)."""

    attempts: int = 0
    interval_s: float = 0.0
    delay_s: float = 30.0
    delay_function: str = "exponential"  # constant | exponential | fibonacci
    max_delay_s: float = 3600.0
    unlimited: bool = True


@dataclass(slots=True)
class MigrateStrategy:
    max_parallel: int = 1
    health_check: str = "checks"
    min_healthy_time_s: float = 10.0
    healthy_deadline_s: float = 300.0


@dataclass(slots=True)
class UpdateStrategy:
    """Deployment/rolling-update knobs. Reference: structs.UpdateStrategy;
    consumed by the reconciler's deployment logic (scheduler/reconcile.go)."""

    max_parallel: int = 1
    health_check: str = "checks"
    min_healthy_time_s: float = 10.0
    healthy_deadline_s: float = 300.0
    progress_deadline_s: float = 600.0
    auto_revert: bool = False
    auto_promote: bool = False
    canary: int = 0
    stagger_s: float = 30.0

    def rolling(self) -> bool:
        return self.max_parallel > 0


@dataclass(slots=True)
class EphemeralDisk:
    size_mb: int = 300
    sticky: bool = False
    migrate: bool = False


@dataclass(slots=True)
class PeriodicConfig:
    """Cron-style launch config. Reference: structs.PeriodicConfig;
    driven by the leader's periodic dispatcher (nomad/periodic.go)."""

    enabled: bool = True
    spec: str = ""
    spec_type: str = "cron"
    prohibit_overlap: bool = False
    time_zone: str = "UTC"


@dataclass(slots=True)
class ParameterizedJobConfig:
    payload: str = "optional"
    meta_required: list[str] = field(default_factory=list)
    meta_optional: list[str] = field(default_factory=list)


@dataclass(slots=True)
class LogConfig:
    """Per-task log retention (structs.LogConfig, DefaultLogConfig:
    10 files × 10 MiB) — consumed by the client's logmon rotation."""

    max_files: int = 10
    max_file_size_mb: int = 10


@dataclass(slots=True)
class ServiceCheck:
    """One health check on a service. Reference: structs.ServiceCheck
    (consumed by client/allochealth via the check watcher; the reference
    registers these in Consul — this build evaluates them client-side)."""

    name: str = ""
    type: str = "tcp"  # tcp | http | script
    path: str = "/"  # http only
    port: int = 0  # literal port (the reference resolves port labels)
    address: str = "127.0.0.1"
    command: str = ""  # script only
    args: list = field(default_factory=list)
    interval_s: float = 1.0
    timeout_s: float = 2.0


@dataclass(slots=True)
class Service:
    """A service advertised by a task. Reference: structs.Service —
    trimmed to the health-check role (no Consul registration)."""

    name: str = ""
    port: int = 0
    checks: list = field(default_factory=list)  # [ServiceCheck]


@dataclass(slots=True)
class Task:
    """One process under a driver. Reference: structs.Task."""

    name: str = "task"
    driver: str = "exec"
    user: str = ""
    config: dict = field(default_factory=dict)
    env: dict[str, str] = field(default_factory=dict)
    resources: Resources = field(default_factory=Resources)
    constraints: list[Constraint] = field(default_factory=list)
    affinities: list[Affinity] = field(default_factory=list)
    meta: dict[str, str] = field(default_factory=dict)
    leader: bool = False
    kill_timeout_s: float = 5.0
    lifecycle_hook: str = ""  # "" (main) | prestart | poststart | poststop
    lifecycle_sidecar: bool = False
    artifacts: list[dict] = field(default_factory=list)
    templates: list[dict] = field(default_factory=list)
    kind: str = ""
    log_config: LogConfig = field(default_factory=LogConfig)
    # volume name → structs.volumes.VolumeMount
    volume_mounts: list = field(default_factory=list)
    # advertised services with health checks (structs.Task.Services)
    services: list = field(default_factory=list)


@dataclass(slots=True)
class ScalingPolicy:
    """Horizontal group scaling bounds + autoscaler policy document.
    Reference: structs.ScalingPolicy (nomad/structs/structs.go; jobspec
    ``scaling`` block on a task group)."""

    min: int = 0
    max: int = 0
    enabled: bool = True
    # opaque autoscaler policy document (passed through verbatim)
    policy: dict = field(default_factory=dict)


@dataclass(slots=True)
class Namespace:
    """Reference: structs.Namespace (nomad/structs/namespace)."""

    name: str = ""
    description: str = ""
    create_index: int = 0
    modify_index: int = 0


@dataclass(slots=True)
class TaskGroup:
    """A co-scheduled set of tasks; the unit of placement.
    Reference: structs.TaskGroup."""

    name: str = "group"
    count: int = 1
    tasks: list[Task] = field(default_factory=list)
    constraints: list[Constraint] = field(default_factory=list)
    affinities: list[Affinity] = field(default_factory=list)
    spreads: list[Spread] = field(default_factory=list)
    restart_policy: RestartPolicy = field(default_factory=RestartPolicy)
    reschedule_policy: Optional[ReschedulePolicy] = None
    ephemeral_disk: EphemeralDisk = field(default_factory=EphemeralDisk)
    update: Optional[UpdateStrategy] = None
    migrate: Optional[MigrateStrategy] = None
    networks: list = field(default_factory=list)
    stop_after_client_disconnect_s: Optional[float] = None
    meta: dict[str, str] = field(default_factory=dict)
    # volume name → structs.volumes.VolumeRequest (group volume blocks)
    volumes: dict[str, object] = field(default_factory=dict)
    scaling: Optional[ScalingPolicy] = None

    def combined_resources(self) -> Resources:
        """Sum of task asks + ephemeral disk, the group's placement ask."""
        out = Resources(cpu=0, memory_mb=0, disk_mb=self.ephemeral_disk.size_mb)
        for t in self.tasks:
            out.cpu += t.resources.cpu
            out.memory_mb += t.resources.memory_mb
            out.networks.extend(t.resources.networks)
            out.devices.extend(t.resources.devices)
        out.networks = list(out.networks) + list(self.networks)
        return out


@dataclass(slots=True)
class Job:
    """Reference: structs.Job. ``version`` increments on every mutating
    registration; the reconciler compares alloc.job_version to decide
    in-place vs destructive updates."""

    id: str = ""
    name: str = ""
    namespace: str = DEFAULT_NAMESPACE
    type: str = JOB_TYPE_SERVICE
    priority: int = JOB_DEFAULT_PRIORITY
    region: str = "global"
    datacenters: list[str] = field(default_factory=lambda: ["dc1"])
    all_at_once: bool = False
    constraints: list[Constraint] = field(default_factory=list)
    affinities: list[Affinity] = field(default_factory=list)
    spreads: list[Spread] = field(default_factory=list)
    task_groups: list[TaskGroup] = field(default_factory=list)
    periodic: Optional[PeriodicConfig] = None
    parameterized: Optional[ParameterizedJobConfig] = None
    parent_id: str = ""
    payload: bytes = b""
    # per-device-class throughput coefficients (Gavel-style heterogeneity):
    # device_class → relative rate this job achieves on that class. A
    # class absent from the map runs at the default 1.0; an empty map
    # means the job is throughput-agnostic and hetero policies treat
    # every class identically. Values must be finite and >= 0 (0 = the
    # job cannot make progress on that class).
    throughputs: dict[str, float] = field(default_factory=dict)
    # gang scheduling stanza: {"groups": [group names placed all-or-
    # nothing], "colocate": {"level": "rack"|"pod", "weight": > 0},
    # "spread": {...}}. colocate/spread are optional topology terms; an
    # empty dict means no gang and the job schedules exactly as before
    # this field existed. Validated by validate_gang.
    gang: dict = field(default_factory=dict)
    meta: dict[str, str] = field(default_factory=dict)
    status: str = JOB_STATUS_PENDING
    stop: bool = False
    stable: bool = False
    version: int = 0
    submit_time_ns: int = 0
    create_index: int = 0
    modify_index: int = 0
    job_modify_index: int = 0

    def lookup_task_group(self, name: str) -> Optional[TaskGroup]:
        for tg in self.task_groups:
            if tg.name == name:
                return tg
        return None

    def is_periodic(self) -> bool:
        return self.periodic is not None

    def is_parameterized(self) -> bool:
        return self.parameterized is not None

    def stopped(self) -> bool:
        return self.stop

    def terminal(self) -> bool:
        return self.stop and self.status == JOB_STATUS_DEAD

    def required_allocs(self) -> dict[str, int]:
        """group name → desired count (0 when the job is stopped)."""
        if self.stop:
            return {tg.name: 0 for tg in self.task_groups}
        return {tg.name: tg.count for tg in self.task_groups}

    def constraints_for_group(self, tg: TaskGroup) -> list[Constraint]:
        """Job + group + per-task constraints, the full hard-constraint set
        for a placement (mirrors how the stack layers ConstraintCheckers
        across job/group/task scopes). Implicit driver constraints are
        added separately by the feasibility layer."""
        out = list(itertools.chain(self.constraints, tg.constraints))
        for t in tg.tasks:
            out.extend(t.constraints)
        return out

    def affinities_for_group(self, tg: TaskGroup) -> list[Affinity]:
        out = list(itertools.chain(self.affinities, tg.affinities))
        for t in tg.tasks:
            out.extend(t.affinities)
        return out

    def spreads_for_group(self, tg: TaskGroup) -> list[Spread]:
        return list(itertools.chain(self.spreads, tg.spreads))

    def namespaced_id(self) -> tuple[str, str]:
        return (self.namespace, self.id)

    def throughput_for(self, device_class: str) -> float:
        """Relative rate this job achieves on ``device_class`` (1.0 when
        the class is unmapped or class-less)."""
        if not device_class:
            return 1.0
        return float(self.throughputs.get(device_class, 1.0))


class JobValidationError(ValueError):
    pass


def validate_throughputs(throughputs: dict) -> list[str]:
    """Validate a per-device-class throughput map, returning structured
    problem strings (empty = valid). Shared by jobspec parse and job
    admission so NaN/negative/garbage coefficients are rejected before
    they can reach the scoring kernels."""
    problems: list[str] = []
    if not isinstance(throughputs, dict):
        return [f"throughput must be a mapping, got {type(throughputs).__name__}"]
    for key, value in throughputs.items():
        if not isinstance(key, str) or not key:
            problems.append(f"throughput class name must be a non-empty string, got {key!r}")
            continue
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            problems.append(
                f"throughput[{key!r}] must be a number, got {type(value).__name__}"
            )
            continue
        v = float(value)
        if v != v:  # NaN
            problems.append(f"throughput[{key!r}] is NaN")
        elif v in (float("inf"), float("-inf")):
            problems.append(f"throughput[{key!r}] must be finite, got {v}")
        elif v < 0:
            problems.append(f"throughput[{key!r}] must be >= 0, got {v}")
    return problems


GANG_TOPOLOGY_LEVELS = ("rack", "pod", "ici")


def validate_gang(gang: dict, group_names=None) -> list[str]:
    """Validate a gang stanza, returning structured problem strings
    (empty = valid). Shared by jobspec parse and job admission.
    ``group_names`` (when given) checks member references against the
    job's real task groups."""
    problems: list[str] = []
    if not isinstance(gang, dict):
        return [f"gang must be a mapping, got {type(gang).__name__}"]
    if not gang:
        return problems
    unknown = set(gang) - {"groups", "colocate", "spread"}
    for key in sorted(unknown):
        problems.append(f"gang has unknown key {key!r}")
    groups = gang.get("groups")
    if not isinstance(groups, list) or not groups:
        problems.append("gang.groups must be a non-empty list of group names")
        groups = []
    seen = set()
    for name in groups:
        if not isinstance(name, str) or not name:
            problems.append(
                f"gang.groups entries must be non-empty strings, got {name!r}"
            )
            continue
        if name in seen:
            problems.append(f"gang.groups lists {name!r} twice")
        seen.add(name)
        if group_names is not None and name not in group_names:
            problems.append(f"gang.groups references unknown group {name!r}")
    levels_used = {}
    for stanza in ("colocate", "spread"):
        term = gang.get(stanza)
        if term is None:
            continue
        if not isinstance(term, dict):
            problems.append(
                f"gang.{stanza} must be a mapping, got {type(term).__name__}"
            )
            continue
        level = term.get("level")
        if level not in GANG_TOPOLOGY_LEVELS:
            problems.append(
                f"gang.{stanza}.level must be one of "
                f"{'/'.join(GANG_TOPOLOGY_LEVELS)}, got {level!r}"
            )
        elif level in levels_used:
            problems.append(
                f"gang.colocate and gang.spread both target level {level!r}"
            )
        else:
            levels_used[level] = stanza
        weight = term.get("weight", 1.0)
        if isinstance(weight, bool) or not isinstance(weight, (int, float)):
            problems.append(
                f"gang.{stanza}.weight must be a number, "
                f"got {type(weight).__name__}"
            )
        else:
            w = float(weight)
            if w != w or w in (float("inf"), float("-inf")):
                problems.append(f"gang.{stanza}.weight must be finite, got {w}")
            elif w <= 0:
                problems.append(f"gang.{stanza}.weight must be > 0, got {w}")
    return problems


def validate_job(job: Job) -> None:
    """Admission validation — the high-value subset of structs.Job.Validate
    + jobspec semantic checks (nomad/structs/structs.go Job.Validate,
    TaskGroup.Validate):

    - id/name/datacenters present, known type, non-negative counts
    - unique group names, unique task names per group, groups non-empty
    - every task volume_mount references a declared group volume
    - a non-per_alloc single-writer CSI volume can't serve count > 1
    """
    if not job.id:
        raise JobValidationError("missing job ID")
    if not job.name:
        raise JobValidationError("missing job name")
    if not job.datacenters:
        raise JobValidationError("job must specify at least one datacenter")
    if job.type not in ("service", "batch", "system", "sysbatch"):
        raise JobValidationError(f"invalid job type: {job.type!r}")
    if not job.task_groups:
        raise JobValidationError("job must have at least one task group")
    for problem in validate_throughputs(job.throughputs):
        raise JobValidationError(problem)
    group_names = {tg.name for tg in job.task_groups}
    for problem in validate_gang(job.gang, group_names):
        raise JobValidationError(problem)
    seen_groups = set()
    for tg in job.task_groups:
        if tg.name in seen_groups:
            raise JobValidationError(f"duplicate task group {tg.name!r}")
        seen_groups.add(tg.name)
        if tg.count < 0:
            raise JobValidationError(f"group {tg.name!r} count must be >= 0")
        if not tg.tasks:
            raise JobValidationError(f"group {tg.name!r} has no tasks")
        seen_tasks = set()
        for t in tg.tasks:
            if t.name in seen_tasks:
                raise JobValidationError(
                    f"duplicate task {t.name!r} in group {tg.name!r}"
                )
            seen_tasks.add(t.name)
            for vm in t.volume_mounts:
                if vm.volume not in tg.volumes:
                    raise JobValidationError(
                        f"task {t.name!r} mounts undeclared volume "
                        f"{vm.volume!r}"
                    )
        for name, req in tg.volumes.items():
            if req.type == "csi" and not req.source:
                raise JobValidationError(
                    f"volume {name!r} requires a source"
                )
            single_writer = req.type == "csi" and not req.read_only and (
                req.access_mode
                in ("", "single-node-writer", "multi-node-single-writer")
            )
            if single_writer and tg.count > 1 and not req.per_alloc:
                raise JobValidationError(
                    f"volume {name!r} is single-writer but group "
                    f"{tg.name!r} has count {tg.count}; use per_alloc"
                )
