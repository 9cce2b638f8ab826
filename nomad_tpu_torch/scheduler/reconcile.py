"""Alloc reconciler — declarative diff of desired vs actual state.

Reference: scheduler/reconcile.go (allocReconciler.Compute :189-259) and
reconcile_util.go (allocSet/allocNameIndex). Pure host-side set arithmetic
(SURVEY.md §7 step 7): given the job spec and its existing allocations,
produce the result taxonomy — place / stop / ignore / in-place update /
destructive update / migrate / lost — that the scheduler turns into a plan.

Round-1 scope: core service/batch reconciliation incl. tainted-node
handling, reschedule eligibility and count changes. Deployment/canary
orchestration layers on in a later round (the result taxonomy already
carries the fields it needs).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

from ..structs import (
    ALLOC_CLIENT_COMPLETE,
    ALLOC_CLIENT_FAILED,
    ALLOC_CLIENT_LOST,
    ALLOC_DESIRED_STOP,
    Allocation,
    Job,
    JOB_TYPE_BATCH,
    Node,
    TaskGroup,
)

# Stop/update description strings (structs.go AllocUpdateReason*)
REASON_ALLOC_NOT_NEEDED = "alloc not needed due to job update"
REASON_ALLOC_STOPPED = "alloc is stopped by user"
REASON_NODE_TAINTED = "alloc was rescheduled because of a node drain/down"
REASON_ALLOC_LOST = "alloc lost since node is down"


@dataclass(slots=True)
class PlaceRequest:
    """One placement the scheduler must make."""

    name: str
    task_group: TaskGroup
    previous_alloc: Optional[Allocation] = None  # replacement chains
    reschedule_penalty_node: str = ""  # node to penalize (rank.go:606)
    canary: bool = False


@dataclass(slots=True)
class StopRequest:
    alloc: Allocation
    reason: str
    client_status: str = ""


@dataclass(slots=True)
class UpdateRequest:
    alloc: Allocation
    new_job: Job


@dataclass(slots=True)
class ReconcileResults:
    """Mirrors reconcileResults (reconcile.go:93-125)."""

    place: list[PlaceRequest] = field(default_factory=list)
    stop: list[StopRequest] = field(default_factory=list)
    inplace_update: list[UpdateRequest] = field(default_factory=list)
    destructive_update: list[tuple[Allocation, PlaceRequest]] = field(
        default_factory=list
    )
    ignore: list[Allocation] = field(default_factory=list)
    # failed allocs whose replacement must wait (backoff) — become
    # followup evals with wait_until (generic_sched.go:718-753)
    disconnect_followups: list[tuple[Allocation, float]] = field(default_factory=list)
    desired_tg_updates: dict[str, dict] = field(default_factory=dict)
    # groups that need a (new) deployment to track their rollout:
    # tg name → DeploymentState template (reconcile.go's deployment logic)
    deployment_states: dict[str, object] = field(default_factory=dict)


def tasks_updated(old_job: Job, new_job: Job, group_name: str) -> bool:
    """Would updating to new_job require restarting the group's tasks?
    Mirrors scheduler/util.go tasksUpdated: drivers, config, env, resources,
    constraints, artifacts, networks are destructive; count is not."""
    a = old_job.lookup_task_group(group_name)
    b = new_job.lookup_task_group(group_name)
    if a is None or b is None:
        return True
    if len(a.tasks) != len(b.tasks):
        return True
    if a.ephemeral_disk.size_mb != b.ephemeral_disk.size_mb:
        return True
    if [c.key() for c in a.constraints] != [c.key() for c in b.constraints]:
        return True
    by_name = {t.name: t for t in b.tasks}
    for ta in a.tasks:
        tb = by_name.get(ta.name)
        if tb is None:
            return True
        if (
            ta.driver != tb.driver
            or ta.user != tb.user
            or ta.config != tb.config
            or ta.env != tb.env
            or ta.artifacts != tb.artifacts
            or ta.resources.cpu != tb.resources.cpu
            or ta.resources.memory_mb != tb.resources.memory_mb
            or len(ta.resources.networks) != len(tb.resources.networks)
            or [c.key() for c in ta.constraints] != [c.key() for c in tb.constraints]
        ):
            return True
    return False


class AllocNameIndex:
    """Bitmap-style tracker of claimed alloc name indices per group
    (reconcile_util.go allocNameIndex): freed indices are reused so names
    stay dense in [0, count)."""

    def __init__(self, job_id: str, group: str, count: int, existing):
        self.job_id = job_id
        self.group = group
        self.count = count
        self.used: set[int] = set()
        for a in existing:
            idx = a.index()
            if idx >= 0:
                self.used.add(idx)

    def next(self, n: int) -> list[str]:
        out = []
        i = 0
        while len(out) < n:
            if i not in self.used:
                self.used.add(i)
                out.append(f"{self.job_id}.{self.group}[{i}]")
            i += 1
        return out

    def highest(self, n: int) -> set[int]:
        return set(sorted(self.used, reverse=True)[:n])


def reconcile(
    job: Optional[Job],
    job_id: str,
    existing: list[Allocation],
    tainted_nodes: dict[str, Node],
    *,
    batch: bool = False,
    now_ns: Optional[int] = None,
    deployment=None,
) -> ReconcileResults:
    """Compute the diff for one job.

    ``job`` None or stopped ⇒ stop everything. ``tainted_nodes`` maps node
    id → Node for down/draining nodes (scheduler/util.go:354 taintedNodes).
    ``deployment`` is the job's latest deployment (if any): groups with an
    update strategy gate their destructive replacements on it — canaries
    first, then at most ``max_parallel`` in-flight unhealthy replacements
    (reconcile.go's deployment-aware computeGroup logic).
    """
    r = ReconcileResults()
    # injection fallback only: schedulers pass now_ns from their context
    # clock so replays are deterministic
    if now_ns is None:
        now_ns = time.time_ns()  # nta: allow=NTA001
    stopped = job is None or job.stopped()

    live = [a for a in existing if not a.terminal_status()]

    if stopped:
        for a in live:
            r.stop.append(StopRequest(a, REASON_ALLOC_STOPPED))
        return r

    by_group: dict[str, list[Allocation]] = {tg.name: [] for tg in job.task_groups}
    for a in existing:
        by_group.setdefault(a.task_group, []).append(a)

    for tg_name, allocs in by_group.items():
        tg = job.lookup_task_group(tg_name)
        counts = {
            "place": 0, "stop": 0, "migrate": 0, "ignore": 0,
            "in_place_update": 0, "destructive_update": 0,
        }
        if tg is None:
            # group removed from job
            for a in allocs:
                if not a.terminal_status():
                    r.stop.append(StopRequest(a, REASON_ALLOC_NOT_NEEDED))
                    counts["stop"] += 1
            r.desired_tg_updates[tg_name] = counts
            continue

        desired = tg.count
        keep: list[Allocation] = []  # allocs that count toward desired
        replace: list[tuple[Allocation, str]] = []  # (prev, penalty_node)

        for a in allocs:
            node = tainted_nodes.get(a.node_id)
            if a.terminal_status():
                if (
                    a.client_status == ALLOC_CLIENT_FAILED
                    and a.desired_status == "run"
                ):
                    # failed: reschedule or leave to followup
                    pol = tg.reschedule_policy
                    if a.followup_eval_id:
                        r.ignore.append(a)
                        counts["ignore"] += 1
                    elif a.next_allocation:
                        r.ignore.append(a)
                        counts["ignore"] += 1
                    elif a.should_reschedule(pol, now_ns):
                        delay = a.next_reschedule_delay(pol) if pol else 0.0
                        if delay > 0:
                            r.disconnect_followups.append((a, delay))
                            counts["ignore"] += 1
                        else:
                            replace.append((a, a.node_id))
                    else:
                        r.ignore.append(a)
                        counts["ignore"] += 1
                elif batch and a.client_status == ALLOC_CLIENT_COMPLETE:
                    # batch jobs: successful completions are not replaced
                    keep.append(a)
                    r.ignore.append(a)
                    counts["ignore"] += 1
                else:
                    r.ignore.append(a)
                    counts["ignore"] += 1
                continue

            if node is not None:
                # tainted node
                if node.terminal_status():
                    # node down ⇒ alloc lost; replace
                    r.stop.append(
                        StopRequest(a, REASON_ALLOC_LOST, ALLOC_CLIENT_LOST)
                    )
                    counts["stop"] += 1
                    replace.append((a, ""))
                elif a.desired_transition.migrate:
                    # draining migrates wave-by-wave: only allocs the
                    # NodeDrainer marked (DesiredTransition.ShouldMigrate,
                    # reconcile_util.go filterByTainted) move now —
                    # migrate.max_parallel is enforced by the drainer
                    r.stop.append(StopRequest(a, REASON_NODE_TAINTED))
                    counts["migrate"] += 1
                    replace.append((a, a.node_id))
                else:
                    # still on a draining node, waiting for its wave
                    keep.append(a)
                    r.ignore.append(a)
                    counts["ignore"] += 1
                continue

            if a.desired_transition.migrate:
                # migrate mark on a HEALTHY node: `alloc stop`
                # (alloc_endpoint.go Stop sets DesiredTransition and the
                # reconciler replaces the alloc wherever it sits)
                r.stop.append(StopRequest(a, REASON_ALLOC_STOPPED))
                counts["migrate"] += 1
                replace.append((a, a.node_id))
                continue

            keep.append(a)

        # deployment gating context for this group
        u = tg.update
        dstate = (
            deployment.task_groups.get(tg_name)
            if deployment is not None
            and deployment.active()
            and deployment.job_version == job.version
            else None
        )
        # a FAILED deployment for this very version halts the rollout —
        # no further replacements, no fresh deployment — until a new job
        # version (e.g. auto-revert) arrives; a PAUSED one freezes it the
        # same way until the operator resumes (deployment_endpoint.go
        # Pause: an eval arriving mid-pause must not advance the rollout)
        rollout_halted = (
            deployment is not None
            and deployment.job_version == job.version
            and deployment.status in ("failed", "paused")
        )
        # unpromoted canaries run *beside* the old version: they don't
        # count toward desired and must not trigger surplus stops
        canaries: list[Allocation] = []
        if u is not None and u.canary > 0 and (
            dstate is None or not dstate.promoted
        ):
            canaries = [
                a for a in keep if a.canary and a.job_version == job.version
            ]
            keep = [a for a in keep if a not in canaries]

        # count adjustment over the kept (healthy, untainted) allocs
        n_target = desired - len(replace)
        if len(keep) > n_target:
            # stop surplus: old-version allocs first (a promoted canary on
            # the new version must survive the count convergence), then
            # highest name indices (allocNameIndex)
            surplus = len(keep) - max(n_target, 0)
            keep_sorted = sorted(
                keep,
                key=lambda a: (a.job_version == job.version, -a.index()),
            )
            for a in keep_sorted[:surplus]:
                if a.terminal_status():
                    continue
                r.stop.append(StopRequest(a, REASON_ALLOC_NOT_NEEDED))
                counts["stop"] += 1
            keep = keep_sorted[surplus:]

        # in-place vs destructive updates for survivors on old job versions;
        # the verdict is cached per old job *version* (allocs in one group
        # can sit on different stale versions with different diffs)
        updated_by_version: dict[int, bool] = {}
        destructive_candidates: list[tuple[Allocation, PlaceRequest]] = []
        for a in keep:
            if a.job_version == job.version or a.terminal_status():
                r.ignore.append(a)
                counts["ignore"] += 1
                continue
            if a.job_version not in updated_by_version:
                old = a.job if a.job is not None else job
                updated_by_version[a.job_version] = tasks_updated(
                    old, job, tg_name
                )
            if updated_by_version[a.job_version]:
                pr = PlaceRequest(name=a.name, task_group=tg, previous_alloc=a)
                destructive_candidates.append((a, pr))
            else:
                r.inplace_update.append(UpdateRequest(a, job))
                counts["in_place_update"] += 1

        # rollout gating (reconcile.go computeGroup): with an update
        # strategy, destructive replacements are throttled by the
        # deployment's health signal instead of happening all at once
        if rollout_halted and u is not None:
            for a, _pr in destructive_candidates:
                r.ignore.append(a)
                counts["ignore"] += 1
            destructive_candidates = []
        canary_phase = (
            u is not None
            and u.canary > 0
            and destructive_candidates
            and (dstate is None or not dstate.promoted)
        )
        if canary_phase:
            # canary phase: place missing canaries, leave old version alone
            need = u.canary - len(
                [a for a in canaries if not a.terminal_status()]
            )
            cname_idx = AllocNameIndex(job.id, tg_name, desired, allocs)
            for name in cname_idx.next(max(need, 0)):
                r.place.append(
                    PlaceRequest(name=name, task_group=tg, canary=True)
                )
                counts["place"] += 1
            for a, _pr in destructive_candidates:
                r.ignore.append(a)
                counts["ignore"] += 1
            destructive_candidates = []
        elif (
            u is not None and u.rolling() and destructive_candidates
        ):
            current = [
                a
                for a in keep + canaries
                if a.job_version == job.version and not a.terminal_status()
            ]
            healthy = len(
                [
                    a
                    for a in current
                    if a.deployment_status is not None
                    and a.deployment_status.is_healthy()
                ]
            )
            in_flight = len(current) - healthy
            budget = max(u.max_parallel - in_flight, 0)
            deferred = destructive_candidates[budget:]
            destructive_candidates = destructive_candidates[:budget]
            for a, _pr in deferred:
                r.ignore.append(a)
                counts["ignore"] += 1

        for a, pr in destructive_candidates:
            r.destructive_update.append((a, pr))
            counts["destructive_update"] += 1

        # signal that this rollout needs deployment tracking
        if (
            not rollout_halted
            and u is not None
            and u.rolling()
            and (destructive_candidates or canary_phase or dstate is None)
            and (
                deployment is None
                or not deployment.active()
                or deployment.job_version != job.version
            )
            and (destructive_candidates or canary_phase or job.version > 0)
        ):
            from ..structs.deployment import DeploymentState

            r.deployment_states[tg_name] = DeploymentState(
                auto_revert=u.auto_revert,
                auto_promote=u.auto_promote,
                desired_canaries=u.canary if canary_phase else 0,
                desired_total=desired,
                progress_deadline_s=u.progress_deadline_s,
            )

        # placements for missing + replacements; batch-complete allocs in
        # ``keep`` count toward desired (their work is done, not missing)
        live_count = len(keep)
        missing = max(desired - live_count - len(replace), 0)
        # terminal allocs release their name index for reuse
        # (reconcile_util.go allocNameIndex tracks live names only)
        name_idx = AllocNameIndex(
            job.id,
            tg_name,
            desired,
            [a for a in allocs if not a.terminal_status()],
        )
        for prev, penalty in replace:
            r.place.append(
                PlaceRequest(
                    name=prev.name,
                    task_group=tg,
                    previous_alloc=prev,
                    reschedule_penalty_node=penalty,
                )
            )
            counts["place"] += 1
        for name in name_idx.next(missing):
            r.place.append(PlaceRequest(name=name, task_group=tg))
            counts["place"] += 1

        r.desired_tg_updates[tg_name] = counts

    return r
