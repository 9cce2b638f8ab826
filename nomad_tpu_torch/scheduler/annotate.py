"""Dry-run planning (`job plan`) — run the scheduler without committing.

Reference: SURVEY.md §3.3 — Job.Plan runs the scheduler inline on a
snapshot with AnnotatePlan=true and the plan is *not* submitted
(scheduler/annotate.go produces the per-group desired-update counts the
CLI renders as "+2 create, ~1 in-place, -1 destroy"). This is also the
zero-risk harness for A/B-ing the TPU scorer against a reference cluster.

The port runs the dry run on ``device`` ("cuda" by default, raising when
CUDA is absent; "cpu" for the plain PyTorch versions), on a private
device-state cache as the reference does.
"""

from __future__ import annotations

import copy
from typing import Optional

from ..structs import Evaluation, Plan, PlanResult
from .scheduler import new_scheduler


class _OverlaySnapshot:
    """A snapshot view with the candidate job overlaid (uncommitted)."""

    def __init__(self, snap, job):
        self._snap = snap
        self._job = job

    def job_by_id(self, namespace, job_id):
        if (namespace, job_id) == (self._job.namespace, self._job.id):
            return self._job
        return self._snap.job_by_id(namespace, job_id)

    def __getattr__(self, name):
        return getattr(self._snap, name)


class _DryRunPlanner:
    """Planner that records the plan instead of submitting it."""

    def __init__(self):
        self.plan: Optional[Plan] = None
        self.evals: list[Evaluation] = []

    def submit_plan(self, plan: Plan):
        self.plan = plan
        # pretend full commit so the scheduler doesn't retry
        result = PlanResult(
            node_allocation={k: list(v) for k, v in plan.node_allocation.items()},
            node_update={k: list(v) for k, v in plan.node_update.items()},
            node_preemptions={
                k: list(v) for k, v in plan.node_preemptions.items()
            },
        )
        return result, None

    def update_eval(self, ev):
        self.evals.append(ev)

    def create_eval(self, ev):
        self.evals.append(ev)

    def reblock_eval(self, ev):
        self.evals.append(ev)


def plan_job(store, job, device="cuda") -> dict:
    """Dry-run the registration of ``job`` on ``device`` and annotate the
    outcome."""
    existing = store.job_by_id(job.namespace, job.id)
    candidate = copy.deepcopy(job)
    candidate.version = existing.version + 1 if existing is not None else 0
    snap = _OverlaySnapshot(store.snapshot(), candidate)
    planner = _DryRunPlanner()
    ev = Evaluation(
        namespace=candidate.namespace,
        priority=candidate.priority,
        type=candidate.type,
        job_id=candidate.id,
        annotate_plan=True,
    )
    sched = new_scheduler(candidate.type, snap, planner, device=device)
    sched.process(ev)

    plan = planner.plan
    annotations: dict[str, dict] = {}
    failed = {}
    for e in planner.evals:
        if e.failed_tg_allocs:
            for tg, metric in e.failed_tg_allocs.items():
                # structured failure detail straight off the AllocMetric
                # the scheduler built — the explain seam stamped its
                # rejection histogram and near-miss score table onto it,
                # so the dry run reports the same counts a live eval
                # would (no re-derivation here)
                failed[tg] = {
                    "coalesced_failures": getattr(
                        metric, "coalesced_failures", 0
                    )
                    + 1,
                    "nodes_evaluated": getattr(metric, "nodes_evaluated", 0),
                    "nodes_exhausted": getattr(metric, "nodes_exhausted", 0),
                    "dimension_exhausted": dict(
                        getattr(metric, "dimension_exhausted", {}) or {}
                    ),
                    "class_exhausted": dict(
                        getattr(metric, "class_exhausted", {}) or {}
                    ),
                    "rejections": dict(
                        getattr(metric, "rejections", {}) or {}
                    ),
                }
    # score provenance without commit: the scheduler kept its per-group
    # explanations (annotate_plan suppresses the flight-recorder ring),
    # so `job plan -verbose` can render candidate tables for a job that
    # never ran
    explanations = {}
    sched_ex = getattr(sched, "explanations", None)
    if sched_ex:
        from ..obs.explain import explanation_to_dict

        explanations = {
            tg: explanation_to_dict(ex) for tg, ex in sched_ex.items()
        }
    if plan is not None:
        placed = {}
        for allocs in plan.node_allocation.values():
            for a in allocs:
                placed[a.task_group] = placed.get(a.task_group, 0) + 1
        stopped = {}
        for allocs in plan.node_update.values():
            for a in allocs:
                stopped[a.task_group] = stopped.get(a.task_group, 0) + 1
        preempted = sum(len(v) for v in plan.node_preemptions.values())
        for tg in candidate.task_groups:
            annotations[tg.name] = {
                "place": placed.get(tg.name, 0),
                "stop": stopped.get(tg.name, 0),
                "preemptions": preempted,
            }
    # gang feasibility verdict: a gang job either commits every member
    # or releases them all (scheduler/generic.py _enforce_gang_atomicity,
    # law 15) — so the dry run can state the all-or-nothing outcome
    # directly instead of making the operator infer it from per-group
    # failure rows
    gang_verdict = None
    gang = getattr(candidate, "gang", None) or {}
    members = list(gang.get("groups") or ())
    if members:
        reasons = sorted({
            r
            for m in members
            for r in (failed.get(m, {}).get("rejections") or {})
            if r.startswith("gang-")
        })
        commits = not any(m in failed for m in members)
        gang_verdict = {
            "members": {
                m: {"place": annotations.get(m, {}).get("place", 0)}
                for m in sorted(members)
            },
            "feasible": commits,
            "released": bool(reasons) or not commits,
            "reasons": reasons,
        }
    return {
        "job_id": candidate.id,
        "version": candidate.version,
        "diff_type": "edited" if existing is not None else "added",
        "annotations": annotations,
        "failed_tg_allocs": failed,
        "placement_explanations": explanations,
        **({"gang": gang_verdict} if gang_verdict is not None else {}),
    }
