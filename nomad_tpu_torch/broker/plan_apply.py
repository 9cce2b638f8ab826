"""Plan applier — the leader's serialization point.

Reference: nomad/plan_apply.go. The scheduler's plan was computed against a
possibly-stale snapshot, so before commit the applier re-verifies, node by
node, that every proposed placement still fits (evaluateNodePlan :638-689
re-runs AllocsFit against the leader's current state), partially commits
what fits, and hands back ``refresh_index`` so the worker retries the
remainder on fresher state (:576-594). Port assignment happens here too —
the scheduler scored with bandwidth/port-count aggregates only (the
guess-then-verify split, SURVEY.md §7 "hard parts").

The reference parallelizes per-node verification over an EvaluatePool of
NumCPU/2 goroutines (plan_apply_pool.go:18-40); here the same check is a
vectorized host pass (and the touched-node count per plan is small).

The port carries the per-plan check (``evaluate_plan``) that the
scheduler harness applies; the serialized ``PlanApplier`` loop and the
merged-plan commit of the server are not ported yet (ROADMAP queue A).
"""

from __future__ import annotations

from ..structs import NetworkIndex, Plan, PlanResult, allocs_fit


def evaluate_node_plan(snapshot, plan: Plan, node_id: str) -> tuple[bool, str]:
    """Can this node absorb the plan's changes for it?
    (plan_apply.go:638-689). Returns (fits, reason)."""
    node = snapshot.node_by_id(node_id)
    if node is None:
        return False, "node does not exist"
    if node.terminal_status():
        return False, "node is not allowed to receive allocations"

    existing = snapshot.allocs_by_node(node_id)
    removed = {
        a.id for a in plan.node_update.get(node_id, ())
    } | {a.id for a in plan.node_preemptions.get(node_id, ())}
    proposed = [a for a in existing if a.id not in removed]
    # updated allocs replace their stored copy
    new_allocs = plan.node_allocation.get(node_id, ())
    new_ids = {a.id for a in new_allocs}
    proposed = [a for a in proposed if a.id not in new_ids]
    proposed.extend(new_allocs)

    ok, dim, _used = allocs_fit(node, proposed, check_devices=True)
    if not ok:
        return False, f"resources exhausted: {dim}"

    # port collision re-check — skipped entirely when nothing on the
    # node carries a network (the common case; building a NetworkIndex
    # per touched node was a measurable slice of the applier's verify)
    if any(getattr(a, "allocated_networks", None) for a in proposed):
        return _node_ports_ok(node, proposed, new_allocs)
    return True, ""


def _node_ports_ok(node, proposed, new_allocs) -> tuple[bool, str]:
    """Port-collision re-check for one node: existing reservations index
    first, then each new alloc's ports against it (evaluateNodePlan's
    NetworkIndex walk)."""
    new_ids = {a.id for a in new_allocs}
    idx = NetworkIndex(node)
    if not idx.add_allocs(a for a in proposed if a.id not in new_ids):
        return False, "port collision in existing allocations"
    for a in new_allocs:
        for net in a.allocated_networks:
            for p in net.reserved_ports + net.dynamic_ports:
                if p.value in idx.used_ports:
                    return False, f"port {p.value} already in use"
        for net in a.allocated_networks:
            idx.add_reserved_network(net)
    return True, ""


def _csi_claims_ok(snapshot, allocs, claimed: dict) -> bool:
    """Optimistic CSI re-verify: would every placed alloc's volume claim
    still succeed against current claim state? ``claimed`` accumulates
    in-plan claims (readers and writers) so two placements in one plan
    can't jointly exceed a volume's access mode — the claim analog of
    evaluateNodePlan's AllocsFit re-check.

    Claims are staged into a local copy and merged into ``claimed`` only
    when the whole node passes; a rejected node's allocs never commit, so
    leaking their claims would spuriously block later nodes in the plan."""
    from ..structs.volumes import (
        ACCESS_MODE_MULTI_NODE_MULTI_WRITER,
        ACCESS_MODE_SINGLE_NODE_READER,
        ACCESS_MODE_SINGLE_NODE_WRITER,
    )

    staged = dict(claimed)
    for a in allocs:
        if a.job is None or a.client_status != "pending":
            continue
        tg = a.job.lookup_task_group(a.task_group)
        if tg is None or not getattr(tg, "volumes", None):
            continue
        for req in tg.volumes.values():
            if req.type != "csi":
                continue
            vid = req.source
            if req.per_alloc:
                per = f"{req.source}[{a.index()}]"
                if snapshot.csi_volume_by_id(per) is not None:
                    vid = per
            vol = snapshot.csi_volume_by_id(vid)
            if vol is None:
                return False
            if not vol.claimable(req.read_only):
                return False
            readers, writers = staged.get(vid, (0, 0))
            single_node = vol.access_mode in (
                ACCESS_MODE_SINGLE_NODE_READER,
                ACCESS_MODE_SINGLE_NODE_WRITER,
            )
            if req.read_only:
                # single-node modes admit one claimant total
                if single_node and (
                    readers + writers + len(vol.read_claims)
                    + len(vol.write_claims)
                ) >= 1:
                    return False
                staged[vid] = (readers + 1, writers)
            else:
                if vol.access_mode != ACCESS_MODE_MULTI_NODE_MULTI_WRITER and (
                    writers + len(vol.write_claims) >= 1
                    or (single_node and readers + len(vol.read_claims) >= 1)
                ):
                    return False
                staged[vid] = (readers, writers + 1)
    claimed.update(staged)
    return True


def evaluate_plan(snapshot, plan: Plan) -> PlanResult:
    """Per-node verify + partial commit (plan_apply.go:400-596): nodes that
    fail verification are dropped from the result; when anything is
    dropped, refresh_index tells the worker to retry on fresher state."""
    result = PlanResult(alloc_index=0)
    rejected = []
    touched = set(plan.node_allocation) | set(plan.node_update) | set(
        plan.node_preemptions
    )
    claimed: dict[str, tuple[int, int]] = {}  # vid → (readers, writers)
    for node_id in sorted(touched):
        has_new = node_id in plan.node_allocation
        if has_new:
            ok, reason = evaluate_node_plan(snapshot, plan, node_id)
            if ok and not _csi_claims_ok(
                snapshot, plan.node_allocation[node_id], claimed
            ):
                ok = False
            if not ok:
                rejected.append(node_id)
                # stops/preemptions still commit (they only free capacity)
                if node_id in plan.node_update:
                    result.node_update[node_id] = list(plan.node_update[node_id])
                continue
        if node_id in plan.node_update:
            result.node_update[node_id] = list(plan.node_update[node_id])
        if node_id in plan.node_preemptions:
            result.node_preemptions[node_id] = list(
                plan.node_preemptions[node_id]
            )
        if has_new:
            result.node_allocation[node_id] = list(plan.node_allocation[node_id])

    result.rejected_nodes = rejected
    if rejected:
        result.refresh_index = getattr(snapshot, "latest_index", 0) or getattr(
            snapshot, "index", 0
        )
    result.deployment = plan.deployment
    result.deployment_updates = list(plan.deployment_updates)
    return result


def preemption_evals(store, result: PlanResult) -> list:
    """One follow-up evaluation per job that lost allocations to
    preemption, so victim jobs replace their capacity (the reference
    applier creates PreemptionEvals in applyPlan, nomad/plan_apply.go)."""
    from ..structs import Evaluation
    from ..structs.evaluation import EVAL_STATUS_PENDING, TRIGGER_PREEMPTION

    jobs: dict[tuple[str, str], object] = {}
    for allocs in result.node_preemptions.values():
        for a in allocs:
            jobs.setdefault((a.namespace, a.job_id), a)
    evals = []
    for (ns, job_id), _a in jobs.items():
        job = store.job_by_id(ns, job_id)
        if job is None or job.stopped():
            continue
        evals.append(
            Evaluation(
                namespace=ns,
                priority=job.priority,
                type=job.type,
                triggered_by=TRIGGER_PREEMPTION,
                job_id=job_id,
                status=EVAL_STATUS_PENDING,
            )
        )
    return evals
