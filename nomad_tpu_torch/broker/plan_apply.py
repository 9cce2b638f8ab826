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
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np

from ..chaos.plane import active_plane, chaos_site, note_committed
from ..obs.trace import global_tracer as tracer
from ..structs import (
    Allocation,
    MergedPlan,
    NetworkIndex,
    Plan,
    PlanResult,
    allocs_fit,
)
from ..structs.resources import node_comparable_capacity
from ..utils.metrics import count_swallowed, global_metrics as metrics


class PlanTokenMismatch(Exception):
    """The plan's broker token is no longer the eval's outstanding token:
    the unack deadline redelivered the eval mid-commit and another worker
    owns it now. The stale submitter must drop its plan, not retry —
    committing both copies would place the job twice (a surplus no
    remaining eval reconciles). Mirrors the reference's token validation
    on plan submission (plan_endpoint.go / OutstandingReset)."""


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


def _merged_touched_nodes(plans) -> dict[str, list[int]]:
    """node id → ordered member ordinals touching it (a member appears
    once even when it touches the node in several buckets)."""
    touched: dict[str, list[int]] = {}
    for i, mp in enumerate(plans):
        for bucket in (mp.node_allocation, mp.node_update, mp.node_preemptions):
            for node_id in bucket:
                members = touched.setdefault(node_id, [])
                if not members or members[-1] != i:
                    members.append(i)
    return touched


def _fast_path_slack(snapshot, node_id, member_plans):
    """Vectorized-verify candidacy for one node: when every touching
    member only ADDS networkless, deviceless, claim-free allocations, the
    whole union check reduces to ``free - sum(asks) >= 0`` per dimension.
    Returns that slack vector, or None to route the node to the exact
    per-member walk (which reproduces evaluate_node_plan bit for bit)."""
    node = snapshot.node_by_id(node_id)
    if node is None or node.terminal_status():
        return None
    new_allocs = []
    for mp in member_plans:
        if node_id in mp.node_update or node_id in mp.node_preemptions:
            return None
        new_allocs.extend(mp.node_allocation.get(node_id, ()))
    existing = snapshot.allocs_by_node(node_id)
    existing_ids = {a.id for a in existing}
    for a in new_allocs:
        if (
            a.id in existing_ids  # in-place update: replacement math
            or a.allocated_networks  # needs the NetworkIndex re-check
            or a.allocated_devices  # needs device-pool accounting
            or a.job is not None  # un-normalized: CSI/device asks possible
        ):
            return None
    free = node_comparable_capacity(node).to_vector()
    for a in existing:
        if a.terminal_status():
            continue
        if a.allocated_networks or a.allocated_devices or a.job is not None:
            return None
        free = free - a.comparable_resources().to_vector()
    for a in new_allocs:
        free = free - a.comparable_resources().to_vector()
    return free


def _evaluate_node_members(
    snapshot, node_id: str, ordered, results, claimed
) -> None:
    """Exact member-order admission for one node shared by several member
    plans: each member is checked against existing allocs PLUS everything
    earlier members already got admitted, so two members of one merged
    commit can never jointly overcommit a node. A failing member gets the
    node in its ``rejected_nodes`` (stops still commit — they only free
    capacity); siblings are unaffected. ``ordered`` is [(ordinal,
    member_plan)] in batch order; ``results`` is indexed by ordinal."""
    node = snapshot.node_by_id(node_id)
    node_ok = node is not None and not node.terminal_status()
    base = list(snapshot.allocs_by_node(node_id)) if node_ok else []
    for ordinal, mp in ordered:
        result = results[ordinal]
        stops = mp.node_update.get(node_id, ())
        preempts = mp.node_preemptions.get(node_id, ())
        new_allocs = mp.node_allocation.get(node_id, ())
        if not new_allocs:
            # freeing-only member: always commits (matches evaluate_plan's
            # no-placement branch)
            if stops:
                result.node_update[node_id] = list(stops)
            if preempts:
                result.node_preemptions[node_id] = list(preempts)
            removed = {a.id for a in stops} | {a.id for a in preempts}
            if removed:
                base = [a for a in base if a.id not in removed]
            continue
        ok = node_ok
        proposed: list = []
        if ok:
            removed = {a.id for a in stops} | {a.id for a in preempts}
            new_ids = {a.id for a in new_allocs}
            proposed = [
                a for a in base
                if a.id not in removed and a.id not in new_ids
            ]
            proposed.extend(new_allocs)
            ok, _dim, _used = allocs_fit(node, proposed, check_devices=True)
        if ok and any(
            getattr(a, "allocated_networks", None) for a in proposed
        ):
            ok, _reason = _node_ports_ok(node, proposed, new_allocs)
        if ok and not _csi_claims_ok(snapshot, new_allocs, claimed):
            ok = False
        if not ok:
            result.rejected_nodes.append(node_id)
            # stops still commit — the single-plan partial-commit rule
            if stops:
                result.node_update[node_id] = list(stops)
                stop_ids = {a.id for a in stops}
                base = [a for a in base if a.id not in stop_ids]
            continue
        if stops:
            result.node_update[node_id] = list(stops)
        if preempts:
            result.node_preemptions[node_id] = list(preempts)
        result.node_allocation[node_id] = list(new_allocs)
        base = proposed


def evaluate_merged_plan(snapshot, plans) -> list[PlanResult]:
    """Verify a whole batched pass's member plans in ONE union-of-nodes
    walk instead of N sequential per-plan walks, committing partially per
    MEMBER: a node whose union of asks still fits admits every member in
    one vectorized check; a node that fails (or needs ports / devices /
    CSI / eviction math) drops to the exact member-order walk, where only
    the members that no longer fit are rejected. Each rejected member
    gets its own ``refresh_index``; siblings commit untouched."""
    results = [PlanResult(alloc_index=0) for _ in plans]
    touched = _merged_touched_nodes(plans)
    slow_nodes: list[str] = []
    fast_ids: list[str] = []
    fast_rows: list = []
    for node_id in sorted(touched):
        slack = _fast_path_slack(
            snapshot, node_id, [plans[i] for i in touched[node_id]]
        )
        if slack is None:
            slow_nodes.append(node_id)
        else:
            fast_ids.append(node_id)
            fast_rows.append(slack)
    if fast_ids:
        fits = (np.stack(fast_rows) >= 0).all(axis=1)
        for node_id, node_fits in zip(fast_ids, fits):
            if node_fits:
                for i in touched[node_id]:
                    allocs = plans[i].node_allocation.get(node_id)
                    if allocs:
                        results[i].node_allocation[node_id] = list(allocs)
            else:
                slow_nodes.append(node_id)
    claimed: dict[str, tuple[int, int]] = {}  # vid → (readers, writers)
    for node_id in sorted(slow_nodes):
        _evaluate_node_members(
            snapshot,
            node_id,
            [(i, plans[i]) for i in touched[node_id]],
            results,
            claimed,
        )
    refresh = getattr(snapshot, "latest_index", 0) or getattr(
        snapshot, "index", 0
    )
    for i, mp in enumerate(plans):
        res = results[i]
        res.deployment = mp.deployment
        res.deployment_updates = list(mp.deployment_updates)
        if res.rejected_nodes:
            res.refresh_index = refresh
    return results


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


class PlanApplier:
    """Serialized apply loop state: evaluate against live store, commit
    through the raft seam (applyPlan → raftApply(ApplyPlanResultsRequest),
    plan_apply.go:204-318). One instance per leader. ``commit`` submits the
    PLAN_RESULT FSM message and returns the committed index; when absent
    (bare Harness tests) the result is applied to the store directly.
    ``on_evals_created`` (if set) receives preemption follow-up evals for
    broker enqueue."""

    def __init__(self, store, on_evals_created=None, commit=None,
                 commit_merged=None, lanes=None, token_check=None):
        self.store = store
        self.on_evals_created = on_evals_created
        self.commit = commit
        self.commit_merged = commit_merged
        # LaneMap when deterministic lane ownership is active: merged
        # plans then carry an owner_worker and the applier ASSERTS lane
        # disjointness instead of discovering conflicts optimistically
        self.lanes = lanes
        # callable(eval_id, token) -> bool: is the token still the
        # eval's CURRENT outstanding broker token? The reference's
        # submission guard (plan_endpoint.go token validation): once the
        # unack deadline redelivers an eval, the original worker's plan
        # must not commit — two workers racing one redelivered eval
        # would otherwise both place it (committed surplus with no eval
        # left to reconcile it). None (or an empty plan token) skips the
        # check — direct callers and tests submit outside the broker.
        self.token_check = token_check
        self._lock = threading.Lock()

    def _token_stale(self, plan) -> bool:
        token = getattr(plan, "eval_token", "")
        if not token or self.token_check is None:
            return False
        if self.token_check(plan.eval_id, token):
            return False
        metrics.incr("nomad.plan.stale_token_rejects")
        return True

    def _check_lane_ownership(self, mplan: MergedPlan) -> None:
        """The structural assertion lane mode buys us: every node a
        merged plan places on must belong to the committing worker's
        lanes or be covered by a confirmed cross-lane claim attached to
        the plan. Anything else means a worker escaped the lane
        contract — count it as a lane conflict (invariant law 9 pins the
        counter at zero) and log through the swallow ledger so the
        flight recorder sees it; the member still verifies/commits
        normally (the applier stays the capacity authority)."""
        claimed = {
            n for c in mplan.claims
            if getattr(c, "confirmed", False)
            for n in c.node_ids()
        }
        for plan in mplan.plans:
            for node_id in plan.node_allocation:
                owner = self.lanes.owner_of_node(node_id)
                if owner != mplan.owner_worker and node_id not in claimed:
                    metrics.incr("nomad.plan.lane_conflicts")
                    count_swallowed(
                        "lanes",
                        AssertionError(
                            f"merged plan from worker {mplan.owner_worker} "
                            f"touches node {node_id} (owner w{owner}) "
                            "without a confirmed cross-lane claim"
                        ),
                    )

    def _check_lane_rejections(self, mplan, results) -> None:
        """Post-verify: a rejected node the committing worker does NOT
        own means a cross-lane race slipped the claim protocol (a
        confirmed claim re-checked capacity on a fresh snapshot, so it
        cannot be bounced for fit). Own-lane rejections stay ordinary
        optimistic staleness — solo retry, not a lane conflict."""
        for res in results:
            for node_id in res.rejected_nodes:
                if self.lanes.owner_of_node(node_id) != mplan.owner_worker:
                    metrics.incr("nomad.plan.lane_conflicts")
                    count_swallowed(
                        "lanes",
                        AssertionError(
                            f"cross-lane rejection on {node_id} for "
                            f"worker {mplan.owner_worker}"
                        ),
                    )

    def apply(self, plan: Plan) -> PlanResult:
        with self._lock, tracer.span(
            "plan_apply", timer="nomad.plan.apply"
        ) as sp:
            if self._token_stale(plan):
                raise PlanTokenMismatch(
                    f"eval {plan.eval_id}: broker token rotated before "
                    "apply (redelivered to another worker)"
                )
            with tracer.span(
                "plan_apply.evaluate", timer="nomad.plan.evaluate"
            ):
                chaos_site("plan_apply.verify")
                result = evaluate_plan(self.store, plan)
            if sp is not None:
                sp.tags["rejected_nodes"] = len(result.rejected_nodes)
            if not result.is_no_op() or result.deployment is not None:
                evals = (
                    preemption_evals(self.store, result)
                    if result.node_preemptions else []
                )
                # ledger wants fresh placements only: an id already in
                # the store is an in-place update, not a placement
                fresh = (
                    [
                        a.id
                        for allocs in result.node_allocation.values()
                        for a in allocs
                        if self.store.alloc_by_id(a.id) is None
                    ]
                    if active_plane() is not None
                    else ()
                )
                with tracer.span("plan_apply.commit"):
                    # before the commit executes: a raise here aborts
                    # cleanly (nothing lands, the waiter sees the error)
                    chaos_site("plan_apply.commit")
                    if self.commit is not None:
                        index = self.commit(result, plan.eval_id, evals)
                    else:
                        index = self.store.latest_index + 1
                        self.store.upsert_plan_results(
                            index, result, plan.eval_id
                        )
                        if evals:
                            self.store.upsert_evals(
                                self.store.latest_index + 1, evals
                            )
                note_committed(fresh)
                # commit-train accounting: one FSM apply, one plan landed
                metrics.incr("nomad.plan.commits")
                metrics.incr("nomad.plan.committed_plans")
                result.alloc_index = index
                if evals and self.on_evals_created is not None:
                    # re-read post-commit: a consensus FSM applies COPIES,
                    # so the submitted objects lack committed modify_index
                    self.on_evals_created([
                        self.store.eval_by_id(e.id) or e for e in evals
                    ])
            if result.rejected_nodes:
                result.refresh_index = self.store.latest_index
            return result

    def apply_merged(self, mplan: MergedPlan) -> tuple[list[PlanResult], dict]:
        """Verify + commit one merged batch under the serialized applier
        lock: one union verify pass, one FSM/Raft entry, one store index
        bump — per-member attribution preserved in the returned results.
        Returns (results, phase timings in seconds); the apply loop
        records the timings as shared spans into every member's trace."""
        t_apply = time.perf_counter()
        with self._lock:
            lane_mode = self.lanes is not None and mplan.owner_worker >= 0
            if lane_mode:
                self._check_lane_ownership(mplan)
            t0 = time.perf_counter()
            chaos_site("plan_apply.verify")
            # stale-token members are excluded BEFORE the union verify:
            # a redelivered eval's duplicate placements must neither
            # commit nor consume capacity that would bounce a live
            # sibling. Their result slot is an empty, flagged no-op so
            # per-member attribution stays aligned with mplan.plans.
            stale = [self._token_stale(p) for p in mplan.plans]
            if any(stale):
                live_idx = [i for i, s in enumerate(stale) if not s]
                live = evaluate_merged_plan(
                    self.store, [mplan.plans[i] for i in live_idx]
                )
                results = [
                    PlanResult(token_stale=True) for _ in mplan.plans
                ]
                for i, res in zip(live_idx, live):
                    results[i] = res
            else:
                results = evaluate_merged_plan(self.store, mplan.plans)
            if lane_mode:
                self._check_lane_rejections(mplan, results)
            evaluate_s = time.perf_counter() - t0
            metrics.measure("nomad.plan.evaluate", evaluate_s)
            # merged-only sample so the bench can report the batched
            # verify latency separately from single-plan evaluates
            metrics.measure("nomad.plan.verify_batch", evaluate_s)
            commit_members = [
                (mp.eval_id, res)
                for mp, res in zip(mplan.plans, results)
                if not res.is_no_op() or res.deployment is not None
            ]
            evals: list = []
            for _eid, res in commit_members:
                if res.node_preemptions:
                    evals.extend(preemption_evals(self.store, res))
            t0 = time.perf_counter()
            if commit_members:
                fresh = (
                    [
                        a.id
                        for _eid, res in commit_members
                        for allocs in res.node_allocation.values()
                        for a in allocs
                        if self.store.alloc_by_id(a.id) is None
                    ]
                    if active_plane() is not None
                    else ()
                )
                chaos_site("plan_apply.commit")
                committed = [res for _eid, res in commit_members]
                eval_ids = [eid for eid, _res in commit_members]
                if self.commit_merged is not None:
                    index = self.commit_merged(committed, eval_ids, evals)
                elif self.commit is not None:
                    # merged callback not wired: stay correct with
                    # per-member commits (evals ride the first one)
                    index = 0
                    for i, (eid, res) in enumerate(commit_members):
                        index = self.commit(
                            res, eid, evals if i == 0 else []
                        )
                else:
                    index = self.store.latest_index + 1
                    self.store.upsert_merged_plan_results(index, committed)
                    if evals:
                        self.store.upsert_evals(
                            self.store.latest_index + 1, evals
                        )
                metrics.incr("nomad.plan.commits")
                metrics.incr(
                    "nomad.plan.committed_plans", len(commit_members)
                )
                metrics.incr("nomad.plan.merged_commits")
                metrics.incr(
                    "nomad.plan.merged_members", len(commit_members)
                )
                for _eid, res in commit_members:
                    res.alloc_index = index
                note_committed(fresh)
                if evals and self.on_evals_created is not None:
                    self.on_evals_created([
                        self.store.eval_by_id(e.id) or e for e in evals
                    ])
            commit_s = time.perf_counter() - t0
            for res in results:
                if res.rejected_nodes:
                    res.refresh_index = self.store.latest_index
            apply_s = time.perf_counter() - t_apply
            metrics.measure("nomad.plan.apply", apply_s)
            return results, {
                "apply_s": apply_s,
                "evaluate_s": evaluate_s,
                "commit_s": commit_s,
            }
