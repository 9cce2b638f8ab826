"""GenericScheduler — service and batch job scheduling with the TPU
placement backend.

Reference control flow: scheduler/generic_sched.go — Process (:125) retry
loop, process (:216), computeJobAllocs (:332), computePlacements (:472),
blocked-eval creation (:193-212), attempt limits (:15-22: 5 service /
2 batch). The per-placement iterator walk the reference does inside
computePlacements is replaced wholesale by one batched device kernel call
per (job, task group): flatten → greedy placement scan on device → build
allocations from the chosen rows (SURVEY.md §7 steps 3+5).

The port binds this control flow to the PyTorch device layer: the
scheduler's ``device`` reaches the kernel factory, the device-state
cache and the preemption search (``device/preempt.py``); every
registered algorithm (binpack, spread, hetero-*, cp-pack, cp-gang) runs
on its ported kernel. Learned throughputs (``throughput_source =
"learned"``) read the calibration plane's estimator
(``wire_throughput_source``). The batched multi-eval methods
(``prepare_batch_attempt``, ``build_batch_plan``,
``complete_merged_attempt``, ``complete_batch_attempt``) serve the server
worker (``server/worker.py``), which merges evals through them with its
lanes, overlay and decorrelation; the ``overlay`` and ``node_filter``
hooks keep a solo eval inside that accounting.
"""

from __future__ import annotations

import time
from typing import Optional

from ..device import flatten_group_ask
from ..device.cache import DeviceStateCache
from .algorithms import make_kernel
from ..obs.trace import global_tracer as tracer
from ..structs import (
    ALLOC_DESIRED_RUN,
    EVAL_STATUS_COMPLETE,
    EVAL_STATUS_FAILED,
    Allocation,
    AllocMetric,
    ComparableResources,
    Evaluation,
    Plan,
    TRIGGER_MAX_PLANS,
    new_id,
)
from ..structs.evaluation import (
    EVAL_STATUS_BLOCKED,
    TRIGGER_JOB_REGISTER,
    TRIGGER_QUEUED_ALLOCS,
)
from .reconcile import reconcile
from .scheduler import Planner, register_scheduler

MAX_SERVICE_SCHEDULE_ATTEMPTS = 5  # generic_sched.go:15-18
MAX_BATCH_SCHEDULE_ATTEMPTS = 2  # generic_sched.go:19-22

BLOCKED_EVAL_MAX_PLAN_DESC = "created due to placement conflicts"
BLOCKED_EVAL_FAILED_PLACEMENTS_DESC = "created to place remaining allocations"


class FailedTGAlloc:
    """Per-group placement-failure metrics attached to the eval
    (structs.AllocMetric in Evaluation.FailedTGAllocs)."""

    def __init__(self, metric: AllocMetric):
        self.metric = metric


def wire_throughput_source(kernel, cfg) -> None:
    """Calibration seam: in learned mode the hetero kernel reads the
    process-global ThroughputEstimator instead of declared jobspec
    coefficients. Same Python-level gating discipline as explain —
    "declared" (the default, and every non-hetero kernel) touches
    nothing, so the pre-calibration path stays bit-identical."""
    if (
        getattr(cfg, "throughput_source", "declared") == "learned"
        and hasattr(kernel, "throughput_source")
    ):
        from ..obs.calibrate import global_estimator

        kernel.throughput_source = "learned"
        kernel.estimator = global_estimator


def tainted_nodes(snapshot, allocs) -> dict:
    """Map node id → Node for nodes that are down or draining
    (scheduler/util.go:354-378). Nodes missing from state count as tainted
    (down)."""
    out = {}
    for a in allocs:
        if a.node_id in out:
            continue
        node = snapshot.node_by_id(a.node_id)
        if node is None:
            from ..structs import Node, NODE_STATUS_DOWN

            out[a.node_id] = Node(id=a.node_id, status=NODE_STATUS_DOWN)
        elif node.terminal_status() or node.drain is not None or not node.ready():
            if node.status != "initializing":
                out[a.node_id] = node
    return out


@register_scheduler("service")
@register_scheduler("batch")
class GenericScheduler:
    def __init__(
        self,
        snapshot,
        planner: Planner,
        *,
        batch: bool = False,
        cache=None,
        clock=None,
        overlay=None,
        node_filter=None,
        device="cuda",
    ):
        self.snapshot = snapshot
        self.planner = planner
        self.batch = batch
        # injectable clock: every wall-time the scheduler stamps into a
        # plan (deployment deadlines, followup-eval times, reschedule
        # events) reads this, so replaying an eval stream against a fixed
        # clock reproduces byte-identical plans (NTA001 enforces it)
        self.clock = clock if clock is not None else time.time
        # resident device-state cache — one per harness; a private one
        # here keeps standalone scheduler construction working
        self.cache = cache if cache is not None else DeviceStateCache(device)
        self.device = self.cache.device
        # server-shared optimistic overlay (server/overlay.py): single-
        # eval processing runs CONCURRENTLY with pipelined batch commits
        # (fallback evals execute inside commit threads), so an
        # overlay-blind single pass seeds the very conflicts it was
        # retrying — it must score against, and reserve into, the same
        # in-flight accounting as the batched passes
        self.overlay = overlay
        # optional eligibility restriction: callable(ct) → bool[padded_n]
        # row mask ANDed into every ask. Lane mode uses it to keep a
        # batch worker's solo fallback inside its own lanes (a solo
        # plan has no cross-lane handoff, so foreign nodes are out);
        # shortfalls become blocked evals, never foreign-node writes.
        self.node_filter = node_filter
        # any registered algorithm's kernel (scheduler/algorithms.py) —
        # all satisfy the PlacementKernel.place contract
        self.kernel = None
        self.eval: Optional[Evaluation] = None
        self.job = None
        self.plan: Optional[Plan] = None
        self.failed_tg_allocs: dict[str, AllocMetric] = {}
        self.queued_allocs: dict[str, int] = {}
        self.followup_evals: list[Evaluation] = []
        self.blocked: Optional[Evaluation] = None

    # -- entry point ------------------------------------------------------
    def process(self, evaluation: Evaluation) -> None:
        """Retry loop (generic_sched.go:125-214)."""
        self.eval = evaluation
        self.batch = self.batch or evaluation.type == "batch"
        limit = (
            MAX_BATCH_SCHEDULE_ATTEMPTS
            if self.batch
            else MAX_SERVICE_SCHEDULE_ATTEMPTS
        )
        cfg = self.snapshot.scheduler_config()
        self.scheduler_config = cfg
        self.kernel = make_kernel(cfg.scheduler_algorithm, device=self.device)
        wire_throughput_source(self.kernel, cfg)
        self._explain = bool(getattr(cfg, "placement_explanations", True))

        success = False
        for _attempt in range(limit):
            done, reschedule = self._process_once()
            if done:
                success = True
                break
            if not reschedule:
                break
        if not success and not self._finished:
            # max plan attempts: mark failed, roll a new blocked eval so the
            # job eventually converges (generic_sched.go:156-193)
            self._set_status(EVAL_STATUS_FAILED, "maximum attempts reached")
            blocked = evaluation.create_blocked_eval({}, True, "", {})
            blocked.triggered_by = TRIGGER_MAX_PLANS
            blocked.status_description = BLOCKED_EVAL_MAX_PLAN_DESC
            self.planner.create_eval(blocked)
            return
        self._finalize()

    _finished = False

    # -- one attempt ------------------------------------------------------
    def _process_once(self) -> tuple[bool, bool]:
        """Returns (done, should_retry)."""
        placements = self._start_attempt()
        if placements and self.job is not None:
            ct, tg_order = self._build_group_asks(placements)
            asks = [t[3] for t in tg_order]
            if self.node_filter is not None and asks:
                mask = self.node_filter(ct)
                for a in asks:
                    a.eligible &= mask
            used_override = None
            if self.overlay is not None:
                used_override = self.overlay.begin_pass(ct)
            try:
                with tracer.span(
                    "kernel_score",
                    tags={"lanes": len(asks), "explain": self._explain},
                ):
                    results = self.kernel.place(
                        ct, asks, used_override=used_override,
                        explain=self._explain,
                    )
                    # the repair walk is also the single-eval safety net:
                    # it resolves cross-TG conflicts within this plan and
                    # re-places kernel shortfalls by exact host re-score
                    # before they read as placement failures
                    from ..device.score import repair_batch_conflicts

                    repair_batch_conflicts(
                        ct, asks, results,
                        algorithm_spread=self.kernel.algorithm_spread,
                        # single-eval: no fresh state to re-run against,
                        # so an unplaceable placement fails into the
                        # blocked-eval accounting instead of aborting the
                        # lane
                        fail_on_contention=True,
                        used_override=used_override,
                    )
                    if self._explain:
                        # repair moves rows in place, so provenance is
                        # stamped from the POST-repair (= committed) rows
                        from ..obs.explain import finalize_explanations

                        finalize_explanations(
                            ct, asks, results, used_override=used_override
                        )
                if self.overlay is not None:
                    for a, res in zip(asks, results):
                        rows = res.node_rows[res.node_rows >= 0]
                        if rows.size:
                            self.overlay.add_delta(ct, rows, a.ask)
                self._finish_placements(ct, tg_order, results)
                self._adjust_queued()
                # the pass marker is held through plan SUBMISSION: once
                # released with the commit not yet applied, a concurrent
                # worker's maybe_reset() could drop the overlay while
                # these placements are still only predictions
                return self._submit_attempt()
            finally:
                if self.overlay is not None:
                    self.overlay.pass_finished()
        return self._submit_attempt()

    # -- batched multi-eval pass (SURVEY.md §7 step 5) --------------------
    def prepare_batch_attempt(self, evaluation: Evaluation, ct=None):
        """Phase A of a batched multi-eval device pass: run the host side
        (reconcile + flatten) and return this eval's group asks for the
        caller to merge into one kernel call across evals — the batch
        dimension replacing the reference's worker-per-core concurrency
        (nomad/worker.go:85, SURVEY.md §2.7).

        ``ct`` is the batch-shared ClusterTensors the caller fetched ONCE
        for the whole batch: every eval's masks must be built against the
        same row order as the capacity/used arrays of the combined kernel
        call (a mid-batch cache-generation advance would otherwise hand
        later evals a differently-ordered transient build).

        Returns the list of GroupAsks, or None when the eval needs the
        individual path: no placement work at all, or a plan whose
        evictions couple placements to freed capacity (the in-plan used
        overlay is eval-local and can't share one batched ``used0``).
        """
        self.eval = evaluation
        self.batch = self.batch or evaluation.type == "batch"
        cfg = self.snapshot.scheduler_config()
        self.scheduler_config = cfg
        self.kernel = make_kernel(cfg.scheduler_algorithm, device=self.device)
        wire_throughput_source(self.kernel, cfg)
        self._explain = bool(getattr(cfg, "placement_explanations", True))
        placements = self._start_attempt()
        if not placements or self.job is None:
            return None
        if self.plan.node_update or self.plan.node_preemptions:
            return None  # evictions free capacity only for this eval's plan
        ct, tg_order = self._build_group_asks(placements, ct=ct)
        self._batch_ctx = (ct, tg_order)
        return [t[3] for t in tg_order]

    def complete_batch_attempt(self, results) -> bool:
        """Phase B: consume this eval's slice of the combined kernel
        results. Returns True when the eval is fully handled (plan
        committed, eval finalized); False when the caller must fall back
        to the individual retry path on a fresh scheduler (partial
        commit against the optimistic shared snapshot)."""
        plan = self.build_batch_plan(results)
        if plan is None:
            return True
        result, new_snap = self.planner.submit_plan(plan)
        return self.complete_merged_attempt(result, new_snapshot=new_snap)

    def build_batch_plan(self, results) -> Optional[Plan]:
        """Phase B1 of the coalesced commit path: consume this eval's
        slice of the combined kernel results and hand back the plan for
        the worker to merge into ONE batch submit. Creates any followup
        evals eagerly (their ids are referenced by in-plan allocs, so
        they must commit before the plan does). Returns None when there
        is nothing to submit — the eval is finalized in place."""
        ct, tg_order = self._batch_ctx
        self._finish_placements(ct, tg_order, results)
        self._adjust_queued()
        if self.plan.is_no_op() and not self.followup_evals:
            self._finished = True
            self._finalize()
            return None
        for f in self.followup_evals:
            self.planner.create_eval(f)
        return self.plan

    def complete_merged_attempt(self, result, new_snapshot=None) -> bool:
        """Phase B2: consume this member's PlanResult from the merged
        apply. Full commit → finalize, True. Partial commit (this member
        went stale under the shared optimistic snapshot) → False: the
        caller retries the eval individually on fresh state; batch
        siblings are unaffected."""
        if new_snapshot is not None:
            self.snapshot = new_snapshot
        full, _expected, _actual = result.full_commit(self.plan)
        if not full:
            return False
        self._finished = True
        self._finalize()
        return True

    def _start_attempt(self):
        """Host-side first half of one attempt: reconcile and build the
        plan's stops/updates; returns the placements list."""
        ev = self.eval
        self.failed_tg_allocs = {}
        self.explanations = {}  # tg_name → PlacementExplanation
        self.followup_evals = []
        self._preempt_rank_cache = {}  # per-attempt: ct/used change
        self.job = self.snapshot.job_by_id(ev.namespace, ev.job_id)
        self.plan = ev.make_plan(self.job)
        self.plan.snapshot_index = getattr(self.snapshot, "index", 0)

        existing = self.snapshot.allocs_by_job(ev.namespace, ev.job_id)
        tainted = tainted_nodes(self.snapshot, existing)
        deployment = self.snapshot.latest_deployment_by_job(
            ev.namespace, ev.job_id
        )
        results = reconcile(
            self.job,
            ev.job_id,
            existing,
            tainted,
            batch=self.batch,
            now_ns=int(self.clock() * 1e9),
            deployment=deployment,
        )

        # deployment lifecycle (reconcile.go + deploymentwatcher semantics):
        # create one for a gated rollout; cancel one superseded by a newer
        # job version
        self.deployment = None
        if deployment is not None and deployment.active() and self.job is not None:
            if deployment.job_version == self.job.version:
                self.deployment = deployment
            else:
                from ..structs.deployment import DESC_NEW_VERSION

                self.plan.deployment_updates.append(
                    {
                        "deployment_id": deployment.id,
                        "status": "cancelled",
                        "description": DESC_NEW_VERSION,
                    }
                )
        if results.deployment_states and self.job is not None:
            from ..structs.deployment import Deployment

            now = self.clock()
            for s in results.deployment_states.values():
                s.require_progress_by_unix = now + s.progress_deadline_s
            new_d = Deployment(
                namespace=self.job.namespace,
                job_id=self.job.id,
                job_version=self.job.version,
                task_groups=dict(results.deployment_states),
            )
            self.plan.deployment = new_d
            self.deployment = new_d

        # stops
        for stop in results.stop:
            self.plan.append_stopped_alloc(
                stop.alloc, stop.reason, stop.client_status
            )
        # in-place updates: same node, new job version
        for upd in results.inplace_update:
            a = upd.alloc.copy_for_update()
            a.job = upd.new_job
            a.job_version = upd.new_job.version
            self.plan.append_alloc(a)
        # destructive updates: stop old + place new
        destructive_places = []
        for old, pr in results.destructive_update:
            self.plan.append_stopped_alloc(
                old, "alloc updated in-place failed; destructive update"
            )
            destructive_places.append(pr)

        placements = results.place + destructive_places

        # delayed reschedules become followup evals (generic_sched.go:718-753);
        # the failed alloc is updated in-plan with followup_eval_id so later
        # reconciles don't spawn duplicates (reconcile.py checks it)
        now = self.clock()
        by_delay: dict[float, Evaluation] = {}
        for alloc, delay in results.disconnect_followups:
            f = by_delay.get(delay)
            if f is None:
                f = ev.create_failed_follow_up_eval(delay, now)
                by_delay[delay] = f
                self.followup_evals.append(f)
            linked = alloc.copy_for_update()
            linked.followup_eval_id = f.id
            self.plan.append_alloc(linked)

        # baseline queued = everything this eval will try to place (fresh
        # placements AND destructive replacements, both in ``placements``)
        self.queued_allocs = {
            tg: c["place"] + c["destructive_update"]
            for tg, c in results.desired_tg_updates.items()
        }
        return placements

    def _adjust_queued(self) -> None:
        """queued = what we could NOT place (adjustQueuedAllocations,
        scheduler/util.go:954 — planned allocs are subtracted)."""
        placed_per_tg: dict[str, int] = {}
        for allocs in self.plan.node_allocation.values():
            for a in allocs:
                if a.eval_id == self.eval.id and a.client_status == "pending":
                    placed_per_tg[a.task_group] = (
                        placed_per_tg.get(a.task_group, 0) + 1
                    )
        for tg in list(self.queued_allocs):
            self.queued_allocs[tg] = max(
                0, self.queued_allocs[tg] - placed_per_tg.get(tg, 0)
            )

    def _submit_attempt(self) -> tuple[bool, bool]:
        """Second half of one attempt: no-op check → submit → full-commit
        check. Returns (done, should_retry)."""
        if self.plan.is_no_op() and not self.followup_evals:
            self._finished = True
            return True, False

        for f in self.followup_evals:
            self.planner.create_eval(f)
        # link placements awaiting delayed evals
        result, new_snap = self.planner.submit_plan(self.plan)
        if new_snap is not None:
            self.snapshot = new_snap

        full, expected, actual = result.full_commit(self.plan)
        if not full:
            # partial commit — retry against refreshed state
            return False, True
        self._finished = True
        return True, False

    # -- placement via the device kernel ---------------------------------
    def _build_group_asks(self, placements, ct=None):
        """Flatten this eval's placements into dense group asks against
        the resident tensors (replaces computePlacements' per-alloc
        stack.Select walk). Returns (ct, tg_order). ``ct`` lets a batch
        caller supply one shared tensors object for all evals."""
        snap = self.snapshot
        if ct is None:
            ct = self.cache.tensors(snap)
        nodes_sorted = ct.nodes
        # overlay this plan's own stops (evicted allocs free capacity)
        for node_id, stops in self.plan.node_update.items():
            row = ct.node_row.get(node_id)
            if row is None:
                continue
            for a in stops:
                ct.used[row] -= a.comparable_resources().to_vector()

        # group placements by task group
        by_tg: dict[str, list] = {}
        for pr in placements:
            by_tg.setdefault(pr.task_group.name, []).append(pr)

        tg_order = []
        for tg_name, prs in by_tg.items():
            tg = self.job.lookup_task_group(tg_name)
            penalty_nodes = {
                pr.reschedule_penalty_node
                for pr in prs
                if pr.reschedule_penalty_node
            }
            ga = flatten_group_ask(
                ct,
                snap,
                self.job,
                tg,
                len(prs),
                nodes_sorted=nodes_sorted,
                penalty_node_ids=penalty_nodes,
                plan=self.plan,
            )
            tg_order.append((tg_name, prs, tg, ga))
        return ct, tg_order

    def _finish_placements(self, ct, tg_order, results) -> None:
        """Consume kernel results: build allocations, run the preemption
        fallback for failures, record metrics."""
        # per-DC ready-node counts walk the whole cluster — filled once
        # per cache generation into the shared dc_ready_counts dict (see
        # ClusterTensors; profiled at 450k ready() calls per 75-eval
        # commit window without it). Mutated in place: rebinding would
        # only update this call's wrapper object.
        nodes_available = ct.dc_ready_counts
        if not nodes_available:
            for n in ct.nodes:
                if n.ready():
                    nodes_available[n.datacenter] = (
                        nodes_available.get(n.datacenter, 0) + 1
                    )
        from .device import group_device_asks

        for (tg_name, prs, tg, ga), res in zip(tg_order, results):
            explanation = getattr(res, "explanation", None)
            if explanation is not None:
                self.explanations[tg_name] = explanation
            instance_meta = getattr(explanation, "instance_meta", None)
            ask_res = tg.combined_resources()
            comparable = ComparableResources(
                cpu=ask_res.cpu,
                memory_mb=ask_res.memory_mb,
                disk_mb=ask_res.disk_mb,
                bandwidth_mbits=ask_res.bandwidth_mbits(),
            )
            # device assignment is per-ALLOC; skip the whole path for the
            # common deviceless group (profiled at 23µs × every alloc)
            tg_has_devices = bool(group_device_asks(tg))
            for i, (pr, row, score) in enumerate(
                zip(prs, res.node_rows, res.scores)
            ):
                metric = AllocMetric(
                    nodes_evaluated=ct.num_nodes,
                    nodes_available=dict(nodes_available),
                )
                if row < 0:
                    # second pass with preemption enabled
                    # (generic_sched.go:773-792 selectNextOption)
                    placed = self._try_preempt(ct, pr, tg_name, ga, comparable)
                    if placed:
                        continue
                    metric.coalesced_failures = 0
                    # explainability: why nodes were filtered/exhausted
                    # (AllocMetric, structs.go:10034-10079)
                    fs = ga.filter_stats
                    metric.nodes_filtered = fs.get("nodes_filtered", 0)
                    metric.constraint_filtered = dict(
                        fs.get("constraint_filtered", {})
                    )
                    metric.class_filtered = dict(fs.get("class_filtered", {}))
                    self._record_exhaustion(metric, ct, ga)
                    if explanation is not None:
                        # near-miss table + structured rejection histogram
                        # ride the failed metric into the blocked eval
                        from ..obs.explain import candidates_as_score_meta

                        metric.score_meta = candidates_as_score_meta(
                            explanation
                        )
                        metric.rejections = dict(explanation.rejections)
                    self._record_failure(tg_name, metric)
                    continue
                node_id = ct.node_ids[row]
                metric.scores[f"{node_id}.score"] = float(score)
                if instance_meta is not None and instance_meta[i] is not None:
                    # this alloc's own per-component breakdown (the
                    # reference's ScoreMetaData row for the winner)
                    metric.score_meta = [instance_meta[i]]
                devices, dev_ok = (
                    self._assign_devices(tg, node_id)
                    if tg_has_devices
                    else (None, True)
                )
                if not dev_ok:
                    # slot_caps are snapshot-scoped; a sibling group in
                    # this same plan took the instances. Fail the
                    # placement rather than shipping a device-less alloc
                    # that would poison the whole node plan at apply time.
                    metric.exhausted_node(node_id, "devices")
                    self._record_failure(tg_name, metric)
                    continue
                alloc = Allocation(
                    id=new_id(),
                    namespace=self.job.namespace,
                    eval_id=self.eval.id,
                    name=pr.name,
                    node_id=node_id,
                    job_id=self.job.id,
                    job=self.job,
                    job_version=self.job.version,
                    task_group=tg_name,
                    resources=comparable.copy(),
                    desired_status=ALLOC_DESIRED_RUN,
                    client_status="pending",
                    metrics=metric,
                )
                if devices:
                    alloc.allocated_devices = devices
                if self.deployment is not None and tg_name in (
                    self.deployment.task_groups
                ):
                    alloc.deployment_id = self.deployment.id
                    alloc.canary = pr.canary
                if pr.previous_alloc is not None:
                    alloc.previous_allocation = pr.previous_alloc.id
                    prev = pr.previous_alloc
                    if prev.client_status in ("failed", "lost"):
                        # carry the reschedule history forward + record this
                        # attempt (generic_sched.go updateRescheduleTracker)
                        from ..structs import RescheduleEvent, RescheduleTracker

                        events = list(
                            prev.reschedule_tracker.events
                            if prev.reschedule_tracker
                            else []
                        )
                        events.append(
                            RescheduleEvent(
                                reschedule_time_ns=int(self.clock() * 1e9),
                                prev_alloc_id=prev.id,
                                prev_node_id=prev.node_id,
                            )
                        )
                        alloc.reschedule_tracker = RescheduleTracker(events=events)
                self.plan.append_alloc(alloc)
        self._enforce_gang_atomicity(ct)

    GANG_RELEASE_DESC = "alloc released: gang member group failed placement"

    def _enforce_gang_atomicity(self, ct) -> None:
        """All-or-nothing commit for the job's gang stanza (invariant
        law 15): if any member group failed placement this pass — or the
        whole gang releases: this plan's member placements come back
        out, surviving member allocs from prior evals are stopped, and
        EVERY member lands in ``failed_tg_allocs`` with per-group
        rejection detail, so the gang rides one blocked eval instead of
        striping a partial plan. Algorithm-independent on purpose: the
        cp-gang kernel already releases within a pass, and this seam
        holds the invariant across passes, fallbacks, and partial plan
        commits (a partially-committed gang from an optimistic plan is
        clawed back by the stop path on the retry eval)."""
        job = self.job
        gang = getattr(job, "gang", None) if job is not None else None
        members = set((gang or {}).get("groups") or ())
        if not members or job.stopped():
            return
        failed = members & set(self.failed_tg_allocs)
        reason = "gang-infeasible"
        if not failed:
            return
        from ..utils.metrics import global_metrics

        released = 0
        for node_id in list(self.plan.node_allocation):
            allocs = self.plan.node_allocation[node_id]
            kept = [
                a for a in allocs
                if a.job_id != job.id or a.task_group not in members
            ]
            released += len(allocs) - len(kept)
            if kept:
                self.plan.node_allocation[node_id] = kept
            else:
                del self.plan.node_allocation[node_id]
        already = {
            a.id for ups in self.plan.node_update.values() for a in ups
        }
        stopped = 0
        if self.snapshot is not None:
            for a in self.snapshot.allocs_by_job(job.namespace, job.id):
                if (
                    a.terminal_status()
                    or a.desired_status != ALLOC_DESIRED_RUN
                    or a.task_group not in members
                    or a.id in already
                ):
                    continue
                self.plan.append_stopped_alloc(a, self.GANG_RELEASE_DESC)
                stopped += 1
        for tg_name in sorted(members):
            metric = self.failed_tg_allocs.get(tg_name)
            if metric is None:
                metric = AllocMetric(
                    nodes_evaluated=ct.num_nodes if ct is not None else 0
                )
                self.failed_tg_allocs[tg_name] = metric
            metric.rejections[reason] = metric.rejections.get(reason, 0) + 1
        global_metrics.incr("nomad.gang.releases")
        if released:
            global_metrics.incr("nomad.gang.released_allocs", released)
        if stopped:
            global_metrics.incr("nomad.gang.stopped_allocs", stopped)

    def _assign_devices(self, tg, node_id):
        from .device import assign_devices_for_plan

        return assign_devices_for_plan(self.snapshot, self.plan, tg, node_id)

    @staticmethod
    def _record_exhaustion(metric, ct, ga) -> None:
        """Count eligible nodes that lacked free capacity, per dimension
        (BinPackIterator's 'dimension exhausted' accounting, rank.go:483)."""
        import numpy as np

        from ..structs.resources import RESOURCE_DIMS

        elig = ga.eligible[: ct.num_nodes]
        if not elig.any():
            return
        free = (ct.capacity - ct.used)[: ct.num_nodes][elig]
        short = free < ga.ask[None, :]
        exhausted = short.any(axis=1)
        metric.nodes_exhausted = int(exhausted.sum())
        for d, dim in enumerate(RESOURCE_DIMS):
            n = int(short[:, d].sum())
            if n:
                metric.dimension_exhausted[dim] = (
                    metric.dimension_exhausted.get(dim, 0) + n
                )
        if ga.slot_caps is not None:
            # eligible nodes whose device instances are the binding limit
            # (resource dims fit but the device pool is drained)
            dev_capped = (~exhausted) & np.isfinite(
                ga.slot_caps[: ct.num_nodes][elig]
            )
            n = int(dev_capped.sum())
            if n:
                metric.nodes_exhausted += n
                metric.dimension_exhausted["devices"] = (
                    metric.dimension_exhausted.get("devices", 0) + n
                )
        if ga.has_throughputs and ga.throughputs is not None:
            # class-infeasible accounting: eligible nodes whose device
            # class the job cannot run on (tp == 0), bucketed by class
            # name so `eval status` says which classes to expand
            infeasible = ga.throughputs[: ct.num_nodes][elig] <= 0.0
            if infeasible.any():
                classes = ct.device_class_column()[: ct.num_nodes][elig]
                vocab = ct.device_class_vocab
                for cid in np.unique(classes[infeasible]):
                    name = vocab[int(cid)] or "none"
                    metric.class_exhausted[name] = metric.class_exhausted.get(
                        name, 0
                    ) + int((classes[infeasible] == cid).sum())

    def _preemption_enabled(self) -> bool:
        cfg = self.scheduler_config
        return (
            cfg.preemption_batch_enabled
            if self.batch
            else cfg.preemption_service_enabled
        )

    def _try_preempt(self, ct, pr, tg_name, ga, comparable) -> bool:
        """Preemption fallback for one failed placement: one device pass
        per GROUP ranks every node's cheapest feasible victim set
        (device/preempt.py — the shortlist is cached across this plan's
        failures, so G failed placements cost one [N, V] kernel pass, not
        G); the final victim set on a shortlisted node is chosen by the
        reference-exact host greedy (preempt_host.select_victims:
        maxParallel penalty, reserved ports, device instances). Victims
        are evicted in-plan and the placement lands on their node
        (generic_sched.go:795 handlePreemptions)."""
        if not self._preemption_enabled() or self.job is None:
            return False
        from ..device.preempt import (
            PREEMPTION_PRIORITY_DELTA,
            rank_preemption_nodes,
        )
        from .preempt_host import select_victims

        if self.job.priority < PREEMPTION_PRIORITY_DELTA:
            return False
        # hard constraints still bind under preemption: distinct_hosts
        # excludes nodes already holding this job (snapshot + in-plan)
        eligible = ga.eligible
        if ga.distinct_hosts:
            eligible = eligible & (ga.job_counts == 0)
            for node_id, allocs in self.plan.node_allocation.items():
                if any(a.job_id == self.job.id for a in allocs):
                    r = ct.node_row.get(node_id)
                    if r is not None:
                        eligible = eligible.copy()
                        eligible[r] = False
        # allocs already evicted by this plan free capacity exactly once
        already_preempted = {
            a.id
            for allocs in self.plan.node_preemptions.values()
            for a in allocs
        }
        cache = getattr(self, "_preempt_rank_cache", None)
        if cache is None:
            cache = self._preempt_rank_cache = {}
        shortlist = cache.get(tg_name)
        if shortlist is None:
            shortlist = rank_preemption_nodes(
                ct,
                self.snapshot,
                self.job,
                ga.ask,
                eligible,
                exclude_ids=already_preempted,
                device=self.device,
            )
            cache[tg_name] = shortlist
        tg = self.job.lookup_task_group(tg_name)
        row, victim_ids = None, []
        for cand_row in shortlist:
            # the shortlist is cached per group, but eligibility is
            # recomputed per failure (distinct_hosts excludes nodes this
            # plan already used) — stale rows are skipped, not trusted
            if not eligible[cand_row]:
                continue
            ids = select_victims(
                ct,
                self.snapshot,
                self.job,
                tg,
                ga.ask,
                cand_row,
                plan=self.plan,
                exclude_ids=already_preempted,
            )
            if ids:
                row, victim_ids = cand_row, ids
                break
        if row is None or not victim_ids:
            return False
        node_id = ct.node_ids[row]
        alloc_id = new_id()
        victim_total = None
        for vid in victim_ids:
            victim = self.snapshot.alloc_by_id(vid)
            if victim is None:
                return False
            self.plan.append_preempted_alloc(victim, alloc_id)
            vec = victim.comparable_resources().to_vector()
            victim_total = vec if victim_total is None else victim_total + vec
        metric = AllocMetric(nodes_evaluated=ct.num_nodes)
        metric.scores[f"{node_id}.preemption"] = 1.0
        alloc = Allocation(
            id=alloc_id,
            namespace=self.job.namespace,
            eval_id=self.eval.id,
            name=pr.name,
            node_id=node_id,
            job_id=self.job.id,
            job=self.job,
            job_version=self.job.version,
            task_group=tg_name,
            resources=comparable.copy(),
            desired_status=ALLOC_DESIRED_RUN,
            client_status="pending",
            metrics=metric,
            preempted_allocations=list(victim_ids),
        )
        if pr.previous_alloc is not None:
            alloc.previous_allocation = pr.previous_alloc.id
        tg = self.job.lookup_task_group(tg_name)
        if tg is not None:
            devices, dev_ok = self._assign_devices(tg, node_id)
            if not dev_ok:
                # victims chosen by resource distance didn't free the
                # needed device instances — abandon this preemption
                # rather than shipping a device-less alloc
                from .device import rollback_plan_preemptions

                rollback_plan_preemptions(self.plan, node_id, victim_ids)
                return False
            if devices:
                alloc.allocated_devices = devices
        self.plan.append_alloc(alloc)
        # keep the device-resident usage honest for subsequent fallbacks
        ct.used[row] += ga.ask - (victim_total if victim_total is not None else 0)
        return True

    def _record_failure(self, tg_name: str, metric: AllocMetric) -> None:
        existing = self.failed_tg_allocs.get(tg_name)
        if existing is not None:
            existing.coalesced_failures += 1
        else:
            self.failed_tg_allocs[tg_name] = metric

    # -- completion -------------------------------------------------------
    def _finalize(self) -> None:
        ev = self.eval
        if self.failed_tg_allocs and not self.batch:
            # create/update blocked eval to hold unplaced work
            # (generic_sched.go:193-212)
            blocked = ev.create_blocked_eval({}, True, "", self.failed_tg_allocs)
            blocked.status_description = BLOCKED_EVAL_FAILED_PLACEMENTS_DESC
            # carry the unplaced counts so parked blocked evals are
            # auditable (bench accounting: placed + blocked == total)
            blocked.queued_allocations = dict(self.queued_allocs)
            # record the snapshot the failure was computed against, so the
            # blocked-evals tracker can detect missed unblocks
            blocked.snapshot_index = getattr(self.snapshot, "index", 0)
            self.planner.create_eval(blocked)
            self.blocked = blocked
        if self.explanations and not ev.annotate_plan:
            # ring the per-group explanations so `alloc why` /
            # `/v1/evaluations/:id/placement` can answer after the fact;
            # dry-run (job plan) returns them inline and skips the ring
            from ..obs.explain import explanation_to_dict
            from ..obs.recorder import flight_recorder

            flight_recorder.record_explanation(
                ev.id,
                {
                    "eval_id": ev.id,
                    "job_id": ev.job_id,
                    "namespace": getattr(ev, "namespace", "default"),
                    "groups": {
                        tg: explanation_to_dict(ex)
                        for tg, ex in self.explanations.items()
                    },
                },
            )
        self._set_status(EVAL_STATUS_COMPLETE, "")

    def _set_status(self, status: str, desc: str) -> None:
        ev = self.eval
        import copy

        updated = copy.copy(ev)
        updated.status = status
        updated.status_description = desc
        updated.failed_tg_allocs = dict(self.failed_tg_allocs)
        updated.queued_allocations = dict(self.queued_allocs)
        self.planner.update_eval(updated)
