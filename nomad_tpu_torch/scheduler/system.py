"""SystemScheduler — place one alloc per feasible node (system/sysbatch).

Reference: scheduler/scheduler_system.go (:27 SystemScheduler, :72 Process).
Where the generic scheduler asks "which node for each alloc", the system
scheduler asks "which nodes at all" — on device that's simply the
feasibility mask itself: every eligible node that fits gets a placement,
computed in one vectorized pass (no greedy scan needed; allocs of a system
job never stack on one node).

The port scores each group through the registry's ``score_group`` on the
scheduler's ``device`` (the score-matrix kernel) and selects victims on
the host (``preempt_host.select_victims``). Each eval's explanations go to
the flight recorder's ring (``obs/recorder.py``), as in the reference.
"""

from __future__ import annotations

import numpy as np

from ..device import flatten_group_ask
from ..device.cache import DeviceStateCache
from .algorithms import score_group
from ..structs import (
    ALLOC_DESIRED_RUN,
    Allocation,
    AllocMetric,
    ComparableResources,
    EVAL_STATUS_COMPLETE,
    Evaluation,
    new_id,
)
from .generic import tainted_nodes
from .reconcile import REASON_ALLOC_LOST, REASON_ALLOC_NOT_NEEDED
from .scheduler import Planner, register_scheduler

MAX_SYSTEM_SCHEDULE_ATTEMPTS = 5  # scheduler_system.go:12-21


@register_scheduler("system")
@register_scheduler("sysbatch")
class SystemScheduler:
    def __init__(
        self,
        snapshot,
        planner: Planner,
        *,
        sysbatch: bool = False,
        cache=None,
        overlay=None,  # accepted for factory uniformity; system placement
        # is per-node (no greedy packing), so the overlay isn't consulted
        node_filter=None,  # likewise unused: a system job runs on EVERY
        # eligible node, so lane restriction would be semantically wrong
        device="cuda",
    ):
        self.snapshot = snapshot
        self.planner = planner
        self.sysbatch = sysbatch
        self.cache = cache if cache is not None else DeviceStateCache(device)
        self.device = self.cache.device
        self.eval = None
        self.job = None
        self.plan = None
        self.failed_tg_allocs: dict[str, AllocMetric] = {}
        self.explanations: dict[str, object] = {}  # tg → PlacementExplanation

    def process(self, evaluation: Evaluation) -> None:
        self.eval = evaluation
        self.sysbatch = self.sysbatch or evaluation.type == "sysbatch"
        self._explain = bool(
            getattr(
                self.snapshot.scheduler_config(),
                "placement_explanations",
                True,
            )
        )
        for _ in range(MAX_SYSTEM_SCHEDULE_ATTEMPTS):
            if self._process_once():
                break
        if self.explanations and not evaluation.annotate_plan:
            from ..obs.explain import explanation_to_dict
            from ..obs.recorder import flight_recorder

            flight_recorder.record_explanation(
                evaluation.id,
                {
                    "eval_id": evaluation.id,
                    "job_id": evaluation.job_id,
                    "namespace": evaluation.namespace,
                    "groups": {
                        tg: explanation_to_dict(ex)
                        for tg, ex in self.explanations.items()
                    },
                },
            )
        import copy

        updated = copy.copy(evaluation)
        updated.status = EVAL_STATUS_COMPLETE
        updated.failed_tg_allocs = dict(self.failed_tg_allocs)
        self.planner.update_eval(updated)

    def _process_once(self) -> bool:
        ev = self.eval
        self.job = self.snapshot.job_by_id(ev.namespace, ev.job_id)
        self.plan = ev.make_plan(self.job)
        existing = self.snapshot.allocs_by_job(ev.namespace, ev.job_id)
        tainted = tainted_nodes(self.snapshot, existing)

        live_by_node_group: dict[tuple[str, str], Allocation] = {}
        for a in existing:
            if a.terminal_status():
                # a completed sysbatch alloc satisfies its node permanently
                # (the batch don't-rerun rule, scheduler_system.go sysbatch)
                if self.sysbatch and a.client_status == "complete":
                    live_by_node_group.setdefault((a.node_id, a.task_group), a)
                continue
            node = tainted.get(a.node_id)
            if node is not None:
                if node.terminal_status():
                    self.plan.append_lost_alloc(a)
                elif a.desired_transition.migrate:
                    # draining: wait for the NodeDrainer's wave mark
                    # (reconcile_util.go filterByTainted — system allocs
                    # leave a draining node only when marked migrating)
                    self.plan.append_stopped_alloc(
                        a, "alloc stopped because node is draining"
                    )
                else:
                    live_by_node_group[(a.node_id, a.task_group)] = a
                continue
            if a.desired_transition.migrate:
                # migrate mark on a HEALTHY node: `alloc stop` — the
                # system reconcile stops it and (the node still being a
                # live placement target below) replaces it in place
                self.plan.append_stopped_alloc(
                    a, "alloc is stopped by user"
                )
                continue
            live_by_node_group[(a.node_id, a.task_group)] = a

        stopped_job = self.job is None or self.job.stopped()
        if stopped_job:
            for a in live_by_node_group.values():
                self.plan.append_stopped_alloc(a, REASON_ALLOC_NOT_NEEDED)
            return self._submit()

        ct = self.cache.tensors(self.snapshot)
        nodes_sorted = ct.nodes

        for tg in self.job.task_groups:
            ga = flatten_group_ask(
                ct, self.snapshot, self.job, tg, 1, nodes_sorted=nodes_sorted
            )
            scored = score_group(
                ct, ga, float(max(tg.count, 1)), explain=self._explain,
                device=self.device,
            )
            if self._explain:
                finals, fits_np, ex = scored
                self.explanations[tg.name] = ex
                # breakdowns are derived against the usage the finals
                # were scored with, not the post-placement overlay
                used_at_score = np.asarray(ct.used).copy()
            else:
                finals, fits_np = scored
                ex = None
            eligible_rows = np.nonzero(ga.eligible[: ct.num_nodes])[0]
            ask_res = tg.combined_resources()
            comparable = ComparableResources(
                cpu=ask_res.cpu,
                memory_mb=ask_res.memory_mb,
                disk_mb=ask_res.disk_mb,
                bandwidth_mbits=ask_res.bandwidth_mbits(),
            )
            for row in eligible_rows:
                node_id = ct.node_ids[row]
                if (node_id, tg.name) in live_by_node_group:
                    continue  # already running there
                preempted_ids: list[str] = []
                if not fits_np[row]:
                    preempted_ids = self._try_preempt_node(ct, tg, row, ga.ask)
                    if not preempted_ids:
                        m = self._fail_metric(node_id, "resources", ex)
                        self._record_failure(tg.name, m)
                        continue
                if (
                    not preempted_ids
                    and ga.slot_caps is not None
                    and ga.slot_caps[row] < 1
                ):
                    # device instances exist but are all held — system
                    # preemption may free them (PreemptForDevice)
                    preempted_ids = self._try_preempt_node(ct, tg, row, ga.ask)
                    if not preempted_ids:
                        m = self._fail_metric(node_id, "devices", ex)
                        self._record_failure(tg.name, m)
                        continue
                alloc_id = new_id()
                # victims enter the plan BEFORE device assignment so
                # collect_in_use sees their instances as freed; a failed
                # assignment rolls the eviction back (the generic path's
                # dev_ok contract, generic.py _try_preempt)
                victim_total = None
                for vid in preempted_ids:
                    victim = self.snapshot.alloc_by_id(vid)
                    if victim is not None:
                        self.plan.append_preempted_alloc(victim, alloc_id)
                        vec = victim.comparable_resources().to_vector()
                        victim_total = (
                            vec if victim_total is None else victim_total + vec
                        )
                devices, dev_ok = self._assign_devices(tg, node_id)
                if not dev_ok:
                    from .device import rollback_plan_preemptions

                    rollback_plan_preemptions(
                        self.plan, node_id, preempted_ids
                    )
                    m = self._fail_metric(node_id, "devices", ex)
                    self._record_failure(tg.name, m)
                    continue
                metric = AllocMetric(nodes_evaluated=1)
                metric.scores[f"{node_id}.score"] = float(finals[row])
                if ex is not None:
                    from ..obs.explain import score_meta_for_row

                    metric.score_meta = [
                        score_meta_for_row(
                            ct,
                            ga,
                            used_at_score,
                            int(row),
                            desired_total=float(max(tg.count, 1)),
                        )
                    ]
                    ex.placed_nodes.append(node_id)
                alloc = Allocation(
                    id=alloc_id,
                    namespace=self.job.namespace,
                    eval_id=ev.id,
                    name=f"{self.job.id}.{tg.name}[0]",
                    node_id=node_id,
                    job_id=self.job.id,
                    job=self.job,
                    job_version=self.job.version,
                    task_group=tg.name,
                    resources=comparable.copy(),
                    desired_status=ALLOC_DESIRED_RUN,
                    client_status="pending",
                    metrics=metric,
                    allocated_devices=devices or [],
                )
                if preempted_ids:
                    alloc.preempted_allocations = list(preempted_ids)
                    if victim_total is not None:
                        ct.used[row] -= victim_total
                # every placement debits the (private) usage overlay so
                # later task groups' fit checks and victim selection see
                # this plan's own load
                ct.used[row] += ga.ask
                self.plan.append_alloc(alloc)
            # stop allocs on nodes no longer eligible (e.g. constraint
            # change) — but NOT draining nodes: those drain via the
            # NodeDrainer's migrate marks, not eligibility loss
            eligible_ids = {ct.node_ids[r] for r in eligible_rows}
            for (node_id, tg_name), a in list(live_by_node_group.items()):
                if (
                    tg_name == tg.name
                    and node_id not in eligible_ids
                    and node_id not in tainted
                    and not a.terminal_status()
                ):
                    self.plan.append_stopped_alloc(a, REASON_ALLOC_NOT_NEEDED)

        return self._submit()

    def _try_preempt_node(self, ct, tg, row, ask_vec) -> list[str]:
        """System-job preemption on one node (the node IS the target for
        system placements — no search needed). Enabled by default per
        SchedulerConfiguration.PreemptionConfig.SystemSchedulerEnabled
        (nomad/structs/operator.go:164-169, scheduler_system.go:27);
        victim selection is the reference-exact host greedy
        (preempt_host.select_victims: maxParallel, ports, devices)."""
        cfg = self.snapshot.scheduler_config()
        if not cfg.preemption_system_enabled or self.job is None:
            return []
        from ..device.preempt import PREEMPTION_PRIORITY_DELTA
        from .preempt_host import select_victims

        if self.job.priority < PREEMPTION_PRIORITY_DELTA:
            return []
        already = {
            a.id
            for allocs in self.plan.node_preemptions.values()
            for a in allocs
        }
        ids = select_victims(
            ct,
            self.snapshot,
            self.job,
            tg,
            ask_vec,
            row,
            plan=self.plan,
            exclude_ids=already,
        )
        return ids or []

    def _assign_devices(self, tg, node_id):
        from .device import assign_devices_for_plan

        return assign_devices_for_plan(self.snapshot, self.plan, tg, node_id)

    @staticmethod
    def _fail_metric(node_id: str, dim: str, ex) -> AllocMetric:
        m = AllocMetric(nodes_evaluated=1)
        m.exhausted_node(node_id, dim)
        if ex is not None:
            # fleet-wide rejection histogram rides the (coalesced) failed
            # metric so `eval status` explains the whole group, not just
            # the first failing node
            m.rejections = dict(ex.rejections)
        return m

    def _record_failure(self, tg_name: str, metric: AllocMetric) -> None:
        existing = self.failed_tg_allocs.get(tg_name)
        if existing is not None:
            existing.coalesced_failures += 1
        else:
            self.failed_tg_allocs[tg_name] = metric

    def _submit(self) -> bool:
        if self.plan.is_no_op():
            return True
        result, new_snap = self.planner.submit_plan(self.plan)
        if new_snap is not None:
            self.snapshot = new_snap
        full, _, _ = result.full_commit(self.plan)
        return full
