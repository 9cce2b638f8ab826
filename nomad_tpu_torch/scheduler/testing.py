"""Harness — in-memory Planner for tests and benchmarks.

Reference: scheduler/testing.go:43-279. SubmitPlan applies results to a
real StateStore exactly as the FSM would (:83-175), so scheduler tests
exercise the true state-mutation path; RejectPlan-style hooks force the
partial-commit/refresh retry path (:18). The benchmark grid drives this
same harness (scheduler/benchmarks/benchmarks_test.go).

``device`` names where the placement kernels run: "cuda" by default
(raising when CUDA is absent), "cpu" for the plain PyTorch versions.

``Harness.process_merged`` runs several service/batch evals as ONE
batched device pass through ``GenericScheduler``'s multi-eval methods —
a small mirror of the server worker's batch pass (``server/worker.py``)
without its lanes, overlay, decorrelation or commit thread, for tests
and paths that drive the scheduler without a server.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..broker.plan_apply import evaluate_plan
from ..device.cache import DeviceStateCache
from ..state import StateStore
from ..structs import Evaluation, Plan, PlanResult
from .scheduler import new_scheduler


class Harness:
    def __init__(self, store: Optional[StateStore] = None, device="cuda"):
        self.store = store or StateStore()
        self.device_cache = DeviceStateCache(device)
        self.device = self.device_cache.device
        self.plans: list[Plan] = []
        self.evals: list[Evaluation] = []
        self.created_evals: list[Evaluation] = []
        self.reblocked_evals: list[Evaluation] = []
        self.results: list[PlanResult] = []
        self._next_index = 1000
        # Test hook: force plan rejection (testing.go:18 RejectPlan)
        self.reject_plan: Optional[Callable[[Plan], bool]] = None
        self.plan_hook: Optional[Callable[[Plan], None]] = None

    def next_index(self) -> int:
        self._next_index += 1
        return self._next_index

    # -- Planner interface -------------------------------------------------
    def submit_plan(self, plan: Plan):
        self.plans.append(plan)
        if self.plan_hook is not None:
            self.plan_hook(plan)
        if self.reject_plan is not None and self.reject_plan(plan):
            result = PlanResult(refresh_index=self.store.latest_index)
            self.results.append(result)
            return result, self.store.snapshot()

        result = evaluate_plan(self.store, plan)
        if not result.is_no_op() or result.deployment is not None:
            index = self.next_index()
            self.store.upsert_plan_results(index, result, plan.eval_id)
            result.alloc_index = index
            if result.node_preemptions:
                from ..broker.plan_apply import preemption_evals

                for ev in preemption_evals(self.store, result):
                    self.create_eval(ev)
        self.results.append(result)
        new_snap = self.store.snapshot() if result.rejected_nodes else None
        return result, new_snap

    def update_eval(self, evaluation: Evaluation) -> None:
        self.evals.append(evaluation)

    def create_eval(self, evaluation: Evaluation) -> None:
        self.created_evals.append(evaluation)
        self.store.upsert_evals(self.next_index(), [evaluation])

    def reblock_eval(self, evaluation: Evaluation) -> None:
        self.reblocked_evals.append(evaluation)

    # -- driving -----------------------------------------------------------
    def process(self, evaluation: Evaluation) -> None:
        """Run the right scheduler for the eval type against a fresh
        snapshot (testing.go:270 Process)."""
        sched = new_scheduler(
            evaluation.type, self.store.snapshot(), self,
            cache=self.device_cache,
            device=self.device,
        )
        sched.process(evaluation)

    def process_merged(self, evaluations: list, overflow: int = 32) -> dict:
        """Run ``evaluations`` as one batched pass against one snapshot:
        every service/batch eval is prepared against ONE shared
        ClusterTensors, their asks are concatenated (``lane_groups``
        records which eval owns each lane), ONE ``kernel.place`` scores
        them all, ``repair_batch_conflicts`` resolves cross-eval
        conflicts, and each eval builds its plan from its slice of the
        results; each plan is submitted and completed with
        ``complete_merged_attempt``. Evals that cannot join the pass (other
        types, evictions, no placements), lanes the repair gives up on, and
        members whose commit was partial take the individual path
        (``process``), as in the reference worker.

        Returns {"merged": [eval ids committed by the pass],
        "individual": [eval ids sent down the individual path],
        "completed": {eval id: complete_merged_attempt's return},
        "lanes": lane count, "lane_groups": [...], "lane_ok": [...]}."""
        from ..device.score import repair_batch_conflicts

        snapshot = self.store.snapshot()
        ct = self.device_cache.tensors(snapshot)
        prepared = []  # (ev, sched, n_asks)
        all_asks: list = []
        lane_groups: list[int] = []
        singles: list = []
        for ev in evaluations:
            if ev.type not in ("service", "batch"):
                singles.append(ev)
                continue
            sched = new_scheduler(
                ev.type, snapshot, self,
                cache=self.device_cache,
                device=self.device,
            )
            asks = sched.prepare_batch_attempt(ev, ct=ct)
            if asks is None:
                singles.append(ev)
                continue
            assert sched._batch_ctx[0] is ct
            lane_groups.extend([len(prepared)] * len(asks))
            prepared.append((ev, sched, len(asks)))
            all_asks.extend(asks)

        lane_ok: list[bool] = []
        completed: dict = {}
        merged: list = []
        if all_asks:
            kernel = prepared[0][1].kernel
            results = kernel.place(ct, all_asks, overflow=overflow)
            lane_ok = repair_batch_conflicts(
                ct, all_asks, results,
                algorithm_spread=kernel.algorithm_spread,
                lane_groups=lane_groups,
            )
            members = []
            off = 0
            for ev, sched, n in prepared:
                span = results[off : off + n]
                span_ok = all(lane_ok[off : off + n])
                off += n
                if not span_ok:
                    singles.append(ev)
                    continue
                plan = sched.build_batch_plan(span)
                if plan is None:
                    merged.append(ev.id)  # no-op: finalized in place
                else:
                    members.append((ev, sched, plan))
            for ev, sched, plan in members:
                result, new_snap = self.submit_plan(plan)
                ok = sched.complete_merged_attempt(result, new_snapshot=new_snap)
                completed[ev.id] = ok
                if ok:
                    merged.append(ev.id)
                else:
                    singles.append(ev)
        for ev in singles:
            self.process(ev)
        return {
            "merged": merged,
            "individual": [ev.id for ev in singles],
            "completed": completed,
            "lanes": len(all_asks),
            "lane_groups": lane_groups,
            "lane_ok": list(lane_ok),
        }
