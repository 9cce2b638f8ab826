"""Harness — in-memory Planner for tests and benchmarks.

Reference: scheduler/testing.go:43-279. SubmitPlan applies results to a
real StateStore exactly as the FSM would (:83-175), so scheduler tests
exercise the true state-mutation path; RejectPlan-style hooks force the
partial-commit/refresh retry path (:18). The benchmark grid drives this
same harness (scheduler/benchmarks/benchmarks_test.go).

``device`` names where the placement kernels run: "cuda" by default
(raising when CUDA is absent), "cpu" for the plain PyTorch versions.
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
