"""Scheduler interfaces and factory registry.

Reference: scheduler/scheduler.go — the ``Scheduler`` interface (:55-60),
the read-only ``State`` seam (:66-110), the write-side ``Planner`` seam
(:113-132), and the ``BuiltinSchedulers`` factory map (:23-28). These two
seams are what keep the whole scheduler package side-effect-free: a state
snapshot goes in, a plan comes out, and everything else (Raft, queues,
RPC) lives behind the Planner.
"""

from __future__ import annotations

from typing import Callable, Optional, Protocol

from ..structs import Evaluation, Plan, PlanResult


class Planner(Protocol):
    """Write-side seam (scheduler/scheduler.go:113-132). submit_plan may
    return a fresher state snapshot when the applier's result carries a
    refresh index (worker.go:585-652)."""

    def submit_plan(self, plan: Plan) -> tuple[PlanResult, Optional[object]]: ...

    def update_eval(self, evaluation: Evaluation) -> None: ...

    def create_eval(self, evaluation: Evaluation) -> None: ...

    def reblock_eval(self, evaluation: Evaluation) -> None: ...


SchedulerFactory = Callable[..., "object"]

BUILTIN_SCHEDULERS: dict[str, SchedulerFactory] = {}


def register_scheduler(name: str):
    def deco(factory):
        BUILTIN_SCHEDULERS[name] = factory
        return factory

    return deco


def new_scheduler(name: str, snapshot, planner: Planner, **kw):
    """Factory dispatch (scheduler.go NewScheduler)."""
    try:
        factory = BUILTIN_SCHEDULERS[name]
    except KeyError:
        raise ValueError(f"unknown scheduler '{name}'") from None
    return factory(snapshot, planner, **kw)
