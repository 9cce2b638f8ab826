"""The server's queues and the leader-side plan verification: the eval
broker, blocked evals, the event stream, the plan queue and the plan
applier."""

from .plan_apply import PlanApplier, evaluate_node_plan, evaluate_plan, preemption_evals

__all__ = ["PlanApplier", "evaluate_plan", "evaluate_node_plan", "preemption_evals"]
