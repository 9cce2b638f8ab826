"""Leader-side plan verification."""

from .plan_apply import evaluate_node_plan, evaluate_plan, preemption_evals

__all__ = ["evaluate_plan", "evaluate_node_plan", "preemption_evals"]
