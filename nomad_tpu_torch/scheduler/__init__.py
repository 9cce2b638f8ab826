"""L2 scheduler layer: pure business logic — snapshot in, plan out.

Importing this package registers the service and batch schedulers. The
system and sysbatch schedulers are not ported yet: their factories raise
``NotImplementedError`` (ROADMAP A8)."""

from .scheduler import BUILTIN_SCHEDULERS, Planner, new_scheduler, register_scheduler
from .reconcile import (
    PlaceRequest,
    ReconcileResults,
    StopRequest,
    reconcile,
    tasks_updated,
)
from .generic import GenericScheduler, tainted_nodes
from .feasible import check_constraint, check_constraint_values
from .testing import Harness


@register_scheduler("system")
@register_scheduler("sysbatch")
def _system_scheduler(snapshot, planner, **kw):
    raise NotImplementedError(
        "nomad_tpu_torch: the system scheduler is not ported yet (ROADMAP A8)"
    )


__all__ = [
    "BUILTIN_SCHEDULERS",
    "Planner",
    "new_scheduler",
    "register_scheduler",
    "reconcile",
    "tasks_updated",
    "PlaceRequest",
    "StopRequest",
    "ReconcileResults",
    "GenericScheduler",
    "tainted_nodes",
    "check_constraint",
    "check_constraint_values",
    "Harness",
]
