"""L2 scheduler layer: pure business logic — snapshot in, plan out.

Importing this package registers the builtin schedulers
(service/batch/system/sysbatch), mirroring BuiltinSchedulers
(scheduler/scheduler.go:23-28)."""

from .scheduler import BUILTIN_SCHEDULERS, Planner, new_scheduler, register_scheduler
from .reconcile import (
    PlaceRequest,
    ReconcileResults,
    StopRequest,
    reconcile,
    tasks_updated,
)
from .generic import GenericScheduler, tainted_nodes
from .system import SystemScheduler
from .feasible import check_constraint, check_constraint_values
from .testing import Harness


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
    "SystemScheduler",
    "tainted_nodes",
    "check_constraint",
    "check_constraint_values",
    "Harness",
]
