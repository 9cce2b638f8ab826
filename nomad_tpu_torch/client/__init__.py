"""L3/L4 client layer: node agent, runners, drivers, fingerprinting."""

from .alloc_runner import AllocRunner
from .client import Client, ServerRPC
from .drivers import (
    ExecDriver,
    MockDriver,
    RawExecDriver,
    TaskDriver,
    TaskHandle,
    builtin_drivers,
)
from .fingerprint import fingerprint_node
from .task_runner import TaskRunner, TaskState

__all__ = [
    "AllocRunner",
    "Client",
    "ServerRPC",
    "TaskDriver",
    "TaskHandle",
    "MockDriver",
    "RawExecDriver",
    "ExecDriver",
    "builtin_drivers",
    "fingerprint_node",
    "TaskRunner",
    "TaskState",
]
