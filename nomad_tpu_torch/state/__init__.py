"""L0 durable-state layer: MVCC store, snapshots, persistence."""

from .store import SchedulerConfiguration, StateSnapshot, StateStore

__all__ = ["StateStore", "StateSnapshot", "SchedulerConfiguration"]
