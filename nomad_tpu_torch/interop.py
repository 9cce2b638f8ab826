"""Build the port's objects from plain NumPy/dict records.

State carried across from another runtime (the JAX package, a snapshot
export, a test fixture) arrives as plain data: arrays, dicts, and the
``dataclasses.asdict`` records of the struct dataclasses. This module
turns such data into the port's own objects, so both packages can be
handed identical IDs and arrays. It reads plain data only and imports
nothing outside the port.

- ``cluster_from_numpy(fields)`` → ``ClusterTensors``
- ``asks_from_numpy(records)`` → ``list[GroupAsk]``
- ``store_from_records(nodes, jobs, allocs)`` → ``StateStore``
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np

from .device.flatten import ClusterTensors, GroupAsk, ValueBlocks
from .state import StateStore
from .structs import (
    AllocatedNetwork,
    Allocation,
    Job,
    NetworkResource,
    Node,
    Task,
    TaskGroup,
)
from .structs.deployment import AllocDeploymentStatus
from .structs.job import Affinity, Constraint, Service, ServiceCheck
from .structs.resources import AllocatedDeviceResource, RequestedDevice

# device-side handles of the other runtime: never carried across
_DEVICE_FIELDS = frozenset({"device_capacity", "score_cache"})

# struct fields annotated as a bare ``list``/``object`` whose records
# hold dataclasses: the element type the annotation does not name
_UNTYPED_FIELDS = {
    (TaskGroup, "networks"): NetworkResource,
    (Task, "services"): Service,
    (Service, "checks"): ServiceCheck,
    (Allocation, "allocated_networks"): AllocatedNetwork,
    (Allocation, "allocated_devices"): AllocatedDeviceResource,
    (Allocation, "deployment_status"): AllocDeploymentStatus,
    (RequestedDevice, "constraints"): Constraint,
    (RequestedDevice, "affinities"): Affinity,
}


def _copy_value(v):
    if isinstance(v, np.ndarray):
        return v.copy()
    if isinstance(v, dict):
        return {k: _copy_value(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_copy_value(x) for x in v]
    return v


def cluster_from_numpy(fields: dict) -> ClusterTensors:
    """ClusterTensors from its fields by name (arrays, vocab dicts,
    lists). Arrays and containers are copied. Device handles of the
    source runtime are dropped; any other unknown field raises."""
    names = {f.name for f in dataclasses.fields(ClusterTensors)}
    unknown = set(fields) - names - _DEVICE_FIELDS
    if unknown:
        raise ValueError(f"cluster_from_numpy: unknown fields {sorted(unknown)}")
    kw = {
        k: _copy_value(v)
        for k, v in fields.items()
        if k in names and k not in _DEVICE_FIELDS
    }
    return ClusterTensors(**kw)


def asks_from_numpy(records: list) -> list:
    """GroupAsks from ``dataclasses.asdict`` records (``blocks`` arrives
    as a dict, or None)."""
    out = []
    for rec in records:
        kw = {k: _copy_value(v) for k, v in rec.items()}
        blocks = kw.get("blocks")
        if isinstance(blocks, dict):
            kw["blocks"] = ValueBlocks(**blocks)
        out.append(GroupAsk(**kw))
    return out


def _convert(tp, value):
    """Rebuild ``value`` (plain data from ``asdict``) as annotation ``tp``."""
    if value is None:
        return None
    if dataclasses.is_dataclass(tp) and isinstance(tp, type):
        return from_record(tp, value)
    origin = typing.get_origin(tp)
    args = typing.get_args(tp)
    if origin is typing.Union:  # Optional[X]
        inner = [a for a in args if a is not type(None)]
        return _convert(inner[0], value) if len(inner) == 1 else value
    if origin is list and args:
        return [_convert(args[0], v) for v in value]
    if origin is tuple and args:
        return tuple(_convert(args[0], v) for v in value)
    if origin is dict and len(args) == 2:
        return {k: _convert(args[1], v) for k, v in value.items()}
    return _copy_value(value)


def from_record(cls, record: dict):
    """One struct dataclass from its ``dataclasses.asdict`` record,
    nested dataclasses included."""
    hints = typing.get_type_hints(cls)
    init_kw = {}
    late = {}
    for f in dataclasses.fields(cls):
        if f.name not in record:
            continue
        elem = _UNTYPED_FIELDS.get((cls, f.name))
        raw = record[f.name]
        if elem is not None and raw is not None:
            val = (
                [from_record(elem, v) for v in raw]
                if isinstance(raw, list)
                else from_record(elem, raw)
            )
        else:
            val = _convert(hints.get(f.name, object), raw)
        (init_kw if f.init else late)[f.name] = val
    obj = cls(**init_kw)
    for k, v in late.items():
        setattr(obj, k, v)
    return obj


def store_from_records(nodes, jobs, allocs, index: int = 1) -> StateStore:
    """A StateStore holding the given records: nodes upserted at
    ``index``, jobs at ``index + 1``, allocs at ``index + 2`` — the same
    sequence a caller applies to the other runtime's store."""
    store = StateStore()
    for rec in nodes:
        store.upsert_node(index, from_record(Node, rec))
    for rec in jobs:
        store.upsert_job(index + 1, from_record(Job, rec))
    if allocs:
        store.upsert_allocs(index + 2, [from_record(Allocation, r) for r in allocs])
    return store


__all__ = [
    "asks_from_numpy",
    "cluster_from_numpy",
    "from_record",
    "store_from_records",
]
