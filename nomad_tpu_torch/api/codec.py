"""JSON codec for the shared structs.

The reference's api/ package mirrors every struct with JSON tags; here one
generic dataclass encoder/decoder covers the API surface. Heavy pointers
(alloc.job) are stubbed out, mirroring Allocation.Stub()."""

from __future__ import annotations

import dataclasses
from typing import Any

from ..structs import (
    Affinity,
    Allocation,
    AllocMetric,
    Constraint,
    Evaluation,
    Job,
    Node,
    Resources,
    Spread,
    SpreadTarget,
    Task,
    TaskGroup,
)
from ..structs.alloc import NodeScoreMeta
from ..structs.job import (
    EphemeralDisk,
    LogConfig,
    MigrateStrategy,
    ParameterizedJobConfig,
    PeriodicConfig,
    ReschedulePolicy,
    RestartPolicy,
    UpdateStrategy,
)
from ..structs.resources import (
    AllocatedDeviceResource,
    NetworkResource,
    NodeDeviceInstance,
    NodeDeviceResource,
    NodeReservedResources,
    NodeResources,
    RequestedDevice,
)
from ..structs.volumes import (
    CSINodeInfo,
    ClientHostVolumeConfig,
    VolumeMount,
    VolumeRequest,
)


def encode(obj: Any, *, _depth: int = 0) -> Any:
    """Dataclass → JSON-able dict (recursively), dropping private and
    heavyweight fields."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {}
        for f in dataclasses.fields(obj):
            if f.name in ("job",):  # stub heavy pointers
                continue
            out[f.name] = encode(getattr(obj, f.name), _depth=_depth + 1)
        return out
    if isinstance(obj, dict):
        return {str(k): encode(v, _depth=_depth + 1) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set, frozenset)):
        return [encode(v, _depth=_depth + 1) for v in obj]
    if isinstance(obj, bytes):
        return obj.decode("utf-8", "replace")
    if hasattr(obj, "__dict__") and not isinstance(
        obj, (str, int, float, bool, type(None))
    ):
        return {
            k: encode(v, _depth=_depth + 1)
            for k, v in vars(obj).items()
            if not k.startswith("_")
        }
    return obj


def _decode_into(cls, data: dict):
    """dict → dataclass, ignoring unknown keys (forward compatibility)."""
    if data is None:
        return None
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        val = data[f.name]
        kwargs[f.name] = _decode_field(f.type, f.name, val)
    return cls(**kwargs)


_NESTED = {
    "resources": Resources,
    "restart_policy": RestartPolicy,
    "reschedule_policy": ReschedulePolicy,
    "ephemeral_disk": EphemeralDisk,
    # a task's log retention; the JAX package's codec leaves it a dict,
    # which the client's log rotation cannot read (ROADMAP C-R7)
    "log_config": LogConfig,
    "update": UpdateStrategy,
    "migrate": MigrateStrategy,
    "periodic": PeriodicConfig,
    "parameterized": ParameterizedJobConfig,
    "node_resources": NodeResources,
    "reserved": NodeReservedResources,
}
_NESTED_LISTS = {
    "constraints": Constraint,
    "affinities": Affinity,
    "spreads": Spread,
    "targets": SpreadTarget,
    "tasks": Task,
    "task_groups": TaskGroup,
    "networks": NetworkResource,
    "devices": RequestedDevice,
    "volume_mounts": VolumeMount,
    "allocated_devices": AllocatedDeviceResource,
    "instances": NodeDeviceInstance,
    "score_meta": NodeScoreMeta,
}
_NESTED_DICTS = {
    "volumes": VolumeRequest,
    "host_volumes": ClientHostVolumeConfig,
    "csi_node_plugins": CSINodeInfo,
    # evals round-trip their structured failure metrics so blocked-eval
    # consumers (`eval status`) keep the per-dimension exhaustion counts
    # and rejection histograms instead of opaque dicts
    "failed_tg_allocs": AllocMetric,
}


def _decode_field(ftype, name, val):
    if name in _NESTED and isinstance(val, dict):
        return _decode_into(_NESTED[name], val)
    if name in _NESTED_DICTS and isinstance(val, dict):
        return {
            k: _decode_into(_NESTED_DICTS[name], v) if isinstance(v, dict) else v
            for k, v in val.items()
        }
    if name in _NESTED_LISTS and isinstance(val, list):
        return [
            _decode_dev(v)
            if name == "devices" and isinstance(v, dict) and "instances" in v
            else _decode_into(_NESTED_LISTS[name], v)
            if isinstance(v, dict)
            else v
            for v in val
        ]
    return val


def _decode_dev(v: dict):
    """Node device groups (with instances) vs task device asks share the
    field name ``devices``; disambiguate by shape."""
    return _decode_into(NodeDeviceResource, v)


def decode_job(data: dict) -> Job:
    return _decode_into(Job, data)


def decode_node(data: dict) -> Node:
    return _decode_into(Node, data)


def decode_alloc(data: dict) -> Allocation:
    known = {f.name for f in dataclasses.fields(Allocation)}
    return Allocation(
        **{
            k: v
            for k, v in data.items()
            if k in known
            and k
            not in (
                "resources",
                "metrics",
                "reschedule_tracker",
                "desired_transition",
                "deployment_status",
            )
        }
    )


def decode_eval(data: dict) -> Evaluation:
    return _decode_into(Evaluation, data)
