"""Node model: fingerprinted attributes, capacity, drain/eligibility state.

Reference: structs.Node (nomad/structs/structs.go ~:1900), computed node
class (nomad/structs/node_class.go) — the memoization key that lets
feasibility be evaluated once per *class* instead of once per node
(scheduler/feasible.go:1029-1153). In the TPU design the computed class is
also the unit at which host-side regex/semver constraints are pre-evaluated
before being broadcast into the device eligibility mask.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Optional

from .resources import NodeReservedResources, NodeResources

NODE_STATUS_INIT = "initializing"
NODE_STATUS_READY = "ready"
NODE_STATUS_DOWN = "down"

NODE_SCHED_ELIGIBLE = "eligible"
NODE_SCHED_INELIGIBLE = "ineligible"


@dataclass(slots=True)
class DrainStrategy:
    """Reference: structs.DrainStrategy."""

    deadline_s: float = 0.0  # <0: force drain now; 0: no deadline
    ignore_system_jobs: bool = False
    force_deadline_unix: float = 0.0


@dataclass(slots=True)
class Node:
    id: str = ""
    name: str = ""
    datacenter: str = "dc1"
    node_class: str = ""
    # accelerator class for heterogeneity-aware scheduling (Gavel-style):
    # e.g. "tpu-v5e", "tpu-v4", "gpu-a100", "cpu". "" means class-less —
    # the node participates in scheduling exactly as before this field
    # existed (throughput coefficient 1.0 for every job).
    device_class: str = ""
    # physical placement coordinates for gang/topology-aware scheduling:
    # level → id, e.g. {"rack": "r03", "pod": "p1", "ici": "2.1"}. Empty
    # means topology-less — the node participates in scheduling exactly
    # as before this field existed (every topology term contributes 0).
    topology: dict[str, str] = field(default_factory=dict)
    attributes: dict[str, str] = field(default_factory=dict)
    meta: dict[str, str] = field(default_factory=dict)
    links: dict[str, str] = field(default_factory=dict)
    node_resources: NodeResources = field(default_factory=NodeResources)
    reserved: NodeReservedResources = field(default_factory=NodeReservedResources)
    drivers: dict[str, bool] = field(default_factory=dict)  # driver → healthy
    # name → ClientHostVolumeConfig (client config host_volume blocks)
    host_volumes: dict[str, object] = field(default_factory=dict)
    # plugin id → CSINodeInfo (fingerprinted running node plugins)
    csi_node_plugins: dict[str, object] = field(default_factory=dict)
    status: str = NODE_STATUS_INIT
    status_description: str = ""
    scheduling_eligibility: str = NODE_SCHED_ELIGIBLE
    drain: Optional[DrainStrategy] = None
    computed_class: str = ""
    status_updated_at: float = 0.0
    create_index: int = 0
    modify_index: int = 0

    def ready(self) -> bool:
        """Node can accept new work — structs.Node.Ready()."""
        return (
            self.status == NODE_STATUS_READY
            and self.drain is None
            and self.scheduling_eligibility == NODE_SCHED_ELIGIBLE
        )

    def terminal_status(self) -> bool:
        return self.status == NODE_STATUS_DOWN

    def compute_class(self) -> None:
        """Hash scheduling-relevant fields into ``computed_class``.
        Mirrors structs.Node.ComputeClass (node_class.go): nodes with equal
        hashes are interchangeable for feasibility, enabling per-class
        memoization and, here, per-class host pre-evaluation of constraint
        operators the device can't run (regex/version)."""
        h = hashlib.blake2b(digest_size=8)
        h.update(self.datacenter.encode())
        h.update(self.node_class.encode())
        for k in sorted(self.attributes):
            if k.startswith("unique."):
                continue
            h.update(k.encode())
            h.update(str(self.attributes[k]).encode())
        for k in sorted(self.meta):
            if k.startswith("unique."):
                continue
            h.update(k.encode())
            h.update(str(self.meta[k]).encode())
        for d in sorted(self.drivers):
            if self.drivers[d]:
                h.update(d.encode())
        for name in sorted(self.host_volumes):
            hv = self.host_volumes[name]
            h.update(f"hv:{name}:{getattr(hv, 'read_only', False)}".encode())
        h.update(self.node_resources.to_vector().tobytes())
        # device_class participates unconditionally: two nodes differing
        # only in accelerator class must never share a computed class, or
        # the per-class feasibility memo (and the device cache keyed on
        # it) silently treats a v5e and a CPU box as interchangeable.
        h.update(b"dev:")
        h.update(self.device_class.encode())
        # topology participates for the same reason: a rack/pod flip must
        # flip the computed class so the device cache (keyed on the class
        # hash) rebuilds its topology id columns.
        h.update(b"topo:")
        for k in sorted(self.topology):
            h.update(k.encode())
            h.update(str(self.topology[k]).encode())
        self.computed_class = "v2:" + h.hexdigest()

    def lookup_attribute(self, target: str) -> Optional[str]:
        """Resolve a constraint LTarget like ``${attr.kernel.name}``,
        ``${node.datacenter}``, ``${meta.rack}`` against this node.
        Mirrors scheduler/feasible.go:748-781 (resolveTarget)."""
        t = target
        if t.startswith("${") and t.endswith("}"):
            t = t[2:-1]
        if t == "node.unique.id":
            return self.id
        if t == "node.unique.name":
            return self.name
        if t == "node.datacenter":
            return self.datacenter
        if t == "node.region":
            return self.attributes.get("platform.region", "global")
        if t == "node.class":
            return self.node_class
        if t == "node.device_class":
            return self.device_class
        if t.startswith("node.topology."):
            return self.topology.get(t[len("node.topology."):])
        if t.startswith("attr."):
            return self.attributes.get(t[len("attr."):])
        if t.startswith("meta."):
            return self.meta.get(t[len("meta."):])
        if t.startswith("node.attr."):
            return self.attributes.get(t[len("node.attr."):])
        if t.startswith("node.meta."):
            return self.meta.get(t[len("node.meta."):])
        return None
