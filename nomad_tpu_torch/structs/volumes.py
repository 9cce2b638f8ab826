"""Volume model: host volumes and CSI volumes with claim accounting.

Reference: structs.ClientHostVolumeConfig + VolumeRequest + VolumeMount
(nomad/structs/volumes.go), structs.CSIVolume / CSIPlugin / claim modes
(nomad/structs/csi.go), checked by HostVolumeChecker
(scheduler/feasible.go:132-207) and CSIVolumeChecker (:209-339), released
by the volume watcher (nomad/volumewatcher/).

TPU note: volume feasibility is host-side per node (host volumes are node
config, CSI claims are counted state) and folds into the dense eligibility
mask like every other hard constraint (device/flatten.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

VOLUME_TYPE_HOST = "host"
VOLUME_TYPE_CSI = "csi"

# CSI access modes (structs/csi.go CSIVolumeAccessMode)
ACCESS_MODE_SINGLE_NODE_READER = "single-node-reader-only"
ACCESS_MODE_SINGLE_NODE_WRITER = "single-node-writer"
ACCESS_MODE_MULTI_NODE_READER = "multi-node-reader-only"
ACCESS_MODE_MULTI_NODE_SINGLE_WRITER = "multi-node-single-writer"
ACCESS_MODE_MULTI_NODE_MULTI_WRITER = "multi-node-multi-writer"

ATTACHMENT_MODE_FILE_SYSTEM = "file-system"
ATTACHMENT_MODE_BLOCK_DEVICE = "block-device"


@dataclass(slots=True)
class ClientHostVolumeConfig:
    """A host directory exposed by a node (client config ``host_volume``).
    Reference: structs.ClientHostVolumeConfig."""

    name: str = ""
    path: str = ""
    read_only: bool = False


@dataclass(slots=True)
class VolumeRequest:
    """A task group's ask for a volume (group ``volume`` block).
    Reference: structs.VolumeRequest."""

    name: str = ""
    type: str = VOLUME_TYPE_HOST
    source: str = ""
    read_only: bool = False
    per_alloc: bool = False
    access_mode: str = ""
    attachment_mode: str = ""


@dataclass(slots=True)
class VolumeMount:
    """A task's mount of a group volume (task ``volume_mount`` block).
    Reference: structs.VolumeMount."""

    volume: str = ""
    destination: str = ""
    read_only: bool = False
    propagation_mode: str = "private"


@dataclass(slots=True)
class CSITopology:
    segments: dict[str, str] = field(default_factory=dict)


@dataclass(slots=True)
class CSIVolume:
    """A registered CSI volume with claim state.
    Reference: structs.CSIVolume (nomad/structs/csi.go)."""

    id: str = ""
    namespace: str = "default"
    name: str = ""
    external_id: str = ""
    plugin_id: str = ""
    access_mode: str = ACCESS_MODE_SINGLE_NODE_WRITER
    attachment_mode: str = ATTACHMENT_MODE_FILE_SYSTEM
    schedulable: bool = True
    # alloc id → node id, split by claim kind
    read_claims: dict[str, str] = field(default_factory=dict)
    write_claims: dict[str, str] = field(default_factory=dict)
    # claims being detached by the volume watcher
    past_claims: dict[str, str] = field(default_factory=dict)
    # claim ids registered via the Claim API by non-alloc claimants; the
    # volume watcher must not reap these as "alloc gone"
    external_claims: set[str] = field(default_factory=set)
    topologies: list[CSITopology] = field(default_factory=list)
    context: dict[str, str] = field(default_factory=dict)
    capacity_bytes: int = 0
    create_index: int = 0
    modify_index: int = 0

    # -- claim logic (structs/csi.go CSIVolume.Claim*) --------------------
    def write_free(self) -> bool:
        if self.access_mode == ACCESS_MODE_SINGLE_NODE_WRITER:
            return len(self.write_claims) == 0
        if self.access_mode == ACCESS_MODE_MULTI_NODE_SINGLE_WRITER:
            return len(self.write_claims) == 0
        if self.access_mode == ACCESS_MODE_MULTI_NODE_MULTI_WRITER:
            return True
        return False  # reader-only modes never admit writers

    def read_free(self) -> bool:
        if self.access_mode in (
            ACCESS_MODE_SINGLE_NODE_READER,
            ACCESS_MODE_SINGLE_NODE_WRITER,
        ):
            # single-node: one claimant total
            return not self.read_claims and not self.write_claims
        return True

    def claimable(self, read_only: bool) -> bool:
        if not self.schedulable:
            return False
        return self.read_free() if read_only else self.write_free()

    def claim(self, alloc_id: str, node_id: str, read_only: bool) -> bool:
        if not self.claimable(read_only):
            return False
        (self.read_claims if read_only else self.write_claims)[alloc_id] = node_id
        return True

    def release(self, alloc_id: str) -> bool:
        found = False
        for claims in (self.read_claims, self.write_claims, self.past_claims):
            if alloc_id in claims:
                del claims[alloc_id]
                found = True
        self.external_claims.discard(alloc_id)
        return found

    def in_use(self) -> bool:
        return bool(self.read_claims or self.write_claims)


@dataclass(slots=True)
class CSIPlugin:
    """Aggregated health of a CSI plugin's controller/node instances.
    Reference: structs.CSIPlugin — derived state, updated as nodes
    fingerprint plugin instances."""

    id: str = ""
    provider: str = ""
    version: str = ""
    controller_required: bool = False
    controllers_healthy: int = 0
    nodes_healthy: int = 0
    create_index: int = 0
    modify_index: int = 0


@dataclass(slots=True)
class CSINodeInfo:
    """Per-node CSI plugin presence (node fingerprint of a running node
    plugin). Reference: structs.CSIInfo on Node.CSINodePlugins."""

    plugin_id: str = ""
    healthy: bool = True
    requires_topology: bool = False
    accessible_topology: Optional[CSITopology] = None
    max_volumes: int = 0  # 0 = unlimited
