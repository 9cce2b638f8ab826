"""Resource model and the fit/score kernels' host reference semantics.

This is the semantic ground truth the device kernels in
``nomad_tpu_torch.device.score`` are validated against. Reference behavior:
nomad/structs/funcs.go:147-274 (AllocsFit, ScoreFitBinPack, ScoreFitSpread,
computeFreePercentage) and nomad/structs/structs.go (Resources,
NodeResources, ComparableResources).

Design note (TPU-first): every resource bundle can be flattened to a fixed
``float32[NUM_DIMS]`` vector via :meth:`ComparableResources.to_vector`, so
that cluster-wide fit checks and scores are dense tensor ops. The dim order
is the module-level ``RESOURCE_DIMS`` tuple and must stay stable — device
arrays, checkpoints, and the plan applier all index by it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Iterable

import numpy as np

# Canonical dense resource dimensions. CPU in MHz, memory/disk in MiB,
# bandwidth in Mbits. Mirrors the axes AllocsFit checks in funcs.go:147-210.
RESOURCE_DIMS: tuple[str, ...] = ("cpu", "memory_mb", "disk_mb", "bandwidth_mbits")
NUM_DIMS = len(RESOURCE_DIMS)

# ScoreFitBinPack constants — nomad/structs/funcs.go:236-256. The score is
# ``20 - 10^freeCpuFrac - 10^freeMemFrac`` clamped to [0, 18] ("BestFit v3"
# from Google's Borg-adjacent work), later normalized by /18 in the ranker
# (scheduler/rank.go:513-516).
BINPACK_MAX_SCORE = 18.0


@dataclass(slots=True)
class NetworkResource:
    """A requested or fingerprinted network. Port accounting itself is
    host-side (see nomad_tpu_torch.structs.network); scores use MBits only."""

    mode: str = "host"
    device: str = ""
    ip: str = ""
    mbits: int = 0
    reserved_ports: list[int] = field(default_factory=list)
    dynamic_ports: list[str] = field(default_factory=list)  # labels


@dataclass(slots=True)
class RequestedDevice:
    """A device ask, e.g. ``gpu`` / ``nvidia/gpu/k80`` with count.
    Reference: structs.RequestedDevice (nomad/structs/structs.go)."""

    name: str = ""
    count: int = 1
    constraints: list = field(default_factory=list)
    affinities: list = field(default_factory=list)


@dataclass(slots=True)
class Resources:
    """A task's resource ask. Reference: structs.Resources."""

    cpu: int = 100
    memory_mb: int = 300
    disk_mb: int = 0
    networks: list[NetworkResource] = field(default_factory=list)
    devices: list[RequestedDevice] = field(default_factory=list)

    def bandwidth_mbits(self) -> int:
        return sum(n.mbits for n in self.networks)

    def add(self, other: "Resources") -> None:
        self.cpu += other.cpu
        self.memory_mb += other.memory_mb
        self.disk_mb += other.disk_mb

    def to_vector(self) -> np.ndarray:
        return np.array(
            [self.cpu, self.memory_mb, self.disk_mb, self.bandwidth_mbits()],
            dtype=np.float32,
        )


@dataclass(slots=True)
class NodeReservedResources:
    """Resources carved out of a node for the OS/agent.
    Reference: structs.NodeReservedResources."""

    cpu: int = 0
    memory_mb: int = 0
    disk_mb: int = 0
    reserved_ports: list[int] = field(default_factory=list)


@dataclass(slots=True)
class NodeDeviceInstance:
    id: str = ""
    healthy: bool = True


@dataclass(slots=True)
class NodeDeviceResource:
    """One device group on a node (vendor/type/name with instances).
    Reference: structs.NodeDeviceResource."""

    vendor: str = ""
    type: str = ""
    name: str = ""
    instances: list[NodeDeviceInstance] = field(default_factory=list)
    attributes: dict[str, object] = field(default_factory=dict)

    def id(self) -> str:
        return f"{self.vendor}/{self.type}/{self.name}"

    def matches(self, ask: RequestedDevice) -> bool:
        """Device name matching per nomad/scheduler/device.go:32-131:
        the ask may be ``type``, ``vendor/type``, or ``vendor/type/name``."""
        parts = ask.name.split("/")
        if len(parts) == 1:
            return parts[0] == self.type
        if len(parts) == 2:
            return parts[0] == self.vendor and parts[1] == self.type
        return (
            parts[0] == self.vendor
            and parts[1] == self.type
            and parts[2] == self.name
        )


@dataclass(slots=True)
class AllocatedDeviceResource:
    """Concrete device instances assigned to an allocation.
    Reference: structs.AllocatedDeviceResource (nomad/structs/structs.go)."""

    vendor: str = ""
    type: str = ""
    name: str = ""
    device_ids: list[str] = field(default_factory=list)

    def id(self) -> str:
        return f"{self.vendor}/{self.type}/{self.name}"


@dataclass(slots=True)
class NodeResources:
    """A node's fingerprinted capacity. Reference: structs.NodeResources."""

    cpu: int = 4000
    memory_mb: int = 8192
    disk_mb: int = 100 * 1024
    networks: list[NetworkResource] = field(default_factory=list)
    devices: list[NodeDeviceResource] = field(default_factory=list)

    def bandwidth_mbits(self) -> int:
        return sum(n.mbits for n in self.networks) or 1000

    def to_vector(self) -> np.ndarray:
        return np.array(
            [self.cpu, self.memory_mb, self.disk_mb, self.bandwidth_mbits()],
            dtype=np.float32,
        )


@dataclass(slots=True)
class ComparableResources:
    """Flattened (summed over tasks) resources used for fit and scoring.
    Reference: structs.ComparableResources / AllocatedResources.Comparable()."""

    cpu: int = 0
    memory_mb: int = 0
    disk_mb: int = 0
    bandwidth_mbits: int = 0

    @classmethod
    def from_task_resources(cls, asks: Iterable[Resources]) -> "ComparableResources":
        out = cls()
        for r in asks:
            out.cpu += r.cpu
            out.memory_mb += r.memory_mb
            out.disk_mb += r.disk_mb
            out.bandwidth_mbits += r.bandwidth_mbits()
        return out

    def add(self, other: "ComparableResources") -> None:
        self.cpu += other.cpu
        self.memory_mb += other.memory_mb
        self.disk_mb += other.disk_mb
        self.bandwidth_mbits += other.bandwidth_mbits

    def superset(self, other: "ComparableResources") -> tuple[bool, str]:
        """Does self contain other? Mirrors ComparableResources.Superset."""
        if self.cpu < other.cpu:
            return False, "cpu"
        if self.memory_mb < other.memory_mb:
            return False, "memory"
        if self.disk_mb < other.disk_mb:
            return False, "disk"
        return True, ""

    def to_vector(self) -> np.ndarray:
        return np.array(
            [self.cpu, self.memory_mb, self.disk_mb, self.bandwidth_mbits],
            dtype=np.float32,
        )

    @classmethod
    def from_vector(cls, v) -> "ComparableResources":
        return cls(
            cpu=int(v[0]),
            memory_mb=int(v[1]),
            disk_mb=int(v[2]),
            bandwidth_mbits=int(v[3]),
        )

    def copy(self) -> "ComparableResources":
        return replace(self)


def node_comparable_capacity(node) -> ComparableResources:
    """The node's schedulable capacity: fingerprinted resources minus the
    OS/agent reserved carve-out. Mirrors Node.ComparableResources() —
    all fit checks and score denominators use this, never raw capacity."""
    cap = node.node_resources
    return ComparableResources(
        cpu=cap.cpu - node.reserved.cpu,
        memory_mb=cap.memory_mb - node.reserved.memory_mb,
        disk_mb=cap.disk_mb - node.reserved.disk_mb,
        bandwidth_mbits=cap.bandwidth_mbits(),
    )


def allocs_fit(
    node,  # structs.node.Node
    allocs,  # Iterable[has .comparable_resources()]
    *,
    check_devices: bool = False,
) -> tuple[bool, str, ComparableResources]:
    """Host reference of AllocsFit (nomad/structs/funcs.go:147-210).

    Sums the proposed allocations' comparable resources (terminal allocs
    skipped, as in the reference) and checks the node's reserved-adjusted
    capacity is a superset. Returns (fits, failure_dimension, used) where
    ``used`` excludes the reserved carve-out. Port-collision checking is
    the plan applier's job (NetworkIndex), matching the reference split
    where the scheduler guesses and the applier verifies
    (nomad/plan_apply.go:638-689).
    """
    used = ComparableResources()
    live = []
    for alloc in allocs:
        if getattr(alloc, "terminal_status", None) and alloc.terminal_status():
            continue
        live.append(alloc)
        used.add(alloc.comparable_resources())

    ok, dim = node_comparable_capacity(node).superset(used)
    if not ok:
        return False, dim, used

    if check_devices:
        ok, dim = _device_accounting_fits(node, live)
        if not ok:
            return False, dim, used

    return True, "", used


def _device_accounting_fits(node, allocs) -> tuple[bool, str]:
    """Count device instance usage vs capacity with a shared pool.
    Mirrors structs.DeviceAccounter (nomad/structs/devices.go): asks drain
    one common per-device-group pool, so overlapping partial ids (``gpu``
    and ``nvidia/gpu/k80``) cannot jointly overcommit. Most-specific asks
    are resolved first so a full-id ask isn't starved by a wildcard one.
    An instance held by two allocs is a collision, as in
    DeviceAccounter.AddAllocs: "device oversubscribed". The JAX package
    counts only the pool, so two members of one merged commit that each
    took a node's first free instance from the same snapshot both pass
    its check."""
    held: set = set()
    for alloc in allocs:
        for ad in getattr(alloc, "allocated_devices", None) or ():
            for did in ad.device_ids:
                if (ad.id(), did) in held:
                    return False, "device oversubscribed"
                held.add((ad.id(), did))
    cap: dict[str, int] = {}
    for dev in node.node_resources.devices:
        cap[dev.id()] = cap.get(dev.id(), 0) + sum(
            1 for i in dev.instances if i.healthy
        )
    asks: dict[str, int] = {}
    for alloc in allocs:
        for dev_id, count in getattr(alloc, "device_asks", lambda: {})().items():
            asks[dev_id] = asks.get(dev_id, 0) + count
    for dev_id in sorted(asks, key=lambda d: -d.count("/")):
        need = asks[dev_id]
        for cid in sorted(c for c in cap if _dev_id_matches(c, dev_id)):
            take = min(cap[cid], need)
            cap[cid] -= take
            need -= take
            if need == 0:
                break
        if need > 0:
            return False, f"device {dev_id}"
    return True, ""


def _dev_id_matches(full_id: str, ask_id: str) -> bool:
    vendor, typ, name = full_id.split("/")
    parts = ask_id.split("/")
    if len(parts) == 1:
        return parts[0] == typ
    if len(parts) == 2:
        return parts[:2] == [vendor, typ]
    return parts[:3] == [vendor, typ, name]


def _free_fraction(capacity: float, used: float) -> float:
    """computeFreePercentage (funcs.go:212-229): free fraction in [?, 1].
    A zero-capacity dimension counts as fully free (fraction 1)."""
    if capacity <= 0:
        return 1.0
    return (capacity - used) / capacity


def score_fit_binpack(node, used: ComparableResources) -> float:
    """ScoreFitBinPack (funcs.go:236-256): BestFit-v3.

    ``score = 20 - 10^freeCpuFrac - 10^freeMemFrac`` clamped to
    [0, BINPACK_MAX_SCORE]. Higher utilization ⇒ higher score (packing).
    ``used`` excludes the reserved carve-out; fractions are over the
    reserved-adjusted capacity (computeFreePercentage subtracts reserved
    from the denominator, funcs.go:212-229).
    """
    cap = node_comparable_capacity(node)
    free_cpu = _free_fraction(cap.cpu, used.cpu)
    free_mem = _free_fraction(cap.memory_mb, used.memory_mb)
    total = math.pow(10.0, free_cpu) + math.pow(10.0, free_mem)
    score = 20.0 - total
    return max(0.0, min(BINPACK_MAX_SCORE, score))


def score_fit_spread(node, used: ComparableResources) -> float:
    """ScoreFitSpread (funcs.go:263-274): inverse of binpack — prefer
    emptier nodes. ``score = 10^freeCpu + 10^freeMem - 2`` clamped."""
    cap = node_comparable_capacity(node)
    free_cpu = _free_fraction(cap.cpu, used.cpu)
    free_mem = _free_fraction(cap.memory_mb, used.memory_mb)
    score = math.pow(10.0, free_cpu) + math.pow(10.0, free_mem) - 2.0
    return max(0.0, min(BINPACK_MAX_SCORE, score))
