"""NetworkIndex — per-node port/bandwidth accounting.

Reference: nomad/structs/network.go:37-360. Inherently sequential bitmap
allocation per node, so it stays host-side: the device score pass uses
aggregate bandwidth/port-count as a fit proxy and the plan applier runs
this exact check before commit (the reference has the same guess-then-
verify split — scheduler guesses in rank.go:210-323, applier verifies in
plan_apply.go:638-689).
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field

from .resources import NetworkResource

MIN_DYNAMIC_PORT = 20000
MAX_DYNAMIC_PORT = 32000
MAX_RAND_PORT_ATTEMPTS = 20


@dataclass(slots=True)
class AllocatedPort:
    label: str
    value: int
    to: int = 0


@dataclass(slots=True)
class AllocatedNetwork:
    device: str = ""
    ip: str = ""
    mbits: int = 0
    reserved_ports: list[AllocatedPort] = field(default_factory=list)
    dynamic_ports: list[AllocatedPort] = field(default_factory=list)


class NetworkIndex:
    """Tracks used ports and bandwidth on one node."""

    def __init__(self, node=None):
        self.avail_bandwidth: int = 0
        self.used_bandwidth: int = 0
        self.used_ports: set[int] = set()
        if node is not None:
            self.set_node(node)

    def set_node(self, node) -> None:
        self.avail_bandwidth = node.node_resources.bandwidth_mbits()
        for p in node.reserved.reserved_ports:
            self.used_ports.add(p)

    def add_allocs(self, allocs) -> bool:
        """Account every non-terminal alloc's network usage. Returns False
        on a (pre-existing) collision, matching NetworkIndex.AddAllocs."""
        collide = False
        for alloc in allocs:
            if alloc.terminal_status():
                continue
            for net in getattr(alloc, "allocated_networks", []) or []:
                if not self.add_reserved_network(net):
                    collide = True
        return not collide

    def add_reserved_network(self, net: AllocatedNetwork) -> bool:
        ok = True
        for p in net.reserved_ports + net.dynamic_ports:
            if p.value in self.used_ports:
                ok = False
            self.used_ports.add(p.value)
        self.used_bandwidth += net.mbits
        return ok

    def assign_network(
        self, ask: NetworkResource, rng: random.Random | None = None
    ) -> tuple[AllocatedNetwork | None, str]:
        """Fit an ask: bandwidth check, reserved-port collision check, then
        dynamic port selection (random probe then linear scan — mirrors
        network.go:270-340). Returns (offer, failure_reason)."""
        if ask.mbits and self.used_bandwidth + ask.mbits > self.avail_bandwidth:
            return None, "bandwidth exceeded"
        offer = AllocatedNetwork(mbits=ask.mbits)
        for p in ask.reserved_ports:
            if p in self.used_ports:
                return None, f"reserved port {p} already in use"
            offer.reserved_ports.append(AllocatedPort(label=str(p), value=p))
        rng = rng or random
        taken = {p.value for p in offer.reserved_ports} | self.used_ports
        for label in ask.dynamic_ports:
            port = self._pick_dynamic_port(taken, rng)
            if port < 0:
                return None, "dynamic port selection failed"
            taken.add(port)
            offer.dynamic_ports.append(AllocatedPort(label=label, value=port))
        return offer, ""

    def _pick_dynamic_port(self, taken: set[int], rng) -> int:
        for _ in range(MAX_RAND_PORT_ATTEMPTS):
            p = rng.randint(MIN_DYNAMIC_PORT, MAX_DYNAMIC_PORT)
            if p not in taken:
                return p
        for p in range(MIN_DYNAMIC_PORT, MAX_DYNAMIC_PORT + 1):
            if p not in taken:
                return p
        return -1

    def commit(self, offer: AllocatedNetwork) -> None:
        self.add_reserved_network(offer)
