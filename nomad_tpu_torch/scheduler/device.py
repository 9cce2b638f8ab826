"""Device allocator — GPU-style device feasibility, affinity scoring, and
concrete instance assignment.

Reference semantics: scheduler/device.go (deviceAllocator.AssignDevice
:32-131 — device-id hierarchy matching, constraint filtering on device
attributes, affinity-scored group selection), scheduler/feasible.go:1173
(DeviceChecker hard filter), structs.DeviceAccounter
(nomad/structs/devices.go — per-instance free accounting), and
rank.go:388-434 (device assignment inside BinPackIterator, with the
matched-affinity sum folded into the node score).

TPU split of labor: device inventories are tiny (a handful of groups ×
instances per node) and string-typed, so feasibility/assignment stay
host-side; the *batch accounting* — "this node can take at most K more
placements of this group" — is flattened to a dense ``slot_caps[N]``
vector consumed by the greedy placement scan on device (score.py), the
same way constraints flatten to the eligibility mask.
"""

from __future__ import annotations

from typing import Optional

from ..structs.job import Constraint, TaskGroup
from ..structs.resources import (
    AllocatedDeviceResource,
    RequestedDevice,
    _dev_id_matches,
)
from .feasible import check_constraint_values


def resolve_device_target(dev, target: str) -> Optional[str]:
    """Resolve a constraint/affinity target against a device group.
    Supported: ``${device.vendor}``, ``${device.type}``, ``${device.model}``,
    ``${device.attr.<name>}`` (device.go nodeDeviceResource resolution)."""
    t = target.strip()
    if t.startswith("${") and t.endswith("}"):
        t = t[2:-1]
    if t == "device.vendor":
        return dev.vendor
    if t == "device.type":
        return dev.type
    if t in ("device.model", "device.name"):
        return dev.name
    if t.startswith("device.attr."):
        v = dev.attributes.get(t[len("device.attr.") :])
        return None if v is None else str(v)
    return None


def _check_device_constraint(dev, c) -> bool:
    lval = resolve_device_target(dev, c.l_target) if c.l_target else None
    rval = c.r_target
    # literal right-hand side unless it's itself a device interpolation
    if rval.startswith("${"):
        rval = resolve_device_target(dev, rval) or ""
    return check_constraint_values(c.operand, lval, rval)


def device_group_matches(dev, ask: RequestedDevice) -> bool:
    """Name hierarchy (type | vendor/type | vendor/type/name) + all hard
    constraints on device attributes."""
    if not dev.matches(ask):
        return False
    return all(_check_device_constraint(dev, c) for c in ask.constraints)


def device_affinity_score(dev, ask: RequestedDevice) -> float:
    """Weight-normalized affinity score of this device group for the ask,
    in [-1, 1] (device.go:94-115 sums matched affinity weights)."""
    if not ask.affinities:
        return 0.0
    total = float(sum(abs(a.weight) for a in ask.affinities)) or 1.0
    score = 0.0
    for a in ask.affinities:
        c = Constraint(
            l_target=a.l_target, r_target=a.r_target, operand=a.operand
        )
        if _check_device_constraint(dev, c):
            score += a.weight
    return score / total


def group_device_asks(tg: TaskGroup) -> list[RequestedDevice]:
    """All device asks across the group's tasks."""
    return [d for t in tg.tasks for d in t.resources.devices]


def free_instances(node, in_use: dict[str, set]) -> dict[str, list[str]]:
    """device full-id → healthy instance ids not currently held.
    ``in_use`` maps full-id → set of held instance ids (DeviceAccounter's
    view, built from the node's non-terminal allocs)."""
    out: dict[str, list[str]] = {}
    for dev in node.node_resources.devices:
        held = in_use.get(dev.id(), set())
        out[dev.id()] = [
            i.id for i in dev.instances if i.healthy and i.id not in held
        ]
    return out


def collect_in_use(allocs) -> dict[str, set]:
    """Union of device instances held by non-terminal allocs on a node.
    Allocs without concrete instance ids (older placements) reserve
    anonymous slots — represented by counting placeholders."""
    in_use: dict[str, set] = {}
    anon = 0
    for a in allocs:
        if a.terminal_status():
            continue
        ids = a.device_instance_ids()
        if ids:
            for did, inst in ids.items():
                in_use.setdefault(did, set()).update(inst)
        else:
            for did, count in a.device_asks().items():
                s = in_use.setdefault(did, set())
                for _ in range(count):
                    s.add(f"__anon{anon}")
                    anon += 1
    return in_use


def assign_devices(
    node, in_use: dict[str, set], tg: TaskGroup
) -> Optional[list[AllocatedDeviceResource]]:
    """Pick concrete instances for every device ask of the group.

    Per ask: among matching device groups with enough free instances,
    choose the highest affinity score (ties → most free, mirroring
    AssignDevice's preference for the offer with the best score,
    device.go:117-129). Returns None if any ask cannot be satisfied.
    Anonymous reservations (``__anon*``) consume capacity but are never
    assigned out.
    """
    free = free_instances(node, in_use)
    avail = {did: len(ids) for did, ids in free.items()}
    # Anonymous reservations (allocs without concrete instance ids) are
    # keyed by the *asked* id, possibly partial (``gpu``). Drain them from
    # matching pools greedily, most-specific debts first — the same shared-
    # pool rule as structs.DeviceAccounter (_device_accounting_fits).
    anon_by_ask: dict[str, int] = {}
    for ask_id, held in in_use.items():
        n = sum(1 for i in held if i.startswith("__anon"))
        if n:
            anon_by_ask[ask_id] = anon_by_ask.get(ask_id, 0) + n
    for ask_id in sorted(anon_by_ask, key=lambda d: -d.count("/")):
        debt = anon_by_ask[ask_id]
        for did in sorted(d for d in avail if _dev_id_matches(d, ask_id)):
            take = min(avail[did], debt)
            avail[did] -= take
            debt -= take
            if debt == 0:
                break
        if debt > 0:
            return None  # node is already device-overcommitted
    devs_by_id = {d.id(): d for d in node.node_resources.devices}
    out: list[AllocatedDeviceResource] = []
    # most-specific asks first so a full-id ask isn't starved by a wildcard
    for ask in sorted(group_device_asks(tg), key=lambda d: -d.name.count("/")):
        best = None  # ((score, avail), dev_id)
        for did, dev in devs_by_id.items():
            if not device_group_matches(dev, ask):
                continue
            if avail.get(did, 0) < ask.count:
                continue
            score = device_affinity_score(dev, ask)
            key = (score, avail[did])
            if best is None or key > best[0]:
                best = (key, did)
        if best is None:
            return None
        did = best[1]
        dev = devs_by_id[did]
        taken = free[did][: ask.count]
        free[did] = free[did][ask.count :]
        avail[did] -= ask.count
        out.append(
            AllocatedDeviceResource(
                vendor=dev.vendor,
                type=dev.type,
                name=dev.name,
                device_ids=list(taken),
            )
        )
    return out


def assign_devices_for_plan(
    snapshot, plan, tg: TaskGroup, node_id: str
) -> tuple[Optional[list[AllocatedDeviceResource]], bool]:
    """Concrete device assignment for one placement, seeing both snapshot
    allocs and the in-flight plan's changes (stops + preemptions free
    instances, in-plan placements hold them) — shared by the generic and
    system schedulers (reference rank.go:388-434). Returns
    (devices | None, ok): ok is False only when the group asks for
    devices the node can't supply."""
    if not group_device_asks(tg):
        return None, True
    node = snapshot.node_by_id(node_id)
    if node is None:
        return None, False
    stopped = {a.id for a in plan.node_update.get(node_id, [])}
    stopped |= {a.id for a in plan.node_preemptions.get(node_id, [])}
    live = [
        a for a in snapshot.allocs_by_node(node_id) if a.id not in stopped
    ]
    live.extend(plan.node_allocation.get(node_id, []))
    devices = assign_devices(node, collect_in_use(live), tg)
    return devices, devices is not None


def rollback_plan_preemptions(plan, node_id: str, victim_ids) -> None:
    """Remove this placement's victims from the plan (device assignment
    failed after the eviction was staged); drop the key entirely when
    emptied so the plan stays a no-op if nothing else touched it."""
    remaining = [
        a
        for a in plan.node_preemptions.get(node_id, [])
        if a.id not in set(victim_ids)
    ]
    if remaining:
        plan.node_preemptions[node_id] = remaining
    else:
        plan.node_preemptions.pop(node_id, None)


def feasible_sets(node, in_use: dict[str, set], tg: TaskGroup, cap: int) -> int:
    """How many *additional* placements of this group the node can take,
    device-wise, up to ``cap``. This is the DeviceChecker hard filter
    (feasible.go:1173) generalized to a count for batch accounting."""
    asks = group_device_asks(tg)
    if not asks:
        return cap
    sets = 0
    sim_in_use = {k: set(v) for k, v in in_use.items()}
    while sets < cap:
        assigned = assign_devices(node, sim_in_use, tg)
        if assigned is None:
            break
        for ad in assigned:
            sim_in_use.setdefault(ad.id(), set()).update(ad.device_ids)
        sets += 1
    return sets


def node_device_affinity(node, tg: TaskGroup) -> tuple[float, bool]:
    """Best-case matched device affinity for the group on this node, used
    as the node-score contribution (rank.go:388-434 adds the assignment's
    matched affinity sum). Mean over asks with affinities."""
    scores = []
    for ask in group_device_asks(tg):
        if not ask.affinities:
            continue
        best = None
        for dev in node.node_resources.devices:
            if device_group_matches(dev, ask):
                s = device_affinity_score(dev, ask)
                best = s if best is None else max(best, s)
        if best is not None:
            scores.append(best)
    if not scores:
        return 0.0, False
    return float(sum(scores) / len(scores)), True
