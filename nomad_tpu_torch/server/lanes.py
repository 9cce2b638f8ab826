"""Deterministic lane ownership — the structurally conflict-free
multi-worker commit path.

The optimistic posture (reference Nomad, and this repo through r5) lets
any worker place on any node and relies on the serialized plan applier
to bounce whatever went stale. That is correct but not *stable*: two
pipelined batching workers racing commits under CPU starvation swung
the conflict rate 0.0–0.96 run to run (PERF_NOTES_r05.md). This module
replaces hope with a contract:

``LaneMap``
    every job and every node hash onto exactly one of ``num_lanes``
    lanes (the job hash is byte-identical to the eval broker's
    partition key, so broker routing IS lane routing), and each lane is
    owned by exactly one batching worker (``lane % num_batch_workers``).
    ``num_lanes`` is a constant independent of the worker count — a
    placement decision must be a function of (job, cluster state) only,
    never of how many workers happen to be running, or a 2-worker run
    could not be byte-identical to the 1-worker reference run.

``LaneClaims``
    the ordered two-phase cross-lane handoff. A batched pass scores the
    FULL cluster (minus actively-claimed nodes), so an eval whose best
    node belongs to a peer's lane is normal, not an error; before that
    placement may ride a merged commit, the committing worker must
    ``reserve`` the foreign nodes (refused if any is already claimed or
    settled) and ``confirm`` the claim (peer's scoring quiesced, no
    peer in-flight delta on the node, and a FRESH store-snapshot
    capacity re-check). A confirmed claim is attached to the MergedPlan
    so the applier can *assert* disjointness instead of discovering
    conflicts. ``release`` always runs (finally — even a chaos
    thread-kill cannot skip it), so a dropped handoff can never leak a
    reservation.

Settled nodes: once a handoff COMMITS, the node's owner still holds a
frozen overlay base that predates the foreign write, so the node stays
blocked for everyone until the owner's next epoch reset rebases it
(``clear_settled``). That closing of the stale-base window is what makes
``nomad.plan.lane_conflicts == 0`` an invariant rather than a hope.
"""

from __future__ import annotations

import threading
import time
import zlib
from typing import Optional

from ..chaos.plane import chaos_site
from ..utils.metrics import global_metrics as metrics

#: lanes in the deterministic map. A constant (not the worker count!)
#: so lane_of_job/lane_of_node — and therefore placement salts and
#: handoff boundaries — never move when the cluster is re-run with a
#: different ``num_batch_workers``.
DEFAULT_NUM_LANES = 16

#: how long ``confirm`` waits for a claimed node's owner to finish its
#: in-flight scoring pass before rejecting the handoff. Passes are
#: bounded device work; a peer that cannot quiesce in this window is
#: busy enough that falling back (solo, own-lane) is the cheaper move.
CONFIRM_QUIESCE_TIMEOUT = 0.25


class LaneMap:
    """Pure deterministic assignment: job → lane, node → lane,
    lane → owning batch worker. Stateless after construction."""

    def __init__(
        self,
        num_lanes: int = DEFAULT_NUM_LANES,
        num_batch_workers: int = 1,
    ):
        # every worker must own at least one lane
        self.num_lanes = max(int(num_lanes), int(num_batch_workers), 1)
        self.num_batch_workers = max(1, int(num_batch_workers))

    # -- assignment (the contract) -----------------------------------------
    def lane_of_job(self, namespace: str, job_id: str) -> int:
        """Byte-identical to EvalBroker._queue_key's partition hash, so
        the broker's partitioned dequeue IS lane-affine routing."""
        return zlib.crc32(f"{namespace}/{job_id}".encode()) % self.num_lanes

    def lane_of_node(self, node_id: str) -> int:
        return zlib.crc32(node_id.encode()) % self.num_lanes

    def owner_of_lane(self, lane: int) -> int:
        return lane % self.num_batch_workers

    def owner_of_job(self, namespace: str, job_id: str) -> int:
        return self.owner_of_lane(self.lane_of_job(namespace, job_id))

    def owner_of_node(self, node_id: str) -> int:
        return self.owner_of_lane(self.lane_of_node(node_id))

    def lanes_of_worker(self, worker_id: int) -> tuple[int, ...]:
        """The disjoint lane set one batching worker owns (empty for
        solo workers — they never touch the lane-affine queues)."""
        if worker_id >= self.num_batch_workers:
            return ()
        return tuple(
            lane
            for lane in range(self.num_lanes)
            if lane % self.num_batch_workers == worker_id
        )

    def assignments(self) -> dict[int, tuple[int, ...]]:
        """worker → owned lanes, for the resilience status surfaces."""
        return {
            w: self.lanes_of_worker(w) for w in range(self.num_batch_workers)
        }


class LaneClaim:
    """One cross-lane handoff: ``claimant`` (worker id) holding foreign
    ``nodes`` (node id → list of proposed new Allocations) for one
    eval's merged-plan member."""

    __slots__ = (
        "claimant", "eval_id", "nodes", "confirmed", "submitted", "released",
    )

    def __init__(self, claimant: int, eval_id: str, nodes: dict):
        self.claimant = claimant
        self.eval_id = eval_id
        self.nodes = nodes
        self.confirmed = False
        # set right before the merged plan is enqueued: past this point
        # the applier may land the claim's placements even if the commit
        # thread dies, so release() must settle the nodes either way
        self.submitted = False
        self.released = False

    def node_ids(self) -> tuple[str, ...]:
        return tuple(self.nodes)

    def __repr__(self):
        state = (
            "released" if self.released
            else "confirmed" if self.confirmed
            else "reserved"
        )
        return (
            f"LaneClaim(w{self.claimant} eval={self.eval_id[:8]} "
            f"nodes={sorted(self.nodes)} {state})"
        )


class LaneClaims:
    """The cross-lane handoff table: reserve → confirm → release.

    ``overlays`` is the per-worker LaneOverlays container (the confirm
    step interrogates the node owner's epoch) and ``snapshot_fn``
    returns a fresh store snapshot for the capacity re-check; both are
    injected by the Server so this table stays unit-testable."""

    def __init__(self, lanes: LaneMap, overlays=None, snapshot_fn=None,
                 sleep=time.sleep):
        self.lanes = lanes
        self.overlays = overlays
        self.snapshot_fn = snapshot_fn
        # the quiesce-wait poll interval sleeper: injectable so chaos
        # skew and unit tests can steer the confirm wait
        self._sleep = sleep
        self._lock = threading.Lock()
        # node id → the active claim holding it (reserve refuses overlap,
        # so at most one claim per node)
        self._by_node: dict[str, LaneClaim] = {}
        # owner worker → nodes committed by a peer's handoff and not yet
        # rebased into the owner's overlay epoch
        self._settled: dict[int, set[str]] = {}
        self.counters = {
            "reserves": 0,
            "reserve_refused": 0,
            "confirms": 0,
            "confirm_rejected": 0,
            "handoff_drops": 0,
            "releases": 0,
            "settled": 0,
        }

    # -- phase 1: reserve --------------------------------------------------
    def reserve(
        self, claimant: int, eval_id: str, nodes: dict
    ) -> Optional[LaneClaim]:
        """Stake the claim: refuse if any node is already actively
        claimed or is settled (its owner has not rebased a prior
        handoff yet). Returns None on refusal — the caller falls back,
        nothing to undo."""
        chaos_site("lane.handoff_delay")
        with self._lock:
            for node_id in nodes:
                if node_id in self._by_node:
                    self.counters["reserve_refused"] += 1
                    return None
                owner = self.lanes.owner_of_node(node_id)
                if node_id in self._settled.get(owner, ()):
                    self.counters["reserve_refused"] += 1
                    return None
            claim = LaneClaim(claimant, eval_id, nodes)
            for node_id in nodes:
                self._by_node[node_id] = claim
            self.counters["reserves"] += 1
            return claim

    # -- phase 2: confirm --------------------------------------------------
    def confirm(self, claim: LaneClaim) -> bool:
        """The peer-lane acknowledgement, in three checks per claimed
        node's owner: (1) the owner's scoring pass has quiesced (bounded
        wait — while a pass is in flight the owner may still be choosing
        the node), (2) the owner's overlay carries NO in-flight delta on
        the node (a nonzero delta means an uncommitted peer placement is
        already riding toward it), (3) a FRESH store snapshot still fits
        the claim's allocations. Anything less and the handoff is
        rejected; the member retries solo in its own lane."""
        action = chaos_site("lane.handoff_drop")
        if action == "drop":
            # the peer's confirmation was lost: the handoff fails and
            # the caller must release the reservation (no leaked claims)
            self.counters["handoff_drops"] += 1
            metrics.incr("nomad.lane.handoff_drops")
            return False
        owners = {
            self.lanes.owner_of_node(n)
            for n in claim.nodes
            if self.lanes.owner_of_node(n) != claim.claimant
        }
        if self.overlays is not None:
            deadline = time.monotonic() + CONFIRM_QUIESCE_TIMEOUT
            for owner in sorted(owners):
                ov = self.overlays.for_worker(owner)
                while ov.passes_in_flight():
                    if time.monotonic() >= deadline:
                        return self._reject(claim)
                    self._sleep(0.002)
            for node_id in claim.nodes:
                owner = self.lanes.owner_of_node(node_id)
                if owner == claim.claimant:
                    continue
                if self.overlays.for_worker(owner).pending_on(node_id):
                    return self._reject(claim)
        if not self._capacity_ok(claim):
            return self._reject(claim)
        claim.confirmed = True
        with self._lock:
            self.counters["confirms"] += 1
        metrics.incr("nomad.plan.cross_lane_handoffs")
        return True

    def _reject(self, claim: LaneClaim) -> bool:
        with self._lock:
            self.counters["confirm_rejected"] += 1
        metrics.incr("nomad.lane.confirm_rejected")
        return False

    def _capacity_ok(self, claim: LaneClaim) -> bool:
        """Exact host-side re-check against a snapshot taken AFTER the
        owners quiesced: live allocs + the claim's allocs must fit every
        claimed node (the same allocs_fit the applier's verify uses, so
        a confirmed claim cannot be rejected for capacity)."""
        if self.snapshot_fn is None:
            return True
        from ..structs import allocs_fit

        snap = self.snapshot_fn()
        for node_id, new_allocs in claim.nodes.items():
            node = snap.node_by_id(node_id)
            if node is None or node.terminal_status():
                return False
            new_ids = {a.id for a in new_allocs}
            proposed = [
                a
                for a in snap.allocs_by_node(node_id)
                if not a.terminal_status() and a.id not in new_ids
            ]
            proposed.extend(new_allocs)
            ok, _dim, _used = allocs_fit(node, proposed, check_devices=True)
            if not ok:
                return False
        return True

    # -- phase 3: release --------------------------------------------------
    def release(self, claim: LaneClaim, committed: bool = False) -> None:
        """Drop the reservation. Idempotent, and ALWAYS reached (the
        worker releases in a finally, which even ChaosThreadKill cannot
        skip). ``committed=True`` moves the nodes to their owners'
        settled sets: the placements are (or may be, if the thread died
        mid-submit) in the store, but each owner's frozen overlay base
        predates them — the node stays blocked until that owner
        rebases."""
        with self._lock:
            if claim.released:
                return
            claim.released = True
            self.counters["releases"] += 1
            for node_id in claim.nodes:
                if self._by_node.get(node_id) is claim:
                    del self._by_node[node_id]
                if committed:
                    owner = self.lanes.owner_of_node(node_id)
                    if owner != claim.claimant:
                        self._settled.setdefault(owner, set()).add(node_id)
                        self.counters["settled"] += 1

    def clear_settled(self, worker_id: int) -> None:
        """Owner rebased (fresh epoch, next snapshot includes every
        committed handoff): its settled nodes become schedulable again."""
        with self._lock:
            s = self._settled.get(worker_id)
            if s:
                s.clear()

    # -- queries -----------------------------------------------------------
    def blocked_node_ids(self) -> frozenset[str]:
        """Nodes no scoring pass may offer right now: actively claimed
        (a peer's handoff is in flight) or settled (the owner's epoch
        still predates a committed handoff)."""
        with self._lock:
            blocked = set(self._by_node)
            for nodes in self._settled.values():
                blocked.update(nodes)
            return frozenset(blocked)

    def active_count(self) -> int:
        with self._lock:
            return len({id(c) for c in self._by_node.values()})

    def settled_count(self) -> int:
        with self._lock:
            return sum(len(s) for s in self._settled.values())

    def drained(self) -> bool:
        """No active claims — the lane_isolation invariant's quiesce
        predicate (settled nodes clear lazily at owner rebase and are
        merely conservative, so they do not count as leaked state)."""
        with self._lock:
            return not self._by_node

    def snapshot(self) -> dict:
        """Status surface (CLI / HTTP): counters + live table sizes."""
        with self._lock:
            return {
                "active_claims": len({id(c) for c in self._by_node.values()}),
                "claimed_nodes": sorted(self._by_node),
                "settled_nodes": sorted(
                    n for s in self._settled.values() for n in s
                ),
                "counters": dict(self.counters),
            }
