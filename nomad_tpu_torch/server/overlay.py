"""Shared optimistic-usage overlay for pipelined batching workers.

One batching worker's pipeline overlaps its device pass with its commit
thread; with SEVERAL batching workers (partitioned eval streams), each
worker's pass must also see the OTHER workers' in-flight placements or
deep concurrent passes double-book nodes and the applier bounces whole
passes. This object is the cross-worker version of the per-worker epoch:
a frozen usage base plus the sum of every in-flight pass's placements.

Reset discipline (the part that bit): the epoch may ONLY be dropped from
a WORKER thread immediately before it takes a fresh snapshot — never
from a commit thread. A commit thread finishing cannot know whether the
ClusterTensors any in-flight pass is holding already reflects its
writes; resetting there lets the next add_delta freeze a base from a
PRE-commit ct, silently dropping a whole pass's reservations (measured
as a 0.97 conflict cascade at the 10k-node shape). So:

- ``maybe_reset()`` — call at the top of a batch iteration, BEFORE the
  snapshot: drops the epoch only when no commit AND no pass is in
  flight, which guarantees the snapshot (and its ct) taken right after
  includes everything the overlay was predicting.
- ``begin_pass(ct)`` — marks a pass in flight, returns the optimistic
  usage (base + deltas) or None on a fresh epoch; ALWAYS pair with
  ``pass_finished()`` (finally).
- ``add_delta(ct, rows, ask)`` — reserve one submitted lane.
- ``commit_started()`` / ``commit_finished()`` — bracket each commit
  thread; finishing only decrements.

The plan applier remains the authority: any slack here surfaces as a
partial commit and an individual retry, never as a wrong placement.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np


class SharedOverlay:
    def __init__(self, owner: Optional[int] = None):
        self._lock = threading.Lock()
        self._base: Optional[np.ndarray] = None
        self._delta: Optional[np.ndarray] = None
        self._layout_gen = -1
        self._commits = 0
        self._passes = 0
        # lane mode: the one batching worker allowed to write deltas
        # here. None = legacy shared mode (any writer).
        self.owner = owner
        # node ids carrying a nonzero in-flight delta this epoch — the
        # cross-lane confirm step asks "does the owner's overlay already
        # predict a placement on this node?" without rescanning arrays
        self._pending_nodes: set[str] = set()

    def maybe_reset(self) -> bool:
        """Drop the epoch iff nothing is in flight. Worker threads call
        this immediately before taking their snapshot, so the snapshot is
        guaranteed to include everything the dropped overlay predicted."""
        with self._lock:
            if self._commits == 0 and self._passes == 0 and (
                self._base is not None
            ):
                self._base = None
                self._delta = None
                self._layout_gen = -1
                self._pending_nodes.clear()
                return True
            return False

    def begin_pass(self, ct) -> Optional[np.ndarray]:
        """Mark a pass in flight and return the usage it should score
        against (base + in-flight deltas), or None when the epoch is
        fresh — then the pass scores on bare ct.used and the first
        add_delta freezes the base. Pair with pass_finished()."""
        with self._lock:
            self._passes += 1
            if self._base is not None and self._layout_gen != ct.layout_gen:
                # full reflatten reordered rows: the frozen base no
                # longer aligns — drop it (applier remains the authority)
                self._base = None
                self._delta = None
                self._layout_gen = -1
                self._pending_nodes.clear()
            if self._base is None:
                return None
            return self._base + self._delta

    def pass_finished(self) -> None:
        with self._lock:
            self._passes = max(0, self._passes - 1)

    def add_delta(
        self, ct, rows: np.ndarray, ask: np.ndarray, writer: Optional[int] = None
    ) -> None:
        """Reserve one lane's submitted placements for later passes.

        In lane mode only the owning worker may write: a cross-lane
        write would fold a peer's in-flight placement into the wrong
        epoch and defeat the whole disjointness contract, so it is
        refused and counted (nomad.overlay.cross_lane_writes — invariant
        law 9 pins it at zero)."""
        with self._lock:
            if (
                self.owner is not None
                and writer is not None
                and writer != self.owner
            ):
                from ..utils.metrics import global_metrics

                global_metrics.incr("nomad.overlay.cross_lane_writes")
                return
            if self._base is None:
                self._base = np.asarray(ct.used).copy()
                self._delta = np.zeros_like(self._base)
                self._layout_gen = ct.layout_gen
            if self._layout_gen != ct.layout_gen:
                return  # layout changed mid-pass; skip (applier resolves)
            np.add.at(self._delta, rows, ask)
            # best-effort node-id tracking for the cross-lane confirm
            # probe; harness CTs without a node table just skip it
            ct_nodes = getattr(ct, "nodes", None)
            if ct_nodes is not None:
                for r in np.atleast_1d(rows):
                    ri = int(r)
                    if 0 <= ri < len(ct_nodes):
                        self._pending_nodes.add(ct_nodes[ri].id)

    def commit_started(self) -> None:
        with self._lock:
            self._commits += 1

    def commit_finished(self) -> None:
        with self._lock:
            self._commits = max(0, self._commits - 1)

    # -- lane-mode queries (cross-lane confirm interrogates these) ---------
    def pending_on(self, node_id: str) -> bool:
        """True when an UNCOMMITTED delta of this epoch touches the node.
        The worker takes its commit marker before dropping the pass
        marker (worker.py pipeline finally), so a submitted placement
        always holds passes+commits > 0 until the applier lands it; once
        both hit zero the retained delta is fully committed state —
        visible in any fresh snapshot — and only lingers because the
        epoch drops lazily on the owner's next iteration. Answering True
        then would spuriously reject cross-lane handoffs to idle
        owners."""
        with self._lock:
            if self._passes == 0 and self._commits == 0:
                return False
            return node_id in self._pending_nodes

    def passes_in_flight(self) -> int:
        with self._lock:
            return self._passes

    def is_fresh(self) -> bool:
        """Fresh epoch: next pass scores on a bare snapshot, which
        includes every committed write — the owner has rebased."""
        with self._lock:
            return (
                self._base is None and self._passes == 0 and self._commits == 0
            )

    def snapshot_markers(self) -> tuple[int, int]:
        """(passes, commits) — invariant checker's drain probe."""
        with self._lock:
            return self._passes, self._commits


class LaneOverlays:
    """Per-worker epoch overlays for lane mode: batching worker *i*
    scores against — and writes deltas into — ``for_worker(i)`` ONLY.
    No shared mutable optimistic state between workers; the cross-lane
    claim protocol (server/lanes.py) is the only bridge.

    For compatibility with call sites that still hold the server's
    ``placement_overlay`` as a single SharedOverlay (solo-path code,
    existing tests, the invariant checker's legacy probe), the container
    delegates the legacy interface to worker 0's overlay — at
    ``num_batch_workers == 1`` that makes it behave bit-identically to
    the old shared object."""

    def __init__(self, num_batch_workers: int = 1):
        self.num_batch_workers = max(1, int(num_batch_workers))
        self._overlays = [
            SharedOverlay(owner=i if self.num_batch_workers > 1 else None)
            for i in range(self.num_batch_workers)
        ]

    def for_worker(self, worker_id: int) -> SharedOverlay:
        return self._overlays[worker_id % self.num_batch_workers]

    def all(self) -> list[SharedOverlay]:
        return list(self._overlays)

    # -- legacy single-overlay interface (delegates to worker 0) -----------
    def maybe_reset(self) -> bool:
        return self._overlays[0].maybe_reset()

    def begin_pass(self, ct):
        return self._overlays[0].begin_pass(ct)

    def pass_finished(self) -> None:
        self._overlays[0].pass_finished()

    def add_delta(self, ct, rows, ask, writer=None) -> None:
        self._overlays[0].add_delta(ct, rows, ask, writer=writer)

    def commit_started(self) -> None:
        self._overlays[0].commit_started()

    def commit_finished(self) -> None:
        self._overlays[0].commit_finished()

    def is_fresh(self) -> bool:
        return self._overlays[0].is_fresh()

    def pending_on(self, node_id) -> bool:
        return self._overlays[0].pending_on(node_id)

    def passes_in_flight(self) -> int:
        return self._overlays[0].passes_in_flight()

    def snapshot_markers(self) -> list[tuple[int, int]]:
        return [ov.snapshot_markers() for ov in self._overlays]

    @property
    def _lock(self):
        return self._overlays[0]._lock

    @property
    def _passes(self):
        return self._overlays[0]._passes

    @property
    def _commits(self):
        return self._overlays[0]._commits

    @property
    def _base(self):
        return self._overlays[0]._base

    @property
    def _delta(self):
        return self._overlays[0]._delta
