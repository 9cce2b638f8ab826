"""DeviceStateCache — resident cluster tensors refreshed incrementally.

SURVEY.md §7 "latency floor": the device arrays are a *derived cache* of
the state store's node/alloc tables, refreshed by state-index watermark
(the ``SnapshotMinIndex`` analog, nomad/worker.go:536-549) — NOT rebuilt
per evaluation. The store's ChangeJournal (state/store.py) records which
node rows were touched; the cache patches exactly those rows.

Generational copy-on-write: a refresh builds new arrays (cheap — O(N·D)
numpy copies) and swaps the generation, so evals holding the previous
``ClusterTensors`` keep reading frozen state — the same MVCC discipline
the store itself uses.

Full rebuilds happen only when the journal can't cover the interval, a
node disappears or changes class/datacenter (representative-node
semantics would go stale), or the padded node bucket overflows.

The port carries the host half: ``tensors(snap)``/``invalidate`` and the
journal-driven row refresh, with the capacity tensor moved to the card
once per layout generation (and again only when a refresh rewrote
capacity rows). The reference's incremental rescoring — the
device-resident ``used`` generations behind ``score_view`` — is not
ported yet (ROADMAP A6); each pass uploads its ``used`` whole.
"""

from __future__ import annotations

import threading
from dataclasses import replace

import numpy as np
import torch

from ..structs.resources import node_comparable_capacity
from ..backend import resolve_device
from .flatten import ClusterTensors, flatten_cluster


def _node_used(snap, node_id: str, dims: int) -> np.ndarray:
    vec = np.zeros(dims, dtype=np.float32)
    for a in snap.allocs_by_node(node_id):
        if not a.terminal_status():
            vec += a.comparable_resources().to_vector()
    return vec


class DeviceStateCache:
    """One per harness; thread-safe. ``tensors(snap)`` returns a
    ClusterTensors at exactly ``snap.index`` whose ``used`` array is a
    private copy (schedulers overlay in-plan stops onto it) and whose
    ``device_capacity`` is the resident capacity tensor on ``device``."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._ct: ClusterTensors | None = None
        # instrumentation: full flattens vs journal-driven refreshes
        self.full_flattens = 0
        self.incremental_refreshes = 0
        self.hits = 0
        self.stale_builds = 0  # older-than-resident snapshots (transient)
        # resident capacity on the device: uploaded once per layout
        # generation, and again when a refresh rewrote capacity rows
        self._dev_capacity: torch.Tensor | None = None
        self._dev_layout_gen = 0
        self._capacity_dirty = False

    # -- public -----------------------------------------------------------
    def tensors(self, snap) -> ClusterTensors:
        with self._lock:
            ct = self._refresh_locked(snap)
            out = replace(ct, used=ct.used.copy())
            out.device_capacity = self._device_capacity_locked(ct)
            return out

    def invalidate(self) -> None:
        with self._lock:
            self._ct = None
            self._dev_capacity = None
            self._capacity_dirty = False

    def _device_capacity_locked(self, ct: ClusterTensors) -> torch.Tensor:
        if (
            self._dev_capacity is None
            or self._capacity_dirty
            or self._dev_layout_gen != ct.layout_gen
            or tuple(self._dev_capacity.shape) != ct.capacity.shape
        ):
            # a private copy: the host array belongs to the generation
            self._dev_capacity = torch.from_numpy(
                np.array(ct.capacity, dtype=np.float32)
            ).to(self.device)
            self._dev_layout_gen = ct.layout_gen
            self._capacity_dirty = False
        return self._dev_capacity

    # -- refresh machinery -------------------------------------------------
    def _rebuild_locked(self, snap) -> ClusterTensors:
        self.full_flattens += 1
        self._ct = replace(
            flatten_cluster(snap), layout_gen=self.full_flattens
        )
        return self._ct

    def _refresh_locked(self, snap) -> ClusterTensors:
        ct = self._ct
        if ct is not None and snap.index < ct.index:
            # A worker holding an older snapshot than the resident
            # generation: serve the RESIDENT build. Its usage is newer
            # than the snapshot — strictly MORE accurate for optimistic
            # placement (it already includes commits the snapshot
            # missed); the plan applier re-checks against live state
            # either way. The alternative (a transient rebuild from the
            # old snapshot) is quadratically worse under pipelined
            # workers: it is a full reflatten per pass, its row order
            # differs from the resident layout (layout_gen 0) so the
            # shared optimistic overlay gets dropped, and its usage
            # EXCLUDES the other workers' in-flight commits — measured
            # as >90% applier rejection of whole passes.
            self.stale_builds += 1
            return ct
        if ct is None:
            return self._rebuild_locked(snap)
        if snap.index == ct.index:
            self.hits += 1
            return ct
        journal = getattr(snap, "journal", None)
        if journal is None:
            return self._rebuild_locked(snap)
        changes = journal.since(ct.index, snap.index)
        if changes is None:
            return self._rebuild_locked(snap)
        node_keys = changes.get("nodes", set())
        alloc_nodes = changes.get("node_allocs", set())
        if not node_keys and not alloc_nodes:
            # index advanced without touching schedulable state
            self._ct = replace(ct, index=snap.index)
            self.hits += 1
            return self._ct

        new_nodes: list = []
        for nid in node_keys:
            node = snap.node_by_id(nid)
            if node is None:
                return self._rebuild_locked(snap)  # node removed
            row = ct.node_row.get(nid)
            if row is None:
                new_nodes.append(node)
                continue
            # class/dc changes invalidate representative-node memoization.
            # device_class folds into computed_class (structs/node.py), so
            # an accelerator-class flip always lands here and forces the
            # rebuild — the cache can never serve a stale class column.
            cid = ct.class_vocab.get(node.computed_class or "")
            if cid is None or cid != ct.class_ids[row]:
                return self._rebuild_locked(snap)
            did = ct.dc_vocab.get(node.datacenter)
            if did is None or did != ct.dc_ids[row]:
                return self._rebuild_locked(snap)
            # belt-and-braces for hand-mutated nodes that skipped
            # compute_class(): a raw device_class change alone still
            # invalidates the heterogeneity column
            dcid = ct.device_class_vocab.get(
                getattr(node, "device_class", "")
            )
            dcol = ct.device_class_ids
            if dcid is None or (
                dcol is not None and dcid != dcol[row]
            ):
                return self._rebuild_locked(snap)
        if ct.num_nodes + len(new_nodes) > ct.padded_n:
            return self._rebuild_locked(snap)  # bucket overflow

        self.incremental_refreshes += 1
        if node_keys or new_nodes:
            self._capacity_dirty = True
        dims = ct.capacity.shape[1]
        capacity = ct.capacity.copy()
        used = ct.used.copy()
        ready = ct.ready.copy()
        dc_ids = ct.dc_ids.copy()
        class_ids = ct.class_ids.copy()
        region_ids = (
            ct.region_ids.copy() if ct.region_ids is not None else None
        )
        region_vocab = dict(ct.region_vocab)
        node_ids = list(ct.node_ids)
        nodes = list(ct.nodes)
        node_row = dict(ct.node_row)
        dc_vocab = dict(ct.dc_vocab)
        class_vocab = dict(ct.class_vocab)
        class_rep = list(ct.class_rep)
        device_class_ids, _ = ct.device_class_column()
        device_class_ids = device_class_ids.copy()
        device_class_vocab = dict(ct.device_class_vocab)
        num_nodes = ct.num_nodes
        # attribute columns referencing changed nodes go stale; drop them
        # (recomputed lazily — node attribute changes are rare next to
        # alloc churn, which never touches these)
        attr_cache = dict(ct.attr_cache) if not node_keys else {}

        for node in new_nodes:
            row = num_nodes
            num_nodes += 1
            node_row[node.id] = row
            node_ids.append(node.id)
            nodes.append(node)
            if not node.computed_class:
                node.compute_class()
            cid = class_vocab.setdefault(node.computed_class, len(class_vocab))
            if cid == len(class_rep):
                class_rep.append(row)
            class_ids[row] = cid
            dc_ids[row] = dc_vocab.setdefault(node.datacenter, len(dc_vocab))
            device_class_ids[row] = device_class_vocab.setdefault(
                getattr(node, "device_class", ""), len(device_class_vocab)
            )
            capacity[row] = node_comparable_capacity(node).to_vector()
            ready[row] = node.ready()
            used[row] = _node_used(snap, node.id, dims)
            if region_ids is not None:
                # appended rows break strict region-major contiguity
                # until the next full reflatten re-sorts
                from .flatten import _region_name, region_key

                region_ids[row] = region_vocab.setdefault(
                    _region_name(region_key(node)), len(region_vocab)
                )

        for nid in node_keys:
            row = node_row[nid]
            if row >= ct.num_nodes:
                continue  # appended above
            node = snap.node_by_id(nid)
            nodes[row] = node
            capacity[row] = node_comparable_capacity(node).to_vector()
            ready[row] = node.ready()
            used[row] = _node_used(snap, nid, dims)

        for nid in alloc_nodes:
            if nid in node_keys:
                continue  # already recomputed
            row = node_row.get(nid)
            if row is None:
                continue  # alloc on an unknown node — nothing resident
            used[row] = _node_used(snap, nid, dims)

        self._ct = ClusterTensors(
            node_ids=node_ids,
            index=snap.index,
            num_nodes=num_nodes,
            capacity=capacity,
            used=used,
            ready=ready,
            dc_ids=dc_ids,
            class_ids=class_ids,
            dc_vocab=dc_vocab,
            class_vocab=class_vocab,
            class_rep=class_rep,
            node_row=node_row,
            nodes=nodes,
            attr_cache=attr_cache,
            device_class_ids=device_class_ids,
            device_class_vocab=device_class_vocab,
            region_ids=region_ids,
            region_vocab=region_vocab,
            # incremental refresh never reorders existing rows (new nodes
            # append) — row-indexed overlays stay valid
            layout_gen=ct.layout_gen,
        )
        return self._ct
