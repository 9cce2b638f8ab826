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

The port carries the journal-driven row refresh and the incremental
rescoring of the reference (``NOMAD_TPU_INCREMENTAL``): the pass's
``used`` stays on the device as immutable generations behind
``score_view``, which serves the resident tensor when no row's bytes
changed; ``score_commit`` waits on the CUDA events recorded after a
generation's upload, never on the whole device.

Without a mesh the capacity tensor moves to the card once per layout
generation, and again only when a refresh rewrote capacity rows; a dirty
``used`` pass uploads the whole tensor, as the reference does on a
degenerate mesh, and counts one patch of its dirty rows. Under a
node-axis mesh (``mesh=``, default the process mesh) both views are laid
out over the mesh's node axis (``backend.ShardedTensor``): a node update
marks its region dirty and re-uploads only the shards holding that
region's rows (``shard_uploads``; ``full_uploads`` counts the whole
uploads), a dirty ``used`` pass re-uploads only the shards holding dirty
rows, and clean shards keep their tensors. ``verify_device_view`` and
``verify_score_view`` copy every shard back and compare it bitwise
(invariant law 12).

A dropped refresh (chaos sites ``mesh.shard_refresh_drop`` and
``cache.score_refresh_drop``) is recovered by a whole upload on the same
access.
"""

from __future__ import annotations

import threading
from dataclasses import replace

import numpy as np
import torch

from ..structs.resources import node_comparable_capacity
from ..backend import get_mesh, incremental_enabled, is_sharded, resolve_device, shard_put
from .flatten import ClusterTensors, flatten_cluster


def _dirty_rows(old: np.ndarray, new: np.ndarray) -> np.ndarray:
    """Rows whose bytes differ between two C-contiguous arrays of one
    shape: compared as unsigned words, so a row that flips between 0.0
    and -0.0 (or carries a NaN) is dirty exactly when its bits changed —
    the reference compares the floats, which would leave a generation
    that is not bitwise equal to its ``used``. The per-column OR is a
    tenth of the cost of ``np.any(axis=1)`` at 16,384 × 4."""
    word = np.uint64 if (old.shape[1] * old.itemsize) % 8 == 0 else np.uint32
    ne = old.view(word) != new.view(word)
    acc = ne[:, 0].copy()
    for col in range(1, ne.shape[1]):
        acc |= ne[:, col]
    return np.flatnonzero(acc)


def _node_used(snap, node_id: str, dims: int) -> np.ndarray:
    vec = np.zeros(dims, dtype=np.float32)
    for a in snap.allocs_by_node(node_id):
        if not a.terminal_status():
            vec += a.comparable_resources().to_vector()
    return vec


class ScoreState:
    """One generation of the persisted device-resident score view.

    The score planes every placement kernel computes are pure functions
    of ``(capacity, used, ask)``; capacity is already device-resident
    (``_device_capacity_locked``) and the asks are per-pass, so the
    persisted half of the score state is ``used`` — the alloc-churn-hot
    tensor that the from-scratch path re-uploads whole every pass. A
    generation is immutable once built (its tensor is never written, and
    the host mirror is a private copy): an in-flight pass keeps reading
    the previous generation while the next one is staged, and
    ``score_commit`` swaps staged → committed at the merge point.
    ``used_host`` is the exact bytes on device — the dirty-row diff and
    ``verify_score_view`` both compare against it bitwise. ``fence`` is
    the CUDA events recorded after the generation's upload, one a card
    it went to (empty on the CPU); ``used_dev`` is a ``ShardedTensor``
    under a node-axis mesh."""

    __slots__ = ("used_dev", "used_host", "layout_gen", "gen", "fence")

    def __init__(self, used_dev, used_host, layout_gen: int, gen: int,
                 fence=()):
        self.used_dev = used_dev
        self.used_host = used_host
        self.layout_gen = layout_gen
        self.gen = gen
        self.fence = fence


def _fences(t) -> list:
    """CUDA events recorded after ``t``'s upload on the current stream of
    each card it lies on (none on the CPU)."""
    devs = {p[2].device for p in t.pieces()} if is_sharded(t) else {t.device}
    out = []
    for d in devs:
        if d.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(d))
            out.append(ev)
    return out


def _bitwise_problems(view, host: np.ndarray, what: str) -> list[str]:
    """Each part of the device view (a tensor, or a ``ShardedTensor``'s
    distinct blocks) copied back and compared bitwise with its rows of
    ``host``; a line for each part that differs."""
    parts = view.pieces() if is_sharded(view) else [(None, (slice(None),), view)]
    out = []
    for _cell, idx, t in parts:
        got = t.detach().cpu().numpy()
        want = host[idx]
        if got.shape != want.shape or got.tobytes() != want.tobytes():
            start = idx[0].start or 0
            out.append(f"{what} rows[{start}:{start + got.shape[0]}] on {t.device}")
    return out


class DeviceStateCache:
    """One per harness; thread-safe. ``tensors(snap)`` returns a
    ClusterTensors at exactly ``snap.index`` whose ``used`` array is a
    private copy (schedulers overlay in-plan stops onto it) and whose
    ``device_capacity`` is the resident capacity: a tensor on ``device``,
    or under a node-axis mesh (``mesh``, a ``backend.MeshConfig``; None
    is the process mesh) a ``ShardedTensor`` refreshed per shard."""

    def __init__(self, device="cuda", mesh=None):
        self.device = resolve_device(device)
        self._mesh = mesh
        self.mesh  # noqa: B018  (a mesh led by another device raises here)
        self._lock = threading.Lock()
        self._ct: ClusterTensors | None = None
        # instrumentation: full flattens vs journal-driven refreshes
        self.full_flattens = 0
        self.incremental_refreshes = 0
        self.hits = 0
        self.stale_builds = 0  # older-than-resident snapshots (transient)
        # resident capacity on the device: uploaded once per layout
        # generation, and again when a refresh rewrote capacity rows
        self._dev_capacity = None  # torch.Tensor, or a ShardedTensor
        self._dev_layout_gen = 0
        self._capacity_dirty = False
        # mesh: dirty REGIONS (region ids are stable across incremental
        # refreshes; only a full reflatten may re-sort rows) map journal
        # changes to the node-axis shards that must re-upload
        self._dirty_regions: set[int] = set()
        self.shard_uploads = 0  # per-shard (partial) capacity refreshes
        self.full_uploads = 0  # whole capacity uploads under a mesh
        # score-state persistence (NOMAD_TPU_INCREMENTAL): double-
        # buffered device-resident ``used`` generations. ``_score`` is
        # the committed generation; ``score_view`` stages the next one
        # (dirty rows diffed bitwise against the newest mirror) and
        # ``score_commit`` swaps it in. Dirty detection is an exact host
        # compare rather than journal bookkeeping: overrides and
        # partially-landed commits self-heal on the next pass because
        # ANY divergence from the mirror re-uploads.
        self._score: ScoreState | None = None  # committed generation
        self._score_staged: ScoreState | None = None
        self.score_rows_rescored = 0  # rows re-uploaded (score inputs changed)
        self.score_rows_reused = 0  # rows served from the resident buffer
        self.score_patch_uploads = 0  # partial (dirty-row) refreshes
        self.score_full_rebuilds = 0  # whole-tensor score-state uploads
        self.score_swaps = 0  # staged → committed generation swaps
        self.pipeline_overlap_ms = 0.0  # commit time hidden behind passes

    @property
    def mesh(self):
        """The mesh the device views are laid out over (the one given,
        else the process mesh); an active mesh's lead must be
        ``device``. The schedulers build their kernels with it."""
        cfg = self._mesh if self._mesh is not None else get_mesh()
        if cfg.active and cfg.lead != self.device:
            raise ValueError(
                f"DeviceStateCache on {self.device}: the mesh's lead device "
                f"is {cfg.lead} ({cfg.source})"
            )
        return cfg

    # -- public -----------------------------------------------------------
    def tensors(self, snap) -> ClusterTensors:
        with self._lock:
            ct = self._refresh_locked(snap)
            out = replace(ct, used=ct.used.copy())
            out.device_capacity = self._device_capacity_locked(ct, self.mesh)
            if incremental_enabled():
                # the incremental seam the kernels read (device/score.py
                # used_device): present ⇒ the pass's ``used`` upload may
                # be served from the persisted score state. Off-mode
                # tensors carry None and take the from-scratch path
                # untouched.
                out.score_cache = self
            return out

    def invalidate(self) -> None:
        with self._lock:
            self._ct = None
            self._dev_capacity = None
            self._capacity_dirty = False
            self._dirty_regions.clear()
            self._score = None
            self._score_staged = None

    def device_counters(self) -> dict:
        with self._lock:
            state = self._score_staged or self._score
            return {
                "shard_uploads": self.shard_uploads,
                "full_uploads": self.full_uploads,
                "dirty_regions": len(self._dirty_regions),
                "score_rows_rescored": self.score_rows_rescored,
                "score_rows_reused": self.score_rows_reused,
                "score_patch_uploads": self.score_patch_uploads,
                "score_full_rebuilds": self.score_full_rebuilds,
                "score_swaps": self.score_swaps,
                "score_gen": 0 if state is None else state.gen,
                "pipeline_overlap_ms": round(self.pipeline_overlap_ms, 3),
            }

    def note_overlap(self, ms: float) -> None:
        """Worker-reported pipeline overlap: wall-clock the commit
        thread ran underneath the NEXT pass's prepare + device work."""
        with self._lock:
            self.pipeline_overlap_ms += max(0.0, float(ms))

    def verify_device_view(self) -> list[str] | None:
        """Invariant law 12 (shard_consistency) probe: copy every
        device-resident capacity shard back to the host and compare it
        *bitwise* with the resident generation's store-derived capacity.
        Returns None when no sharded view is materialized (no mesh, or
        never accessed); else a list of mismatch details (empty ==
        consistent). Pending dirty regions are flushed first, so the
        comparison sees what the next eval would read; a shard that
        claims to be clean must match."""
        with self._lock:
            ct = self._ct
            arr = self._dev_capacity
            if ct is None or not is_sharded(arr):
                return None
            if self._dirty_regions:
                arr = self._device_capacity_locked(ct, arr.cfg)
            return [
                f"{p} diverge from store-derived capacity"
                for p in _bitwise_problems(arr, np.ascontiguousarray(ct.capacity), "capacity")
            ]

    # -- score-state persistence (incremental rescoring) -------------------
    def score_view(self, ct, used0: np.ndarray, cfg=None):
        """Device-resident ``used`` for one scoring pass, bitwise equal
        to ``used0`` — or None when the incremental path is inactive
        (callers upload from scratch, exactly the off-mode path).

        Stages the next score-state generation: with no dirty row the
        pass gets the resident view and no bytes travel. Otherwise, under
        an active node-axis mesh ``cfg``, only the shards holding dirty
        rows re-upload and the clean shards keep their tensors; without
        one the new generation is uploaded whole (the reference's
        degenerate-mesh patch) and counted as one patch of the dirty
        rows. A change of layout (a mesh where there was none, another
        mesh) rebuilds. The staged generation becomes committed at
        ``score_commit``."""
        if not incremental_enabled():
            return None
        used0 = np.ascontiguousarray(used0, dtype=np.float32)
        layout_gen = getattr(ct, "layout_gen", 0)
        mesh = cfg if cfg is not None and cfg.active else None
        with self._lock:
            base = self._score_staged or self._score
            n_rows = int(used0.shape[0])
            if (
                base is None
                or base.layout_gen != layout_gen
                or base.used_host.shape != used0.shape
                or (base.used_dev.cfg if is_sharded(base.used_dev) else None)
                is not (mesh if mesh is not None and n_rows % mesh.mp == 0 else None)
            ):
                # first access, layout change (full reflatten re-sorts
                # rows: every cached row is misaligned), a shape flip or
                # another mesh — rebuild the whole score state
                return self._score_rebuild_locked(used0, layout_gen, mesh)
            dirty = _dirty_rows(base.used_host, used0)
            if dirty.size == 0:
                self.score_rows_reused += n_rows
                self._score_staged = ScoreState(
                    base.used_dev, base.used_host, layout_gen, base.gen,
                    base.fence,
                )
                return base.used_dev
            from ..chaos.plane import chaos_site

            if chaos_site("cache.score_refresh_drop") == "drop":
                # a dropped dirty-row refresh must never serve stale
                # score inputs: recovery is a whole-tensor rebuild on
                # this access (mesh.shard_refresh_drop discipline)
                return self._score_rebuild_locked(used0, layout_gen, mesh)
            self.score_rows_rescored += int(dirty.size)
            self.score_rows_reused += n_rows - int(dirty.size)
            dev, host, fence = self._score_patch_locked(base, used0, dirty, mesh)
            self._score_staged = ScoreState(
                dev, host, layout_gen, base.gen + 1, fence
            )
            self.score_patch_uploads += 1
            return dev

    def _upload(self, used0, mesh=None):
        """(view, mirror, fence) of a new generation. The mirror is a
        PRIVATE copy of the caller's live ``used``, and so is the view:
        on the CPU ``torch.from_numpy(...).to("cpu")`` aliases its array,
        and a generation must hold the exact bytes it was built from,
        never track the mirror or the caller. Under ``mesh`` the view is
        laid out on its node axis (each block a copy). The fence holds
        events after the upload on the cards it went to."""
        host = used0.copy()
        src = torch.from_numpy(host)
        if mesh is not None:
            dev = shard_put(src, ("nodes",), mesh)
            if not is_sharded(dev) and dev.device.type == "cpu":
                dev = dev.clone()
            return dev, host, _fences(dev)
        if self.device.type != "cuda":
            return src.clone(), host, []
        dev = src.to(self.device)
        return dev, host, _fences(dev)

    def _score_rebuild_locked(self, used0, layout_gen: int, mesh=None):
        dev, host, fence = self._upload(used0, mesh)
        base = self._score_staged or self._score
        gen = 1 if base is None else base.gen + 1
        self._score_staged = ScoreState(dev, host, layout_gen, gen, fence)
        self.score_full_rebuilds += 1
        self.score_rows_rescored += int(used0.shape[0])
        return dev

    def _score_patch_locked(self, base: ScoreState, used0, dirty, mesh):
        """(view, mirror, fence) for ``used0`` from ``base``: under a
        node-axis mesh a new carrier whose shards holding ``dirty`` rows
        are uploaded afresh around the clean shards' tensors (the
        capacity protocol); without one a whole upload — there is no
        partial placement of an unsharded tensor, and the reuse win
        there is the zero-dirty case."""
        arr = base.used_dev
        if mesh is None or not is_sharded(arr):
            return self._upload(used0)
        host = used0.copy()
        seg = host.shape[0] // mesh.mp
        fresh = {
            int(j): torch.from_numpy(host[j * seg:(j + 1) * seg])
            for j in np.unique(dirty // seg)
        }
        dev = arr.with_blocks(fresh)
        return dev, host, _fences(dev)

    def score_commit(self) -> None:
        """Swap the staged score-state generation in as committed — the
        double buffer's merge point. The one wait of the pipeline lives
        here: it waits on the staged generation's CUDA events (its
        upload), never on the whole device; on the CPU it waits on
        nothing."""
        with self._lock:
            staged = self._score_staged
            if staged is None:
                return
            self._score_staged = None
            if self._score is not None and staged.gen == self._score.gen:
                return  # zero-dirty pass: same generation, no swap
            self._score = staged
            self.score_swaps += 1
        for ev in staged.fence:
            ev.synchronize()

    def score_abort(self) -> None:
        """Drop the staged generation (a pass that died before commit);
        the next pass diffs against the committed mirror and re-uploads
        whatever the aborted pass had staged — correctness never
        depends on an abort being observed."""
        with self._lock:
            self._score_staged = None

    def verify_score_view(self) -> list[str] | None:
        """Invariant law 12 (shard_consistency), score half: copy every
        shard of the newest score-state generation back to the host (one
        card is one shard) and compare it *bitwise* (uint32 views)
        against its mirror. Returns None when no score state is
        materialized (incremental off, or never accessed); else a list
        of mismatch details (empty == consistent)."""
        with self._lock:
            state = self._score_staged or self._score
            if state is None:
                return None
            return [
                f"{p} diverge bitwise from the gen-{state.gen} mirror"
                for p in _bitwise_problems(state.used_dev, state.used_host, "score")
            ]

    def _device_capacity_locked(self, ct: ClusterTensors, cfg):
        """The resident capacity view of generation ``ct``. Under a
        node-axis mesh that divides the bucket: a ``ShardedTensor`` whose
        steady-state refreshes re-upload ONLY the shards holding rows of
        dirty regions (``shard_uploads``); a layout change (full
        reflatten), another mesh, or a dropped shard refresh (chaos site
        ``mesh.shard_refresh_drop``) uploads it whole (``full_uploads``).
        Else one tensor on the device, re-uploaded when a refresh rewrote
        capacity rows."""
        mp = cfg.n_node_shards
        pn = ct.padded_n
        if mp <= 1 or pn % mp != 0 or ct.region_ids is None:
            if (
                self._dev_capacity is None
                or is_sharded(self._dev_capacity)
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
                self._dirty_regions.clear()
            return self._dev_capacity
        arr = self._dev_capacity
        if (
            not is_sharded(arr)
            or arr.cfg is not cfg
            or self._dev_layout_gen != ct.layout_gen
            or tuple(arr.shape) != ct.capacity.shape
        ):
            return self._capacity_whole_locked(ct, cfg)
        if not self._dirty_regions:
            return arr
        from ..chaos.plane import chaos_site

        if chaos_site("mesh.shard_refresh_drop") == "drop":
            # a dropped shard upload must never serve stale capacity:
            # recovery is a whole upload on this access
            return self._capacity_whole_locked(ct, cfg)
        seg = pn // mp
        rows = np.flatnonzero(np.isin(ct.region_ids, list(self._dirty_regions)))
        fresh = {
            int(j): torch.from_numpy(np.array(ct.capacity[j * seg:(j + 1) * seg], dtype=np.float32))
            for j in np.unique(rows // seg)
        }
        self._dev_capacity = arr.with_blocks(fresh)
        self._dirty_regions.clear()
        self._capacity_dirty = False
        self.shard_uploads += 1
        return self._dev_capacity

    def _capacity_whole_locked(self, ct: ClusterTensors, cfg):
        self._dev_capacity = shard_put(
            np.array(ct.capacity, dtype=np.float32), ("nodes",), cfg
        )
        self._dev_layout_gen = ct.layout_gen
        self._dirty_regions.clear()
        self._capacity_dirty = False
        self.full_uploads += 1
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
        # the topology columns ride along (the reference's refresh drops
        # them, so every node reads as coordinate-less after the first
        # commit and cp-gang loses its topology term); a changed node's
        # coordinates fold into its computed class, which rebuilds above
        topo_ids = [col.copy() for col in ct.topology_columns()]
        topo_vocabs = [
            dict(ct.topo_rack_vocab), dict(ct.topo_pod_vocab),
            dict(ct.topo_ici_vocab),
        ]
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
            topo = getattr(node, "topology", None) or {}
            for level, ids, vocab in zip(("rack", "pod", "ici"), topo_ids, topo_vocabs):
                ids[row] = vocab.setdefault(topo.get(level, ""), len(vocab))
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
                self._dirty_regions.add(int(region_ids[row]))

        for nid in node_keys:
            row = node_row[nid]
            if row >= ct.num_nodes:
                continue  # appended above
            node = snap.node_by_id(nid)
            nodes[row] = node
            capacity[row] = node_comparable_capacity(node).to_vector()
            ready[row] = node.ready()
            used[row] = _node_used(snap, nid, dims)
            if region_ids is not None:
                self._dirty_regions.add(int(region_ids[row]))

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
            topo_rack_ids=topo_ids[0],
            topo_pod_ids=topo_ids[1],
            topo_ici_ids=topo_ids[2],
            topo_rack_vocab=topo_vocabs[0],
            topo_pod_vocab=topo_vocabs[1],
            topo_ici_vocab=topo_vocabs[2],
            # incremental refresh never reorders existing rows (new nodes
            # append) — row-indexed overlays stay valid
            layout_gen=ct.layout_gen,
        )
        return self._ct
