"""Flattening layer: snapshot state → dense device tensors.

This is the layer SURVEY.md §7 step 1 demands: `NodeResources`/`Resources`
→ dense ``float32[nodes, dims]`` arrays with a stable node-index mapping
and masks for datacenter/class/eligibility. The reference walks Go structs
per node per placement (scheduler/rank.go:193-527); we pay the struct walk
once per snapshot refresh and let every placement reuse the arrays.

Split of labor (mirrors the reference's class-memoization bet,
scheduler/feasible.go:1029-1153: classes ≪ nodes):

- **Host (here):** resolve string/regex/version constraints once per
  *computed node class* into per-class bits, then broadcast to per-node
  masks with one gather. Constraints touching ``unique.`` attributes are
  evaluated per node ("escaped class" in the reference's terms).
- **Device (score.py):** resource fit, scoring, argmax, and the greedy
  placement scan over dense arrays only.

Shapes are padded to buckets (powers of two), as in the reference, so
both packages lay the cluster out identically.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..structs import NUM_DIMS, Job, TaskGroup
from ..structs.resources import node_comparable_capacity


def _check_constraint(node, c):
    # deferred import: scheduler package imports device at init time, so a
    # top-level import here would be circular
    from ..scheduler.feasible import check_constraint

    return check_constraint(node, c)

# Padding buckets for the node axis: next power of two, min 8. Keeps the
# number of distinct compiled shapes logarithmic in cluster size.
_MIN_BUCKET = 8


def region_key(node) -> tuple[str, str]:
    """The region a node belongs to: (datacenter, device_class). Rows are
    laid out region-major so a region's rows are contiguous and — with a
    mesh active — land on as few node-axis shards as possible, keeping
    per-shard feasibility prefilters local. The key is pure node identity
    (no usage state), so it is stable across incremental refreshes; only
    a full reflatten may re-sort."""
    return (node.datacenter, getattr(node, "device_class", "") or "")


def _region_name(key: tuple[str, str]) -> str:
    return f"{key[0]}/{key[1]}" if key[1] else key[0]


def node_bucket(n: int) -> int:
    b = _MIN_BUCKET
    while b < n:
        b <<= 1
    return b


@dataclass
class ClusterTensors:
    """Dense snapshot of schedulable cluster state.

    ``node_ids[i]`` ↔ row i of every array; rows ≥ ``num_nodes`` are
    padding (``ready`` False ⇒ never selected).
    """

    node_ids: list[str]
    index: int  # state index this was built at (raft watermark analog)
    num_nodes: int
    capacity: np.ndarray  # f32[N, D] reserved-adjusted capacity
    used: np.ndarray  # f32[N, D] non-terminal alloc usage
    ready: np.ndarray  # bool[N]
    dc_ids: np.ndarray  # i32[N]
    class_ids: np.ndarray  # i32[N]
    dc_vocab: dict[str, int]
    class_vocab: dict[str, int]
    # per-class representative node index (for host-side class evaluation)
    class_rep: list[int]
    node_row: dict[str, int] = field(default_factory=dict)
    # heterogeneity axis: per-node accelerator class ids. Id 0 is always
    # the class-less "" so hand-built tensors (benchmarks, parity
    # corpora) and pre-heterogeneity snapshots behave identically without
    # declaring anything. None = never flattened with classes; the
    # device_class_column accessor synthesizes the all-classless column.
    device_class_ids: np.ndarray | None = None  # i32[N]
    device_class_vocab: dict[str, int] = field(
        default_factory=lambda: {"": 0}
    )
    # topology axis (gang scheduling): factored per-level coordinate id
    # columns. Id 0 is always the coordinate-less "" so hand-built
    # tensors and pre-topology snapshots behave identically; None =
    # never flattened with topology (topology_columns synthesizes the
    # all-zero columns).
    topo_rack_ids: np.ndarray | None = None  # i32[N]
    topo_pod_ids: np.ndarray | None = None  # i32[N]
    topo_ici_ids: np.ndarray | None = None  # i32[N]
    topo_rack_vocab: dict[str, int] = field(default_factory=lambda: {"": 0})
    topo_pod_vocab: dict[str, int] = field(default_factory=lambda: {"": 0})
    topo_ici_vocab: dict[str, int] = field(default_factory=lambda: {"": 0})
    # row-ordered Node objects (nodes[i] ↔ row i); kept in sync by the
    # flattener / DeviceStateCache so host-side per-class constraint
    # evaluation never re-sorts the cluster
    nodes: list = field(default_factory=list)
    # attribute → (value_ids i32[N], vocab dict) — lazily built columns for
    # spread/property attributes, owned by the cache generation
    attr_cache: dict = field(default_factory=dict)
    # datacenter → ready-node count, filled lazily IN PLACE by the
    # scheduler (AllocMetric.nodes_available). The dict OBJECT is shared
    # by reference across the per-call used-copy wrappers (replace()
    # copies field references), so one computation serves every eval of
    # a cache generation; refresh/rebuild construct a fresh empty dict,
    # which is exactly the staleness boundary.
    dc_ready_counts: dict = field(default_factory=dict)
    # region axis (mesh sharding): per-row region ids, nondecreasing by
    # construction (rows are sorted region-major), -1 on padding rows.
    # None = hand-built tensors that never declared regions; treat as one
    # region. region_vocab maps "dc[/device_class]" → id.
    region_ids: np.ndarray | None = None  # i32[N]
    region_vocab: dict[str, int] = field(default_factory=dict)
    # device-resident capacity tensor for this generation (filled by
    # DeviceStateCache.tensors; None = upload on the fly). Shared by
    # reference across the per-call used-copy wrappers.
    device_capacity: object = None
    # row-layout generation: bumped ONLY by a full reflatten (which may
    # re-sort rows); preserved across incremental refreshes and the
    # per-call used-copy. Consumers holding row-indexed overlays (the
    # worker's pipelined usage epoch) compare this to decide whether
    # their row indices still align. 0 = transient build, never matches.
    layout_gen: int = 0

    @property
    def padded_n(self) -> int:
        return self.capacity.shape[0]

    def row_of(self, node_id: str) -> int:
        return self.node_row[node_id]

    def attr_column(self, attr: str) -> tuple[np.ndarray, dict[str, int]]:
        """Per-node value ids for one attribute (-1 = absent), cached.
        The vocab grows append-only so cached GroupAsk ids stay valid."""
        cached = self.attr_cache.get(attr)
        if cached is not None:
            return cached
        ids = np.full(self.padded_n, -1, dtype=np.int32)
        vocab: dict[str, int] = {}
        for i in range(self.num_nodes):
            v = self.nodes[i].lookup_attribute(attr)
            if v is not None:
                ids[i] = vocab.setdefault(str(v), len(vocab))
        self.attr_cache[attr] = (ids, vocab)
        return ids, vocab

    def device_class_column(self) -> tuple[np.ndarray, dict[str, int]]:
        """Per-node device-class ids + vocab (id 0 = class-less "")."""
        if self.device_class_ids is None:
            self.device_class_ids = np.zeros(self.padded_n, dtype=np.int32)
        return self.device_class_ids, self.device_class_vocab

    @property
    def has_device_classes(self) -> bool:
        """True when any node declares a non-empty device_class."""
        return len(self.device_class_vocab) > 1

    def topology_columns(
        self,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Per-node (rack_ids, pod_ids, ici_ids) i32 columns (id 0 = no
        coordinate). The factored per-level form of the topology
        distance matrix: two rows are rack-adjacent iff their rack ids
        match, pod-adjacent iff their pod ids match, ici-adjacent iff
        their normalized ICI-hop-distance slice ids match — N
        three-column entries instead of an N×N hop matrix."""
        if self.topo_rack_ids is None:
            self.topo_rack_ids = np.zeros(self.padded_n, dtype=np.int32)
        if self.topo_pod_ids is None:
            self.topo_pod_ids = np.zeros(self.padded_n, dtype=np.int32)
        if self.topo_ici_ids is None:
            self.topo_ici_ids = np.zeros(self.padded_n, dtype=np.int32)
        return self.topo_rack_ids, self.topo_pod_ids, self.topo_ici_ids

    @property
    def has_topology(self) -> bool:
        """True when any node declares rack/pod/ici coordinates."""
        return (
            len(self.topo_rack_vocab) > 1
            or len(self.topo_pod_vocab) > 1
            or len(self.topo_ici_vocab) > 1
        )


def flatten_cluster(snap, nodes=None) -> ClusterTensors:
    """Build ClusterTensors from a StateSnapshot (or an explicit node list).

    Usage is summed from each node's non-terminal allocations — the same
    quantity ``BinPackIterator`` derives per node via ProposedAllocs
    (scheduler/context.go:120-157), minus in-flight plan deltas which the
    scheduler overlays separately (see score.py's ``used`` argument).
    """
    # Region-major row order — UNCONDITIONAL, so the single-device and
    # sharded paths see the same rows in the same order and argmax
    # tie-breaks agree bit-for-bit. Within a region, by node id (the
    # pre-region order); single-dc classless clusters keep the exact
    # pre-region layout.
    if nodes is None:
        nodes = snap.nodes()
    nodes = sorted(nodes, key=lambda nd: (*region_key(nd), nd.id))
    n = len(nodes)
    pn = node_bucket(max(n, 1))

    capacity = np.zeros((pn, NUM_DIMS), dtype=np.float32)
    used = np.zeros((pn, NUM_DIMS), dtype=np.float32)
    ready = np.zeros(pn, dtype=bool)
    dc_ids = np.zeros(pn, dtype=np.int32)
    class_ids = np.zeros(pn, dtype=np.int32)
    dc_vocab: dict[str, int] = {}
    class_vocab: dict[str, int] = {}
    class_rep: list[int] = []
    node_row: dict[str, int] = {}
    device_class_ids = np.zeros(pn, dtype=np.int32)
    device_class_vocab: dict[str, int] = {"": 0}
    topo_rack_ids = np.zeros(pn, dtype=np.int32)
    topo_pod_ids = np.zeros(pn, dtype=np.int32)
    topo_ici_ids = np.zeros(pn, dtype=np.int32)
    topo_rack_vocab: dict[str, int] = {"": 0}
    topo_pod_vocab: dict[str, int] = {"": 0}
    topo_ici_vocab: dict[str, int] = {"": 0}
    region_ids = np.full(pn, -1, dtype=np.int32)
    region_vocab: dict[str, int] = {}

    for i, node in enumerate(nodes):
        node_row[node.id] = i
        capacity[i] = node_comparable_capacity(node).to_vector()
        ready[i] = node.ready()
        dc_ids[i] = dc_vocab.setdefault(node.datacenter, len(dc_vocab))
        region_ids[i] = region_vocab.setdefault(
            _region_name(region_key(node)), len(region_vocab)
        )
        device_class_ids[i] = device_class_vocab.setdefault(
            getattr(node, "device_class", ""), len(device_class_vocab)
        )
        topo = getattr(node, "topology", None) or {}
        topo_rack_ids[i] = topo_rack_vocab.setdefault(
            topo.get("rack", ""), len(topo_rack_vocab)
        )
        topo_pod_ids[i] = topo_pod_vocab.setdefault(
            topo.get("pod", ""), len(topo_pod_vocab)
        )
        topo_ici_ids[i] = topo_ici_vocab.setdefault(
            topo.get("ici", ""), len(topo_ici_vocab)
        )
        if not node.computed_class:
            node.compute_class()
        cid = class_vocab.setdefault(node.computed_class, len(class_vocab))
        if cid == len(class_rep):
            class_rep.append(i)
        class_ids[i] = cid
        if snap is not None:
            for a in snap.allocs_by_node(node.id):
                if not a.terminal_status():
                    used[i] += a.comparable_resources().to_vector()

    return ClusterTensors(
        node_ids=[nd.id for nd in nodes],
        index=getattr(snap, "index", 0) if snap is not None else 0,
        num_nodes=n,
        capacity=capacity,
        used=used,
        ready=ready,
        dc_ids=dc_ids,
        class_ids=class_ids,
        dc_vocab=dc_vocab,
        class_vocab=class_vocab,
        class_rep=class_rep,
        node_row=node_row,
        nodes=list(nodes),
        device_class_ids=device_class_ids,
        device_class_vocab=device_class_vocab,
        topo_rack_ids=topo_rack_ids,
        topo_pod_ids=topo_pod_ids,
        topo_ici_ids=topo_ici_ids,
        topo_rack_vocab=topo_rack_vocab,
        topo_pod_vocab=topo_pod_vocab,
        topo_ici_vocab=topo_ici_vocab,
        region_ids=region_ids,
        region_vocab=region_vocab,
    )


@dataclass
class ValueBlocks:
    """Stacked per-attribute-value accounting blocks for one group ask.

    Spread blocks (scored — scheduler/spread.go) and distinct_property
    blocks (capped — scheduler/feasible.go:604) share the same shape: a
    per-node value-id column plus per-value state the kernel carries
    through its placement scan. ``kinds[b]`` selects the semantics
    (score.py BLOCK_* constants)."""

    value_ids: np.ndarray  # i32[B, N]  (−1 = node has no value)
    counts0: np.ndarray  # f32[B, V] initial combined-use counts
    desired: np.ndarray  # f32[B, V] target-mode desired; −1 = untargeted
    caps: np.ndarray  # f32[B, V] distinct_property allowed-count; +inf else
    weights: np.ndarray  # f32[B] target-mode relative weight (w / Σw)
    kinds: np.ndarray  # i32[B] BLOCK_TARGET_SPREAD/EVEN_SPREAD/DISTINCT_CAP

    @property
    def num_blocks(self) -> int:
        return self.value_ids.shape[0]

    @property
    def num_values(self) -> int:
        return self.counts0.shape[1]

    @property
    def has_spreads(self) -> bool:
        from .score import BLOCK_DISTINCT_CAP

        return bool((self.kinds != BLOCK_DISTINCT_CAP).any())


def pad_value_blocks(blocks: list, pn: int) -> dict:
    """Stack per-ask ValueBlocks (or None) into the padded [G, B, N] /
    [G, B, V] kernel tensors, bucketing B and V to powers of two."""
    from .score import BLOCK_INACTIVE

    def bucket(n: int) -> int:
        b = 1
        while b < n:
            b <<= 1
        return b

    max_b = bucket(max([b.num_blocks for b in blocks if b is not None] or [1]))
    max_v = bucket(max([b.num_values for b in blocks if b is not None] or [1]))
    g = len(blocks)
    value_ids = np.full((g, max_b, pn), -1, dtype=np.int32)
    counts0 = np.zeros((g, max_b, max_v), dtype=np.float32)
    desired = np.full((g, max_b, max_v), -1.0, dtype=np.float32)
    caps = np.full((g, max_b, max_v), np.inf, dtype=np.float32)
    weights = np.zeros((g, max_b), dtype=np.float32)
    kinds = np.full((g, max_b), BLOCK_INACTIVE, dtype=np.int32)
    for gi, b in enumerate(blocks):
        if b is None:
            continue
        nb, nv = b.num_blocks, b.num_values
        value_ids[gi, :nb, : b.value_ids.shape[1]] = b.value_ids
        counts0[gi, :nb, :nv] = b.counts0
        desired[gi, :nb, :nv] = b.desired
        caps[gi, :nb, :nv] = b.caps
        weights[gi, :nb] = b.weights
        kinds[gi, :nb] = b.kinds
    return dict(
        block_value_ids=value_ids,
        block_counts0=counts0,
        block_desired=desired,
        block_caps=caps,
        block_weights=weights,
        block_kinds=kinds,
    )


@dataclass
class GroupAsk:
    """One task group's flattened placement request — everything the device
    kernel needs, with strings already resolved to masks/ids."""

    job_id: str
    tg_name: str
    count: int  # placements wanted in this pass
    desired_total: int  # tg.count — anti-affinity denominator (rank.go:589)
    ask: np.ndarray  # f32[D]
    eligible: np.ndarray  # bool[N] constraint ∧ dc ∧ ready mask
    job_counts: np.ndarray  # i32[N] existing allocs of this job per node
    penalty_nodes: np.ndarray  # bool[N] rescheduling penalty (rank.go:606)
    affinity_scores: np.ndarray  # f32[N] pre-normalized [-1, 1]
    has_affinities: bool
    distinct_hosts: bool
    # spread + distinct_property accounting blocks; None when the group
    # has neither (→ the closed-form top-k path)
    blocks: ValueBlocks | None = None
    # Per-node cap on additional placements of this group, from device
    # instance accounting (scheduler/device.py feasible_sets); None when
    # the group asks for no devices (kernel substitutes +inf).
    slot_caps: np.ndarray | None = None
    # AllocMetric filter accounting (structs.go AllocMetric): populated by
    # _eligibility_for_group, surfaced on placement failures.
    filter_stats: dict = field(default_factory=dict)
    # Heterogeneity: per-node throughput coefficient for THIS job (the
    # job's per-device-class map gathered through the fleet's class
    # column). None = class-less / throughput-agnostic — every kernel and
    # policy must treat None exactly as an all-ones vector, and the base
    # binpack/spread kernels never read it at all (bit-identity).
    throughputs: np.ndarray | None = None  # f32[N]
    has_throughputs: bool = False
    # Calibration profile key (obs/calibrate.py): the job-profile axis of
    # the ThroughputEstimator's (device_class × profile) matrix. Empty =
    # not calibratable; only the hetero kernel's learned mode reads it.
    profile: str = ""
    # Job priority (structs/job.py, 0-100). The CP dispatcher's joint
    # pass resolves contested nodes by tier before score (scheduler/
    # cp.py); the per-group kernels never read it.
    priority: int = 50
    # Gang scheduling (structs/job.py gang stanza): True when this group
    # is a member of its job's all-or-nothing gang. The signed topology
    # weights price co-location (+, colocate) or anti-location (−,
    # spread) against gang-mate assignments at each level; 0.0 = no term
    # at that level. Only the cp-gang dispatcher reads any of these —
    # the base kernels stay bit-identical.
    gang_member: bool = False
    gang_weight_rack: float = 0.0
    gang_weight_pod: float = 0.0
    gang_weight_ici: float = 0.0

    @property
    def has_spreads(self) -> bool:
        return self.blocks is not None and self.blocks.has_spreads


def job_throughput_vector(
    ct: ClusterTensors, job: Job
) -> tuple[np.ndarray | None, bool]:
    """Gather the job's per-device-class throughput coefficients into a
    per-node f32[N] vector (default 1.0 for unmapped classes). Returns
    (None, False) when the fleet is class-less or the job carries no
    coefficients — the signal every downstream consumer uses to stay on
    the pre-heterogeneity code path bit-for-bit."""
    throughputs = getattr(job, "throughputs", None)
    if not throughputs or not ct.has_device_classes:
        return None, False
    ids, vocab = ct.device_class_column()
    per_class = np.ones(len(vocab), dtype=np.float32)
    for name, cid in vocab.items():
        if name:
            per_class[cid] = np.float32(throughputs.get(name, 1.0))
    vec = per_class[ids]
    if bool(np.all(vec == np.float32(1.0))):
        return None, False
    return vec, True


def job_profile_key(job) -> str:
    """Stable calibration-profile key for a job: an explicit
    ``calibration_profile`` wins; otherwise the declared throughput map
    itself (sorted, value-normalized) names the profile, so jobs with the
    same declared shape share telemetry cells. Empty = no profile —
    learned mode leaves the job on its declared/all-ones coefficients."""
    explicit = getattr(job, "calibration_profile", "") or ""
    if explicit:
        return str(explicit)
    throughputs = getattr(job, "throughputs", None) or {}
    if not throughputs:
        return ""
    return "tp:" + ",".join(
        f"{k}={float(v):g}" for k, v in sorted(throughputs.items())
    )


def _eligibility_for_group(
    ct: ClusterTensors, nodes_sorted, job: Job, tg: TaskGroup, snap=None
) -> tuple[np.ndarray, dict]:
    """ready ∧ datacenter ∧ hard constraints, with per-class memoization.

    Constraints whose targets resolve per-node (``unique.`` attrs, node id/
    name) force per-node evaluation — the "escaped computed class" path
    (scheduler/feasible.go:1029-1153).

    Also returns filter accounting for AllocMetric explainability
    (structs.go AllocMetric.FilterNode: NodesFiltered, ConstraintFiltered
    per reason, ClassFiltered per computed class)."""
    pn = ct.padded_n
    eligible = ct.ready.copy()

    dc_ok = np.zeros(pn, dtype=bool)
    for dc in job.datacenters:
        cid = ct.dc_vocab.get(dc)
        if cid is not None:
            dc_ok |= ct.dc_ids == cid
    eligible &= dc_ok
    candidates = int(eligible[: ct.num_nodes].sum())

    constraints = job.constraints_for_group(tg)
    # implicit driver constraints: every task's driver must be healthy
    drivers = {t.driver for t in tg.tasks}

    escaped = any(
        "unique." in c.l_target or "unique." in c.r_target for c in constraints
    )
    # volume feasibility is per-node: host volumes are node config and CSI
    # claims are counted cluster state (HostVolumeChecker/CSIVolumeChecker,
    # feasible.go:132-339)
    volumes = getattr(tg, "volumes", None) or {}
    if volumes:
        from ..scheduler.feasible import (  # deferred: circular at init
            FILTER_HOST_VOLUMES,
            check_csi_volumes,
            check_host_volumes,
        )

        escaped = True
    if not constraints and not drivers and not volumes:
        # nothing to check at all — skip the walk entirely. (Rare in real
        # jobs: tasks always carry a driver, which routes through the
        # cheap per-class branch below; this covers synthetic asks.)
        rows = ()
        per_class = False
    elif escaped:
        rows = range(ct.num_nodes)
        per_class = False
    else:
        rows = ct.class_rep
        per_class = True

    ok_rows = np.ones(len(ct.class_rep) if per_class else ct.num_nodes, dtype=bool)
    reason_rows: dict[str, list[int]] = {}
    for j, i in enumerate(rows):
        node = nodes_sorted[i]
        for d in drivers:
            if not node.drivers.get(d, False):
                ok_rows[j] = False
                reason_rows.setdefault(f"missing drivers: {d}", []).append(j)
                break
        if ok_rows[j] and volumes:
            if not check_host_volumes(node, volumes):
                ok_rows[j] = False
                reason_rows.setdefault(FILTER_HOST_VOLUMES, []).append(j)
            else:
                csi_ok, reason = check_csi_volumes(snap, node, volumes)
                if not csi_ok:
                    ok_rows[j] = False
                    reason_rows.setdefault(reason, []).append(j)
        if ok_rows[j]:
            for c in constraints:
                if c.operand in ("distinct_hosts", "distinct_property"):
                    continue  # handled dynamically / via property sets
                if not _check_constraint(node, c):
                    ok_rows[j] = False
                    reason_rows.setdefault(
                        f"{c.l_target} {c.operand} {c.r_target}".strip(), []
                    ).append(j)
                    break
    stats: dict = {"constraint_filtered": {}, "class_filtered": {}}
    if per_class:
        class_ok = ok_rows
        # a filtered class filters all its member nodes (feasible.go:1029)
        class_sizes = np.bincount(
            ct.class_ids[: ct.num_nodes][eligible[: ct.num_nodes]],
            minlength=len(ct.class_rep),
        )
        class_names = {cid: name for name, cid in ct.class_vocab.items()}
        for reason, js in reason_rows.items():
            n = int(sum(class_sizes[j] for j in js))
            if n:
                stats["constraint_filtered"][reason] = n
        for j, ok in enumerate(class_ok):
            if not ok and class_sizes[j]:
                stats["class_filtered"][class_names.get(j, str(j))] = int(
                    class_sizes[j]
                )
        eligible[: ct.num_nodes] &= class_ok[ct.class_ids[: ct.num_nodes]]
    else:
        for reason, js in reason_rows.items():
            n = sum(1 for j in js if eligible[j])
            if n:
                stats["constraint_filtered"][reason] = n
        eligible[: ct.num_nodes] &= ok_rows
    stats["nodes_filtered"] = candidates - int(eligible[: ct.num_nodes].sum())
    return eligible, stats


def _affinity_scores(ct, nodes_sorted, job: Job, tg: TaskGroup) -> tuple[np.ndarray, bool]:
    """Weight-normalized affinity score per node, in [-1, 1]
    (scheduler/rank.go:650-737: Σ w_i·match_i / Σ|w_i|).

    Class-stable affinities (no ``unique.`` target) are evaluated once per
    computed node class and broadcast — O(classes), not O(nodes), the same
    memoization bet the feasibility path makes (feasible.go:1029)."""
    affs = job.affinities_for_group(tg)
    scores = np.zeros(ct.padded_n, dtype=np.float32)
    if not affs:
        return scores, False
    from ..structs import Constraint

    n = ct.num_nodes
    total = float(sum(abs(a.weight) for a in affs)) or 1.0
    for a in affs:
        c = Constraint(l_target=a.l_target, r_target=a.r_target, operand=a.operand)
        if "unique." in c.l_target or "unique." in c.r_target:
            match = np.fromiter(
                (_check_constraint(nodes_sorted[i], c) for i in range(n)),
                dtype=bool,
                count=n,
            )
        else:
            rep_ok = np.fromiter(
                (_check_constraint(nodes_sorted[r], c) for r in ct.class_rep),
                dtype=bool,
                count=len(ct.class_rep),
            )
            match = rep_ok[ct.class_ids[:n]]
        scores[:n] += np.where(match, np.float32(a.weight), np.float32(0.0))
    return scores / total, True


IMPLICIT_SPREAD_TARGET = "*"  # scheduler/spread.go:10


def _combined_counts_vector(pset, vocab):
    """Flatten a PropertySet's combined-use map onto value ids. Values
    used by allocations but carried by no current node (e.g. only on a
    removed node) get *phantom* slots appended past the node vocab so
    even-spread min/max still sees them."""
    combined = pset.combined_use()
    extra = {v: n for v, n in combined.items() if v not in vocab}
    nv = len(vocab) + len(extra)
    counts = np.zeros(max(nv, 1), dtype=np.float32)
    ids = dict(vocab)
    for v, n in combined.items():
        if v in ids:
            counts[ids[v]] = n
        else:
            ids[v] = len(ids)
            counts[ids[v]] = n
    return counts, ids


def _value_blocks(
    ct, job: Job, tg: TaskGroup, snap, plan, total_desired, eligible, filter_stats
):
    """Build the group's stacked spread + distinct_property blocks.

    Spread (scheduler/spread.go:232-257 computeSpreadInfo): per block,
    desired[v] = percent/100 x tg.count for explicit targets; the
    remaining count goes to the implicit ``*`` target when explicit
    targets cover only part of the total; values with neither get -1
    (flat penalty). Block weight is weight/sum(weights) — relative across
    blocks, 1.0 for a single block (spread.go:155-161).

    distinct_property (feasible.go:604-707): job-level constraints count
    allocs of the whole job, task-group-level only this group's; nodes
    missing the property are hard-filtered here (UsedCount errors), and
    the per-value allowed-count cap is enforced dynamically in-kernel.
    """
    from ..scheduler.propertyset import PropertySet
    from .score import (
        BLOCK_DISTINCT_CAP,
        BLOCK_EVEN_SPREAD,
        BLOCK_TARGET_SPREAD,
    )

    spreads = job.spreads_for_group(tg)
    distinct_job = [
        c for c in job.constraints if c.operand == "distinct_property"
    ]
    distinct_tg = [
        c
        for c in list(tg.constraints)
        + [c for t in tg.tasks for c in t.constraints]
        if c.operand == "distinct_property"
    ]
    if not spreads and not distinct_job and not distinct_tg:
        return None

    cols = []
    counts_l = []
    desired_l = []
    caps_l = []
    weights_l = []
    kinds_l = []

    def build_pset(attribute, scope, allowed=0):
        p = PropertySet(
            namespace=job.namespace,
            job_id=job.id,
            attribute=attribute,
            task_group=scope,
            allowed_count=allowed,
        )
        return p.populate(snap, plan) if snap is not None else p

    sum_weights = float(sum(sp.weight for sp in spreads)) or 1.0
    for sp in spreads:
        node_vals, vocab = ct.attr_column(sp.attribute)
        pset = build_pset(sp.attribute, tg.name)
        counts, ids = _combined_counts_vector(pset, vocab)
        nv = counts.shape[0]
        desired = np.full(nv, -1.0, dtype=np.float32)
        if sp.targets:
            explicit_sum = 0.0
            implicit = None
            for t in sp.targets:
                d = t.percent / 100.0 * total_desired
                explicit_sum += d
                if t.value == IMPLICIT_SPREAD_TARGET:
                    implicit = d
                    continue
                vid = ids.get(t.value)
                if vid is not None:
                    desired[vid] = d
            if 0 < explicit_sum < total_desired:
                implicit = total_desired - explicit_sum
            if implicit is not None:
                # untargeted values inherit the implicit target's desired
                # count (spread.go:145-149)
                explicit_vids = {
                    ids[t.value]
                    for t in sp.targets
                    if t.value in ids and t.value != IMPLICIT_SPREAD_TARGET
                }
                for vid in range(nv):
                    if vid not in explicit_vids:
                        desired[vid] = implicit
            kinds_l.append(BLOCK_TARGET_SPREAD)
        else:
            kinds_l.append(BLOCK_EVEN_SPREAD)
        cols.append(node_vals)
        counts_l.append(counts)
        desired_l.append(desired)
        caps_l.append(np.full(nv, np.inf, dtype=np.float32))
        weights_l.append(float(sp.weight) / sum_weights)

    for c, scope in [(c, "") for c in distinct_job] + [
        (c, tg.name) for c in distinct_tg
    ]:
        node_vals, vocab = ct.attr_column(c.l_target)
        try:
            allowed = int(c.r_target) if c.r_target else 1
        except ValueError:
            # unparsable allowed-count: constraint can never pass
            # (propertyset.go:88-95 errorBuilding)
            eligible[:] = False
            filter_stats.setdefault("constraint_filtered", {})[
                f"distinct_property: bad count {c.r_target!r}"
            ] = int(ct.num_nodes)
            continue
        pset = build_pset(c.l_target, scope, allowed)
        counts, ids = _combined_counts_vector(pset, vocab)
        nv = counts.shape[0]
        # nodes missing the property are infeasible (UsedCount error path)
        missing = (node_vals < 0) & eligible
        n_missing = int(missing[: ct.num_nodes].sum())
        if n_missing:
            eligible &= node_vals >= 0
            cf = filter_stats.setdefault("constraint_filtered", {})
            reason = f'missing property "{c.l_target}"'
            cf[reason] = cf.get(reason, 0) + n_missing
            filter_stats["nodes_filtered"] = (
                filter_stats.get("nodes_filtered", 0) + n_missing
            )
        cols.append(node_vals)
        counts_l.append(counts)
        desired_l.append(np.full(nv, -1.0, dtype=np.float32))
        caps_l.append(np.full(nv, float(allowed), dtype=np.float32))
        weights_l.append(0.0)
        kinds_l.append(BLOCK_DISTINCT_CAP)

    nb = len(cols)
    max_v = max(c.shape[0] for c in counts_l)
    value_ids = np.stack(cols)  # [B, N] — all share pn
    counts0 = np.zeros((nb, max_v), dtype=np.float32)
    desired = np.full((nb, max_v), -1.0, dtype=np.float32)
    caps = np.full((nb, max_v), np.inf, dtype=np.float32)
    for b in range(nb):
        nv = counts_l[b].shape[0]
        counts0[b, :nv] = counts_l[b]
        desired[b, :nv] = desired_l[b]
        caps[b, :nv] = caps_l[b]
    return ValueBlocks(
        value_ids=value_ids,
        counts0=counts0,
        desired=desired,
        caps=caps,
        weights=np.array(weights_l, dtype=np.float32),
        kinds=np.array(kinds_l, dtype=np.int32),
    )


def _device_slot_caps(
    ct, nodes_sorted, snap, tg, count, eligible, filter_stats
):
    """Device feasibility → dense per-node slot caps + device affinity.

    Returns (slot_caps f32[N] | None, dev_aff f32[N], has_dev_aff bool).
    Nodes that can't satisfy even one set of the group's device asks are
    filtered hard (DeviceChecker, feasible.go:1173); the cap feeds the
    in-batch accounting in the placement scan.
    """
    from ..scheduler.device import (
        collect_in_use,
        feasible_sets,
        group_device_asks,
        node_device_affinity,
    )

    if not group_device_asks(tg):
        return None, np.zeros(ct.padded_n, dtype=np.float32), False

    slot_caps = np.zeros(ct.padded_n, dtype=np.float32)
    dev_aff = np.zeros(ct.padded_n, dtype=np.float32)
    has_dev_aff = False
    filtered = 0
    for i in range(ct.num_nodes):
        if not eligible[i]:
            continue
        node = nodes_sorted[i]
        in_use = (
            collect_in_use(snap.allocs_by_node(node.id))
            if snap is not None
            else {}
        )
        sets = feasible_sets(node, in_use, tg, count)
        slot_caps[i] = sets
        if sets == 0 and feasible_sets(node, {}, tg, 1) == 0:
            # no matching device *hardware* at all — hard filter
            # (DeviceChecker, feasible.go:1173). Nodes whose devices are
            # merely held by other allocs keep eligible=True with
            # slot_caps=0: the scan can't place there, but the preemption
            # fallback still may (PreemptForDevice's candidate set).
            eligible[i] = False
            filtered += 1
        elif sets > 0:
            s, has = node_device_affinity(node, tg)
            if has:
                dev_aff[i] = s
                has_dev_aff = True
    if filtered:
        cf = filter_stats.setdefault("constraint_filtered", {})
        cf["missing devices"] = cf.get("missing devices", 0) + filtered
        filter_stats["nodes_filtered"] = (
            filter_stats.get("nodes_filtered", 0) + filtered
        )
    return slot_caps, dev_aff, has_dev_aff


def flatten_group_ask(
    ct: ClusterTensors,
    snap,
    job: Job,
    tg: TaskGroup,
    count: int,
    *,
    nodes_sorted=None,
    penalty_node_ids: set[str] | None = None,
    plan=None,
) -> GroupAsk:
    """Flatten one (job, task group, count) placement request. ``plan``
    (when given) feeds proposed/cleared allocations into the spread and
    distinct_property property sets (propertyset.go:163-208)."""
    if nodes_sorted is None:
        # row-ordered node objects from the tensors themselves; falling
        # back to a sort only for hand-built ClusterTensors without them
        nodes_sorted = ct.nodes or (
            sorted(snap.nodes(), key=lambda n: n.id) if snap is not None else []
        )
    ask_res = tg.combined_resources()
    ask = np.array(
        [
            ask_res.cpu,
            ask_res.memory_mb,
            ask_res.disk_mb,
            ask_res.bandwidth_mbits(),
        ],
        dtype=np.float32,
    )

    eligible, filter_stats = _eligibility_for_group(
        ct, nodes_sorted, job, tg, snap
    )

    job_counts = np.zeros(ct.padded_n, dtype=np.int32)
    if snap is not None:
        for a in snap.allocs_by_job(job.namespace, job.id):
            if a.terminal_status():
                continue
            row = ct.node_row.get(a.node_id)
            if row is not None:
                job_counts[row] += 1

    penalty = np.zeros(ct.padded_n, dtype=bool)
    for nid in penalty_node_ids or ():
        row = ct.node_row.get(nid)
        if row is not None:
            penalty[row] = True

    aff, has_aff = _affinity_scores(ct, nodes_sorted, job, tg)
    slot_caps, dev_aff, has_dev_aff = _device_slot_caps(
        ct, nodes_sorted, snap, tg, count, eligible, filter_stats
    )
    if has_dev_aff:
        # matched device affinity folds into the node-affinity component
        # (rank.go:388-434 adds the assignment's affinity sum to the score)
        aff = (aff + dev_aff) / (2.0 if has_aff else 1.0)
        has_aff = True
    blocks = _value_blocks(
        ct, job, tg, snap, plan, tg.count, eligible, filter_stats
    )

    distinct = any(
        c.operand == "distinct_hosts" for c in job.constraints_for_group(tg)
    )
    throughputs, has_tp = job_throughput_vector(ct, job)
    gang_member, gw_rack, gw_pod, gw_ici = gang_terms(job, tg.name)

    return GroupAsk(
        job_id=job.id,
        tg_name=tg.name,
        count=count,
        desired_total=max(tg.count, 1),
        ask=ask,
        eligible=eligible,
        job_counts=job_counts,
        penalty_nodes=penalty,
        affinity_scores=aff,
        has_affinities=has_aff,
        distinct_hosts=distinct,
        blocks=blocks,
        slot_caps=slot_caps,
        filter_stats=filter_stats,
        throughputs=throughputs,
        has_throughputs=has_tp,
        profile=job_profile_key(job),
        priority=job.priority,
        gang_member=gang_member,
        gang_weight_rack=gw_rack,
        gang_weight_pod=gw_pod,
        gang_weight_ici=gw_ici,
    )


def gang_terms(job, tg_name: str) -> tuple[bool, float, float, float]:
    """Resolve one group's gang membership + signed per-level topology
    weights from the job's gang stanza. Non-members (and gang-less jobs)
    get (False, 0.0, 0.0, 0.0) — the zero that keeps every pre-gang
    path untouched."""
    gang = getattr(job, "gang", None) or {}
    groups = gang.get("groups") or []
    if tg_name not in groups:
        return False, 0.0, 0.0, 0.0
    weights = {"rack": 0.0, "pod": 0.0, "ici": 0.0}
    colocate = gang.get("colocate") or {}
    if colocate.get("level") in weights:
        weights[colocate["level"]] = float(colocate.get("weight", 1.0))
    spread = gang.get("spread") or {}
    if spread.get("level") in weights:
        weights[spread["level"]] = -float(spread.get("weight", 1.0))
    return True, weights["rack"], weights["pod"], weights["ici"]
