"""Placement explainability — score provenance from the dense kernels.

The reference answers "why did alloc X land on node Y" with the
per-node iterator chain's AllocMetric/ScoreMetaData trail (structs.go
:10034-10079): every node the stack walked leaves a score row the CLI
renders. Our batched kernels (device/score.py) collapse that walk into
one dense pass and return only the winning rows, so the trail has to be
*reconstructed* from the same component math instead of recorded along
the way.

This module is that reconstruction — the one seam raw score data may
cross on its way to an operator (lint rule NTA014 polices the
scheduler/server side). Three pieces:

- ``PlacementExplanation``: per-group top-k candidate nodes with the
  per-component score breakdown (fit, anti-affinity, reschedule
  penalty, affinity, spread boost, throughput), a feasibility-rejection
  histogram bucketed by structured reason, and the committed placement
  rows.
- ``explain_group``: host-side NumPy mirrors
  of the kernels' component semantics (the same math as
  ``device.score._rescore_pick``, which the conflict-repair walk
  already trusts as the exact oracle). Explanations are *observational*:
  they never feed back into placement, so explain-on and explain-off
  place bit-identically, and no new jitted program exists in either
  mode (zero extra retraces by construction).
- ``finalize_explanations``: post-repair pass that stamps the
  *committed* rows (conflict repair may move placements after the
  kernel returns) and derives per-instance score breakdowns by
  replaying the lane's placements against a usage overlay.

Candidate ranking is computed against the same base usage snapshot the
kernel pass scored against, so on an uncontended pass the top-1
candidate is exactly the node greedy placement committed first — the
provenance property the parity tests pin across seeds and algorithms.
Decorrelated batch passes add per-lane tie-break jitter (~1e-5) the
explanation deliberately omits: the ranking shown is the jitter-free
score, while ``placed_nodes`` always reflects what actually committed.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..structs.alloc import NodeScoreMeta
from ..structs.resources import BINPACK_MAX_SCORE, RESOURCE_DIMS

EXPLAIN_SCHEMA_VERSION = 1
DEFAULT_TOP_K = 5

# structured feasibility-rejection reasons (the histogram keys). A node
# lands in exactly one of ineligible/class-infeasible/distinct-hosts,
# or in one-or-more exhausted:* axis buckets (a node short on cpu AND
# memory counts in both, matching AllocMetric.dimension_exhausted).
REJECT_INELIGIBLE = "ineligible"
REJECT_CLASS_INFEASIBLE = "class-infeasible"
REJECT_DISTINCT_HOSTS = "distinct-hosts"
REJECT_PENALTY = "penalty-excluded"


def _exhausted_key(dim: str) -> str:
    return f"exhausted:{dim}"


@dataclass
class CandidateExplanation:
    """One candidate node's first-instance score breakdown."""

    node_id: str = ""
    node_row: int = -1
    final_score: float = 0.0
    components: dict[str, float] = field(default_factory=dict)
    # committed instances of this group on this node (filled post-repair)
    placed: int = 0


@dataclass
class PlacementExplanation:
    """Why one task group's placements landed where they did.

    Threaded onto ``PlacementResult.explanation`` by the placement
    kernels when explain is on, stamped into ``failed_tg_allocs`` for
    unplaced groups and the flight recorder's explanation ring for
    placed ones (scheduler/generic.py, scheduler/system.py)."""

    schema_version: int = EXPLAIN_SCHEMA_VERSION
    job_id: str = ""
    tg_name: str = ""
    algorithm: str = ""
    policy: str = ""  # hetero policy name when the joint pass scored
    nodes_evaluated: int = 0
    feasible_nodes: int = 0
    top_candidates: list[CandidateExplanation] = field(default_factory=list)
    rejections: dict[str, int] = field(default_factory=dict)
    # committed node ids in placement order (post conflict repair)
    placed_nodes: list[str] = field(default_factory=list)
    # CP solver provenance when the cp-pack joint pass scored
    # (scheduler/cp.py): {"iterations", "gap", "agreement"}. None for
    # every other algorithm — the JSON shape only grows a "cp" block
    # when the solver ran, so existing schema pins are untouched.
    cp: dict | None = None
    # gang provenance when the cp-gang pass scored a gang member
    # (scheduler/cp.py): {"gang_id", "members", "topology_score",
    # "release_rounds"}. None otherwise — same only-grows contract.
    gang: dict | None = None


def _feasibility(capacity, used, a, n: int, throughputs=None):
    """Shared feasibility split: returns (fits bool[n], rejections dict).

    Bucketing mirrors the kernels' gates in order: eligibility, the
    hetero class gate (tp==0 ⇒ the job cannot progress on that class),
    distinct_hosts, then per-resource-axis capacity — a node is counted
    under the FIRST gate that rejects it, except the axis buckets which
    count every short dimension (AllocMetric.dimension_exhausted
    semantics, rank.go:483)."""
    elig = np.asarray(a.eligible[:n], dtype=bool)
    rejections: dict[str, int] = {}
    n_inelig = int(n - elig.sum())
    if n_inelig:
        rejections[REJECT_INELIGIBLE] = n_inelig

    alive = elig.copy()
    if throughputs is not None:
        class_dead = alive & (np.asarray(throughputs[:n]) <= 0.0)
        k = int(class_dead.sum())
        if k:
            rejections[REJECT_CLASS_INFEASIBLE] = k
        alive &= ~class_dead
    if a.distinct_hosts:
        dh_dead = alive & (np.asarray(a.job_counts[:n]) > 0)
        k = int(dh_dead.sum())
        if k:
            rejections[REJECT_DISTINCT_HOSTS] = k
        alive &= ~dh_dead

    prop = used[:n] + a.ask[None, :]
    short = prop > capacity[:n]  # [n, D]
    for d, dim in enumerate(RESOURCE_DIMS):
        k = int((alive & short[:, d]).sum())
        if k:
            rejections[_exhausted_key(dim)] = k
    fits_cap = ~short.any(axis=1)
    if a.slot_caps is not None:
        dev_dead = alive & fits_cap & (np.asarray(a.slot_caps[:n]) < 1)
        k = int(dev_dead.sum())
        if k:
            rejections[_exhausted_key("devices")] = k
        alive &= ~dev_dead
    fits = alive & fits_cap
    # reschedule-penalized nodes are feasible but score -1 on that
    # component; surfaced in the histogram because in practice they are
    # excluded from winning whenever any unpenalized node fits
    if fits.any():
        k = int((fits & np.asarray(a.penalty_nodes[:n], dtype=bool)).sum())
        if k:
            rejections[REJECT_PENALTY] = k
    return fits, rejections


def _final_vector(
    capacity, used, a, n: int, fits, counts, algorithm_spread,
    throughputs=None, desired_total=None, rows=None,
):
    """Vectorized first-instance final score f32[n] (-inf infeasible) —
    the ranking pass. Same formulation as device.score._rescore_pick
    (the host oracle conflict repair already trusts) so the candidate
    order agrees with what greedy placement picks.

    ``rows`` (i64[m], ascending) restricts the pass to a candidate
    subset — the sharded-node-axis path, where pulling full score rows
    back to host would defeat the mesh; the returned vector is then
    length m, aligned with ``rows``, and ``fits`` must already be
    row-aligned."""
    from ..device.score import (
        BLOCK_DISTINCT_CAP,
        _host_block_tables,
    )

    idx = slice(None, n) if rows is None else rows
    m = n if rows is None else len(rows)
    prop = used[idx] + a.ask[None, :]
    free = np.where(
        capacity[idx] > 0,
        (capacity[idx] - prop) / np.maximum(capacity[idx], 1e-9),
        1.0,
    )
    pow_sum = 10.0 ** free[:, 0] + 10.0 ** free[:, 1]
    binpack = np.clip(20.0 - pow_sum, 0.0, BINPACK_MAX_SCORE)
    spread_fit = np.clip(pow_sum - 2.0, 0.0, BINPACK_MAX_SCORE)
    fit = (spread_fit if algorithm_spread else binpack) / BINPACK_MAX_SCORE
    jc = np.asarray(a.job_counts)[idx]
    coll = jc.astype(np.float32)
    dt = a.desired_total if desired_total is None else desired_total
    anti = np.where(jc > 0, -(coll + 1.0) / max(dt, 1.0), 0.0)
    pen = np.asarray(a.penalty_nodes, dtype=bool)[idx]
    resched = np.where(pen, -1.0, 0.0)
    aff = a.affinity_scores[idx] if a.has_affinities else 0.0
    boost = np.zeros(m, dtype=np.float32)
    has_spread_any = False
    if a.blocks is not None and counts is not None:
        tbl_boost, _allow = _host_block_tables(counts, a.blocks)
        for b in range(a.blocks.num_blocks):
            if a.blocks.kinds[b] == BLOCK_DISTINCT_CAP:
                continue
            has_spread_any = True
            vids = a.blocks.value_ids[b][idx]
            safe = np.maximum(vids, 0)
            boost += np.where(vids >= 0, tbl_boost[b][safe], -1.0)
    spread_on = has_spread_any & (boost != 0.0)
    num = fit + anti + resched + aff + np.where(spread_on, boost, 0.0)
    den = (
        1.0
        + (jc > 0)
        + pen
        + (1.0 if a.has_affinities else 0.0)
        + spread_on
    )
    if throughputs is not None:
        tp = np.asarray(throughputs)[idx]
        num = num + tp
        den = den + 1.0
    return np.where(fits, num / den, -np.inf)


def _components_at(
    capacity, used, a, rows, placed_on_rows, counts, algorithm_spread,
    throughputs=None, desired_total=None,
):
    """Per-component breakdown for ``rows`` (same math and component
    join rules as device.score._rescore_pick / component_scores).
    ``placed_on_rows`` is this lane's prior instance count per row (0
    for the first-instance candidate view). Returns a list of
    (components dict, final) aligned with rows."""
    from ..device.score import (
        BLOCK_DISTINCT_CAP,
        _host_block_tables,
    )

    fit_name = "spread-fit" if algorithm_spread else "binpack"
    blocks = a.blocks
    boost_tbl = None
    if blocks is not None and counts is not None:
        boost_tbl, _allow = _host_block_tables(counts, blocks)
    out = []
    for row, mine in zip(rows, placed_on_rows):
        prop = used[row] + a.ask
        free = np.where(
            capacity[row] > 0,
            (capacity[row] - prop) / np.maximum(capacity[row], 1e-9),
            1.0,
        )
        pow_sum = 10.0 ** float(free[0]) + 10.0 ** float(free[1])
        binpack = float(np.clip(20.0 - pow_sum, 0.0, BINPACK_MAX_SCORE))
        spread_fit = float(np.clip(pow_sum - 2.0, 0.0, BINPACK_MAX_SCORE))
        fit = (spread_fit if algorithm_spread else binpack) / BINPACK_MAX_SCORE
        comps = {fit_name: fit}
        num, den = fit, 1.0
        jc = int(a.job_counts[row]) + int(mine)
        if jc > 0:
            dt = a.desired_total if desired_total is None else desired_total
            anti = -(jc + 1.0) / max(dt, 1.0)
            comps["job-anti-affinity"] = anti
            num, den = num + anti, den + 1.0
        if a.penalty_nodes[row]:
            comps["node-reschedule-penalty"] = -1.0
            num, den = num - 1.0, den + 1.0
        if a.has_affinities:
            aff = float(a.affinity_scores[row])
            comps["node-affinity"] = aff
            num, den = num + aff, den + 1.0
        if blocks is not None and boost_tbl is not None:
            boost = 0.0
            spread_any = False
            for b in range(blocks.num_blocks):
                if blocks.kinds[b] == BLOCK_DISTINCT_CAP:
                    continue
                spread_any = True
                v = blocks.value_ids[b, row]
                boost += float(boost_tbl[b][v]) if v >= 0 else -1.0
            if spread_any and boost != 0.0:
                comps["allocation-spread"] = boost
                num, den = num + boost, den + 1.0
        if throughputs is not None:
            tp = float(throughputs[row])
            comps["throughput"] = tp
            num, den = num + tp, den + 1.0
        out.append((comps, num / den))
    return out


def explain_group(
    cluster,
    a,
    used0,
    *,
    algorithm: str = "binpack",
    algorithm_spread: bool = False,
    throughputs=None,
    top_k: int = DEFAULT_TOP_K,
    desired_total=None,
    candidate_rows=None,
) -> PlacementExplanation:
    """Build the candidate/rejection explanation for one group ask
    against the usage snapshot the kernel pass scored with.

    ``throughputs`` is the pre-normalized [0, 1] heterogeneity axis when
    the *scoring* path consumed one (score_group); the base placement
    kernels ignore the axis, so their explanations do too.

    ``candidate_rows`` (ascending node rows) restricts the RANKING pass
    to the columns the kernel's hierarchical top-k already surfaced —
    the node-axis-sharded path, where the per-shard top-k union provably
    contains every global winner, so ranking the union ranks the same
    top candidates without gathering full score rows to host. The
    rejection histogram stays a full host-side pass either way (it reads
    the flattened ask masks, not device score rows)."""
    n = cluster.num_nodes
    capacity = np.asarray(cluster.capacity)
    used = np.asarray(used0)
    fits, rejections = _feasibility(capacity, used, a, n, throughputs)
    ex = PlacementExplanation(
        job_id=a.job_id,
        tg_name=a.tg_name,
        algorithm=algorithm,
        nodes_evaluated=n,
        feasible_nodes=int(fits.sum()),
        rejections=rejections,
    )
    if not fits.any() or a.count <= 0:
        return ex
    counts = a.blocks.counts0 if a.blocks is not None else None
    if candidate_rows is not None:
        rows = np.asarray(candidate_rows, dtype=np.int64)
        rows = np.unique(rows[(rows >= 0) & (rows < n)])
        if rows.size == 0:
            return ex
        finals = _final_vector(
            capacity, used, a, n, fits[rows], counts, algorithm_spread,
            throughputs, desired_total, rows=rows,
        )
        # stable sort over ascending rows: ties keep row order, matching
        # argmax's first-index win (the subset inherits the full
        # ranking's tie-break because rows are ascending)
        pick = np.argsort(-finals, kind="stable")[: max(top_k, 1)]
        pick = pick[finals[pick] > -np.inf]
        order = rows[pick]
        finals_by_row = {int(r): finals[i] for i, r in enumerate(rows)}
        finals = np.full(n, -np.inf, dtype=np.float32)
        for r, f in finals_by_row.items():
            finals[r] = f
    else:
        finals = _final_vector(
            capacity, used, a, n, fits, counts, algorithm_spread,
            throughputs, desired_total,
        )
        # stable sort: ties keep row order, matching argmax's
        # first-index win
        order = np.argsort(-finals, kind="stable")[: max(top_k, 1)]
        order = order[finals[order] > -np.inf]
    breakdown = _components_at(
        capacity, used, a, order, np.zeros(len(order)), counts,
        algorithm_spread, throughputs, desired_total,
    )
    ex.top_candidates = [
        CandidateExplanation(
            node_id=cluster.node_ids[int(r)],
            node_row=int(r),
            final_score=float(f),
            components={k: float(v) for k, v in comps.items()},
        )
        for r, (comps, f) in zip(order, breakdown)
    ]
    return ex


def _instance_components_vec(capacity, used0, a, rows, mine, algorithm_spread):
    """Vectorized per-instance breakdowns for one lane's committed rows —
    the blocks-free fast path of the finalize replay. Instance i on row
    r sees ``used0[r] + mine[i] * ask``, the same state the sequential
    overlay would hold when it scored that instance. Returns
    (components, final) pairs aligned with ``rows``."""
    fit_name = "spread-fit" if algorithm_spread else "binpack"
    rows = np.asarray(rows, dtype=np.int64)
    mine_i = np.asarray(mine, dtype=np.int64)
    cap = capacity[rows]
    prop = used0[rows] + (mine_i + 1).astype(np.float32)[:, None] * a.ask[None, :]
    free = np.where(cap > 0, (cap - prop) / np.maximum(cap, 1e-9), 1.0)
    pow_sum = 10.0 ** free[:, 0] + 10.0 ** free[:, 1]
    binpack = np.clip(20.0 - pow_sum, 0.0, BINPACK_MAX_SCORE)
    spread_fit = np.clip(pow_sum - 2.0, 0.0, BINPACK_MAX_SCORE)
    fit = (spread_fit if algorithm_spread else binpack) / BINPACK_MAX_SCORE
    jc = np.asarray(a.job_counts)[rows] + mine_i
    anti = np.where(jc > 0, -(jc + 1.0) / max(a.desired_total, 1.0), 0.0)
    pen = np.asarray(a.penalty_nodes, dtype=bool)[rows]
    num = fit + anti + np.where(pen, -1.0, 0.0)
    den = 1.0 + (jc > 0) + pen
    aff = None
    if a.has_affinities:
        aff = np.asarray(a.affinity_scores)[rows]
        num = num + aff
        den = den + 1.0
    finals = num / den
    out = []
    for i in range(len(rows)):
        comps = {fit_name: float(fit[i])}
        if jc[i] > 0:
            comps["job-anti-affinity"] = float(anti[i])
        if pen[i]:
            comps["node-reschedule-penalty"] = -1.0
        if aff is not None:
            comps["node-affinity"] = float(aff[i])
        out.append((comps, float(finals[i])))
    return out


def finalize_explanations(cluster, asks, results, used_override=None) -> None:
    """Post-repair pass: stamp committed rows into each lane's
    explanation and derive per-instance score breakdowns by replaying
    the lane's placements against a lane-local usage overlay (the same
    evolution the greedy scan applied). Conflict repair mutates
    ``node_rows`` in place after the kernel returned, so this runs
    AFTER ``repair_batch_conflicts`` — ``placed_nodes`` reflects what
    will actually commit."""
    used0 = np.asarray(
        cluster.used if used_override is None else used_override
    )
    capacity = np.asarray(cluster.capacity)
    for a, res in zip(asks, results):
        ex = getattr(res, "explanation", None)
        if ex is None:
            continue
        hetero = bool(ex.policy)
        rows_list = np.asarray(res.node_rows).tolist()
        placed_on: dict[int, int] = {}
        ex.placed_nodes = []
        if not hetero and a.blocks is None:
            # fast path: no spread counts evolve per placement, so every
            # instance's state is used0 + (prior instances on its row) *
            # ask — computable for the whole lane in one vectorized pass
            placed_idx = [i for i, r in enumerate(rows_list) if r >= 0]
            prows = [rows_list[i] for i in placed_idx]
            mine = []
            for r in prows:
                mine.append(placed_on.get(r, 0))
                placed_on[r] = placed_on.get(r, 0) + 1
            instance_meta = [None] * len(rows_list)
            if prows:
                breakdown = _instance_components_vec(
                    capacity, used0, a, prows, mine,
                    ex.algorithm == "spread",
                )
                for i, r, (comps, final) in zip(
                    placed_idx, prows, breakdown
                ):
                    node_id = cluster.node_ids[r]
                    ex.placed_nodes.append(node_id)
                    instance_meta[i] = NodeScoreMeta(
                        node_id=node_id, scores=comps, norm_score=final
                    )
        else:
            used = used0.copy()
            counts = (
                a.blocks.counts0.copy() if a.blocks is not None else None
            )
            instance_meta = []
            for i, row in enumerate(rows_list):
                if row < 0:
                    instance_meta.append(None)
                    continue
                node_id = cluster.node_ids[row]
                ex.placed_nodes.append(node_id)
                if hetero:
                    comps = {"throughput": float(res.scores[i])}
                    final = float(res.scores[i])
                else:
                    (comps, final), = _components_at(
                        capacity, used, a, [row],
                        [placed_on.get(row, 0)], counts,
                        ex.algorithm == "spread",
                    )
                instance_meta.append(
                    NodeScoreMeta(
                        node_id=node_id,
                        scores={k: float(v) for k, v in comps.items()},
                        norm_score=float(final),
                    )
                )
                used[row] += a.ask
                placed_on[row] = placed_on.get(row, 0) + 1
                if counts is not None:
                    for b in range(a.blocks.num_blocks):
                        v = a.blocks.value_ids[b, row]
                        if v >= 0:
                            counts[b, v] += 1
        # per-instance metas ride as a plain attribute (not a dataclass
        # field) so API encodings of the explanation stay bounded
        ex.instance_meta = instance_meta
        by_row = {c.node_row: c for c in ex.top_candidates}
        for row, k in placed_on.items():
            cand = by_row.get(row)
            if cand is not None:
                cand.placed = k
            else:
                # repair (or a later greedy step) committed a node
                # outside the first-instance top-k: append it so
                # `alloc why` always finds its breakdown
                meta = next(
                    m
                    for m in instance_meta
                    if m is not None and m.node_id == cluster.node_ids[row]
                )
                ex.top_candidates.append(
                    CandidateExplanation(
                        node_id=meta.node_id,
                        node_row=int(row),
                        final_score=meta.norm_score,
                        components=dict(meta.scores),
                        placed=k,
                    )
                )


def candidates_as_score_meta(ex: PlacementExplanation) -> list[NodeScoreMeta]:
    """Top-k candidates as AllocMetric.score_meta rows (the reference's
    ScoreMetaData shape) — stamped onto failed placements so blocked
    evals carry the near-miss table."""
    return [
        NodeScoreMeta(
            node_id=c.node_id,
            scores=dict(c.components),
            norm_score=c.final_score,
        )
        for c in ex.top_candidates
    ]


def explanation_to_dict(ex: PlacementExplanation) -> dict:
    """JSON shape for the API/CLI surfaces (schema pinned by the tier-1
    smoke test)."""
    return {
        "schema_version": ex.schema_version,
        "job_id": ex.job_id,
        "tg_name": ex.tg_name,
        "algorithm": ex.algorithm,
        "policy": ex.policy,
        "nodes_evaluated": ex.nodes_evaluated,
        "feasible_nodes": ex.feasible_nodes,
        "top_candidates": [
            {
                "node_id": c.node_id,
                "rank": i + 1,
                "final_score": c.final_score,
                "components": dict(c.components),
                "placed": c.placed,
            }
            for i, c in enumerate(ex.top_candidates)
        ],
        "rejections": dict(ex.rejections),
        "placed_nodes": list(ex.placed_nodes),
        **({"cp": dict(ex.cp)} if ex.cp is not None else {}),
        **({"gang": dict(ex.gang)} if ex.gang is not None else {}),
    }
