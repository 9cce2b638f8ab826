"""Constraint-programming dispatcher: whole-batch joint placement, on
PyTorch and CUDA.

Ports ``nomad_tpu/scheduler/cp.py``: the ``cp-pack`` and ``cp-gang``
algorithm plugins (scheduler/algorithms.py). One pass takes EVERY
pending group at once, assembles the dense score matrix through the
registry's score seam (``score_groups``: one launch of the port's
score-matrix kernel a pass, the same finals binpack ranks by), and
hands the whole batch to ``device/cp.py``'s auction — congestion prices mediate contention
instead of per-group greedy order:

- per-node capacity across all resource dims is exact by construction
  (one instance per node per round, fit-checked against committed use);
- ``distinct_hosts`` holds against existing allocs AND instances rounded
  earlier in the same pass;
- same-job groups repel each other through an in-batch anti-affinity
  price;
- priority tiers win contested nodes before any score comparison.

What the relaxation does not model — spread/distinct_property value
blocks and device slot caps — delegates the whole batch to the base
binpack kernel (the port's closed-form kernel), and cp-gang fails such
a batch's gang asks outright rather than stripe a gang through it. These
are the reference's semantics, not a fallback to a plain version.

While ``cp_place_kernel``'s circuit breaker is not closed, or every
breaker is forced open, a pass goes to the base closed-form kernel on the
same device (``nomad.cp.fallback_passes``): another hand-written kernel,
as in the reference, never a plain version. The dispatcher reads the
breaker by the name the kernel guard keys it with; the reference reads a
short name its guard never uses, so its breaker cannot open there
(ROADMAP C-R4). Conservation accounting for chaos invariant law 13
(``cp_assignment_conservation``): every group in a CP pass ends exactly
one of placed / deferred / failed, and committed usage never exceeds
capacity (``nomad.cp.*`` counters). Chaos site ``cp.round_perturb``
perturbs the auction's initial prices (``lam0``) for one pass — the
solution may legitimately shift, but law 13 must still hold.

``run_cp_ab`` and ``run_gang_ab`` are the ``bench.py cp`` / ``bench.py
gang`` acceptance harnesses on ``device``. Where the reference holds
each pass against its NumPy oracle (the report's ``oracle_mismatches``),
the port holds it bit for bit against the plain version, the port's
oracle: that check grades the pass and places nothing.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..backend import resolve_device, shard_put
# the kernel wrappers are called through the module, so that a stand-in
# (chip_smoke.py's recorder) sees every call
from ..device import cp as device_cp
from ..device.cp import (
    _steps_bucket,
    release_incomplete_gangs,
    topo_onehot,
    topology_term_host,
)
from ..device.score import capacity_on, used_device
from ..utils.metrics import global_metrics
from .hetero import _outputs_mismatch

#: per-node initial-price perturbation (the reference's chaos action):
#: exact f32 (power-of-two scale, small ints) so a perturbed run is still
#: byte-deterministic.
PERTURB_SCALE = np.float32(0.0625)


def _t(x, dtype, device):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype)).to(device)


@dataclass
class CpBatch:
    """Assembled dense inputs for one joint CP pass (host arrays)."""

    capacity: np.ndarray
    used: np.ndarray
    asks: np.ndarray
    counts: np.ndarray
    eligible: np.ndarray
    scores: np.ndarray
    prio: np.ndarray
    job_counts: np.ndarray
    distinct: np.ndarray
    jobgrp: np.ndarray
    lam0: np.ndarray
    steps: int
    max_c: int

    def tensors(self, device, capacity=None, used=None) -> tuple:
        """The pass's inputs on ``device`` in ``cp_place``'s order, lam0
        last; ``capacity`` and ``used`` may be tensors already there
        (the resident capacity, the ``used_device`` seam's tensor)."""
        return (
            capacity if capacity is not None
            else _t(self.capacity, np.float32, device),
            used if used is not None else _t(self.used, np.float32, device),
            _t(self.asks, np.float32, device),
            _t(self.counts, np.int32, device),
            _t(self.eligible, bool, device),
            _t(self.scores, np.float32, device),
            _t(self.prio, np.float32, device),
            _t(self.job_counts, np.int32, device),
            _t(self.distinct, bool, device),
            _t(self.jobgrp, np.int32, device),
            _t(self.lam0, np.float32, device),
        )


def perturb_prices(pn: int) -> np.ndarray:
    """Deterministic non-uniform initial-price vector (zeros would be a
    no-op: a uniform shift cancels inside every argmax)."""
    return (PERTURB_SCALE * (np.arange(pn) % 8)).astype(np.float32)


def build_cp_batch(cluster, asks: list, used_override=None,
                   lam0=None, device="cuda", mesh=None) -> CpBatch:
    """Score rows come from the registry's score seam on ``device``
    (``score_groups``: every ask of the pass in one score-matrix launch,
    each row what ``score_group`` gives that ask) — the identical finals
    binpack ranks by, so the A/B compares solvers, not scoring functions.
    Scoring runs against the cluster's base usage snapshot; feasibility
    inside the solver is exact against ``used_override`` + committed
    rounds. Under an active ``mesh`` the score matrix runs a launch per
    node slice."""
    from .algorithms import score_groups

    pn = cluster.padded_n
    ask_m = np.stack([a.ask for a in asks]).astype(np.float32)
    counts = np.array([a.count for a in asks], dtype=np.int32)
    finals, fits = score_groups(
        cluster, asks, [float(a.desired_total) for a in asks], device=device,
        mesh=mesh,
    )
    scores = np.where(fits, finals, np.float32(0.0))
    eligible = np.stack([a.eligible for a in asks]) & fits
    prio = np.array(
        [float(getattr(a, "priority", 50)) for a in asks], dtype=np.float32
    )
    job_counts = np.stack([a.job_counts for a in asks]).astype(np.int32)
    distinct = np.array([a.distinct_hosts for a in asks], dtype=bool)
    codes: dict[str, int] = {}
    jobgrp = np.array(
        [codes.setdefault(a.job_id, len(codes)) for a in asks],
        dtype=np.int32,
    )
    used = (
        used_override if used_override is not None else cluster.used
    ).astype(np.float32)
    if lam0 is None:
        lam0 = np.zeros(pn, dtype=np.float32)
    total = int(counts.sum())
    return CpBatch(
        capacity=cluster.capacity.astype(np.float32),
        used=used,
        asks=ask_m,
        counts=counts,
        eligible=eligible,
        scores=scores,
        prio=prio,
        job_counts=job_counts,
        distinct=distinct,
        jobgrp=jobgrp,
        lam0=lam0.astype(np.float32),
        steps=_steps_bucket(total + 1),
        max_c=_steps_bucket(max(int(counts.max(initial=1)), 1)),
    )


def solver_stats(batch: CpBatch, choices: np.ndarray,
                 choice_scores: np.ndarray, rounds: int) -> dict:
    """Host-side solver provenance, computed from the pass's outputs:

    - ``gap``: duality-gap proxy = fractional upper bound (each group's
      count best eligible rows, per-node capacity relaxed) − the rounded
      objective;
    - ``agreement``: fraction of committed slots that landed inside
      their group's fractional-optimum row set (rounding confidence)."""
    masked = np.where(batch.eligible, batch.scores, -np.inf)  # f32[G, N]
    committed = choices >= 0
    achieved = float(choice_scores[committed].astype(np.float64).sum())
    bound = 0.0
    in_opt = 0
    for i, c in enumerate(batch.counts):
        order = np.argsort(-masked[i], kind="stable")[: int(c)]
        top = masked[i, order]
        top = top[np.isfinite(top)]
        bound += float(top.astype(np.float64).sum())
        opt_rows = set(order[: top.size].tolist())
        rows = choices[i][committed[i]]
        in_opt += sum(int(r) in opt_rows for r in rows)
    n_placed = int(committed.sum())
    return {
        "iterations": int(rounds),
        "gap": round(max(bound - achieved, 0.0), 6),
        "agreement": round(in_opt / n_placed, 6) if n_placed else 1.0,
    }


def _conservation(asks, choices, used_out, capacity) -> None:
    """Every group of a pass ends placed, deferred or failed; committed
    usage never exceeds capacity (``nomad.cp.*`` counters)."""
    placed_g = deferred_g = failed_g = 0
    for i, a in enumerate(asks):
        k = int((choices[i, : a.count] >= 0).sum())
        if k >= a.count:
            placed_g += 1
        elif k > 0:
            deferred_g += 1
        else:
            failed_g += 1
    violations = int((used_out > capacity).any(axis=1).sum())
    global_metrics.incr("nomad.cp.groups_in", len(asks))
    global_metrics.incr("nomad.cp.placed_groups", placed_g)
    global_metrics.incr("nomad.cp.deferred_groups", deferred_g)
    global_metrics.incr("nomad.cp.failed_groups", failed_g)
    if violations:
        global_metrics.incr("nomad.cp.capacity_violations", violations)


def _result(a, choices_row, scores_row):
    from ..device.score import PlacementResult

    rows = choices_row[: a.count].astype(np.int32)
    scores = np.where(
        rows >= 0, scores_row[: a.count], np.float32(-np.inf)
    ).astype(np.float32)
    return PlacementResult(node_rows=rows, scores=scores)


class CpPlacementKernel:
    """Drop-in for device/score.py's PlacementKernel behind the
    algorithm registry: one joint CP pass per batch on ``device``;
    blocks/slot-caps batches delegate to greedy binpack."""

    def __init__(self, force_scan: bool = False, mesh=None, device="cuda"):
        from ..device.score import PlacementKernel

        # the base kernel resolves the device (raising without CUDA) and
        # the mesh
        self._base = PlacementKernel("binpack", force_scan, mesh=mesh, device=device)
        self.device = self._base.device
        self.algorithm_spread = False
        self.force_scan = force_scan

    def mesh_cfg(self):
        return self._base.mesh_cfg()

    def _layout(self, cluster):
        """The mesh a pass lays the score matrix and the auction's batch
        out over (one whose node axis divides the padded nodes); or
        None."""
        return self.mesh_cfg() if self._base._n_shards(cluster.padded_n) > 1 else None

    def _inputs(self, cluster, batch: CpBatch, cfg) -> tuple:
        """The auction's inputs in ``cp_place``'s order, lam0 last: on
        ``device``, or under ``cfg`` laid out as the reference lays them
        (its shard_put calls; capacity and usage through the cache's
        per-shard views)."""
        if cfg is None:
            return batch.tensors(
                self.device, capacity_on(cluster, self.device),
                used_device(cluster, batch.used, self.device),
            )
        return (
            capacity_on(cluster, self.device, cfg),
            used_device(cluster, batch.used, self.device, cfg),
            *[shard_put(x, axes, cfg) for x, axes in (
                (batch.asks, ("groups",)), (batch.counts, ("groups",)),
                (batch.eligible, ("groups", "nodes")), (batch.scores, ("groups", "nodes")),
                (batch.prio, ("groups",)), (batch.job_counts, ("groups", "nodes")),
                (batch.distinct, ("groups",)), (batch.jobgrp, ()), (batch.lam0, ()),
            )],
        )

    def _cp_eligible(self, asks: list) -> bool:
        # value blocks (spread / distinct_property) and device slot caps
        # are not modeled by the relaxation
        return not any(
            a.blocks is not None or a.slot_caps is not None for a in asks
        )

    def _fallback_open(self) -> bool:
        from ..resilience.breaker import CLOSED, breaker_for, forced_open

        if forced_open():
            return True
        return breaker_for("cp_place_kernel").state != CLOSED

    def _batch(self, cluster, asks, kwargs) -> CpBatch:
        from ..chaos.plane import chaos_site

        lam0 = None
        if chaos_site("cp.round_perturb") == "perturb":
            lam0 = perturb_prices(cluster.padded_n)
            global_metrics.incr("nomad.cp.chaos_perturbs")
        return build_cp_batch(
            cluster, asks, used_override=kwargs.get("used_override"),
            lam0=lam0, device=self.device, mesh=self._layout(cluster),
        )

    def place(self, cluster, asks: list, **kwargs):
        if not asks:
            return []
        if self._fallback_open():
            global_metrics.incr("nomad.cp.fallback_passes")
            return self._base.place(cluster, asks, **kwargs)
        if not self._cp_eligible(asks):
            return self._base.place(cluster, asks, **kwargs)
        batch = self._batch(cluster, asks, kwargs)
        out = device_cp.cp_place(
            *self._inputs(cluster, batch, self._layout(cluster)),
            steps=batch.steps, max_c=batch.max_c,
        )
        choices, choice_scores, used_out, rounds, _lam = (
            x.cpu().numpy() for x in out
        )
        _conservation(asks, choices, used_out, batch.capacity)
        explain = bool(kwargs.get("explain", False))
        stats = (
            solver_stats(batch, choices, choice_scores, int(rounds))
            if explain
            else None
        )
        results = []
        for i, a in enumerate(asks):
            res = _result(a, choices[i], choice_scores[i])
            if explain:
                from ..obs.explain import explain_cp_group

                res.explanation = explain_cp_group(
                    cluster, a, batch.used,
                    scores_row=batch.scores[i],
                    cp=stats,
                )
            results.append(res)
        return results


# -- gang/topology dispatcher (cp-gang) --------------------------------------


@dataclass
class GangInputs:
    """Gang-axis arrays for one batch, aligned with a CpBatch's rows."""

    gang: np.ndarray  # i32[G] gang ids (0 = not in a gang)
    w_rack: np.ndarray  # f32[G] signed rack weight
    w_pod: np.ndarray  # f32[G] signed pod weight
    w_ici: np.ndarray  # f32[G] signed ici weight
    level_ids: np.ndarray  # i32[3, N] rack / pod / ici ids (0 = none)
    widths: tuple  # (R, P, I) bucket-padded id bounds, the one-hot widths
    job_of: dict  # gang id → job id
    members: dict  # gang id → [tg_name, ...]

    def tensors(self, device) -> tuple:
        """The seven gang inputs of ``cp_gang_place`` (the reference's
        signature: one i32[N, W] one-hot per level, column 0 zeroed) on
        ``device``."""
        return (
            *self._weights(device),
            *(_t(topo_onehot(ids, w), np.int32, device)
              for ids, w in zip(self.level_ids, self.widths)),
        )

    def id_tensors(self, device) -> tuple:
        """The six gang inputs of ``cp_gang_place_ids`` on ``device``."""
        return (*self._weights(device), _t(self.level_ids, np.int32, device),
                self.widths)

    def _weights(self, device) -> tuple:
        return (
            _t(self.gang, np.int32, device),
            _t(self.w_rack, np.float32, device),
            _t(self.w_pod, np.float32, device),
            _t(self.w_ici, np.float32, device),
        )

    def topology_term(self, assigned) -> np.ndarray:
        """f32[G, N] signed topology term of an assignment i32[G, N]."""
        return topology_term_host(
            self.gang, self.w_rack, self.w_pod, self.w_ici,
            self.level_ids, self.widths, assigned,
        )


def build_gang_inputs(cluster, asks: list) -> GangInputs:
    """Gang ids are per job (every gang-member group of one job shares
    an id; 0 = not ganged); topology ids come from the tensors' factored
    per-level columns, their widths bucket-padded."""
    g = len(asks)
    gang = np.zeros(g, dtype=np.int32)
    w_rack = np.zeros(g, dtype=np.float32)
    w_pod = np.zeros(g, dtype=np.float32)
    w_ici = np.zeros(g, dtype=np.float32)
    codes: dict[str, int] = {}
    members: dict[int, list] = {}
    for i, a in enumerate(asks):
        if not getattr(a, "gang_member", False):
            continue
        gid = codes.setdefault(a.job_id, len(codes) + 1)
        gang[i] = gid
        w_rack[i] = np.float32(a.gang_weight_rack)
        w_pod[i] = np.float32(a.gang_weight_pod)
        w_ici[i] = np.float32(getattr(a, "gang_weight_ici", 0.0))
        members.setdefault(gid, []).append(a.tg_name)
    level_ids = np.stack(cluster.topology_columns()).astype(np.int32)
    return GangInputs(
        gang=gang,
        w_rack=w_rack,
        w_pod=w_pod,
        w_ici=w_ici,
        level_ids=level_ids,
        widths=tuple(
            _steps_bucket(max(int(ids.max(initial=0)) + 1, 2)) for ids in level_ids
        ),
        job_of={v: k for k, v in codes.items()},
        members=members,
    )


def _assignment(choices: np.ndarray, n: int) -> np.ndarray:
    """i32[G, N] instances per (group, node) of a pass's choices."""
    assigned = np.zeros((choices.shape[0], n), dtype=np.int32)
    for i in range(choices.shape[0]):
        for node in choices[i][choices[i] >= 0]:
            assigned[i, int(node)] += 1
    return assigned


class CpGangPlacementKernel(CpPlacementKernel):
    """The ``cp-gang`` algorithm plugin: cp-pack plus all-or-nothing
    gangs with topology-priced co/anti-location.

    Batches with no gang members take the parent's path through
    ``cp_place`` — bit-identical to cp-pack by construction. Batches the
    relaxation cannot model (value blocks / slot caps) go to greedy
    binpack for the NON-gang asks only; gang asks fail outright rather
    than stripe a gang through a greedy kernel that cannot hold its
    atomicity (``nomad.cp.gang_fallback_failures``)."""

    def place(self, cluster, asks: list, **kwargs):
        if not asks:
            return []
        gang_idx = [
            i for i, a in enumerate(asks)
            if getattr(a, "gang_member", False)
        ]
        if not gang_idx:
            return super().place(cluster, asks, **kwargs)
        if self._fallback_open() or not self._cp_eligible(asks):
            return self._fallback_failing_gangs(
                cluster, asks, gang_idx, **kwargs
            )
        batch = self._batch(cluster, asks, kwargs)
        gi = build_gang_inputs(cluster, asks)
        cfg = self._layout(cluster)
        common = self._inputs(cluster, batch, cfg)
        gang = gi.id_tensors(self.device)
        if cfg is not None:
            gang = (*gang[:4], shard_put(gi.level_ids, (None, "nodes"), cfg), gi.widths)
        out = device_cp.cp_gang_place_ids(
            *common[:10], *gang, common[10],
            steps=batch.steps, max_c=batch.max_c,
        )
        choices, choice_scores, used_out, rounds, _lam, waits = (
            x.cpu().numpy() for x in out
        )
        rounds = int(rounds)

        # all-or-nothing: reservations of any gang short of its counts
        # release before anything leaves the solver layer
        choices, choice_scores, used_out, released = (
            release_incomplete_gangs(
                choices, choice_scores, used_out,
                batch.asks, batch.counts, gi.gang,
            )
        )
        released_set = set(released)
        global_metrics.incr("nomad.cp.gang_groups_in", len(gang_idx))
        global_metrics.incr(
            "nomad.cp.gang_commits",
            sum(1 for gid in gi.members if gid not in released_set),
        )
        if released:
            global_metrics.incr("nomad.cp.gang_releases", len(released))
        _conservation(asks, choices, used_out, batch.capacity)

        explain = bool(kwargs.get("explain", False))
        stats = topo_final = None
        if explain:
            stats = solver_stats(batch, choices, choice_scores, rounds)
            topo_final = gi.topology_term(
                _assignment(choices, batch.capacity.shape[0])
            )
        results = []
        for i, a in enumerate(asks):
            res = _result(a, choices[i], choice_scores[i])
            if explain:
                from ..obs.explain import explain_cp_gang, explain_cp_group

                gid = int(gi.gang[i])
                rows = res.node_rows
                if gid > 0:
                    res.explanation = explain_cp_gang(
                        cluster, a, batch.used,
                        scores_row=batch.scores[i],
                        cp=stats,
                        gang_info={
                            "gang_id": gi.job_of[gid],
                            "members": list(gi.members[gid]),
                            "topology_score": round(
                                float(
                                    topo_final[i, rows[rows >= 0]]
                                    .astype(np.float64)
                                    .sum()
                                ),
                                6,
                            ),
                            "release_rounds": int(waits[i]),
                        },
                    )
                else:
                    res.explanation = explain_cp_group(
                        cluster, a, batch.used,
                        scores_row=batch.scores[i],
                        cp=stats,
                    )
            results.append(res)
        return results

    def _fallback_failing_gangs(self, cluster, asks, gang_idx, **kwargs):
        """Preserves gang atomicity by failing the gang asks outright:
        the base binpack kernel places the non-gang asks exactly as
        cp-pack would, while every gang member reports zero placements
        (→ blocked eval with per-group rejection detail,
        scheduler/generic.py) instead of a striped fragment the release
        pass could not claw back."""
        from ..device.score import PlacementResult

        global_metrics.incr("nomad.cp.fallback_passes")
        global_metrics.incr(
            "nomad.cp.gang_fallback_failures", len(gang_idx)
        )
        gang_set = set(gang_idx)
        rest = [a for i, a in enumerate(asks) if i not in gang_set]
        rest_results = (
            self._base.place(cluster, rest, **kwargs) if rest else []
        )
        results = []
        it = iter(rest_results)
        for i, a in enumerate(asks):
            if i in gang_set:
                results.append(
                    PlacementResult(
                        node_rows=np.full(a.count, -1, dtype=np.int32),
                        scores=np.full(
                            a.count, -np.inf, dtype=np.float32
                        ),
                    )
                )
            else:
                results.append(next(it))
        return results


# -- seeded A/B harness (bench.py cp) ----------------------------------------


def build_cp_asks(ct, n_jobs: int, count_per_job: int, seed: int = 7):
    """Contended CP workload on the mixed fleet: the hetero profile asks
    scaled up so top-ranked nodes hold only a few instances, every 4th
    job demanding distinct hosts, and three priority tiers."""
    from .hetero import build_mixed_asks

    asks = build_mixed_asks(ct, n_jobs, count_per_job, seed=seed)
    for j, a in enumerate(asks):
        a.ask = (a.ask * np.float32(4.0)).astype(np.float32)
        a.priority = (30, 50, 80)[j % 3]
        if j % 4 == 3:
            a.distinct_hosts = True
    return asks


def _cp_quality(asks, results, scores: np.ndarray) -> dict:
    """Canonical quality block for one algorithm's output: slots placed,
    slots left unplaced (preemption pressure), and the assignment's
    value under ONE shared objective — the dense score matrix both
    solvers rank by."""
    placed = 0
    unplaced = 0
    aggregate = 0.0
    for i, (a, r) in enumerate(zip(asks, results)):
        rows = np.asarray(r.node_rows)
        ok = rows >= 0
        placed += int(ok.sum())
        unplaced += int(a.count - ok.sum())
        aggregate += float(scores[i, rows[ok]].astype(np.float64).sum())
    return {
        "placed": placed,
        "unplaced": unplaced,
        "aggregate_score": round(aggregate, 4),
    }


def run_cp_ab(
    n_nodes: int = 1000,
    n_jobs: int = 12,
    count_per_job: int = 40,
    seed: int = 42,
    device="cuda",
) -> dict:
    """The ``bench.py cp`` A/B block on ``device``: greedy binpack vs
    cp-pack on one seeded contended mixed fleet. Placements are
    deterministic for a seed, so the whole report is byte-reproducible.
    The pass (the kernel on a CUDA device) is held bit for bit against
    the plain version on two seeds, every output compared."""
    from ..device.score import PlacementKernel
    from .hetero import build_mixed_fleet

    dev = resolve_device(device)
    ct = build_mixed_fleet(n_nodes, seed=seed)
    asks = build_cp_asks(ct, n_jobs, count_per_job, seed=seed + 1)

    base = PlacementKernel("binpack", device=dev)
    base_results = base.place(ct, asks)
    kern = CpPlacementKernel(device=dev)
    cp_results = kern.place(ct, asks)

    mismatches = 0
    stats = {}
    for check_seed in (seed, seed + 1):
        ct2 = build_mixed_fleet(n_nodes, seed=check_seed)
        asks2 = build_cp_asks(ct2, n_jobs, count_per_job, seed=check_seed + 1)
        batch = build_cp_batch(ct2, asks2, device=dev)
        args = batch.tensors(dev)
        d = device_cp.cp_place(*args, steps=batch.steps, max_c=batch.max_c)
        o = device_cp.cp_place_plain(*args, batch.steps, batch.max_c)
        mismatches += _outputs_mismatch(d, o)
        if check_seed == seed:
            stats = solver_stats(batch, d[0].cpu().numpy(),
                                 d[1].cpu().numpy(), int(d[3]))

    value_batch = build_cp_batch(ct, asks, device=dev)
    b = _cp_quality(asks, base_results, value_batch.scores)
    c = _cp_quality(asks, cp_results, value_batch.scores)
    score_delta = round(c["aggregate_score"] - b["aggregate_score"], 4)
    preempt_avoided = b["unplaced"] - c["unplaced"]
    report = {
        "config": {
            "nodes": n_nodes,
            "jobs": n_jobs,
            "count_per_job": count_per_job,
            "seed": seed,
            "device_classes": sorted(
                k for k in ct.device_class_vocab if k
            ),
        },
        "binpack": b,
        "cp": {**c, "solver": stats},
        "oracle_mismatches": mismatches,
        "ab": {
            "score_delta": score_delta,
            "preemptions_avoided": preempt_avoided,
            "cp_beats_score": score_delta > 0,
            "cp_avoids_preemptions": preempt_avoided > 0,
        },
    }
    ab = report["ab"]
    report["ok"] = mismatches == 0 and (
        (ab["cp_beats_score"] and preempt_avoided >= 0)
        or (ab["cp_avoids_preemptions"] and score_delta >= 0)
    )
    return report


CP_SCHEMA = (
    "ab.cp_avoids_preemptions",
    "ab.cp_beats_score",
    "ab.preemptions_avoided",
    "ab.score_delta",
    "binpack.aggregate_score",
    "binpack.placed",
    "binpack.unplaced",
    "config.count_per_job",
    "config.device_classes",
    "config.jobs",
    "config.nodes",
    "config.seed",
    "cp.aggregate_score",
    "cp.placed",
    "cp.solver.agreement",
    "cp.solver.gap",
    "cp.solver.iterations",
    "cp.unplaced",
    "ok",
    "oracle_mismatches",
)


def cp_schema_of(report: dict) -> tuple[str, ...]:
    """Sorted dotted key paths of a run_cp_ab report (lists are
    leaves)."""
    paths: list[str] = []

    def walk(prefix: str, obj) -> None:
        if isinstance(obj, dict):
            for k, v in obj.items():
                walk(f"{prefix}.{k}" if prefix else str(k), v)
        else:
            paths.append(prefix)

    walk("", report)
    return tuple(sorted(paths))


# -- seeded gang A/B harness (bench.py gang) ---------------------------------


def build_topo_fleet(
    n_nodes: int, seed: int = 42, racks: int = 8, pods: int = 2
):
    """Seeded homogeneous fleet with rack/pod structure as
    ClusterTensors: racks are contiguous row blocks, pods are contiguous
    rack blocks, ici slices halve each rack, and a seeded 0–30%
    background load scatters binpack's best-scoring nodes ACROSS racks —
    the regime where topology-blind greedy fragments a gang."""
    from ..device.flatten import ClusterTensors, node_bucket

    rng = np.random.default_rng(seed)
    pn = node_bucket(n_nodes)
    capacity = np.zeros((pn, 4), dtype=np.float32)
    capacity[:n_nodes, 0] = 4000
    capacity[:n_nodes, 1] = 8192
    capacity[:n_nodes, 2] = 100 * 1024
    capacity[:n_nodes, 3] = 1000
    used = np.zeros_like(capacity)
    load = rng.uniform(0.0, 0.3, size=(n_nodes, 1)).astype(np.float32)
    used[:n_nodes, :2] = capacity[:n_nodes, :2] * load
    ready = np.zeros(pn, dtype=bool)
    ready[:n_nodes] = True
    rack_of = (np.arange(n_nodes) * racks // max(n_nodes, 1)).astype(
        np.int32
    )
    pod_of = (rack_of * pods // max(racks, 1)).astype(np.int32)
    ici_of = (np.arange(n_nodes) * racks * 2 // max(n_nodes, 1)).astype(
        np.int32
    )
    topo_rack_ids = np.zeros(pn, dtype=np.int32)
    topo_rack_ids[:n_nodes] = rack_of + 1
    topo_pod_ids = np.zeros(pn, dtype=np.int32)
    topo_pod_ids[:n_nodes] = pod_of + 1
    topo_ici_ids = np.zeros(pn, dtype=np.int32)
    topo_ici_ids[:n_nodes] = ici_of + 1
    return ClusterTensors(
        node_ids=[f"node-{i}" for i in range(n_nodes)],
        index=1,
        num_nodes=n_nodes,
        capacity=capacity,
        used=used,
        ready=ready,
        dc_ids=np.zeros(pn, dtype=np.int32),
        class_ids=np.zeros(pn, dtype=np.int32),
        dc_vocab={"dc1": 0},
        class_vocab={"": 0},
        class_rep=[0] if n_nodes else [],
        node_row={f"node-{i}": i for i in range(n_nodes)},
        topo_rack_ids=topo_rack_ids,
        topo_pod_ids=topo_pod_ids,
        topo_ici_ids=topo_ici_ids,
        topo_rack_vocab={"": 0, **{f"r{r:02d}": r + 1 for r in range(racks)}},
        topo_pod_vocab={"": 0, **{f"p{p}": p + 1 for p in range(pods)}},
        topo_ici_vocab={
            "": 0, **{f"i{s:02d}": s + 1 for s in range(racks * 2)}
        },
    )


def build_gang_asks(
    ct, n_jobs: int, groups: int, count_per_group: int = 2, seed: int = 7
):
    """Seeded multi-group gang jobs: even jobs colocate their gang at
    rack level (with the tighter ici slice priced too), odd jobs spread
    it across pods."""
    from ..device.flatten import GroupAsk

    rng = np.random.default_rng(seed)
    pn = ct.padded_n
    asks = []
    for j in range(n_jobs):
        colocate = j % 2 == 0
        cpu = float(rng.choice([1600, 1800, 2000]))
        memv = float(rng.choice([3200, 3600, 4000]))
        for k in range(groups):
            asks.append(
                GroupAsk(
                    job_id=f"gang-job-{j}",
                    tg_name=f"tg{k}",
                    count=count_per_group,
                    desired_total=count_per_group,
                    ask=np.array(
                        [cpu, memv, 300.0, 0.0], dtype=np.float32
                    ),
                    eligible=ct.ready.copy(),
                    job_counts=np.zeros(pn, dtype=np.int32),
                    penalty_nodes=np.zeros(pn, dtype=bool),
                    affinity_scores=np.zeros(pn, dtype=np.float32),
                    has_affinities=False,
                    distinct_hosts=False,
                    gang_member=True,
                    gang_weight_rack=2.0 if colocate else 0.0,
                    gang_weight_pod=0.0 if colocate else -1.0,
                    gang_weight_ici=0.5 if colocate else 0.0,
                )
            )
    return asks


def _gang_quality(ct, asks, results, gi: GangInputs,
                  scores: np.ndarray) -> dict:
    """Canonical gang-quality block for one algorithm's assignment,
    re-valued under ONE shared objective: the dense score matrix plus
    the signed topology terms. A gang is *intact* when every member
    placed its full count all-or-nothing; its topology is *satisfied*
    when a rack-colocate gang landed entirely in one rack and a
    pod-spread gang spans more than one pod."""
    g = len(asks)
    n = ct.padded_n
    assigned = np.zeros((g, n), dtype=np.int32)
    placed = np.zeros(g, dtype=np.int32)
    base_value = 0.0
    for i, (a, r) in enumerate(zip(asks, results)):
        rows = np.asarray(r.node_rows)
        rows = rows[rows >= 0]
        placed[i] = rows.size
        for node in rows:
            assigned[i, int(node)] += 1
        base_value += float(scores[i, rows].astype(np.float64).sum())
    topo_final = gi.topology_term(assigned)
    # each placed instance values the topology term at its node
    topo_value = float(
        (topo_final * (assigned > 0) * assigned).astype(np.float64).sum()
    )
    rack_ids, pod_ids, _ici_ids = ct.topology_columns()
    gangs_intact = 0
    topology_satisfied = 0
    fragmented = 0
    for gid, member_names in sorted(gi.members.items()):
        idx = np.flatnonzero(gi.gang == gid)
        intact = bool(
            np.all(placed[idx] >= np.array([asks[i].count for i in idx]))
        )
        nodes = np.flatnonzero(assigned[idx].sum(axis=0) > 0)
        colocate = bool(np.any(gi.w_rack[idx] > 0))
        if nodes.size == 0:
            topo_ok = False
        elif colocate:
            topo_ok = len(set(rack_ids[nodes].tolist())) == 1
        else:
            topo_ok = len(set(pod_ids[nodes].tolist())) > 1
        gangs_intact += int(intact)
        topology_satisfied += int(intact and topo_ok)
        fragmented += int(not intact or not topo_ok)
    return {
        "placed": int(placed.sum()),
        "unplaced": int(sum(a.count for a in asks) - placed.sum()),
        "gangs_intact": gangs_intact,
        "topology_satisfied": topology_satisfied,
        "gangs_fragmented": fragmented,
        "objective": round(base_value + topo_value, 4),
        "topology_value": round(topo_value, 4),
    }


def run_gang_ab(
    n_nodes: int = 64,
    n_jobs: int = 8,
    groups: int = 3,
    seed: int = 42,
    device="cuda",
) -> dict:
    """The ``bench.py gang`` A/B block on ``device``: topology-blind
    greedy binpack vs cp-gang on one seeded rack/pod fleet of
    multi-group gang jobs, both re-valued under the shared objective; the
    gate demands binpack fragment ≥ 1 gang while cp-gang places every
    gang all-or-nothing with its topology term satisfied and no objective
    regression. The gang pass (the kernel on a CUDA device) is held bit
    for bit against the plain version on two seeds, every output
    compared."""
    from ..device.score import PlacementKernel

    dev = resolve_device(device)
    ct = build_topo_fleet(n_nodes, seed=seed)
    asks = build_gang_asks(ct, n_jobs, groups, seed=seed + 1)

    base = PlacementKernel("binpack", device=dev)
    base_results = base.place(ct, asks)
    kern = CpGangPlacementKernel(device=dev)
    gang_results = kern.place(ct, asks)

    mismatches = 0
    for check_seed in (seed, seed + 1):
        ct2 = build_topo_fleet(n_nodes, seed=check_seed)
        asks2 = build_gang_asks(ct2, n_jobs, groups, seed=check_seed + 1)
        batch = build_cp_batch(ct2, asks2, device=dev)
        common = batch.tensors(dev)
        args = (*common[:10], *build_gang_inputs(ct2, asks2).id_tensors(dev),
                common[10])
        d = device_cp.cp_gang_place_ids(*args, steps=batch.steps, max_c=batch.max_c)
        o = device_cp.cp_gang_place_ids_plain(*args, batch.steps, batch.max_c)
        mismatches += _outputs_mismatch(d, o)

    value_batch = build_cp_batch(ct, asks, device=dev)
    gi = build_gang_inputs(ct, asks)
    b = _gang_quality(ct, asks, base_results, gi, value_batch.scores)
    c = _gang_quality(ct, asks, gang_results, gi, value_batch.scores)
    n_gangs = len(gi.members)
    objective_delta = round(c["objective"] - b["objective"], 4)
    report = {
        "config": {
            "nodes": n_nodes,
            "jobs": n_jobs,
            "groups": groups,
            "gangs": n_gangs,
            "seed": seed,
            "racks": len([k for k in ct.topo_rack_vocab if k]),
            "pods": len([k for k in ct.topo_pod_vocab if k]),
        },
        "binpack": b,
        "cp_gang": c,
        "oracle_mismatches": mismatches,
        "ab": {
            "objective_delta": objective_delta,
            "binpack_fragments": b["gangs_fragmented"],
            "gangs_rescued": c["gangs_intact"] - b["gangs_intact"],
        },
    }
    report["ok"] = (
        mismatches == 0
        and b["gangs_fragmented"] >= 1
        and c["gangs_intact"] == n_gangs
        and c["topology_satisfied"] == n_gangs
        and objective_delta >= 0
    )
    return report

