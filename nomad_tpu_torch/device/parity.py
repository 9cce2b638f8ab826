"""Placement-score parity harness — the BASELINE ≤0.5% clause.

BASELINE.md's acceptance bar is "≤0.5% placement-score regression vs the
Go binpacker" (scheduler/benchmarks/benchmarks_test.go:71-124 shapes,
scored per the AllocMetric breakdown nomad/structs/structs.go:
10034-10079). The component vectors (tests/test_rank_vectors.py etc.) pin
each scoring term in isolation; this module closes the corpus-level gap:
it drives a seeded PLAN STREAM through (a) the device placement kernels
and (b) a reference-faithful host oracle — ``_rescore_pick``, the exact
NumPy implementation of the same component semantics, applied stepwise-
greedily exactly like the reference's iterator chain walks one placement
at a time (scheduler/rank.go:193-527, stack.go:343-438) — and reports
the aggregate normalized-score delta plus per-placement divergence.

The port's copy of ``nomad_tpu/device/parity.py``: the same oracle,
stream and corpus builders, with the placement pass run on ``device``
(default ``"cuda"``, raising without CUDA; the tests pass ``"cpu"``).

The oracle and the kernels intentionally share scoring SEMANTICS but not
mechanism: the kernels place via closed-form top-k / chunked scans over
[N, J] planes (approximating stepwise greedy with a monotone clamp and
frozen-boost chunks), so a nonzero delta here measures exactly the
approximation the ≤0.5% clause bounds.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .score import PlacementKernel, _rescore_pick


@dataclass
class ParityResult:
    config: str
    n_placements: int = 0
    device_total: float = 0.0
    oracle_total: float = 0.0
    node_mismatches: int = 0  # chosen node differs (ties excluded)
    score_mismatches: int = 0  # |device − oracle| > tol at same step
    failed_device: int = 0  # device failed where oracle placed
    failed_oracle: int = 0  # oracle failed where device placed

    @property
    def score_delta_pct(self) -> float:
        """Aggregate regression of device vs oracle total score, in %.
        Positive = device scored WORSE (a regression); negative = device
        scored better than stepwise greedy (possible: greedy is not
        optimal)."""
        if self.oracle_total == 0:
            return 0.0
        return round(
            (self.oracle_total - self.device_total)
            / abs(self.oracle_total)
            * 100.0,
            4,
        )

    def to_dict(self) -> dict:
        return {
            "config": self.config,
            "placements": self.n_placements,
            "device_total_score": round(self.device_total, 3),
            "oracle_total_score": round(self.oracle_total, 3),
            "score_delta_pct": self.score_delta_pct,
            "node_mismatches": self.node_mismatches,
            "score_mismatches": self.score_mismatches,
            "failed_device": self.failed_device,
            "failed_oracle": self.failed_oracle,
        }


def oracle_place(capacity, used, ask, count: int, algorithm_spread=False):
    """Reference-faithful stepwise greedy: one exact argmax per placement
    (the Go iterator chain's semantics), mutating a local overlay.
    Returns (rows i32[count], scores f32[count], used') — used' includes
    the placements."""
    used = used.copy()
    placed = np.zeros(capacity.shape[0], dtype=np.float32)
    counts = ask.blocks.counts0.copy() if ask.blocks is not None else None
    rows = np.full(count, -1, dtype=np.int32)
    scores = np.full(count, -np.inf, dtype=np.float32)
    for i in range(count):
        row, sc = _rescore_pick(
            capacity, used, ask, placed, counts, algorithm_spread
        )
        if row < 0:
            break
        rows[i] = row
        scores[i] = sc
        used[row] += ask.ask
        placed[row] += 1
        if ask.blocks is not None:
            for b in range(ask.blocks.num_blocks):
                v = ask.blocks.value_ids[b, row]
                if v >= 0:
                    counts[b, v] += 1
    return rows, scores, used


def run_parity_stream(
    cluster,
    asks: list,
    config_name: str,
    algorithm: str = "binpack",
    tol: float = 1e-3,
    device="cuda",
) -> ParityResult:
    """Drive one seeded ask stream through the device kernels and the
    host oracle SEQUENTIALLY (each eval's placements are committed into
    the shared usage before the next eval, both sides in the same order —
    the corpus drifts identically, so per-step comparisons stay
    meaningful)."""
    kernel = PlacementKernel(algorithm, device=device)
    res = ParityResult(config=config_name)
    capacity = np.asarray(cluster.capacity)
    used_dev = np.asarray(cluster.used).copy()
    used_ora = np.asarray(cluster.used).copy()
    spread = algorithm == "spread"
    for a in asks:
        [r] = kernel.place(cluster, [a], used_override=used_dev)
        o_rows, o_scores, used_ora = oracle_place(
            capacity, used_ora, a, a.count, algorithm_spread=spread
        )
        d_rows = r.node_rows
        d_scores = r.scores
        for i in range(a.count):
            d_ok = i < d_rows.shape[0] and d_rows[i] >= 0
            o_ok = o_rows[i] >= 0
            if d_ok and o_ok:
                res.n_placements += 1
                res.device_total += float(d_scores[i])
                res.oracle_total += float(o_scores[i])
                if abs(float(d_scores[i]) - float(o_scores[i])) > tol:
                    res.score_mismatches += 1
                    if d_rows[i] != o_rows[i]:
                        res.node_mismatches += 1
            elif o_ok and not d_ok:
                res.failed_device += 1
                res.oracle_total += float(o_scores[i])
                res.n_placements += 1
            elif d_ok and not o_ok:
                res.failed_oracle += 1
            # commit device placements into the device stream's usage
            if d_ok:
                used_dev[d_rows[i]] += a.ask
    return res


# -- seeded corpus builders (BASELINE graded-config shapes) ------------------


def _cluster(n_nodes: int, seed: int, load: float = 0.35):
    """Synthetic heterogeneous cluster, same recipe as bench.build_cluster
    (4/8/16-core classes, 0..load pre-existing usage)."""
    from .flatten import ClusterTensors, node_bucket

    rng = np.random.default_rng(seed)
    pn = node_bucket(n_nodes)
    classes = rng.integers(0, 3, size=n_nodes)
    cpu = np.choose(classes, [4000, 8000, 16000]).astype(np.float32)
    mem = np.choose(classes, [8192, 16384, 32768]).astype(np.float32)
    capacity = np.zeros((pn, 4), dtype=np.float32)
    capacity[:n_nodes, 0] = cpu
    capacity[:n_nodes, 1] = mem
    capacity[:n_nodes, 2] = 100 * 1024
    capacity[:n_nodes, 3] = 1000
    used = np.zeros_like(capacity)
    lf = rng.uniform(0.0, load, size=(n_nodes, 1)).astype(np.float32)
    used[:n_nodes, :2] = capacity[:n_nodes, :2] * lf
    ready = np.zeros(pn, dtype=bool)
    ready[:n_nodes] = True
    return ClusterTensors(
        node_ids=[f"node-{i}" for i in range(n_nodes)],
        index=1,
        num_nodes=n_nodes,
        capacity=capacity,
        used=used,
        ready=ready,
        dc_ids=np.pad(rng.integers(0, 3, n_nodes).astype(np.int32), (0, pn - n_nodes)),
        class_ids=np.pad(classes.astype(np.int32), (0, pn - n_nodes)),
        dc_vocab={"dc1": 0, "dc2": 1, "dc3": 2},
        class_vocab={"small": 0, "medium": 1, "large": 2},
        class_rep=[0, 1, 2],
        node_row={f"node-{i}": i for i in range(n_nodes)},
    )


def _ask(ct, job: str, count: int, cpu: float, mem: float, **kw):
    from .flatten import GroupAsk

    pn = ct.padded_n
    return GroupAsk(
        job_id=job,
        tg_name="web",
        count=count,
        desired_total=count,
        ask=np.array([cpu, mem, 300.0, 0.0], dtype=np.float32),
        eligible=ct.ready.copy(),
        job_counts=np.zeros(pn, dtype=np.int32),
        penalty_nodes=np.zeros(pn, dtype=bool),
        affinity_scores=np.zeros(pn, dtype=np.float32),
        has_affinities=False,
        distinct_hosts=False,
        **kw,
    )


def build_config2(n_nodes=1000, n_jobs=20, count=250, seed=11):
    """BASELINE config 2: homogeneous service binpack (cpu+mem only)."""
    ct = _cluster(n_nodes, seed)
    rng = np.random.default_rng(seed + 1)
    asks = [
        _ask(
            ct,
            f"c2-{j}",
            count,
            float(rng.choice([250, 500, 1000])),
            float(rng.choice([256, 512, 1024])),
        )
        for j in range(n_jobs)
    ]
    return ct, asks


def build_config3(n_nodes=5000, n_jobs=10, count=250, racks=25, seed=13):
    """BASELINE config 3 shape: spread + affinity scoring."""
    from .flatten import ValueBlocks
    from .score import BLOCK_EVEN_SPREAD

    ct = _cluster(n_nodes, seed)
    pn = ct.padded_n
    rng = np.random.default_rng(seed + 1)
    rack_ids = np.pad(
        (np.arange(n_nodes) % racks).astype(np.int32),
        (0, pn - n_nodes),
        constant_values=-1,
    )
    asks = []
    for j in range(n_jobs):
        a = _ask(
            ct,
            f"c3-{j}",
            count,
            float(rng.choice([250, 500])),
            float(rng.choice([256, 512])),
        )
        a.blocks = ValueBlocks(
            value_ids=rack_ids[None, :],
            counts0=np.zeros((1, racks), dtype=np.float32),
            desired=np.full((1, racks), -1.0, dtype=np.float32),
            caps=np.full((1, racks), np.inf, dtype=np.float32),
            weights=np.ones(1, dtype=np.float32),
            kinds=np.array([BLOCK_EVEN_SPREAD], dtype=np.int32),
        )
        # ssd affinity on every 4th node (the config-3 bench shape)
        a.has_affinities = True
        a.affinity_scores = np.where(
            np.arange(pn) % 4 == 0, 0.5, -0.5
        ).astype(np.float32) * ct.ready
        asks.append(a)
    return ct, asks


def build_config4(n_nodes=5000, n_jobs=10, count=200, seed=17):
    """BASELINE config 4 shape: anti-affinity pressure (existing job
    allocs on some nodes) + distinct_property caps + target spread."""
    from .flatten import ValueBlocks
    from .score import BLOCK_DISTINCT_CAP, BLOCK_TARGET_SPREAD

    ct = _cluster(n_nodes, seed)
    pn = ct.padded_n
    rng = np.random.default_rng(seed + 1)
    dcs = 3
    dc_ids = np.pad(
        (np.arange(n_nodes) % dcs).astype(np.int32),
        (0, pn - n_nodes),
        constant_values=-1,
    )
    asks = []
    for j in range(n_jobs):
        a = _ask(
            ct,
            f"c4-{j}",
            count,
            float(rng.choice([500, 1000])),
            float(rng.choice([512, 1024])),
        )
        # anti-affinity: pretend 1/8 of nodes already run an alloc of
        # this job (rank.go:536-604 JobAntiAffinity)
        a.job_counts = (
            (rng.random(pn) < 0.125) & ct.ready
        ).astype(np.int32)
        # reschedule penalty on a few nodes (rank.go:606-648)
        a.penalty_nodes = (rng.random(pn) < 0.02) & ct.ready
        # dc target spread 50/30/20 + per-dc distinct cap
        weights = np.array([0.7, 0.3], dtype=np.float32)
        desired = np.stack(
            [
                np.array(
                    [count * 0.5, count * 0.3, count * 0.2], dtype=np.float32
                ),
                np.full(dcs, -1.0, dtype=np.float32),
            ]
        )
        caps = np.stack(
            [
                np.full(dcs, np.inf, dtype=np.float32),
                np.full(dcs, count * 0.6, dtype=np.float32),
            ]
        )
        a.blocks = ValueBlocks(
            value_ids=np.stack([dc_ids, dc_ids]),
            counts0=np.zeros((2, dcs), dtype=np.float32),
            desired=desired,
            caps=caps,
            weights=weights,
            kinds=np.array(
                [BLOCK_TARGET_SPREAD, BLOCK_DISTINCT_CAP], dtype=np.int32
            ),
        )
        asks.append(a)
    return ct, asks


def run_parity_suite(small: bool = False, device="cuda") -> dict:
    """The published corpus: one ParityResult per graded config. ``small``
    shrinks shapes for CI."""
    shrink = 5 if small else 1
    c2 = build_config2(
        n_nodes=1000 // shrink, n_jobs=max(20 // shrink, 3),
        count=max(250 // shrink, 40),
    )
    c3 = build_config3(
        n_nodes=5000 // shrink, n_jobs=max(10 // shrink, 2),
        count=max(250 // shrink, 40),
    )
    c4 = build_config4(
        n_nodes=5000 // shrink, n_jobs=max(10 // shrink, 2),
        count=max(200 // shrink, 40),
    )
    out = {}
    for name, (ct, asks) in (
        ("config2_binpack", c2),
        ("config3_spread_affinity", c3),
        ("config4_antiaffinity_caps", c4),
    ):
        out[name] = run_parity_stream(ct, asks, name, device=device).to_dict()
    return out
