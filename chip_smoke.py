"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's kernels from the sources in this checkout, holds each
against its plain PyTorch version on the card at the shapes the main
paths give it, then schedules service, spread and distinct_property jobs
end to end through the port's ``Harness(device="cuda")`` and checks what
lands in the state store. It imports nothing of JAX and nothing of the
JAX package.

Phases (none is wrapped in a ``try``; any failure exits non-zero):

1. the card's name and power limit; build the CUDA libraries (one nvcc
   per ``csrc/*.cu``, started together) and JIT the Triton kernel;
2. ``place_closed_form`` (CUDA) against ``place_closed_form_plain`` at
   the headline shape — 10,000 nodes (padded to 16,384), 100 service
   groups x 1,000 allocs, binpack (the JAX package's ``bench.py kernel``
   shape) — and on a smaller case with every score component live;
3. ``score_matrix`` (Triton) against ``component_scores`` at
   [128, 16,384], without and with the throughput term;
4. a small end-to-end run on the card against the same run on the CPU,
   service jobs and one each of even-spread, target-spread and
   distinct_property jobs;
5. the paths of the slice, each with the launch counters zeroed just
   before it and read just after it:
   - "schedule": 10,000 mock nodes, 10 service jobs x 1,000 allocs at
     500 MHz / 256 MiB, each eval processed by the port's Harness on
     the card (one closed-form launch per placement pass, no score
     matrix);
   - "score_group": each job's group annotated against the committed
     state through the registry's ``score_group`` seam (one score-matrix
     launch per job, no closed form);
   - "spread": the JAX package's ``bench.py end_to_end`` node recipe
     (10,000 nodes over 25 racks, ssd on every 4th, every 3rd at
     8,000 MHz / 16,384 MiB) and 30 jobs through the Harness: its 20
     even rack spread + ssd affinity jobs x 250 (one-per-value kernel),
     5 target rack spread jobs x 250 (chunked kernel), 5
     distinct_property jobs x 200 capped at 10 per rack (value-scan
     kernel); the cut from bench.py's 100 jobs to 30 is for time;
   - "wide_values": on the spread path's cluster, one job per coupled
     route keyed on ``${node.unique.id}`` (V 16,384), whose working
     state does not fit in shared memory and runs from global scratch;
   every kernel call of each path is recorded, and after the counters
   are read each recorded call is replayed through the kernel and its
   plain version (choices and scores compared); every coupled call's
   kernel is timed, and the last call of each kernel in full;
6. the port's parity suite (``device/parity.py``) at full size on the
   card: each coupled config's placements against the stepwise host
   oracle, within the reference's 0.5 % score bar;
7. one JSON line of per-kernel results, then the device line last.

Times, kernels and plain versions alike, are device times per launch
from a CUDA-graph replay of 20 launches (3 for the coupled plain
versions, each thousands of small kernels), so no host launch cost sits
in either; "stream_ms" and "plain_stream_ms" are the same launched back
to back from Python. A coupled kernel's "bound_ms" counts the steps this
run's data made it take ("steps_per_launch").

Tolerances: the kernels and their plain versions run the same IEEE
float32 operations in the same order (no FMA contraction, IEEE
division, the same libdevice ``expf``), so choices and fits must be
identical and scores agree within ``MAX_ABS_ERR`` (the coupled kernels:
exactly). The parity suite holds the coupled placements to the
reference's own bar against its oracle, ``|score_delta_pct| <= 0.5``
and no placement the oracle made and the card did not.
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import json
import subprocess
import sys
import time

import numpy as np
import torch

MAX_ABS_ERR = 1e-6
TIMED_LAUNCHES = 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores (same sheet)
# f32 operations per feasible (g, n, j) candidate of the closed-form
# plane: (j+1), then per cpu/mem dim mul+add (proposed), sub, max, div
# (free fraction), mul (ln 10), exp, add (pow sum) = 16; binpack clip 3,
# fit div 1, collision add+compare 2, anti add+neg+max+div 4, numerator
# adds 3, denominator adds 3, final div 1, running min 1, order key 2
CLOSED_FORM_OPS_PER_CANDIDATE = 37
# f32 operations per (g, n) of the score matrix: 4 adds + 4 compares
# (fit test), per cpu/mem dim sub, max, div, mul, exp (10), pow sum add,
# clip 3, fit div 1, anti add+neg+max+div 4, component adds 3 and count
# adds 3, final div 1
SCORE_MATRIX_OPS_PER_CELL = 33
# f32 operations of one node's score in a coupled step, per value block
# (table lookup, select, boost add) and per node (fit and cap tests,
# boost-on test, numerator and denominator adds, division, argmax
# compare): 3 per block + 8
COUPLED_OPS_PER_BLOCK = 3
COUPLED_OPS_PER_NODE = 8
# f32 operations per (block, value) table entry and step (count add,
# min/max, target or even boost: sub, add, max, div, mul)
COUPLED_OPS_PER_TABLE_ENTRY = 8
PARITY_BAR_PCT = 0.5
SPREAD_NODES = 10_000
SPREAD_RACKS = 25
DISTINCT_CAP = 10


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = TIMED_LAUNCHES, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back launches,
    after a warm-up, measured with CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = TIMED_LAUNCHES) -> float:
    """Mean device time of one ``fn`` launch: ``iters`` launches captured
    in a CUDA graph and replayed, so no host launch overhead sits between
    them (a kernel shorter than its Python wrapper would otherwise be
    timed at the host's launch rate)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


# -- the headline inputs (the port's copy of bench.py's builders) -----------


def build_cluster(n_nodes: int, seed: int = 42):
    """Synthetic heterogeneous cluster (4/8/16-core classes, 0-40% load)."""
    from nomad_tpu_torch.device.flatten import ClusterTensors, node_bucket

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
    load = rng.uniform(0.0, 0.4, size=(n_nodes, 1)).astype(np.float32)
    used[:n_nodes, :2] = capacity[:n_nodes, :2] * load
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


def build_asks(ct, n_jobs: int, count_per_job: int, seed: int = 7):
    from nomad_tpu_torch.device.flatten import GroupAsk

    rng = np.random.default_rng(seed)
    pn = ct.padded_n
    asks = []
    for j in range(n_jobs):
        cpu = float(rng.choice([250, 500, 1000]))
        mem = float(rng.choice([256, 512, 1024]))
        asks.append(
            GroupAsk(
                job_id=f"job-{j}",
                tg_name="web",
                count=count_per_job,
                desired_total=count_per_job,
                ask=np.array([cpu, mem, 300.0, 0.0], dtype=np.float32),
                eligible=ct.ready.copy(),
                job_counts=np.zeros(pn, dtype=np.int32),
                penalty_nodes=np.zeros(pn, dtype=bool),
                affinity_scores=np.zeros(pn, dtype=np.float32),
                has_affinities=False,
                distinct_hosts=False,
            )
        )
    return asks


def device_batch(ct, asks, dev):
    """The kernel inputs exactly as PlacementKernel assembles them."""
    from nomad_tpu_torch.device import score as S

    kern = S.PlacementKernel(device=dev)
    max_j = kern._max_j(ct, asks)
    k = S._steps_bucket(max(a.count for a in asks) + S.OVERFLOW_CANDIDATES)
    lanes = S._pad_group_axis(list(asks), ct.padded_n)
    b = S._device_batch(S._shared_batch(lanes, ct.padded_n), dev)
    b["capacity"] = torch.from_numpy(ct.capacity).to(dev)
    b["used0"] = torch.from_numpy(ct.used).to(dev)
    return b, max_j, k


def closed_form_args(b):
    order = (
        "capacity", "used0", "asks", "eligible", "job_counts",
        "desired_totals", "penalty_nodes", "affinity_scores",
        "has_affinities", "distinct_hosts", "slot_caps",
    )
    return [b[key] for key in order]


# -- phase 2 -----------------------------------------------------------------


def check_closed_form(name, args, spread, max_j, k, jitter, timed):
    from nomad_tpu_torch.device import score as S

    ch, sc = S.place_closed_form(*args, spread, max_j, k, jitter)
    chp, scp = S.place_closed_form_plain(*args, spread, max_j, k, jitter)
    torch.cuda.synchronize()
    mismatches = int((ch != chp).sum())
    fin = torch.isfinite(scp)
    inf_agree = bool(torch.equal(torch.isfinite(sc), fin))
    err = float((sc - scp).abs()[fin].max()) if bool(fin.any()) else 0.0
    picked = ch[ch >= 0]
    assert picked.numel() > 0, f"closed_form {name}: nothing placed"
    out = {
        "max_abs_err": err,
        "choice_mismatches": mismatches,
        "lowest_row": int(picked.min()),
        "nodes_picked": int(torch.unique(picked).numel()),
    }
    log(
        f"[closed_form:{name}] G={args[2].shape[0]} N={args[0].shape[0]} "
        f"J={max_j} k={k} placed_slots={picked.numel()} on "
        f"{out['nodes_picked']} nodes from row {out['lowest_row']} "
        f"choice_mismatches={mismatches} max_abs_err={err!r} inf_agree={inf_agree}"
    )
    assert mismatches == 0, f"closed_form {name}: choices differ from plain"
    assert inf_agree, f"closed_form {name}: infeasible slots differ"
    assert err <= MAX_ABS_ERR, f"closed_form {name}: |err| {err} > {MAX_ABS_ERR}"
    if timed:
        launch = lambda: S.place_closed_form(*args, spread, max_j, k, jitter)  # noqa: E731
        plain = lambda: S.place_closed_form_plain(*args, spread, max_j, k, jitter)  # noqa: E731
        out["ms"] = graph_ms(launch)
        out["stream_ms"] = cuda_ms(launch)
        out["plain_ms"] = graph_ms(plain)
        out["plain_stream_ms"] = cuda_ms(plain)
        # the work this run's data needs: feasible candidates of the plane
        num, den, fits = S._score_planes(
            *args[:11], spread, max_j, jitter=jitter
        )
        feasible = int(fits.sum())
        del num, den, fits
        g, n = args[3].shape
        in_bytes = nbytes(*args, jitter)
        out_bytes = g * k * 8
        t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
        t_ops = feasible * CLOSED_FORM_OPS_PER_CANDIDATE / F32_OPS_PER_S * 1e3
        out["bound_ms"] = max(t_bytes, t_ops)
        out["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        out["feasible_candidates"] = feasible
        out["plane_candidates"] = g * n * max_j
        log(
            f"[closed_form:{name}] kernel_ms={out['ms']!r} plain_ms="
            f"{out['plain_ms']!r} (graph replay; back to back on the stream "
            f"{out['stream_ms']!r} and {out['plain_stream_ms']!r}) bound_ms="
            f"{out['bound_ms']!r} ({out['bound_by']}; {feasible} feasible of "
            f"{g * n * max_j} candidates)"
        )
    return out


def extras_case(dev):
    """A smaller case with every closed-form component non-trivial."""
    ct = build_cluster(2000, seed=3)
    asks = build_asks(ct, 12, 60, seed=5)
    rng = np.random.default_rng(11)
    pn = ct.padded_n
    for i, a in enumerate(asks):
        a.job_counts = (
            (rng.random(pn) < 0.2) * rng.integers(1, 3, pn)
        ).astype(np.int32) * ct.ready
        a.penalty_nodes = (rng.random(pn) < 0.05) & ct.ready
        a.has_affinities = True
        a.affinity_scores = (
            rng.choice([-0.5, 0.0, 0.5], pn).astype(np.float32) * ct.ready
        )
        a.slot_caps = np.where(
            rng.random(pn) < 0.3, rng.integers(0, 4, pn), np.inf
        ).astype(np.float32)
        a.distinct_hosts = i % 4 == 0
    b, max_j, k = device_batch(ct, asks, dev)
    rows = np.arange(pn, dtype=np.int64)
    h = (rows * 2654435761 + 40503) & 0xFFFFFFFF
    jitter = torch.from_numpy(
        ((h % 65536).astype(np.float32) / 65536.0) * 2e-5
    ).to(dev)
    return closed_form_args(b), max_j, k, jitter


# -- phase 3 -----------------------------------------------------------------


def check_score_matrix(name, args, spread, tp, timed):
    from nomad_tpu_torch.device import score as S

    f, fits = S.score_matrix(*args, spread, tp)
    fp, fitsp = S.component_scores(*args, spread, tp)
    torch.cuda.synchronize()
    fits_mismatch = int((fits != fitsp).sum())
    fin = torch.isfinite(fp)
    inf_agree = bool(torch.equal(torch.isfinite(f), fin))
    err = float((f - fp).abs()[fin].max()) if bool(fin.any()) else 0.0
    log(
        f"[score_matrix:{name}] G={args[2].shape[0]} N={args[0].shape[0]} "
        f"feasible={int(fitsp.sum())} fits_mismatches={fits_mismatch} "
        f"max_abs_err={err!r} inf_agree={inf_agree}"
    )
    assert fits_mismatch == 0 and inf_agree, f"score_matrix {name}: fits differ"
    assert err <= MAX_ABS_ERR, f"score_matrix {name}: |err| {err} > {MAX_ABS_ERR}"
    out = {"max_abs_err": err, "choice_mismatches": fits_mismatch}
    if timed:
        launch = lambda: S.score_matrix(*args, spread, tp)  # noqa: E731
        plain = lambda: S.component_scores(*args, spread, tp)  # noqa: E731
        out["ms"] = graph_ms(launch)
        out["stream_ms"] = cuda_ms(launch)
        out["plain_ms"] = graph_ms(plain)
        out["plain_stream_ms"] = cuda_ms(plain)
        g, n = args[3].shape
        t_bytes = (nbytes(*args, tp) + g * n * 5) / HBM_BYTES_PER_S * 1e3
        t_ops = g * n * SCORE_MATRIX_OPS_PER_CELL / F32_OPS_PER_S * 1e3
        out["bound_ms"] = max(t_bytes, t_ops)
        out["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        log(
            f"[score_matrix:{name}] kernel_ms={out['ms']!r} plain_ms="
            f"{out['plain_ms']!r} (graph replay; back to back on the stream "
            f"{out['stream_ms']!r} and {out['plain_stream_ms']!r}) bound_ms="
            f"{out['bound_ms']!r} ({out['bound_by']})"
        )
    return out


def score_matrix_inputs(b, dev):
    rng = np.random.default_rng(13)
    g, n = b["eligible"].shape
    jc = torch.from_numpy(
        ((rng.random((g, n)) < 0.2) * rng.integers(1, 3, (g, n))).astype(np.int32)
    ).to(dev)
    pen = torch.from_numpy(rng.random((g, n)) < 0.05).to(dev)
    aff = torch.from_numpy(
        rng.choice([-0.5, 0.0, 0.5], (g, n)).astype(np.float32)
    ).to(dev)
    haff = torch.from_numpy(rng.random(g) < 0.5).to(dev)
    dh = torch.from_numpy(rng.random(g) < 0.25).to(dev)
    tp = torch.from_numpy(
        rng.choice([0.0, 0.25, 0.5, 1.0], (g, n)).astype(np.float32)
    ).to(dev)
    args = [
        b["capacity"], b["used0"], b["asks"], b["eligible"], jc,
        b["desired_totals"], pen, aff, haff, dh,
    ]
    return args, tp


# -- phases 4 and 5 -----------------------------------------------------------


def committed_overcommit(store) -> int:
    """Nodes whose committed (non-terminal) usage exceeds capacity."""
    from nomad_tpu_torch.structs.resources import node_comparable_capacity

    bad = 0
    for node in store.nodes():
        cap = node_comparable_capacity(node).to_vector()
        used = np.zeros_like(cap)
        for a in store.allocs_by_node(node.id):
            if not a.terminal_status():
                used += a.comparable_resources().to_vector()
        bad += int(np.any(used > cap))
    return bad


def cross_device_check(dev):
    """The same small scheduling run on the card and on the CPU must
    place the same nodes with the same scores: service jobs, then an
    even rack spread, a target rack spread and a distinct_property job
    (each coupled kernel once)."""
    from nomad_tpu_torch import interop, mock
    from nomad_tpu_torch.scheduler import Harness
    from nomad_tpu_torch.structs import Constraint, Spread, SpreadTarget

    nodes = []
    for i in range(300):
        n = mock.node()
        n.attributes["platform.rack"] = f"r{i % 10}"
        n.compute_class()
        nodes.append(n)
    rack = "${attr.platform.rack}"
    jobs = []
    for count, spreads, constraints in (
        (150, [], []),
        (90, [], []),
        (400, [], []),
        (80, [Spread(attribute=rack, weight=50)], []),
        (60, [Spread(attribute=rack, weight=50, targets=[
            SpreadTarget(value=f"r{r}", percent=30) for r in range(3)
        ])], []),
        (40, [], [Constraint(l_target=rack, r_target="5", operand="distinct_property")]),
    ):
        j = mock.job()
        j.task_groups[0].count = count
        j.spreads = spreads
        j.task_groups[0].constraints.extend(constraints)
        jobs.append(j)
    recs = (
        [dataclasses.asdict(n) for n in nodes],
        [dataclasses.asdict(j) for j in jobs],
        [],
    )
    views = []
    for device in (dev, "cpu"):
        h = Harness(interop.store_from_records(*recs), device=device)
        for j in jobs:
            ev = mock.eval_for(j, id=f"eval-{j.id}")
            h.store.upsert_evals(h.next_index(), [ev])
            h.process(ev)
        views.append(
            sorted(
                (a.job_id, a.node_id, float(v))
                for a in h.store.allocs()
                for v in a.metrics.scores.values()
            )
        )
    card, cpu = views
    assert [v[:2] for v in card] == [v[:2] for v in cpu], (
        "card and CPU runs placed differently"
    )
    err = max(abs(a[2] - b[2]) for a, b in zip(card, cpu))
    assert err <= MAX_ABS_ERR, f"card and CPU scores differ by {err}"
    log(
        f"[cross_device] 300 nodes, {len(jobs)} jobs (3 service, even spread, "
        f"target spread, distinct_property): {len(card)} allocs on the same "
        f"nodes on card and CPU, max score difference {err!r}"
    )


class Recorder:
    """Stands in for a kernel wrapper ``module.name`` while a path runs and
    keeps the arguments of every call, so that the path's own kernel
    inputs can be replayed against the plain version once its launch
    counters have been read. The wrapper itself still runs each call and
    counts it: it bumps ``<its name>.launches`` through the module global,
    which is this object while it stands in, so ``launches`` is passed
    through to the wrapper's own counter."""

    def __init__(self, real):
        self.real = real
        self.sig = inspect.signature(real)
        self.calls = []

    def __call__(self, *args, **kwargs):
        bound = self.sig.bind(*args, **kwargs)
        bound.apply_defaults()
        self.calls.append(dict(bound.arguments))
        return self.real(*args, **kwargs)

    @property
    def launches(self):
        return self.real.launches

    @launches.setter
    def launches(self, value):
        self.real.launches = value


@contextlib.contextmanager
def recording(module, name):
    rec = Recorder(getattr(module, name))
    setattr(module, name, rec)
    try:
        yield rec.calls
    finally:
        setattr(module, name, rec.real)


# the coupled kernels' wrappers, by the kernel.place span tag of their route
COUPLED = {
    "place_spread_opv": "opv",
    "place_spread_chunked": "chunked",
    "place_value_scan": "scan",
}


def counters() -> dict:
    from nomad_tpu_torch.device import score as S
    from nomad_tpu_torch.device import score_triton as ST

    return {
        "place_closed_form": S.place_closed_form.launches,
        "score_matrix": ST.score_matrix_triton.launches,
        **{name: getattr(S, name).launches for name in COUPLED},
    }


def zero_counters() -> None:
    from nomad_tpu_torch.device import score as S
    from nomad_tpu_torch.device import score_triton as ST

    S.place_closed_form.launches = 0
    ST.score_matrix_triton.launches = 0
    for name in COUPLED:
        getattr(S, name).launches = 0


CLOSED_FORM_INPUTS = (
    "capacity", "used0", "asks", "eligible", "job_counts", "desired_totals",
    "penalty_nodes", "affinity_scores", "has_affinities", "distinct_hosts",
    "slot_caps",
)
SCORE_MATRIX_INPUTS = (
    "capacity", "used", "asks", "eligible", "job_counts", "desired_totals",
    "penalty_nodes", "affinity_scores", "has_affinities", "distinct_hosts",
)


def replay_closed_form(calls):
    """Every closed-form launch of the schedule path, through the kernel
    and the plain version on the same inputs; the last one timed."""
    worst = {"max_abs_err": 0.0, "choice_mismatches": 0}
    for i, c in enumerate(calls):
        last = i == len(calls) - 1
        out = check_closed_form(
            f"schedule pass {i}", [c[key] for key in CLOSED_FORM_INPUTS],
            c["algorithm_spread"], c["max_j"], c["k"], c["jitter"], timed=last,
        )
        worst["max_abs_err"] = max(worst["max_abs_err"], out["max_abs_err"])
        worst["choice_mismatches"] += out["choice_mismatches"]
    # the timed pass is the last eval's: earlier jobs have filled the
    # lowest rows, so its picks start past one 512-row compaction round
    # and its k-th key lies inside the tie class of the empty nodes
    assert out["lowest_row"] >= 512, out["lowest_row"]
    g, n = c["eligible"].shape
    out.update(worst)
    out["shape"] = f"G={g} N={n} J={c['max_j']} k={c['k']} (last schedule pass)"
    return out


def replay_score_matrix(calls):
    """Every score-matrix launch of the score_group path, through the
    kernel and the plain version on the same inputs; the last one timed."""
    worst = {"max_abs_err": 0.0, "choice_mismatches": 0}
    for i, c in enumerate(calls):
        out = check_score_matrix(
            f"score_group call {i}", [c[key] for key in SCORE_MATRIX_INPUTS],
            c["algorithm_spread"], c["throughputs"], timed=i == len(calls) - 1,
        )
        worst["max_abs_err"] = max(worst["max_abs_err"], out["max_abs_err"])
        worst["choice_mismatches"] += out["choice_mismatches"]
    g, n = c["eligible"].shape
    out.update(worst)
    out["shape"] = f"G={g} N={n} (last score_group call)"
    return out


def main_path(dev, n_nodes=10_000, n_jobs=10, count=1000):
    """The slice's two paths. Returns each path's launch counts and the
    recorded kernel calls of each."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.device import score as S
    from nomad_tpu_torch.device import score_triton as ST
    from nomad_tpu_torch.device.flatten import flatten_group_ask
    from nomad_tpu_torch.obs.trace import global_tracer as tracer
    from nomad_tpu_torch.scheduler import Harness
    from nomad_tpu_torch.scheduler.algorithms import score_group

    t0 = time.perf_counter()
    h = Harness(device=dev)
    for _ in range(n_nodes):
        h.store.upsert_node(h.next_index(), mock.node())
    jobs = []
    for _ in range(n_jobs):
        j = mock.job()  # one service group of 500 MHz / 256 MiB tasks
        j.task_groups[0].count = count
        h.store.upsert_job(h.next_index(), j)
        jobs.append(j)
    log(f"[main] set-up {time.perf_counter() - t0:.3f} s ({n_nodes} nodes, {n_jobs} jobs)")

    # path "schedule": each eval runs under a trace; its "kernel.place"
    # spans count the PlacementKernel passes (one closed-form launch each)
    passes = 0
    lat = []
    zero_counters()
    with recording(S, "place_closed_form") as cf_calls:
        t_run = time.perf_counter()
        for j in jobs:
            ev = mock.eval_for(j)
            h.store.upsert_evals(h.next_index(), [ev])
            tracer.begin(ev.id)
            t1 = time.perf_counter()
            with tracer.activate(ev.id):
                h.process(ev)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t1)
            trace = tracer.finish(ev.id)
            passes += sum(sp["name"] == "kernel.place" for sp in trace["spans"])
        sched_s = time.perf_counter() - t_run
    schedule = counters()

    # path "score_group": dry-run annotation of each job's group against
    # the committed state through the registry seam (the system
    # scheduler's score path)
    snap = h.store.snapshot()
    ct = h.device_cache.tensors(snap)
    zero_counters()
    with recording(ST, "score_matrix_triton") as sm_calls:
        for j in jobs:
            tg = j.task_groups[0]
            ga = flatten_group_ask(ct, snap, j, tg, tg.count)
            finals, fits = score_group(ct, ga, tg.count, device=dev)
            assert finals.shape == (ct.padded_n,) and fits.any()
            assert np.isfinite(finals[fits]).all() and np.isneginf(finals[~fits]).all()
    annotate = counters()

    placed = sum(
        1 for j in jobs for a in h.store.allocs_by_job(j.namespace, j.id)
        if not a.terminal_status()
    )
    rejected = sum(len(r.rejected_nodes) for r in h.results)
    over = committed_overcommit(h.store)
    statuses = sorted({e.status for e in h.evals})
    lat_ms = np.array(lat) * 1e3
    log(
        f"[main] placed {placed}/{n_jobs * count} allocs; rejected plan nodes "
        f"{rejected}; over-committed nodes {over}; eval statuses {statuses}"
    )
    log(
        f"[main] {n_jobs} evals in {sched_s:.3f} s: evals/s={n_jobs / sched_s!r} "
        f"allocs/s={placed / sched_s!r} eval p50_ms={float(np.percentile(lat_ms, 50))!r} "
        f"p99_ms={float(np.percentile(lat_ms, 99))!r}"
    )
    log(
        f"[main] launches: schedule path {schedule} ({passes} placement "
        f"passes); score_group path {annotate}"
    )
    assert placed == n_jobs * count, "not every alloc was placed"
    assert rejected == 0, "a plan had rejected nodes"
    assert over == 0, "a node is over-committed in the store"
    assert statuses == ["complete"]
    idle = {name: 0 for name in COUPLED}
    assert schedule == {"place_closed_form": passes, "score_matrix": 0, **idle} and passes > 0
    assert annotate == {"place_closed_form": 0, "score_matrix": n_jobs, **idle}
    assert len(cf_calls) == passes and len(sm_calls) == n_jobs
    return {"schedule": schedule, "score_group": annotate}, cf_calls, sm_calls


# -- phase 5, "spread" path, and phase 6 ---------------------------------------


def spread_nodes(h, n_nodes=SPREAD_NODES, racks=SPREAD_RACKS):
    """The JAX package's bench.py end_to_end node recipe."""
    from nomad_tpu_torch import mock

    for i in range(n_nodes):
        node = mock.node()
        node.datacenter = "dc1"
        node.attributes["platform.rack"] = f"r{i % racks}"
        node.attributes["storage.type"] = "ssd" if i % 4 == 0 else "hdd"
        if i % 3 == 1:
            node.node_resources.cpu = 8000
            node.node_resources.memory_mb = 16384
        node.compute_class()
        h.store.upsert_node(h.next_index(), node)


def spread_jobs(per_job=250, distinct_count=200):
    """(route, job) in processing order: bench.py end_to_end's
    ``make_job(j)`` for j = 0..19 (even rack spread + ssd affinity, every
    third a batch job), then 5 target rack spread jobs (r0–r4 at 20 %
    each) and 5 jobs with a distinct_property rack cap."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import Affinity, Constraint, Spread, SpreadTarget

    rack = "${attr.platform.rack}"
    jobs = []
    for j in range(20):
        job = mock.batch_job() if j % 3 == 2 else mock.job()
        job.id = f"bench-{j}"
        tg = job.task_groups[0]
        tg.count = per_job
        tg.tasks[0].resources.cpu = int(np.random.default_rng(j).choice([250, 500]))
        job.spreads = [Spread(attribute=rack, weight=50)]
        job.affinities = [
            Affinity(l_target="${attr.storage.type}", r_target="ssd", operand="=", weight=50)
        ]
        jobs.append(("opv", job))
    for j in range(5):
        job = mock.job()
        job.id = f"target-{j}"
        job.task_groups[0].count = per_job
        job.spreads = [
            Spread(attribute=rack, weight=50, targets=[
                SpreadTarget(value=f"r{r}", percent=20) for r in range(5)
            ])
        ]
        jobs.append(("chunked", job))
    for j in range(5):
        job = mock.job()
        job.id = f"distinct-{j}"
        job.task_groups[0].count = distinct_count
        job.task_groups[0].constraints.append(
            Constraint(l_target=rack, r_target=str(DISTINCT_CAP), operand="distinct_property")
        )
        jobs.append(("scan", job))
    return jobs


def spread_path(dev, n_nodes=SPREAD_NODES):
    """The "spread" path: spread and distinct_property jobs through the
    Harness on the card. Returns its launch counts, the recorded calls of
    each coupled kernel and its end-to-end numbers."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.device import score as S
    from nomad_tpu_torch.obs.trace import global_tracer as tracer
    from nomad_tpu_torch.scheduler import Harness

    t0 = time.perf_counter()
    h = Harness(device=dev)
    spread_nodes(h, n_nodes)
    routed = spread_jobs()
    for _, j in routed:
        h.store.upsert_job(h.next_index(), j)
    log(
        f"[spread] set-up {time.perf_counter() - t0:.3f} s ({n_nodes} nodes "
        f"over {SPREAD_RACKS} racks, {len(routed)} jobs)"
    )

    split = {route: 0 for route in ("fast", "chunked", "opv", "scan")}
    lat = []
    zero_counters()
    with contextlib.ExitStack() as stack:
        calls = {name: stack.enter_context(recording(S, name)) for name in COUPLED}
        t_run = time.perf_counter()
        for route, j in routed:
            ev = mock.eval_for(j)
            h.store.upsert_evals(h.next_index(), [ev])
            tracer.begin(ev.id)
            t1 = time.perf_counter()
            with tracer.activate(ev.id):
                h.process(ev)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t1)
            for sp in tracer.finish(ev.id)["spans"]:
                if sp["name"] == "kernel.place":
                    for key in split:
                        split[key] += sp["tags"][key]
        run_s = time.perf_counter() - t_run
    launches = counters()

    want = sum(j.task_groups[0].count for _, j in routed)
    placed = sum(
        1 for _, j in routed for a in h.store.allocs_by_job(j.namespace, j.id)
        if not a.terminal_status()
    )
    rejected = sum(len(r.rejected_nodes) for r in h.results)
    over = committed_overcommit(h.store)
    statuses = sorted({e.status for e in h.evals})
    rack_of = {n.id: n.attributes["platform.rack"] for n in h.store.nodes()}
    worst_rack = 0
    for route, j in routed:
        if route == "scan":
            per_rack = {}
            for a in h.store.allocs_by_job(j.namespace, j.id):
                if not a.terminal_status():
                    r = rack_of[a.node_id]
                    per_rack[r] = per_rack.get(r, 0) + 1
            worst_rack = max(worst_rack, max(per_rack.values()))
    lat_ms = np.array(lat) * 1e3
    log(
        f"[spread] placed {placed}/{want} allocs; rejected plan nodes {rejected}; "
        f"over-committed nodes {over}; eval statuses {statuses}; most allocs of "
        f"one distinct_property job on one rack {worst_rack} (cap {DISTINCT_CAP})"
    )
    log(
        f"[spread] {len(routed)} evals in {run_s:.3f} s: evals/s={len(routed) / run_s!r} "
        f"allocs/s={placed / run_s!r} eval p50_ms={float(np.percentile(lat_ms, 50))!r} "
        f"p99_ms={float(np.percentile(lat_ms, 99))!r}"
    )
    log(f"[spread] launches {launches}; kernel.place split {split}")
    assert placed == want, "not every alloc was placed"
    assert rejected == 0, "a plan had rejected nodes"
    assert over == 0, "a node is over-committed in the store"
    assert statuses == ["complete"]
    assert worst_rack <= DISTINCT_CAP, "a distinct_property cap was exceeded"
    assert launches["place_closed_form"] == 0 and launches["score_matrix"] == 0
    assert split["fast"] == 0
    for name, route in COUPLED.items():
        assert launches[name] == split[route], (name, launches[name], split[route])
        assert len(calls[name]) == launches[name]
    assert split["opv"] >= 20 and split["chunked"] >= 5 and split["scan"] >= 5, split
    return h, launches, calls, {
        "evals": len(routed), "placed": placed, "seconds": run_s,
        "p50_ms": float(np.percentile(lat_ms, 50)),
        "p99_ms": float(np.percentile(lat_ms, 99)),
    }


def wide_values_path(h):
    """The "wide_values" path, on the spread path's cluster: one job per
    coupled route with its block keyed on ``${node.unique.id}`` -- an
    even spread (one-per-value), a target spread over five nodes
    (chunked) and a distinct_property cap of one per node (value scan).
    The 10,000 values bucket V to 16,384, so a lane's working state
    (~0.7 MB) does not fit in a block's shared memory and every call runs
    from global scratch (asserted). Returns the launch counts and the
    recorded calls of each coupled kernel."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.device import score as S
    from nomad_tpu_torch.obs.trace import global_tracer as tracer
    from nomad_tpu_torch.structs import Constraint, Spread, SpreadTarget

    attr = "${node.unique.id}"
    targets = sorted(n.id for n in h.store.nodes())[:5]
    even, target, distinct = mock.job(), mock.job(), mock.job()
    even.spreads = [Spread(attribute=attr, weight=50)]
    target.spreads = [Spread(attribute=attr, weight=50, targets=[
        SpreadTarget(value=t, percent=20) for t in targets
    ])]
    distinct.task_groups[0].constraints.append(
        Constraint(l_target=attr, r_target="1", operand="distinct_property")
    )
    routed = [("opv", even, 100), ("chunked", target, 60), ("scan", distinct, 40)]
    for route, j, count in routed:
        j.id = f"wide-{route}"
        j.task_groups[0].count = count
        h.store.upsert_job(h.next_index(), j)

    split = {route: 0 for route in ("fast", "chunked", "opv", "scan")}
    first_result = len(h.results)
    zero_counters()
    with contextlib.ExitStack() as stack:
        calls = {name: stack.enter_context(recording(S, name)) for name in COUPLED}
        for _, j, _ in routed:
            ev = mock.eval_for(j)
            h.store.upsert_evals(h.next_index(), [ev])
            tracer.begin(ev.id)
            with tracer.activate(ev.id):
                h.process(ev)
            for sp in tracer.finish(ev.id)["spans"]:
                if sp["name"] == "kernel.place":
                    for key in split:
                        split[key] += sp["tags"][key]
    launches = counters()

    placed = {
        route: [a.node_id for a in h.store.allocs_by_job(j.namespace, j.id)
                if not a.terminal_status()]
        for route, j, _ in routed
    }
    rejected = sum(len(r.rejected_nodes) for r in h.results[first_result:])
    statuses = sorted({e.status for e in h.evals})
    scratch = {
        name: sorted({
            S.coupled_scratch_bytes(
                f"nomad_{name}", c["eligible"].shape[1], *c["block_counts0"].shape[1:]
            )
            for c in calls[name]
        })
        for name in COUPLED
    }
    log(
        f"[wide_values] placed {({r: len(p) for r, p in placed.items()})} of "
        f"{({r: c for r, _, c in routed})}; rejected plan nodes {rejected}; "
        f"launches {launches}; kernel.place split {split}; scratch bytes per "
        f"lane {scratch}"
    )
    assert all(len(placed[r]) == c for r, _, c in routed), placed
    assert len(set(placed["scan"])) == len(placed["scan"]), "a node holds two"
    assert rejected == 0 and statuses == ["complete"]
    assert launches["place_closed_form"] == 0 and launches["score_matrix"] == 0
    assert split["fast"] == 0
    for name, route in COUPLED.items():
        assert launches[name] == split[route] >= 1, (name, launches[name], split)
        assert len(calls[name]) == launches[name]
        assert calls[name][0]["block_counts0"].shape[2] >= SPREAD_NODES
        assert min(scratch[name]) > 0, (name, "region fit in shared memory")
    return launches, calls


def coupled_steps(name, c, choices):
    """Steps the kernel ran per lane (it stops after the first step that
    places nothing) and slots per step."""
    if name == "place_value_scan":
        width, total = 1, c["max_steps"]
    elif name == "place_spread_chunked":
        width, total = c["chunk"], c["n_chunks"]
    else:
        width, total = c["k_seg"], c["n_chunks"]
    took = (choices.view(choices.shape[0], total, width) >= 0).any(dim=2)
    with_pick = took.sum(dim=1)
    return torch.clamp(with_pick + 1, max=total), width


def check_coupled(name, c, timed):
    """One recorded coupled call through the kernel and its plain version
    on the same inputs: choices identical, scores exact; the kernel timed
    by graph replay, and with ``timed`` the plain version and bound too."""
    from nomad_tpu_torch.device import score as S

    kernel = getattr(S, name)
    plain = getattr(S, f"{name}_plain")
    ch, sc = kernel(**c)
    chp, scp = plain(**c)
    torch.cuda.synchronize()
    mismatches = int((ch != chp).sum())
    fin = torch.isfinite(scp)
    inf_agree = bool(torch.equal(torch.isfinite(sc), fin))
    err = float((sc - scp).abs()[fin].max()) if bool(fin.any()) else 0.0
    assert mismatches == 0, f"{name}: {mismatches} choices differ from plain"
    assert inf_agree, f"{name}: untaken slots differ from plain"
    assert err == 0.0, f"{name}: |score error| {err}"
    launch = lambda: kernel(**c)  # noqa: E731
    out = {"max_abs_err": err, "choice_mismatches": mismatches, "ms": graph_ms(launch)}
    if timed:
        steps, width = coupled_steps(name, c, chp)
        g, n = c["eligible"].shape
        nb, nv = c["block_counts0"].shape[1:]
        passes = 2 if name == "place_spread_opv" else 1
        picks = int((chp >= 0).sum())
        ran = int(steps.sum())
        ops = (
            (g * n + picks) * CLOSED_FORM_OPS_PER_CANDIDATE
            + ran * passes * n * (COUPLED_OPS_PER_NODE + COUPLED_OPS_PER_BLOCK * nb)
            + ran * passes * nb * nv * COUPLED_OPS_PER_TABLE_ENTRY
        )
        in_bytes = nbytes(*[v for v in c.values() if isinstance(v, torch.Tensor)])
        t_bytes = (in_bytes + ch.numel() * 8) / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_OPS_PER_S * 1e3
        run_plain = lambda: plain(**c)  # noqa: E731
        out.update({
            "stream_ms": cuda_ms(launch),
            "plain_ms": graph_ms(run_plain, iters=3),
            "plain_stream_ms": cuda_ms(run_plain, iters=3, warmup=1),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "steps_per_launch": int(steps.max()),
            "slots_per_step": width,
            "picks": picks,
            "shape": f"G={g} N={n} J={c['max_j']} B={nb} V={nv} (last call of the path)",
        })
        log(
            f"[{name}] kernel_ms={out['ms']!r} plain_ms={out['plain_ms']!r} "
            f"(graph replay; back to back on the stream {out['stream_ms']!r} and "
            f"{out['plain_stream_ms']!r}) bound_ms={out['bound_ms']!r} "
            f"({out['bound_by']}); {out['steps_per_launch']} steps x {width} "
            f"slots, {picks} picks; {out['shape']}"
        )
    return out


def replay_coupled(name, calls):
    """Every recorded call of one coupled kernel on a path, through the
    kernel and the plain version; each call's kernel timed by graph
    replay ("path_ms" is their sum), the last one in full."""
    worst = {"max_abs_err": 0.0, "choice_mismatches": 0}
    per_call = []
    for i, c in enumerate(calls):
        out = check_coupled(name, c, timed=i == len(calls) - 1)
        worst["max_abs_err"] = max(worst["max_abs_err"], out["max_abs_err"])
        worst["choice_mismatches"] += out["choice_mismatches"]
        per_call.append(out["ms"])
    log(
        f"[{name}] {len(calls)} recorded calls replayed: choice_mismatches="
        f"{worst['choice_mismatches']} max_abs_err={worst['max_abs_err']!r}; "
        f"kernel time over the calls path_ms={sum(per_call)!r} "
        f"(per call {[round(t, 4) for t in per_call]})"
    )
    out.update(worst)
    out["path_ms"] = sum(per_call)
    return out


def full_parity(dev) -> dict:
    """The port's parity suite at full size on the card."""
    from nomad_tpu_torch.device.parity import run_parity_suite

    t0 = time.perf_counter()
    res = run_parity_suite(small=False, device=dev)
    log(f"[parity] full-size suite in {time.perf_counter() - t0:.3f} s")
    for name, r in res.items():
        log(
            f"[parity] {name}: placements {r['placements']} score_delta_pct="
            f"{r['score_delta_pct']!r} node_mismatches={r['node_mismatches']} "
            f"failed_device={r['failed_device']} failed_oracle={r['failed_oracle']}"
        )
    for name in ("config3_spread_affinity", "config4_antiaffinity_caps"):
        r = res[name]
        assert abs(r["score_delta_pct"]) <= PARITY_BAR_PCT, (name, r)
        assert r["failed_device"] == 0, (name, r)
    return res


def kernel_entry(name, route, source, replaces, path, by_path, main, extra):
    keys = ("max_abs_err", "choice_mismatches", "ms", "plain_ms", "bound_ms",
            "bound_by", "stream_ms", "plain_stream_ms", "shape")
    entry = {
        "name": name,
        "route": route,
        "source": source,
        "replaces": replaces,
        "path": path,
        "launches": by_path[path][name],
        "launches_by_path": {p: c[name] for p, c in by_path.items()},
        "library_ms": None,
    }
    entry.update({key: main[key] for key in keys})
    entry.update(extra)
    return entry


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from nomad_tpu_torch import backend
    from nomad_tpu_torch.device import score as S

    dev = backend.resolve_device("cuda")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    card = card_line()
    log(card)

    # phase 1: builds
    t0 = time.perf_counter()
    libs = backend.build_all()
    log(
        f"[build] nvcc {sorted(p.name for p in libs.values())} in "
        f"{time.perf_counter() - t0:.3f} s"
    )

    # phase 2: closed-form kernel at the headline shape and with extras
    ct = build_cluster(10_000, seed=42)
    asks = build_asks(ct, 100, 1000, seed=7)
    b, max_j, k = device_batch(ct, asks, dev)
    assert (ct.padded_n, max_j, k) == (16384, 80, 1024), (ct.padded_n, max_j, k)
    args = closed_form_args(b)
    cf = check_closed_form("headline", args, False, max_j, k, None, timed=True)
    ex_args, ex_j, ex_k, jitter = extras_case(dev)
    cf_ex = check_closed_form(
        "extras+spread+jitter", ex_args, True, ex_j, ex_k, jitter, timed=False
    )

    # phase 3: score matrix, both variants
    t0 = time.perf_counter()
    sm_args, tp = score_matrix_inputs(b, dev)
    S.score_matrix(*sm_args, False, None)
    torch.cuda.synchronize()
    log(f"[build] triton score_matrix first launch {time.perf_counter() - t0:.3f} s")
    sm = check_score_matrix("plain", sm_args, False, None, timed=True)
    sm_tp = check_score_matrix("throughputs", sm_args, False, tp, timed=True)
    del b, args, ex_args, sm_args, tp

    # phase 4: small run, card against CPU
    cross_device_check(dev)

    # phase 5: the paths, counters zeroed just before each; then each
    # recorded kernel call against its plain version
    by_path, cf_calls, sm_calls = main_path(dev)
    cf_main = replay_closed_form(cf_calls)
    sm_main = replay_score_matrix(sm_calls)
    del cf_calls, sm_calls
    h, by_path["spread"], spread_calls, _ = spread_path(dev)
    coupled = {name: replay_coupled(name, spread_calls[name]) for name in COUPLED}
    del spread_calls
    by_path["wide_values"], wide_calls = wide_values_path(h)
    wide = {name: replay_coupled(name, wide_calls[name]) for name in COUPLED}
    del h, wide_calls

    # phase 6: the coupled placements against the stepwise oracle
    full_parity(dev)

    def headline(r, shape):
        return {
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "stream_ms": r["stream_ms"],
            "plain_stream_ms": r["plain_stream_ms"], "shape": shape,
        }

    cf_main["max_abs_err"] = max(
        cf_main["max_abs_err"], cf["max_abs_err"], cf_ex["max_abs_err"]
    )
    cf_main["choice_mismatches"] += cf["choice_mismatches"] + cf_ex["choice_mismatches"]
    sm_main["max_abs_err"] = max(
        sm_main["max_abs_err"], sm["max_abs_err"], sm_tp["max_abs_err"]
    )
    sm_main["choice_mismatches"] += sm["choice_mismatches"] + sm_tp["choice_mismatches"]
    kernels = [
        kernel_entry(
            "place_closed_form", "cuda", "nomad_tpu_torch/csrc/closed_form.cu",
            "nomad_tpu/device/score.py:313", "schedule", by_path, cf_main,
            {"headline": headline(cf, "G=128 (100 real) N=16384 J=80 k=1024")},
        ),
        kernel_entry(
            "score_matrix", "triton", "nomad_tpu_torch/device/score_triton.py",
            "nomad_tpu/device/score.py:914", "score_group", by_path, sm_main,
            {
                "headline": headline(sm, "G=128 N=16384"),
                "headline_throughputs": headline(sm_tp, "G=128 N=16384"),
            },
        ),
    ] + [
        kernel_entry(
            name, "cuda", "nomad_tpu_torch/csrc/coupled.cu", replaces, "spread",
            by_path, coupled[name],
            {
                **{k: coupled[name][k] for k in (
                    "steps_per_launch", "slots_per_step", "picks", "path_ms",
                )},
                "wide_values": {k: wide[name][k] for k in (
                    "max_abs_err", "choice_mismatches", "ms", "plain_ms",
                    "bound_ms", "bound_by", "steps_per_launch", "picks", "shape",
                )},
            },
        )
        for name, replaces in (
            ("place_value_scan", "nomad_tpu/device/score.py:430"),
            ("place_spread_chunked", "nomad_tpu/device/score.py:545"),
            ("place_spread_opv", "nomad_tpu/device/score.py:690"),
        )
    ]
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
