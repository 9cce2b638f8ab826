"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's kernels from the sources in this checkout, holds each
against its plain PyTorch version on the card at the shapes the main
path gives it, then schedules service jobs end to end through the port's
``Harness(device="cuda")`` and checks what lands in the state store. It
imports nothing of JAX and nothing of the JAX package.

Phases (none is wrapped in a ``try``; any failure exits non-zero):

1. the card's name and power limit; build the CUDA library (one nvcc per
   ``csrc/*.cu``, started together) and JIT the Triton kernel;
2. ``place_closed_form`` (CUDA) against ``place_closed_form_plain`` at
   the headline shape — 10,000 nodes (padded to 16,384), 100 service
   groups x 1,000 allocs, binpack (the JAX package's ``bench.py kernel``
   shape) — and on a smaller case with every score component live;
3. ``score_matrix`` (Triton) against ``component_scores`` at
   [128, 16,384], without and with the throughput term;
4. a small end-to-end run on the card against the same run on the CPU;
5. the two paths of the slice, each with the launch counters zeroed
   just before it and read just after it:
   - "schedule": 10,000 mock nodes, 10 service jobs x 1,000 allocs at
     500 MHz / 256 MiB, each eval processed by the port's Harness on
     the card (one closed-form launch per placement pass, no score
     matrix);
   - "score_group": each job's group annotated against the committed
     state through the registry's ``score_group`` seam (one score-matrix
     launch per job, no closed form);
   every kernel call of either path is recorded, and after the counters
   are read each recorded call is replayed through the kernel and its
   plain version (choices and scores compared), the last one timed;
6. one JSON line of per-kernel results, then the device line last.

Times, kernels and plain versions alike, are device times per launch
from a CUDA-graph replay of 20 launches, so no host launch cost sits in
either; "stream_ms" and "plain_stream_ms" are the same 20 launched back
to back from Python.

Tolerances: the kernels and their plain versions run the same IEEE
float32 operations in the same order (no FMA contraction, IEEE
division, the same libdevice ``expf``), so choices and fits must be
identical and scores agree within ``MAX_ABS_ERR``.
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
    place the same nodes with the same scores."""
    from nomad_tpu_torch import interop, mock
    from nomad_tpu_torch.scheduler import Harness

    nodes = [mock.node() for _ in range(300)]
    jobs = []
    for count in (150, 90, 400):
        j = mock.job()
        j.task_groups[0].count = count
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
        f"[cross_device] 300 nodes, 3 jobs: {len(card)} allocs on the same "
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


def counters() -> dict:
    from nomad_tpu_torch.device import score as S
    from nomad_tpu_torch.device import score_triton as ST

    return {
        "place_closed_form": S.place_closed_form.launches,
        "score_matrix": ST.score_matrix_triton.launches,
    }


def zero_counters() -> None:
    from nomad_tpu_torch.device import score as S
    from nomad_tpu_torch.device import score_triton as ST

    S.place_closed_form.launches = 0
    ST.score_matrix_triton.launches = 0


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
    assert schedule == {"place_closed_form": passes, "score_matrix": 0} and passes > 0
    assert annotate == {"place_closed_form": 0, "score_matrix": n_jobs}
    assert len(cf_calls) == passes and len(sm_calls) == n_jobs
    return {"schedule": schedule, "score_group": annotate}, cf_calls, sm_calls


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
