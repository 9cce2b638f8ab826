"""Heterogeneity-aware placement policies over the dense score matrix, on
PyTorch and CUDA.

Ports ``nomad_tpu/scheduler/hetero.py``. Gavel (PAPERS.md, arxiv
2008.09213) observes that once jobs carry per-accelerator-class
throughput coefficients, heterogeneity-aware policies — max-min
fairness, makespan minimization, cost-aware packing — all become
optimization passes over one (jobs × nodes) effective-rate matrix. Nodes
declare a ``device_class``, jobs declare ``throughputs``, the flattener
gathers them into per-node coefficient vectors (device/flatten.py
``job_throughput_vector``), and the policies here run a joint greedy
pass over the whole batch.

Three policies, all the same slot-at-a-time greedy skeleton with a
different (job-pick, node-pick) key pair:

``hetero-maxmin``
    each step gives the next slot to the job with the LOWEST normalized
    throughput share (accumulated rate ÷ ideal rate), on its fastest
    feasible node — discrete water-filling of Gavel's max-min objective.
``hetero-makespan``
    each step gives the next slot to the job with the LARGEST modeled
    completion time (remaining work ÷ accumulated rate), on its fastest
    feasible node — the LPT rule specialized to rate accumulation.
``hetero-cost``
    slots go to jobs most-remaining-first, each on the feasible node
    maximizing throughput-per-cost (per-class costs from
    ``DEVICE_CLASS_COSTS``; unknown classes cost 1.0).

The pass has two halves here: ``hetero_place_plain``, the reference's
step spelled out in PyTorch ops, which is what a CPU tensor runs (and
what ``chip_smoke.py`` holds the kernel against), and ``hetero_place``,
which launches the hand-written kernel of ``csrc/hetero.cu`` on a CUDA
tensor or raises. Both are bit-identical to the reference: every carried
value is f32, every step does the same multiplies/divides/adds in the
same order, and ties break on the first index.

Class-less batches never reach the pass: ``HeteroPlacementKernel``
delegates to the base ``PlacementKernel`` whenever no ask carries a
throughput vector, so pre-heterogeneity clusters place bit-identically
to the binpack/spread kernels.

In learned mode (``throughput_source="learned"``) the kernel object
reads the calibration plane's ThroughputEstimator through
``obs.calibrate.learned_tp_matrix`` and launches the same kernel. Left
out of the port, raising where reached: the node-axis mesh (ROADMAP
A13).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from ..backend import (
    check_launch,
    count_launch,
    cuda_library,
    current_stream,
    guarded,
    resolve_device,
    same_device,
)
from ..device.score import (
    _check_inputs,
    _first_argmax,
    _steps_bucket,
    capacity_on,
    used_device,
)

# Policy ids (the kernel branches on these).
POLICY_MAXMIN = 0
POLICY_MAKESPAN = 1
POLICY_COST = 2

POLICY_IDS = {
    "maxmin": POLICY_MAXMIN,
    "makespan": POLICY_MAKESPAN,
    "cost": POLICY_COST,
}

# Canonical per-device-class relative cost (hetero-cost's denominator).
# Operators override per deployment; unknown classes cost 1.0 so a fleet
# without declared costs degrades to pure throughput maximization.
DEVICE_CLASS_COSTS: dict[str, float] = {
    "": 1.0,
    "cpu": 1.0,
    "tpu-v4": 2.5,
    "tpu-v5e": 2.0,
    "tpu-v5p": 4.0,
    "gpu-a100": 3.0,
    "gpu-h100": 5.0,
}

_EPS = np.float32(1e-9)

# Where the policies' throughput matrix comes from (SchedulerConfiguration
# knob): the jobspec's declared coefficients, or the calibration plane's
# ThroughputEstimator (obs/calibrate.py), learned from execute spans.
THROUGHPUT_DECLARED = "declared"
THROUGHPUT_LEARNED = "learned"
THROUGHPUT_SOURCES = (THROUGHPUT_DECLARED, THROUGHPUT_LEARNED)


def class_cost_vector(ct, costs: dict | None = None) -> np.ndarray:
    """Per-node cost f32[N] from the fleet's device-class column."""
    ids, vocab = ct.device_class_column()
    table = DEVICE_CLASS_COSTS if costs is None else costs
    per_class = np.ones(len(vocab), dtype=np.float32)
    for name, cid in vocab.items():
        per_class[cid] = np.float32(table.get(name, 1.0))
    return per_class[ids]


# -- the shared greedy step --------------------------------------------------
#
# Carry: used f32[N, D], placed i32[G], accum f32[G] (Σ tp of assigned
# nodes), choices i32[G, C], choice_tp f32[G, C]. One step = pick a job
# by the policy's fairness key, pick its node by the policy's node key,
# commit. Infeasible/done lanes key to ±inf; a step where nothing is
# placeable commits nothing, so the state it leaves is the state it found
# and every later step is the same no-op: both halves stop there.


def _job_keys(policy, placed, accum, counts, tpmax, placeable):
    """f32[G] selection key, argmin semantics; +inf = not selectable."""
    countsf = counts.to(torch.float32)
    if policy == POLICY_MAXMIN:
        ideal = countsf * tpmax  # rate if every slot ran on the best class
        key = accum / torch.clamp(ideal, min=float(_EPS))  # share in [0, 1]
    elif policy == POLICY_MAKESPAN:
        # modeled completion time = total work / accumulated rate; jobs
        # with no rate yet sort first (longest possible time)
        key = -(countsf / torch.clamp(accum, min=float(_EPS)))
    else:  # POLICY_COST — most remaining work first
        key = -(countsf - placed.to(torch.float32))
    return torch.where(placeable, key, torch.inf)


def _node_keys(policy, tp_row, cost, feasible):
    """f32[N] node key, argmax semantics; -inf = infeasible."""
    if policy == POLICY_COST:
        key = tp_row / torch.clamp(cost, min=float(_EPS))
    else:
        key = tp_row
    return torch.where(feasible, key, -torch.inf)


def _feasible_matrix(capacity, used, asks, eligible, tp):
    """bool[G, N]: room for one more instance ∧ eligible ∧ tp > 0."""
    proposed = used[None, :, :] + asks[:, None, :]  # [G, N, D]
    fits = (proposed <= capacity[None, :, :]).all(dim=-1)
    return fits & eligible & (tp > 0.0)


def hetero_place_plain(
    capacity, used0, asks, counts, eligible, tp, tpmax, cost,
    policy: int, steps: int, max_c: int,
):
    """Plain PyTorch version of ``hetero_place``: the reference's step,
    executed stepwise (``oracle_hetero_place``'s loop), stopping at the
    first step where nothing is placeable."""
    _check_hetero("hetero_place_plain", capacity, used0, asks, counts,
                  eligible, tp, tpmax, cost, max_c)
    g = tp.shape[0]
    dev = tp.device
    used = used0.clone()
    placed = torch.zeros(g, dtype=torch.int32, device=dev)
    accum = torch.zeros(g, dtype=torch.float32, device=dev)
    choices = torch.full((g, max_c), -1, dtype=torch.int32, device=dev)
    choice_tp = torch.zeros((g, max_c), dtype=torch.float32, device=dev)
    for _ in range(steps):
        feas = _feasible_matrix(capacity, used, asks, eligible, tp)
        placeable = (placed < counts) & feas.any(dim=1)
        if not bool(placeable.any()):
            break
        jkey = _job_keys(policy, placed, accum, counts, tpmax, placeable)
        j = int(_first_argmax(-jkey)[0])
        nkey = _node_keys(policy, tp[j], cost, feas[j])
        node = int(_first_argmax(nkey)[0])
        slot = int(placed[j])
        used[node] = used[node] + asks[j]
        choices[j, slot] = node
        choice_tp[j, slot] = tp[j, node]
        placed[j] += 1
        accum[j] = accum[j] + tp[j, node]
    return choices, choice_tp, used


def _check_hetero(what, capacity, used0, asks, counts, eligible, tp, tpmax,
                  cost, max_c) -> None:
    g, n = tp.shape
    same_device(
        (capacity, used0, asks, counts, eligible, tp, tpmax, cost),
        capacity.device, what,
    )
    _check_inputs(what, [
        ("capacity", capacity, torch.float32, (n, 4)),
        ("used0", used0, torch.float32, (n, 4)),
        ("asks", asks, torch.float32, (g, 4)),
        ("counts", counts, torch.int32, (g,)),
        ("eligible", eligible, torch.bool, (g, n)),
        ("tp", tp, torch.float32, (g, n)),
        ("tpmax", tpmax, torch.float32, (g,)),
        ("cost", cost, torch.float32, (n,)),
    ])
    if n < 1 or max_c < 1:
        raise ValueError(f"{what}: unsupported shape N={n} C={max_c}")
    # a slot past max_c has nowhere to go (the reference's scatter would
    # drop it); build_hetero_batch sizes max_c to the largest count
    if g and int(counts.max()) > max_c:
        raise ValueError(f"{what}: a count exceeds max_c={max_c}")


_HETERO_ARGTYPES = (
    [ctypes.c_void_p] * 7  # capacity, asks … cost
    + [ctypes.c_int] * 5  # policy, g, n, steps, max_c
    + [ctypes.c_void_p, ctypes.c_size_t]  # scratch and its bytes
    + [ctypes.c_void_p] * 4  # choices, choice_tp, used, stream
)

# Nodes a block of the kernel's list build sorts (csrc/hetero.cu kChunk).
HETERO_SORT_CHUNK = 2048
# Bytes of the chain's per-group state (csrc/hetero.cu state_bytes).
HETERO_STATE_BYTES = 56


def hetero_scratch_bytes(g: int, n: int) -> int:
    """Global scratch bytes of one ``csrc/hetero.cu`` pass, in its layout:
    the sorted chunks and the per-group node lists (8 bytes a slot each,
    nodes rounded up to the sort chunk), the list lengths (16-byte
    aligned) and the chain's per-group state, for when it does not fit in
    shared memory. The kernel refuses a smaller scratch."""
    slots = g * -(-n // HETERO_SORT_CHUNK) * HETERO_SORT_CHUNK
    return ((16 * slots + 4 * g + 15) & ~15) + HETERO_STATE_BYTES * g


def hetero_scratch(g: int, n: int, device) -> torch.Tensor:
    return torch.empty(hetero_scratch_bytes(g, n), dtype=torch.uint8, device=device)


def _hetero_library():
    fn = cuda_library("hetero").nomad_hetero_place
    if fn.argtypes is None:
        fn.argtypes = _HETERO_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


@guarded("hetero_place_kernel")
def hetero_place(
    capacity,  # f32[N, 4]
    used0,  # f32[N, 4]
    asks,  # f32[G, 4]
    counts,  # i32[G]
    eligible,  # bool[G, N]
    tp,  # f32[G, N] per-node throughput coefficients
    tpmax,  # f32[G] max coefficient over each job's eligible nodes
    cost,  # f32[N]
    policy: int,
    steps: int,
    max_c: int,
):
    """Joint greedy hetero pass — the port of ``hetero_place_kernel``.
    Returns (choices i32[G, C], choice_tp f32[G, C], used f32[N, 4]),
    C = max_c, -1 = unfilled. CPU tensors run the plain version; CUDA
    tensors launch ``csrc/hetero.cu``."""
    args = (capacity, used0, asks, counts, eligible, tp, tpmax, cost)
    if capacity.device.type == "cpu":
        return hetero_place_plain(*args, policy, steps, max_c)
    return _launch_hetero(args, policy, steps, max_c)


def _launch_hetero(args, policy, steps, max_c):
    """Check the inputs, allocate the outputs, launch
    ``nomad_hetero_place`` on the current stream and count the launch on
    ``hetero_place``."""
    capacity, used0, tp = args[0], args[1], args[5]
    _check_hetero("hetero_place", *args, max_c)
    g, n = tp.shape
    dev = capacity.device
    choices = torch.full((g, max_c), -1, dtype=torch.int32, device=dev)
    choice_tp = torch.zeros((g, max_c), dtype=torch.float32, device=dev)
    used = used0.clone()
    if g == 0 or steps < 1:
        return choices, choice_tp, used
    scratch = hetero_scratch(g, n, dev)
    _hetero_call(args, policy, steps, max_c, scratch, choices, choice_tp, used)
    count_launch(hetero_place)
    return choices, choice_tp, used


def _hetero_call(args, policy, steps, max_c, scratch, choices, choice_tp, used):
    """The bare launch on checked inputs and allocated outputs (``used``
    holding used0, ``choices`` -1, ``choice_tp`` 0, ``scratch`` a uint8
    tensor of ``hetero_scratch_bytes(G, N)``); no host sync."""
    g, n = args[5].shape
    status = _hetero_library()(
        *[t.data_ptr() for t in (args[0], *args[2:])], int(policy), g, n, int(steps),
        int(max_c), scratch.data_ptr(), scratch.numel(), choices.data_ptr(),
        choice_tp.data_ptr(), used.data_ptr(), current_stream(used.device),
    )
    check_launch(status, "hetero_place")


hetero_place.launches = 0


# -- PlacementKernel-compatible wrapper --------------------------------------


@dataclass
class HeteroBatch:
    """Assembled dense inputs for one joint hetero pass (host arrays)."""

    capacity: np.ndarray
    used: np.ndarray
    asks: np.ndarray
    counts: np.ndarray
    eligible: np.ndarray
    tp: np.ndarray
    tpmax: np.ndarray
    cost: np.ndarray
    steps: int
    max_c: int

    def tensors(self, device, capacity=None, used=None) -> tuple:
        """The pass's eight inputs on ``device``, in ``hetero_place``'s
        order; ``capacity`` and ``used`` may be tensors already there
        (the resident capacity, the ``used_device`` seam's tensor)."""
        def t(x, dtype):
            return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype)).to(device)

        return (
            capacity if capacity is not None else t(self.capacity, np.float32),
            used if used is not None else t(self.used, np.float32),
            t(self.asks, np.float32),
            t(self.counts, np.int32),
            t(self.eligible, bool),
            t(self.tp, np.float32),
            t(self.tpmax, np.float32),
            t(self.cost, np.float32),
        )


def build_hetero_batch(cluster, asks: list, used_override=None) -> HeteroBatch:
    pn = cluster.padded_n
    g = len(asks)
    ask_m = np.stack([a.ask for a in asks]).astype(np.float32)
    counts = np.array([a.count for a in asks], dtype=np.int32)
    eligible = np.stack([a.eligible for a in asks])
    tp = np.ones((g, pn), dtype=np.float32)
    for i, a in enumerate(asks):
        if a.throughputs is not None:
            tp[i] = a.throughputs
    elig_tp = np.where(eligible, tp, np.float32(0.0))
    tpmax = elig_tp.max(axis=1).astype(np.float32)
    used = (
        used_override if used_override is not None else cluster.used
    ).astype(np.float32)
    total = int(counts.sum())
    return HeteroBatch(
        capacity=cluster.capacity.astype(np.float32),
        used=used,
        asks=ask_m,
        counts=counts,
        eligible=eligible,
        tp=tp,
        tpmax=tpmax,
        cost=class_cost_vector(cluster),
        steps=_steps_bucket(max(total, 1)),
        max_c=_steps_bucket(max(int(counts.max(initial=1)), 1)),
    )


class HeteroPlacementKernel:
    """Drop-in for device/score.py's PlacementKernel behind the algorithm
    registry: hetero batches run the joint policy pass on ``device``;
    anything the policy doesn't model (class-less batches,
    spread/distinct coupling, device-slot caps) delegates to the base
    binpack kernel so behavior degrades to exactly the
    pre-heterogeneity placement."""

    def __init__(
        self,
        policy: str,
        force_scan: bool = False,
        mesh=None,
        throughput_source: str = "declared",
        estimator=None,
        device="cuda",
    ):
        from ..device.score import PlacementKernel

        if policy not in POLICY_IDS:
            raise ValueError(f"unknown hetero policy {policy!r}")
        if throughput_source not in THROUGHPUT_SOURCES:
            raise ValueError(
                f"unknown throughput source {throughput_source!r}"
            )
        # the base kernel raises for a mesh (ROADMAP A13) and resolves
        # the device (raising without CUDA)
        self._base = PlacementKernel("binpack", force_scan, mesh=mesh, device=device)
        self.device = self._base.device
        self.policy = policy
        self.policy_id = POLICY_IDS[policy]
        self.algorithm_spread = False
        self.force_scan = force_scan
        # calibration seam (obs/calibrate.py): in learned mode the batch's
        # declared tp matrix is substituted on the host — same shape and
        # dtype, so the kernel is launched exactly as in declared mode.
        # Declared mode never consults the estimator (bit-identity gate).
        self.throughput_source = throughput_source
        self.estimator = estimator

    def _learned(self) -> bool:
        return (
            self.throughput_source == THROUGHPUT_LEARNED
            and self.estimator is not None
        )

    def _hetero_eligible(self, cluster, asks: list) -> bool:
        if not getattr(cluster, "has_device_classes", False):
            return False
        # learned mode qualifies on profile keys alone: the whole point
        # is running the policies on jobs whose declared coefficients are
        # absent (or hidden), estimated from telemetry instead
        if not any(a.has_throughputs for a in asks) and not (
            self._learned()
            and any(getattr(a, "profile", "") for a in asks)
        ):
            return False
        # coupled features stay on the base scan
        return not any(
            a.blocks is not None or a.slot_caps is not None
            or a.distinct_hosts
            for a in asks
        )

    def place(self, cluster, asks: list, **kwargs):
        from ..device.score import PlacementResult

        if not asks:
            return []
        if not self._hetero_eligible(cluster, asks):
            return self._base.place(cluster, asks, **kwargs)
        batch = build_hetero_batch(
            cluster, asks, used_override=kwargs.get("used_override")
        )
        if self._learned():
            # host-side substitution before the upload: learned
            # per-(class × profile) values replace the declared matrix
            # cell-wise (declared anchors stay the fallback below the
            # sample floor), shapes and dtypes unchanged
            from ..obs.calibrate import learned_tp_matrix

            batch.tp = learned_tp_matrix(
                self.estimator, cluster, asks, batch.tp
            )
            elig_tp = np.where(batch.eligible, batch.tp, np.float32(0.0))
            batch.tpmax = elig_tp.max(axis=1).astype(np.float32)
        choices, choice_tp, _ = hetero_place(
            *batch.tensors(
                self.device, capacity_on(cluster, self.device),
                used_device(cluster, batch.used, self.device),
            ),
            policy=self.policy_id,
            steps=batch.steps,
            max_c=batch.max_c,
        )
        choices = choices.cpu().numpy()
        choice_tp = choice_tp.cpu().numpy()
        explain = bool(kwargs.get("explain", False))
        results = []
        for i, a in enumerate(asks):
            rows = choices[i, : a.count].astype(np.int32)
            # score = throughput share of the job's best class, in [0, 1]
            denom = max(float(batch.tpmax[i]), float(_EPS))
            scores = np.where(
                rows >= 0,
                choice_tp[i, : a.count] / np.float32(denom),
                np.float32(-np.inf),
            ).astype(np.float32)
            res = PlacementResult(node_rows=rows, scores=scores)
            if explain:
                # explanations rank by this policy's node key so the top
                # candidate is the node the joint greedy takes first for
                # this lane
                from ..obs.explain import explain_hetero_group

                res.explanation = explain_hetero_group(
                    cluster, a, batch.used,
                    policy=self.policy,
                    tp_row=batch.tp[i],
                    tpmax=float(batch.tpmax[i]),
                    cost=batch.cost,
                )
            results.append(res)
        return results


# -- seeded mixed-fleet A/B harness (bench.py hetero) ------------------------


def build_mixed_fleet(
    n_nodes: int, seed: int = 42, classes: tuple[str, ...] = (
        "tpu-v5e", "tpu-v4", "gpu-a100", "cpu"
    )
):
    """Seeded synthetic mixed fleet as ClusterTensors (≥3 device
    classes), mirroring bench.py's build_cluster but with a populated
    device-class column."""
    from ..device.flatten import ClusterTensors, node_bucket

    rng = np.random.default_rng(seed)
    pn = node_bucket(n_nodes)
    kind = rng.integers(0, len(classes), size=n_nodes)
    cpu = np.choose(kind % 3, [4000, 8000, 16000]).astype(np.float32)
    mem = np.choose(kind % 3, [8192, 16384, 32768]).astype(np.float32)
    capacity = np.zeros((pn, 4), dtype=np.float32)
    capacity[:n_nodes, 0] = cpu
    capacity[:n_nodes, 1] = mem
    capacity[:n_nodes, 2] = 100 * 1024
    capacity[:n_nodes, 3] = 1000
    used = np.zeros_like(capacity)
    load = rng.uniform(0.0, 0.3, size=(n_nodes, 1)).astype(np.float32)
    used[:n_nodes, :2] = capacity[:n_nodes, :2] * load
    ready = np.zeros(pn, dtype=bool)
    ready[:n_nodes] = True
    device_class_vocab = {"": 0}
    for c in classes:
        device_class_vocab[c] = len(device_class_vocab)
    device_class_ids = np.zeros(pn, dtype=np.int32)
    device_class_ids[:n_nodes] = kind.astype(np.int32) + 1
    return ClusterTensors(
        node_ids=[f"node-{i}" for i in range(n_nodes)],
        index=1,
        num_nodes=n_nodes,
        capacity=capacity,
        used=used,
        ready=ready,
        dc_ids=np.zeros(pn, dtype=np.int32),
        class_ids=np.pad(kind.astype(np.int32), (0, pn - n_nodes)),
        dc_vocab={"dc1": 0},
        class_vocab={c: i for i, c in enumerate(classes)},
        class_rep=list(range(min(len(classes), n_nodes))),
        node_row={f"node-{i}": i for i in range(n_nodes)},
        device_class_ids=device_class_ids,
        device_class_vocab=device_class_vocab,
    )


def throughput_profile(j: int, names) -> dict[str, float]:
    """Job j's per-class throughput map: accelerator-hungry (fast on
    TPUs), GPU-leaning, or CPU-leaning batch, in turn."""
    kindj = j % 3
    m: dict[str, float] = {}
    for c in names:
        if kindj == 0:  # accelerator-hungry: fast on TPUs
            m[c] = 4.0 if c.startswith("tpu") else (
                2.0 if c.startswith("gpu") else 0.5
            )
        elif kindj == 1:  # GPU-leaning
            m[c] = 3.5 if c.startswith("gpu") else (
                1.5 if c.startswith("tpu") else 0.75
            )
        else:  # CPU-leaning batch (accelerators waste on it)
            m[c] = 1.0 if c == "cpu" else (
                0.9 if c.startswith("tpu") else 0.6
            )
    return m


def build_mixed_asks(ct, n_jobs: int, count_per_job: int, seed: int = 7):
    """Seeded GroupAsks with per-class throughput maps: some jobs are
    TPU-hungry, some GPU-leaning, some indifferent — the mixed workload
    Gavel's policies differentiate on."""
    from ..device.flatten import GroupAsk

    rng = np.random.default_rng(seed)
    ids, vocab = ct.device_class_column()
    names = [n for n in vocab if n]
    pn = ct.padded_n
    asks = []
    for j in range(n_jobs):
        m = throughput_profile(j, names)
        per_class = np.ones(len(vocab), dtype=np.float32)
        for name, cid in vocab.items():
            if name:
                per_class[cid] = np.float32(m.get(name, 1.0))
        vec = per_class[ids]
        has_tp = not bool(np.all(vec == np.float32(1.0)))
        cpu = float(rng.choice([500, 1000, 2000]))
        memv = float(rng.choice([512, 1024, 2048]))
        asks.append(
            GroupAsk(
                job_id=f"job-{j}",
                tg_name="web",
                count=count_per_job,
                desired_total=count_per_job,
                ask=np.array([cpu, memv, 300.0, 0.0], dtype=np.float32),
                eligible=ct.ready.copy(),
                job_counts=np.zeros(pn, dtype=np.int32),
                penalty_nodes=np.zeros(pn, dtype=bool),
                affinity_scores=np.zeros(pn, dtype=np.float32),
                has_affinities=False,
                distinct_hosts=False,
                throughputs=vec if has_tp else None,
                has_throughputs=has_tp,
            )
        )
    return asks


def _quality_metrics(ct, asks, results) -> dict:
    """Canonical placement-quality block for one algorithm's output."""
    ids, vocab = ct.device_class_column()
    names = {cid: name for name, cid in vocab.items()}
    per_class_alloc: dict[str, int] = {}
    per_class_cpu_used: dict[str, float] = {}
    cost_vec = class_cost_vector(ct)
    shares = []
    makespans = []
    total_cost = 0.0
    total_rate = 0.0
    placed = 0
    for a, r in zip(asks, results):
        tp_vec = (
            a.throughputs
            if a.throughputs is not None
            else np.ones(ct.padded_n, dtype=np.float32)
        )
        rows = r.node_rows[r.node_rows >= 0]
        placed += int(rows.size)
        rate = float(tp_vec[rows].sum(dtype=np.float32))
        elig_tp = np.where(a.eligible, tp_vec, 0.0)
        ideal = float(elig_tp.max()) * a.count
        shares.append(rate / ideal if ideal > 0 else 0.0)
        makespans.append(a.count / rate if rate > 0 else float("inf"))
        total_cost += float(cost_vec[rows].sum(dtype=np.float32))
        total_rate += rate
        for row in rows:
            name = names.get(int(ids[row]), "")
            per_class_alloc[name] = per_class_alloc.get(name, 0) + 1
            per_class_cpu_used[name] = per_class_cpu_used.get(name, 0.0) + float(
                a.ask[0]
            )
    class_cap: dict[str, float] = {}
    for i in range(ct.num_nodes):
        name = names.get(int(ids[i]), "")
        class_cap[name] = class_cap.get(name, 0.0) + float(ct.capacity[i, 0])
    utilization = {
        name: round(per_class_cpu_used.get(name, 0.0) / cap, 4)
        for name, cap in sorted(class_cap.items())
        if cap > 0
    }
    return {
        "placed": placed,
        "worst_share": round(min(shares), 4) if shares else 0.0,
        "mean_share": round(float(np.mean(shares)), 4) if shares else 0.0,
        "makespan": round(max(makespans), 4) if makespans else 0.0,
        "throughput_per_cost": round(total_rate / total_cost, 4)
        if total_cost > 0
        else 0.0,
        "per_class_allocs": dict(sorted(per_class_alloc.items())),
        "per_class_cpu_utilization": utilization,
    }


def _outputs_mismatch(got, want) -> int:
    """Entries (bit patterns for floats) where two passes' outputs differ."""
    return sum(
        int((g.reshape(-1).view(torch.int32)
             != w.reshape(-1).view(torch.int32)).sum())
        for g, w in zip(got, want)
    )


def run_hetero_ab(
    n_nodes: int = 1000,
    n_jobs: int = 12,
    count_per_job: int = 25,
    seed: int = 42,
    device="cuda",
) -> dict:
    """The `bench.py hetero` A/B block: binpack vs each hetero policy on
    one seeded mixed fleet, on ``device``. Placements are deterministic
    for a seed, so the whole report is byte-reproducible. Also holds each
    policy's pass (the kernel on a CUDA device) against the plain version
    on the same inputs, where the reference uses its NumPy oracle, and
    reports the mismatching entries of every output, bit for bit (must
    be 0); that check places nothing."""
    from ..device.score import PlacementKernel

    dev = resolve_device(device)
    ct = build_mixed_fleet(n_nodes, seed=seed)
    asks = build_mixed_asks(ct, n_jobs, count_per_job, seed=seed + 1)

    base = PlacementKernel("binpack", device=dev)
    base_results = base.place(ct, asks)
    report: dict = {
        "config": {
            "nodes": n_nodes,
            "jobs": n_jobs,
            "count_per_job": count_per_job,
            "seed": seed,
            "device_classes": sorted(
                k for k in ct.device_class_vocab if k
            ),
        },
        "binpack": _quality_metrics(ct, asks, base_results),
        "policies": {},
        "oracle_mismatches": 0,
    }
    batch = build_hetero_batch(ct, asks)
    args = batch.tensors(dev)
    for policy in ("maxmin", "makespan", "cost"):
        kern = HeteroPlacementKernel(policy, device=dev)
        results = kern.place(ct, asks)
        metrics = _quality_metrics(ct, asks, results)
        statics = (POLICY_IDS[policy], batch.steps, batch.max_c)
        mism = _outputs_mismatch(
            hetero_place(*args, *statics), hetero_place_plain(*args, *statics)
        )
        metrics["oracle_identical"] = mism == 0
        report["oracle_mismatches"] += mism
        report["policies"][f"hetero-{policy}"] = metrics

    b = report["binpack"]
    mm = report["policies"]["hetero-maxmin"]
    ms = report["policies"]["hetero-makespan"]
    report["ab"] = {
        "maxmin_worst_share_delta": round(
            mm["worst_share"] - b["worst_share"], 4
        ),
        "makespan_delta": round(b["makespan"] - ms["makespan"], 4),
        "maxmin_improves_worst_share": mm["worst_share"] > b["worst_share"],
        "makespan_reduced": ms["makespan"] < b["makespan"],
    }
    report["ok"] = (
        report["ab"]["maxmin_improves_worst_share"]
        and report["ab"]["makespan_reduced"]
        and report["oracle_mismatches"] == 0
    )
    return report
