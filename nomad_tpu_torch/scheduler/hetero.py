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
``obs.calibrate.learned_tp_matrix`` and launches the same kernel. Under
a node-axis mesh (``mesh=``) the batch is laid out over it and the pass
runs a step loop over the mesh's cells, with a cross-shard reduction on
the mesh lead every step (``hetero_place_sharded``).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from ..backend import (
    _gathered,
    check_launch,
    count_launch,
    cuda_library,
    current_stream,
    gather,
    guarded,
    inside_guard,
    is_sharded,
    resolve_device,
    same_device,
    shard_put,
)
from ..device.score import (
    _check_inputs,
    _first_argmax,
    _i32,
    _mesh_cells,
    _order_keys,
    _stacked,
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
    # drop it); build_hetero_batch sizes max_c to the largest count. The
    # kernel writes a group's slots into its row of max_c, so this one
    # host sync keeps its writes in bounds
    if g and int(counts.max()) > max_c:  # nta: allow=NTA002
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


@guarded(
    "hetero_place_kernel",
    sharded=lambda *a, **kw: hetero_place_sharded(*a, **kw),
    # a build budget of 1: the one load of csrc/hetero.cu a process makes
    build_budget=1,
    library="hetero",
    symbols=("nomad_hetero_place", "nomad_sharded_hetero"),
)
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
hetero_place.plain_calls = 0  # a CPU mesh's gathered calls


# -- the pass under a node-axis mesh ------------------------------------------
#
# Cell (i, j) of a dp x mp mesh holds groups row i's slice of the groups
# and column j's slice of the nodes, and keeps its own copy of the usage
# of its nodes. A step: each cell reports, for each of its groups still
# short of its count, the head of the group's list over the cell's nodes
# (its best node where one more instance fits: the node key, then the
# lowest node), as the word (order key, global node, tp bits)
# (``hetero_shard_step``); the mesh lead, cell (0, 0), takes the best
# head of every group over the columns, the policy's job key over all G
# and its first-index argmin, commits the placement and writes the
# step's record (``hetero_step_merge``); the record goes to every cell,
# and each grows the committed node's usage if it holds it and counts
# the placement if it holds the group (``hetero_shard_apply``). Every
# step couples all groups, so the merge runs once, on the lead, over
# every groups row. A step where nothing is placeable commits nothing
# and every later step of the reference is the same no-op: the loop
# stops there.

# the step's record: state (0 a commit, 1 nothing placeable: stop), the
# group, the global node, tp's bits, then the group's ask as bits
_HREC_STATE, _HREC_GROUP, _HREC_NODE, _HREC_TP, _HREC_ASK = 0, 1, 2, 3, 4
HETERO_RECORD = 8
# a candidate: the node key's order key (0: none), the global node (-1:
# none), tp's bits
HETERO_CAND = 3

# (name, axes) of the pass's inputs, in hetero_place's order: the
# reference's layout (nomad_tpu/scheduler/hetero.py, its shard_put calls)
_HETERO_AXES = (
    ("capacity", ("nodes", None)),
    ("used0", ("nodes", None)),
    ("asks", ("groups", None)),
    ("counts", ("groups",)),
    ("eligible", ("groups", "nodes")),
    ("tp", ("groups", "nodes")),
    ("tpmax", ("groups",)),
    ("cost", ("nodes",)),
)


def hetero_shard_step_plain(capacity, used, asks, counts, eligible, tp, cost, placed,
                            policy: int, col0: int, cells: int = 1):
    """The plain version of ``hetero_shard_step``: the candidates
    i32[cells, G, 3] of ``cells`` cells side by side on the node axis
    (each ``n / cells`` nodes, the first global node ``col0``): for each
    group with ``placed`` below its count, the cell's best node where one
    more instance fits (the greatest node key, then the lowest node), as
    (order key, global node, tp's bits); (0, -1, 0) otherwise."""
    g, n = tp.shape
    seg = n // cells
    feas = _feasible_matrix(capacity, used, asks, eligible, tp)
    keys = _order_keys(_node_keys(policy, tp, cost, feas)).view(g, cells, seg)
    ok = (feas & (placed < counts)[:, None]).view(g, cells, seg)
    keys = torch.where(ok, keys, -1)
    best = keys.amax(dim=2)  # [G, cells]
    ar = torch.arange(seg, device=tp.device)
    low = torch.where(ok & (keys == best[..., None]), ar, seg).amin(dim=2)
    held = best >= 0
    low = low.clamp(max=seg - 1)
    node = low + col0 + torch.arange(cells, device=tp.device)[None, :] * seg
    tp_bits = torch.gather(tp.view(g, cells, seg), 2, low[..., None])[..., 0].view(torch.int32)
    out = torch.zeros((cells, g, HETERO_CAND), dtype=torch.int32, device=tp.device)
    out[..., 0] = torch.where(held, _i32(best.clamp(min=0)), 0).T
    out[..., 1] = torch.where(held, node, -1).T.to(torch.int32)
    out[..., 2] = torch.where(held, tp_bits, 0).T
    return out


def hetero_step_merge_plain(cand, placed, accum, counts, tpmax, asks, choices, choice_tp,
                            policy: int):
    """The plain version of ``hetero_step_merge``: the columns' candidates
    ``cand`` i32[S, G, 3] become the step's commit. Each group's best
    head over the columns (key desc, node asc); the placeable groups
    (short of their count, with a head); the least job key, first index;
    its head takes slot ``placed[j]``. Returns (record i32[8], placed,
    accum, choices, choice_tp), the inputs left as they were."""
    g = cand.shape[1]
    placed, accum = placed.clone(), accum.clone()
    choices, choice_tp = choices.clone(), choice_tp.clone()
    record = torch.zeros(HETERO_RECORD, dtype=torch.int32, device=cand.device)
    key = cand[..., 0].long() & 0xFFFFFFFF
    rank = torch.where(key > 0, key * 2**31 + (2**31 - 1 - cand[..., 1].long()), -1)
    best = torch.gather(cand, 0, rank.argmax(dim=0)[None, :, None].expand(1, g, HETERO_CAND))[0]
    placeable = (placed < counts) & (best[:, 0] != 0)
    if g == 0 or not bool(placeable.any()):
        record[_HREC_STATE] = 1
        return record, placed, accum, choices, choice_tp
    jkey = _job_keys(policy, placed, accum, counts, tpmax, placeable)
    j = int(_first_argmax(-jkey)[0])
    node, tp_bits = best[j, 1], best[j, 2]
    slot = int(placed[j])
    tpv = tp_bits.view(1).view(torch.float32)[0]
    choices[j, slot] = node
    choice_tp[j, slot] = tpv
    placed[j] += 1
    accum[j] = accum[j] + tpv
    record[_HREC_GROUP] = j
    record[_HREC_NODE] = node
    record[_HREC_TP] = tp_bits
    record[_HREC_ASK:] = asks[j].contiguous().view(torch.int32)
    return record, placed, accum, choices, choice_tp


def hetero_shard_apply_plain(record, used, placed, col0: int, g0: int):
    """The plain version of ``hetero_shard_apply``: one cell's usage
    f32[n, 4] of nodes [col0, col0 + n) and placements i32[g] of groups
    [g0, g0 + g) after a step's record, the inputs left as they were."""
    used, placed = used.clone(), placed.clone()
    if int(record[_HREC_STATE]) != 0:
        return used, placed
    x = int(record[_HREC_NODE]) - col0
    if 0 <= x < used.shape[0]:
        used[x] = used[x] + record[_HREC_ASK:].contiguous().view(torch.float32)
    j = int(record[_HREC_GROUP]) - g0
    if 0 <= j < placed.shape[0]:
        placed[j] += 1
    return used, placed


def _mesh_fn(symbol: str):
    fn = getattr(cuda_library("hetero"), symbol)
    if fn.argtypes is None:
        fn.argtypes = _MESH_ARGTYPES[symbol]
        fn.restype = ctypes.c_int
    return fn


_MESH_ARGTYPES = {
    # capacity, used, asks, counts, eligible, tp, cost, placed; policy, g,
    # n, col0; scratch and its bytes; cand, stream
    "nomad_hetero_shard_step": (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_size_t]
        + [ctypes.c_void_p] * 2
    ),
    # cand; cells, g, policy, max_c; counts, tpmax, asks, placed, accum,
    # choices, choice_tp, record, stream
    "nomad_hetero_step_merge": (
        [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 9
    ),
    # record, used, placed; n, g, col0, g0; stream
    "nomad_hetero_shard_apply": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    "nomad_hetero_cell_scratch_bytes": [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_size_t)],
    # rows, mp, devices, ptrs, gseg, seg, policy, steps, max_c, poll, launched
    "nomad_sharded_hetero": (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    ),
    "nomad_hetero_cell_ptrs": [],
}


def _cell_scratch_bytes(g: int, n: int) -> int:
    out = ctypes.c_size_t(0)
    check_launch(_mesh_fn("nomad_hetero_cell_scratch_bytes")(g, n, ctypes.byref(out)),
                 "hetero_shard_step")
    return out.value


@inside_guard(
    "hetero_shard_step",
    # it launches inside the hetero pass's guard
    guard="hetero_place_kernel",
    # a build budget of 1: it shares csrc/hetero.cu's one load
    build_budget=1,
    library="hetero",
    symbols=("nomad_hetero_shard_step",),
)
def hetero_shard_step(capacity, used, asks, counts, eligible, tp, cost, placed,
                      policy: int, col0: int):
    """One mesh cell's candidates i32[1, G, 3] for a step of the sharded
    hetero pass (see ``hetero_shard_step_plain``; the cell's nodes are
    [col0, col0 + n)). CPU tensors run the plain version; CUDA tensors
    build the cell's lists (``csrc/hetero.cu``'s sort and merge launches)
    and launch ``hetero_shard_step_kernel`` on them, as the step loop's
    first step does."""
    args = (capacity, used, asks, counts, eligible, tp, cost, placed)
    if capacity.device.type == "cpu":
        return hetero_shard_step_plain(*args, policy, col0)
    dev = capacity.device
    g, n = tp.shape
    same_device(args, dev, "hetero_shard_step")
    _check_inputs("hetero_shard_step", [
        ("capacity", capacity, torch.float32, (n, 4)),
        ("used", used, torch.float32, (n, 4)),
        ("asks", asks, torch.float32, (g, 4)),
        ("counts", counts, torch.int32, (g,)),
        ("eligible", eligible, torch.bool, (g, n)),
        ("tp", tp, torch.float32, (g, n)),
        ("cost", cost, torch.float32, (n,)),
        ("placed", placed, torch.int32, (g,)),
    ])
    if n < 1:
        raise ValueError("hetero_shard_step: no node")
    cand = torch.zeros((1, g, HETERO_CAND), dtype=torch.int32, device=dev)
    if g == 0:
        return cand
    scratch = torch.empty(_cell_scratch_bytes(g, n), dtype=torch.uint8, device=dev)
    status = _mesh_fn("nomad_hetero_shard_step")(
        *[t.data_ptr() for t in args], int(policy), g, n, int(col0),
        scratch.data_ptr(), scratch.numel(), cand.data_ptr(), current_stream(dev),
    )
    check_launch(status, "hetero_shard_step")
    count_launch(hetero_shard_step)
    return cand


hetero_shard_step.launches = 0
hetero_shard_step.plain_calls = 0  # a CPU mesh's step loop: its plain calls


@inside_guard(
    "hetero_step_merge",
    guard="hetero_place_kernel",
    # a build budget of 1: it shares csrc/hetero.cu's one load
    build_budget=1,
    library="hetero",
    symbols=("nomad_hetero_step_merge",),
)
def hetero_step_merge(cand, placed, accum, counts, tpmax, asks, choices, choice_tp,
                      policy: int):
    """One step's merge on the mesh lead (see ``hetero_step_merge_plain``);
    returns (record, placed, accum, choices, choice_tp), the inputs left as
    they were. CPU tensors run the plain version; CUDA tensors launch
    ``csrc/hetero.cu``'s ``hetero_step_merge_kernel``, one block."""
    dev = cand.device
    if dev.type == "cpu":
        return hetero_step_merge_plain(cand, placed, accum, counts, tpmax, asks, choices,
                                       choice_tp, policy)
    s, g, _ = cand.shape
    max_c = choices.shape[1]
    _check_inputs("hetero_step_merge", [
        ("cand", cand, torch.int32, (s, g, HETERO_CAND)),
        ("placed", placed, torch.int32, (g,)),
        ("accum", accum, torch.float32, (g,)),
        ("counts", counts, torch.int32, (g,)),
        ("tpmax", tpmax, torch.float32, (g,)),
        ("asks", asks, torch.float32, (g, 4)),
        ("choices", choices, torch.int32, (g, max_c)),
        ("choice_tp", choice_tp, torch.float32, (g, max_c)),
    ])
    same_device([placed, accum, counts, tpmax, asks, choices, choice_tp], dev,
                "hetero_step_merge")
    placed, accum = placed.clone(), accum.clone()
    choices, choice_tp = choices.clone(), choice_tp.clone()
    record = torch.zeros(HETERO_RECORD, dtype=torch.int32, device=dev)
    if g == 0:
        record[_HREC_STATE] = 1
        return record, placed, accum, choices, choice_tp
    status = _mesh_fn("nomad_hetero_step_merge")(
        cand.data_ptr(), s, g, int(policy), max_c,
        *[t.data_ptr() for t in (counts, tpmax, asks, placed, accum, choices, choice_tp,
                                 record)],
        current_stream(dev),
    )
    check_launch(status, "hetero_step_merge")
    count_launch(hetero_step_merge)
    return record, placed, accum, choices, choice_tp


hetero_step_merge.launches = 0
hetero_step_merge.plain_calls = 0


@inside_guard(
    "hetero_shard_apply",
    guard="hetero_place_kernel",
    # a build budget of 1: it shares csrc/hetero.cu's one load
    build_budget=1,
    library="hetero",
    symbols=("nomad_hetero_shard_apply",),
)
def hetero_shard_apply(record, used, placed, col0: int, g0: int):
    """One mesh cell's usage and placements after a step (see
    ``hetero_shard_apply_plain``), the inputs left as they were. CPU
    tensors run the plain version; CUDA tensors launch ``csrc/hetero.cu``'s
    ``hetero_shard_apply_kernel`` (here without the cell's lists, whose
    heads only the step loop keeps)."""
    dev = record.device
    if dev.type == "cpu":
        return hetero_shard_apply_plain(record, used, placed, col0, g0)
    n, g = used.shape[0], placed.shape[0]
    _check_inputs("hetero_shard_apply", [
        ("record", record, torch.int32, (HETERO_RECORD,)),
        ("used", used, torch.float32, (n, 4)),
        ("placed", placed, torch.int32, (g,)),
    ])
    same_device([used, placed], dev, "hetero_shard_apply")
    used, placed = used.clone(), placed.clone()
    status = _mesh_fn("nomad_hetero_shard_apply")(
        record.data_ptr(), used.data_ptr(), placed.data_ptr(), n, g, int(col0), int(g0),
        current_stream(dev),
    )
    check_launch(status, "hetero_shard_apply")
    count_launch(hetero_shard_apply)
    return used, placed


hetero_shard_apply.launches = 0
hetero_shard_apply.plain_calls = 0


def hetero_place_sharded(capacity, used0, asks, counts, eligible, tp, tpmax, cost,
                         policy: int, steps: int, max_c: int):
    """``hetero_place`` with its inputs laid out over a mesh (any of them
    a ``ShardedTensor``): the step loop over the cells (the groups axis
    splits when it divides G, else groups row 0 alone runs), one merge a
    step on the mesh lead over all G. Returns (choices, choice_tp, used)
    on the lead, identical to the one-device pass. A node axis the mesh
    does not divide runs the one-device kernel on the lead (gathered)."""
    args = (capacity, used0, asks, counts, eligible, tp, tpmax, cost)
    cfg = next(x.cfg for x in args if is_sharded(x))
    lead = cfg.lead
    g, n = asks.shape[0], capacity.shape[0]
    statics = {"policy": policy, "steps": steps, "max_c": max_c}
    if n % cfg.mp != 0:
        out = _gathered(hetero_place.__wrapped__, lead, list(args), statics)
        if lead.type == "cpu":  # the plain version ran where the card launches
            count_launch(hetero_place, "plain_calls", layout="gathered")
        return out
    if g == 0 or steps < 1:
        return (torch.full((g, max_c), -1, dtype=torch.int32, device=lead),
                torch.zeros((g, max_c), dtype=torch.float32, device=lead),
                gather(used0, lead).clone())
    rows_split = cfg.dp if g % cfg.dp == 0 else 1
    gseg, seg = g // rows_split, n // cfg.mp
    cells = _mesh_cells(cfg, args, _HETERO_AXES, rows_split, gseg, seg)
    # what the merge reads for every group, on the lead
    every = {name: gather(x, lead) for name, x in (
        ("asks", asks), ("counts", counts), ("tpmax", tpmax))}
    _check_hetero("hetero_place (sharded)", *[cells[0, 0][name] for name, _ in _HETERO_AXES[:3]],
                  cells[0, 0]["counts"], cells[0, 0]["eligible"], cells[0, 0]["tp"],
                  cells[0, 0]["tpmax"], cells[0, 0]["cost"], max_c)
    _check_inputs("hetero_place (sharded)", [("counts", every["counts"], torch.int32, (g,))])
    if g and int(every["counts"].max()) > max_c:  # nta: allow=NTA002
        raise ValueError(f"hetero_place (sharded): a count exceeds max_c={max_c}")
    run = _hetero_loop_cpu if lead.type == "cpu" else _hetero_loop_cuda
    return run(cfg, cells, every, rows_split, gseg, seg, int(policy), int(steps), int(max_c))


def _hetero_loop_cpu(cfg, cells, every, rows_split, gseg, seg, policy, steps, max_c):
    """The step loop through the plain versions (a CPU mesh). Every cell
    lies on the CPU, so each step runs them all as one call: the rows'
    groups one after another and the columns' nodes side by side, each
    column's candidates from its own nodes; then the merge, then every
    cell's apply as one call. Each of these calls is counted
    (``plain_calls``) and filed under the layout the card's launches
    take ("shard" or "merge")."""
    mp = cfg.mp
    t = {name: _stacked(cells, name, axes, rows_split, mp) for name, axes in _HETERO_AXES}
    g = t["tp"].shape[0]
    used = t["used0"].clone()
    placed_cells = torch.zeros(g, dtype=torch.int32)
    placed = torch.zeros(g, dtype=torch.int32)
    accum = torch.zeros(g, dtype=torch.float32)
    choices = torch.full((g, max_c), -1, dtype=torch.int32)
    choice_tp = torch.zeros((g, max_c), dtype=torch.float32)
    for _ in range(steps):
        cand = hetero_shard_step_plain(
            t["capacity"], used, t["asks"], t["counts"], t["eligible"], t["tp"], t["cost"],
            placed_cells, policy, 0, cells=mp,
        )
        count_launch(hetero_shard_step, "plain_calls", layout="shard")
        record, placed, accum, choices, choice_tp = hetero_step_merge_plain(
            cand, placed, accum, every["counts"], every["tpmax"], every["asks"], choices,
            choice_tp, policy,
        )
        count_launch(hetero_step_merge, "plain_calls", layout="merge")
        if int(record[_HREC_STATE]) != 0:
            break
        used, placed_cells = hetero_shard_apply_plain(record, used, placed_cells, 0, 0)
        count_launch(hetero_shard_apply, "plain_calls", layout="shard")
    return choices, choice_tp, used


# the per-cell pointers of the C step loop, in csrc/hetero.cu's HeteroPtr order
_HETERO_CELL_INPUTS = ("capacity", "asks", "counts", "eligible", "tp", "cost")
_HETERO_CELL_STATE = (
    "used", "placed", "scratch", "cand", "record", "gathered", "lead_placed", "accum",
    "every_counts", "every_tpmax", "every_asks", "choices", "choice_tp", "master",
)
# steps between two reads of the lead's stop word by the C step loop
MESH_POLL_STEPS = 16


def _hetero_loop_cuda(cfg, cells, every, rows_split, gseg, seg, policy, steps, max_c):
    """The step loop as one C call (``nomad_sharded_hetero``). It reports
    the launches it made, counted in C where each kernel launches; they
    are added here to each wrapper's count under its layout (each cell's
    one list build a call to ``hetero_place``, "shard")."""
    lead = cfg.lead
    per_cell = _mesh_fn("nomad_hetero_cell_ptrs")()
    assert per_cell == len(_HETERO_CELL_INPUTS) + len(_HETERO_CELL_STATE) + 1
    g = rows_split * gseg
    region = _cell_scratch_bytes(gseg, seg)
    n_cells = rows_split * cfg.mp
    ptrs = (ctypes.c_void_p * (n_cells * per_cell))()
    devices = (ctypes.c_int * n_cells)()
    keep = []
    for i in range(rows_split):
        for j in range(cfg.mp):
            dev = cfg.device(i, j)
            parts = cells[i, j]
            state = {
                "used": parts["used0"].clone(),
                "placed": torch.zeros(gseg, dtype=torch.int32, device=dev),
                "scratch": torch.empty(region, dtype=torch.uint8, device=dev),
                "cand": torch.empty((gseg, HETERO_CAND), dtype=torch.int32, device=dev),
                "record": torch.zeros(HETERO_RECORD, dtype=torch.int32, device=dev),
            }
            if (i, j) == (0, 0):
                state.update(
                    gathered=torch.empty((cfg.mp, g, HETERO_CAND), dtype=torch.int32,
                                         device=dev),
                    lead_placed=torch.zeros(g, dtype=torch.int32, device=dev),
                    accum=torch.zeros(g, dtype=torch.float32, device=dev),
                    every_counts=every["counts"], every_tpmax=every["tpmax"],
                    every_asks=every["asks"],
                    choices=torch.full((g, max_c), -1, dtype=torch.int32, device=dev),
                    choice_tp=torch.zeros((g, max_c), dtype=torch.float32, device=dev),
                    master=torch.zeros(HETERO_RECORD, dtype=torch.int32, device=dev),
                )
            c = i * cfg.mp + j
            row = [parts[name] for name in _HETERO_CELL_INPUTS] + [
                state.get(name) for name in _HETERO_CELL_STATE
            ]
            for k, x in enumerate(row):
                ptrs[c * per_cell + k] = None if x is None else x.data_ptr()
            ptrs[c * per_cell + len(row)] = current_stream(dev)
            devices[c] = dev.index
            keep.append((parts, state))
    poll = torch.zeros(1, dtype=torch.int32, pin_memory=True)
    launched = (ctypes.c_longlong * 4)()  # shard steps, merges, applies, list builds
    status = _mesh_fn("nomad_sharded_hetero")(
        rows_split, cfg.mp, devices, ptrs, gseg, seg, policy, steps, max_c,
        poll.data_ptr(), launched,
    )
    for fn, layout, k in zip(
        (hetero_shard_step, hetero_step_merge, hetero_shard_apply, hetero_place),
        ("shard", "merge", "shard", "shard"), launched,
    ):
        if k:
            count_launch(fn, layout=layout, n=k)
    check_launch(status, "hetero_place (sharded)")
    lead_state = keep[0][1]
    used = torch.cat([keep[j][1]["used"].to(lead) for j in range(cfg.mp)])
    return lead_state["choices"], lead_state["choice_tp"], used


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
        # the base kernel resolves the device (raising without CUDA) and
        # the mesh
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

    def mesh_cfg(self):
        return self._base.mesh_cfg()

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
        # under a node-axis mesh that divides the padded nodes the batch
        # is laid out as the reference lays it (its shard_put calls), and
        # the pass runs sharded (hetero_place_sharded)
        cfg = self.mesh_cfg() if self._base._n_shards(cluster.padded_n) > 1 else None
        if cfg is None:
            inputs = batch.tensors(
                self.device, capacity_on(cluster, self.device),
                used_device(cluster, batch.used, self.device),
            )
        else:
            inputs = (
                capacity_on(cluster, self.device, cfg),
                used_device(cluster, batch.used, self.device, cfg),
                *[shard_put(x, axes, cfg) for x, axes in (
                    (batch.asks, ("groups",)), (batch.counts, ("groups",)),
                    (batch.eligible, ("groups", "nodes")), (batch.tp, ("groups", "nodes")),
                    (batch.tpmax, ("groups",)), (batch.cost, ()),
                )],
            )
        choices, choice_tp, _ = hetero_place(
            *inputs,
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
