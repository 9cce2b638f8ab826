"""Vectorized preemption, on PyTorch and CUDA — the knapsack relaxation of
the reference's greedy victim search.

Ports ``nomad_tpu/device/preempt.py``. Reference semantics
(scheduler/preemption.go):

- eligibility: victim priority ≤ job priority − 10
  (filterAndGroupPreemptibleAllocs :663-697);
- victim choice per node: by priority ascending, then nearest resource
  distance first (PreemptForTaskGroup :198-265, basicResourceDistance
  :608-624), taken until the ask fits;
- scoring: preempting options are down-ranked by a logistic of the summed
  victim priorities, inflection at net priority 2048
  (rank.go:775-844 PreemptionScoringIterator / preemptionScore).

All nodes are evaluated at once. Victims are padded to ``[N, V]``; one
pass per node sorts them by (priority, distance), prefix-sums the freed
resources in that order, finds the minimal prefix k after which the ask
fits and the net priority of that prefix; the node choice scores the fit
after freeing every victim times the logistic penalty and takes the
first-index argmax over nodes.

Each device function has two halves here: a plain PyTorch version, which
is what a CPU tensor runs (and what ``chip_smoke.py`` holds the kernels
against), and a wrapper that launches the hand-written kernel of
``csrc/preempt.cu`` on a CUDA tensor or raises. The host drivers
(``build_victim_tensors``, ``rank_preemption_nodes``,
``find_preemptions``) take ``device``, default ``"cuda"``.
"""

from __future__ import annotations

import ctypes

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
from .score import _check_inputs, _div, _first_argmax, _pow10, capacity_on

# Priority delta a preemptor must have over its victims
# (preemption.go:673: delta ≥ 10).
PREEMPTION_PRIORITY_DELTA = 10
# Logistic inflection point for the net-priority penalty (rank.go:842).
NET_PRIORITY_INFLECTION = 2048.0
# The most victims per node the kernels can address: they count a row's
# padded width in a 32-bit int and keep a victim's index in the low 32
# bits of its sort word. Any V the reference takes below it runs.
MAX_VICTIM_WIDTH = 1 << 30
# The most nodes: the row count is a 32-bit int.
MAX_NODES = 2**31 - 1
# The find pass's forms (``csrc/preempt.cu``, ``find_plan``): a warp over
# 32 / Vp rows up to padded width Vp 32; a warp a row up to ROW_WIDTH; a
# row over a thread-block cluster up to CLUSTER_VICTIMS (16 blocks of
# 12,288 positions), its size picked at the launch from the shape and the
# card's occupancy; past that the global form, with a global scratch of Vp
# words for each resident block that the wrapper allocates. By the code
# ``nomad_find_preemption`` reports for the form it launched:
FIND_FORMS = ("warp", "warp a row", "cluster", "global")
ROW_WIDTH = 1024
CLUSTER_VICTIMS = 16 * 12288
GLOBAL_FORM = FIND_FORMS[3]
_PAD_KEY = 1e9


def preemption_score(net_priority):
    """Down-weight for preempting options: ≈1 for cheap preemptions, →0 as
    summed victim priority passes the inflection (rank.go:834-844)."""
    return torch.reciprocal(
        1.0 + torch.exp(_div(net_priority - NET_PRIORITY_INFLECTION, 256.0))
    )


def fma_square_add(x, acc):
    """float32 ``fma(x, x, acc)``: x * x + acc with one rounding, as a
    fused multiply-add gives it. PyTorch has no single-rounding FMA, so
    the sum is formed in float64, where the square of a float32 is exact,
    rounded to odd (TwoSum gives the sum's error; an inexact sum with an
    even last bit steps one ulp toward it), then rounded to float32:
    rounding to odd at 53 bits and then to nearest at 24 is one correct
    rounding, where two roundings to nearest could land on a false tie.
    The same elementwise float64 ops on the CPU and on the card."""
    p = x.double() * x.double()
    c = acc.double()
    s = p + c
    back = s - p
    err = (p - (s - back)) + (c - back)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(torch.float64)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def resource_distance(ask, victim):
    """basicResourceDistance (preemption.go:608-624) as the kernel takes
    it: L2 over the relative deltas of all four dimensions, the squares
    summed in dimension order by a chain of fused multiply-adds,
    ``fma(r3, r3, fma(r2, r2, fma(r1, r1, r0 * r0)))``, which is what the
    reference's ``jnp.sum(rel * rel, axis=-1)`` compiles to on the CPU,
    and a correctly rounded square root: taken in float64 and rounded to
    float32, since PyTorch's float32 ``sqrt`` on the CPU is off by an ulp
    on some inputs (the host's ``preempt_host.basic_resource_distance`` is
    a different function: three dimensions, zero asks skipped)."""
    rel = (victim - ask) / torch.clamp(ask, min=1.0)
    total = rel[..., 0] * rel[..., 0]
    for d in range(1, 4):
        total = fma_square_add(rel[..., d], total)
    return torch.sqrt(total.double()).to(torch.float32)


# -- the per-node pass --------------------------------------------------------


def find_preemption_plain(
    capacity, used, ask, eligible, victim_res, victim_prio, victim_mask
):
    """Plain PyTorch version of ``find_preemption``, op for op the
    reference body: a stable argsort, ``cumsum`` prefixes, the first
    fitting prefix."""
    n, v, _ = victim_res.shape
    dist = resource_distance(ask[None, None, :], victim_res)
    key = victim_prio.to(torch.float32) * 1e4 + torch.clamp(dist, max=9e3)
    key = torch.where(victim_mask, key, _PAD_KEY)
    order = torch.argsort(key, dim=1, stable=True)

    sorted_res = torch.take_along_dim(victim_res, order[:, :, None], dim=1)
    sorted_prio = torch.take_along_dim(
        torch.where(victim_mask, victim_prio, 0), order, dim=1
    )
    sorted_mask = torch.take_along_dim(victim_mask, order, dim=1)

    freed = torch.cumsum(
        torch.where(sorted_mask[:, :, None], sorted_res, 0.0), dim=1
    )
    fits_after = (
        used[:, None, :] - freed + ask[None, None, :] <= capacity[:, None, :]
    ).all(dim=-1) & sorted_mask

    any_fit = fits_after.any(dim=1) & eligible
    ar = torch.arange(v, device=victim_res.device)
    first = torch.where(fits_after, ar, v).amin(dim=1)
    k = torch.where(any_fit, first + 1, 0)
    prio_prefix = torch.cumsum(sorted_prio * sorted_mask, dim=1)
    net = torch.where(
        any_fit,
        torch.take_along_dim(
            prio_prefix, torch.clamp(k - 1, min=0)[:, None], dim=1
        )[:, 0].to(torch.float32),
        0.0,
    )
    return any_fit, k.to(torch.int32), net, order.to(torch.int32)


def choose_preemption_node_plain(
    capacity, used, ask, eligible, victim_res, victim_prio, victim_mask
):
    """Plain PyTorch version of ``choose_preemption_node``."""
    feasible, k, net, order = find_preemption_plain(
        capacity, used, ask, eligible, victim_res, victim_prio, victim_mask
    )
    # fit after preempting + placing (approximate: every victim freed)
    freed = torch.where(victim_mask[:, :, None], victim_res, 0.0).sum(dim=1)
    proposed = used - freed + ask
    free_frac = torch.where(
        capacity > 0,
        (capacity - proposed) / torch.clamp(capacity, min=1e-9),
        1.0,
    )
    fit = _div(
        torch.clamp(
            (20.0 - _pow10(free_frac[:, 0])) - _pow10(free_frac[:, 1]),
            0.0, 18.0,
        ),
        18.0,
    )
    score = fit * preemption_score(net)
    score = torch.where(feasible, score, -torch.inf)
    best, _ = _first_argmax(score)
    return best.to(torch.int32), feasible, k, net, order, score


def _pass_specs(capacity, used, ask, eligible, victim_res, victim_prio,
                victim_mask):
    n, v = victim_prio.shape
    return [
        ("capacity", capacity, torch.float32, (n, 4)),
        ("used", used, torch.float32, (n, 4)),
        ("ask", ask, torch.float32, (4,)),
        ("eligible", eligible, torch.bool, (n,)),
        ("victim_res", victim_res, torch.float32, (n, v, 4)),
        ("victim_prio", victim_prio, torch.int32, (n, v)),
        ("victim_mask", victim_mask, torch.bool, (n, v)),
    ]


def _check_pass(what: str, inputs) -> None:
    """Refuse what the kernels cannot address: a row count or victim
    width past the 32-bit indices they use."""
    same_device(inputs, inputs[0].device, what)
    _check_inputs(what, _pass_specs(*inputs))
    n, v = inputs[5].shape
    if not 1 <= n <= MAX_NODES or not 1 <= v <= MAX_VICTIM_WIDTH:
        raise ValueError(
            f"{what}: unsupported shape N={n} V={v} (the kernels address "
            f"1 ≤ N ≤ {MAX_NODES} nodes and 1 ≤ V ≤ MAX_VICTIM_WIDTH = "
            f"{MAX_VICTIM_WIDTH} victims per node)"
        )


def find_form(v: int) -> str:
    """The find pass's form for V victims a node, by the documented rule
    (the cluster form can still be picked down to another size, or to the
    global form, by the card's occupancy: the wrapper's ``forms`` count
    says what was launched)."""
    vp = _victim_bucket(v)
    if vp <= 32:
        return FIND_FORMS[0]
    if vp <= ROW_WIDTH:
        return FIND_FORMS[1]
    return FIND_FORMS[2] if v <= CLUSTER_VICTIMS else GLOBAL_FORM


def _check_aligned(what: str, inputs) -> None:
    """The kernels read capacity, usage and victim records as 16-byte
    float4s: each must start on 16 bytes (a fresh tensor does)."""
    for name, t in (("capacity", inputs[0]), ("used", inputs[1]), ("victim_res", inputs[4])):
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must start on 16 bytes")


def _library(symbol: str, argtypes):
    fn = getattr(cuda_library("preempt"), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_longlong if symbol.endswith("words") else ctypes.c_int
    return fn


_FIND_ARGTYPES = (
    [ctypes.c_void_p] * 7  # capacity … victim_mask
    + [ctypes.c_int] * 2  # n, v
    + [ctypes.c_void_p] * 5  # feasible, k, net, order, scratch
    + [ctypes.c_int]  # want
    + [ctypes.c_void_p] * 2  # launched, stream
)
_FIND_CHOOSE_ARGTYPES = (
    [ctypes.c_void_p] * 7  # capacity … victim_mask
    + [ctypes.c_int] * 2  # n, v
    + [ctypes.c_void_p] * 8  # feasible, k, net, order, scratch, best, score, stream
)
_SCRATCH_ARGTYPES = [ctypes.c_int] * 3  # n, v, want
_CHOOSE_ARGTYPES = (
    [ctypes.c_void_p] * 7  # capacity, used, ask, victim_res, victim_mask,
    # feasible, net
    + [ctypes.c_int] * 2  # n, v
    + [ctypes.c_void_p] * 4  # scratch, best, score, stream
)


@guarded(
    "find_preemption_kernel",
    # a build budget of 1: the one load of csrc/preempt.cu a process makes
    build_budget=1,
    library="preempt",
    symbols=("nomad_find_preemption",),
)
def find_preemption(
    capacity,  # f32[N, 4]
    used,  # f32[N, 4] (incl. victims)
    ask,  # f32[4]
    eligible,  # bool[N] (constraint/dc mask, ignoring resource fit)
    victim_res,  # f32[N, V, 4] resources per candidate victim
    victim_prio,  # i32[N, V] victim priorities (already delta-filtered)
    victim_mask,  # bool[N, V] real victims vs padding
):
    """For every node, the minimal sorted victim prefix that frees room —
    the port of ``find_preemption_kernel``. Returns (feasible bool[N],
    k i32[N] victims needed, net_priority f32[N], order i32[N, V] victim
    index order). CPU tensors run the plain version; CUDA tensors launch
    ``csrc/preempt.cu``."""
    inputs = (capacity, used, ask, eligible, victim_res, victim_prio, victim_mask)
    if capacity.device.type == "cpu":
        return find_preemption_plain(*inputs)
    return _launch_find(inputs)


def _launch_find(inputs, want=None):
    """Check the pass's inputs, allocate its outputs and the form's
    scratch (the global form's sort words, sized by the library for this
    card), launch ``nomad_find_preemption`` on the current stream, count
    the launch on ``find_preemption`` and the form the library reports it
    launched in ``find_preemption.forms``. ``want`` = (form code, blocks a
    row) asks for a form (``tools/preempt_find_profile.py`` times every
    form at one width); None: the library's plan."""
    _check_pass("find_preemption", inputs)
    _check_aligned("find_preemption", inputs)
    dev = inputs[0].device
    n, v = inputs[5].shape
    feasible, k, net, order = _pass_outputs(n, v, dev)
    code = -1 if want is None else want[0] << 8 | want[1]
    scratch = None
    if v > ROW_WIDTH or want is not None:  # the global form's scratch, sized by the library
        with torch.cuda.device(dev):
            words = _library("nomad_find_preemption_scratch_words", _SCRATCH_ARGTYPES)(n, v, code)
        if words < 0:
            raise RuntimeError(
                f"find_preemption: scratch sizing failed with cudaError {-words}"
            )
        if words > 0:
            scratch = torch.empty(int(words), dtype=torch.int64, device=dev)
    launched = (ctypes.c_int * 3)()
    fn = _library("nomad_find_preemption", _FIND_ARGTYPES)
    status = fn(
        *[t.data_ptr() for t in inputs], n, v, feasible.data_ptr(),
        k.data_ptr(), net.data_ptr(), order.data_ptr(),
        None if scratch is None else scratch.data_ptr(), code, launched, current_stream(dev),
    )
    check_launch(status, "find_preemption")
    form, size, asked = launched
    name = FIND_FORMS[form]
    if name == "cluster":
        name += f" S={size}" + (f" (asked {asked}, not resident)" if asked != size else "")
    elif name == GLOBAL_FORM and want is None and v <= CLUSTER_VICTIMS:
        name += f" (a cluster of {asked} not resident)"
    count_launch(find_preemption, form=name)
    return feasible, k, net, order


def _pass_outputs(n, v, dev):
    return (
        torch.empty(n, dtype=torch.bool, device=dev),
        torch.empty(n, dtype=torch.int32, device=dev),
        torch.empty(n, dtype=torch.float32, device=dev),
        torch.empty((n, v), dtype=torch.int32, device=dev),
    )


find_preemption.launches = 0
# launches by the form the library reported ("warp", "warp a row",
# "cluster S=<blocks a row>", "global"), counted at the launch
find_preemption.forms = {}
# find passes carried inside the choice's launch (V <= 32), which counts
# the launch itself on ``choose_preemption_node``
find_preemption.carried = 0


@guarded(
    "choose_preemption_node_kernel",
    # a build budget of 1: the one load of csrc/preempt.cu a process makes
    build_budget=1,
    library="preempt",
    symbols=("nomad_find_choose_preemption", "nomad_choose_preemption_node"),
)
def choose_preemption_node(
    capacity, used, ask, eligible, victim_res, victim_prio, victim_mask
):
    """The best node to preempt on: the binpack fit after freeing every
    victim and placing the ask, scaled by the preemption penalty — the
    port of ``choose_preemption_node_kernel``. Returns (best i32,
    feasible, k, net, order, score f32[N]), −inf scores on infeasible
    rows, best 0 when none is feasible. On CUDA tensors at V <= 32: one
    launch, the find pass and the choice in one kernel (counted on this
    wrapper, and the pass it carries on ``find_preemption.carried``);
    above: the per-node pass of ``find_preemption`` (its own launch and
    count), then this wrapper's kernel for the score and the first-index
    argmax."""
    inputs = (capacity, used, ask, eligible, victim_res, victim_prio, victim_mask)
    if capacity.device.type == "cpu":
        return choose_preemption_node_plain(*inputs)
    return _launch_choose(inputs)


def _launch_choose(inputs):
    """V <= 32: one launch of ``nomad_find_choose_preemption``, the find
    pass and the choice in one kernel node. Above: ``find_preemption``'s
    pass through the module-level wrapper (which checks the inputs), then
    the choice kernel on its outputs."""
    n, v = inputs[5].shape
    if v > 32:
        feasible, k, net, order = find_preemption(*inputs)
        best, score = launch_choice(inputs, feasible, net)
        return best, feasible, k, net, order, score
    _check_pass("choose_preemption_node", inputs)
    _check_aligned("choose_preemption_node", inputs)
    dev = inputs[0].device
    feasible, k, net, order = _pass_outputs(n, v, dev)
    best = torch.empty((), dtype=torch.int32, device=dev)
    score = torch.empty(n, dtype=torch.float32, device=dev)
    fn = _library("nomad_find_choose_preemption", _FIND_CHOOSE_ARGTYPES)
    status = fn(
        *[t.data_ptr() for t in inputs], n, v, feasible.data_ptr(), k.data_ptr(),
        net.data_ptr(), order.data_ptr(), _scratch_for(dev).data_ptr(),
        best.data_ptr(), score.data_ptr(), current_stream(dev),
    )
    check_launch(status, "choose_preemption_node")
    count_launch(choose_preemption_node)
    count_launch(find_preemption, "carried")
    return best, feasible, k, net, order, score


# the choice kernel's two-word cross-block scratch, one per (device,
# stream): zeroed once when made, and left zero by every launch
_choice_scratch: dict = {}


def _scratch_for(dev) -> torch.Tensor:
    """This stream's scratch, made (zeroed) at its first call. Never made
    inside a CUDA graph capture: its memset would become a node of the
    graph and its memory the graph's, zero only once the graph has run.
    A stream being captured needs an eager call first."""
    key = (dev.index, current_stream(dev))
    scratch = _choice_scratch.get(key)
    if scratch is None:
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "choose_preemption_node: the capture stream has no choice "
                "scratch yet; call it once on that stream before capturing"
            )
        # setdefault: two host threads (the server's worker and its commit
        # thread) may both miss at once; both must get the one scratch
        scratch = _choice_scratch.setdefault(
            key, torch.zeros(2, dtype=torch.int64, device=dev)
        )
    return scratch


def launch_choice(inputs, feasible, net):
    """One launch of ``nomad_choose_preemption_node`` on the find pass's
    ``feasible`` and ``net`` (checked inputs on the card), counted on
    ``choose_preemption_node``: (best i32, score f32[N]). One kernel node a
    call: its cross-block scratch is this stream's, which every launch
    leaves zero (``csrc/preempt.cu``), so nothing is cleared per call."""
    capacity, used, ask, _, victim_res, victim_prio, victim_mask = inputs
    dev = capacity.device
    n, v = victim_prio.shape
    best = torch.empty((), dtype=torch.int32, device=dev)
    score = torch.empty(n, dtype=torch.float32, device=dev)
    fn = _library("nomad_choose_preemption_node", _CHOOSE_ARGTYPES)
    status = fn(
        capacity.data_ptr(), used.data_ptr(), ask.data_ptr(),
        victim_res.data_ptr(), victim_mask.data_ptr(), feasible.data_ptr(),
        net.data_ptr(), n, v, _scratch_for(dev).data_ptr(), best.data_ptr(),
        score.data_ptr(), current_stream(dev),
    )
    check_launch(status, "choose_preemption_node")
    count_launch(choose_preemption_node)
    return best, score


choose_preemption_node.launches = 0


# -- host drivers ---------------------------------------------------------------


def _victim_bucket(n: int) -> int:
    """Pad the victim axis to a power of two (the reference's policy
    against recompilation; the kernels' sorting networks want it too)."""
    b = 1
    while b < n:
        b <<= 1
    return b


def build_victim_tensors(ct, snap, job, exclude_ids=frozenset(), device="cuda"):
    """Flatten preemption candidates: for every node row, the allocs whose
    priority is ≤ job.priority − 10 (preemption.go:663-697), padded to a
    power-of-two victim bucket. ``exclude_ids`` drops allocs already
    preempted by the in-flight plan (their capacity is freed once, not
    twice). The placing job's own allocs stay, as in the reference.
    Returns (victim_res, victim_prio, victim_mask) on ``device`` and
    victim_ids, a list of alloc ids per node row."""
    dev = resolve_device(device)
    pn = ct.padded_n
    max_prio = job.priority - PREEMPTION_PRIORITY_DELTA
    per_node: list[list] = [[] for _ in range(pn)]
    for row, node_id in enumerate(ct.node_ids):
        for a in snap.allocs_by_node(node_id):
            if a.terminal_status() or a.id in exclude_ids:
                continue
            prio = a.job.priority if a.job is not None else 50
            if prio <= max_prio:
                per_node[row].append((a, prio))
    v = _victim_bucket(max((len(x) for x in per_node), default=1) or 1)
    victim_res = np.zeros((pn, v, 4), dtype=np.float32)
    victim_prio = np.zeros((pn, v), dtype=np.int32)
    victim_mask = np.zeros((pn, v), dtype=bool)
    victim_ids: list[list[str]] = [[] for _ in range(pn)]
    for row, cands in enumerate(per_node):
        for j, (a, prio) in enumerate(cands):
            victim_res[row, j] = a.comparable_resources().to_vector()
            victim_prio[row, j] = prio
            victim_mask[row, j] = True
            victim_ids[row].append(a.id)
    return (
        torch.from_numpy(victim_res).to(dev),
        torch.from_numpy(victim_prio).to(dev),
        torch.from_numpy(victim_mask).to(dev),
        victim_ids,
    )


def _choose(ct, snap, job, ask_vec, eligible, exclude_ids, dev):
    """The device pass over every node, or None when no node holds a
    victim. The usage is uploaded on every call: the scheduler updates
    ``ct.used`` on the host after each preemption."""
    victim_res, victim_prio, victim_mask, victim_ids = build_victim_tensors(
        ct, snap, job, exclude_ids=exclude_ids, device=dev
    )
    if not any(victim_ids):
        return None
    def t(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype)).to(dev)

    out = choose_preemption_node(
        capacity_on(ct, dev),
        t(ct.used, np.float32),
        t(ask_vec, np.float32),
        t(eligible, bool),
        victim_res,
        victim_prio,
        victim_mask,
    )
    return out, victim_ids


def rank_preemption_nodes(
    ct, snap, job, ask_vec, eligible, exclude_ids=frozenset(), top: int = 16,
    device="cuda",
):
    """One [N, V] device pass ranking every node by post-preemption fit ×
    preemption penalty; returns up to ``top`` feasible node rows, best
    first (a stable host sort of the scores). The exact victim set per
    node is then chosen on the host by
    ``scheduler/preempt_host.select_victims``: the kernel narrows the
    cluster to a shortlist, the host pays exactness only on it."""
    dev = resolve_device(device)
    chosen = _choose(ct, snap, job, ask_vec, eligible, exclude_ids, dev)
    if chosen is None:
        return []
    (_best, feasible, _k, _net, _order, score), _ids = chosen
    feasible = feasible.cpu().numpy()
    score = score.cpu().numpy()
    rows = np.flatnonzero(feasible)
    if rows.size == 0:
        return []
    return rows[np.argsort(-score[rows], kind="stable")][:top].tolist()


def find_preemptions(
    ct, snap, job, ask_vec, eligible, exclude_ids=frozenset(), device="cuda"
):
    """Host driver: one device pass, then map the chosen node's sorted
    victim prefix back to allocation ids. Returns (node_row, [alloc ids])
    or (None, [])."""
    dev = resolve_device(device)
    chosen = _choose(ct, snap, job, ask_vec, eligible, exclude_ids, dev)
    if chosen is None:
        return None, []
    (best, feasible, k, _net, order, _score), victim_ids = chosen
    best = int(best)
    if not bool(feasible[best]):
        return None, []
    kk = int(k[best])
    ids = []
    for idx in order[best, :kk].tolist():
        if idx < len(victim_ids[best]):
            ids.append(victim_ids[best][idx])
    return best, ids
