"""Batched joint placement as an assignment relaxation, on PyTorch and
CUDA.

Ports ``nomad_tpu/device/cp.py``. The CP/ILP job-dispatcher line
(PAPERS.md: arxiv 2009.10348, constraint-based pod packing arxiv
2511.08373) models dispatch as one assignment problem over the dense
score matrix, solved by **iterated proportional rounding** — an
auction-flavored price loop:

  1. price the matrix: ``u[g, n] = score[g, n] − λ[n] − anti·sib[g, n]``
     (λ = per-node congestion price, sib = OTHER same-job groups'
     instances already rounded onto the node this pass; a group's own
     instances are priced only by λ and blocked only by distinct_hosts);
  2. every unfinished group claims its argmax-feasible node;
  3. each contested node admits ONE claimant — highest priority tier
     first, then highest priced utility (first index on ties) — and
     commits exactly one instance, so per-node capacity is re-checked
     against the committed ``used`` and can never be exceeded;
  4. λ rises on every node with leftover claimants and relaxes on nodes
     nobody claims, and the loop repeats until a round finds no claimant
     (that round still runs: its λ decay is part of the result).

``cp_gang_place`` adds a signed rack/pod/ici topology term over gang
mates' reservations (weights quantized to 1/256, integer sums) and a
``waits`` counter. It takes the reference's inputs, one [N, W] one-hot
per level; ``cp_gang_place_ids`` takes the same levels as per-node
coordinate ids, the form the kernel reads and the kernel object passes.

Each program has two halves here: a plain PyTorch version (the
reference's round spelled out in torch ops, the CPU path and the oracle
``chip_smoke.py`` holds the kernel against) and a wrapper that launches
the hand-written kernel of ``csrc/cp.cu`` on a CUDA tensor or raises.
Both are bit-identical to the reference: every carried value is f32/i32,
every op elementwise, argmax or an exact integer sum, ties on the first
index. The reference's integer matrix products (``same @ assigned`` and
the one-hot topology products) become exact count tables — a per-(job,
node) sibling count and a per-(gang, level coordinate) mate count — kept
with ``index_add_``: no integer matmul, which the card's BLAS lacks.
"""

from __future__ import annotations

import ctypes

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
    same_device,
    shard_put,
)
from .score import (
    _NEG_INF_KEY,
    _check_inputs,
    _first_argmax,
    _i32,
    _mesh_cells,
    _order_keys,
    _stacked,
)

# Price step per leftover claimant: a power of two, so the f32 multiply
# is exact.
ETA = np.float32(0.125)
# In-batch same-job co-location penalty (soft anti-affinity across task
# groups of one job). Also a power of two for exact f32 scaling.
ANTI = np.float32(0.0625)
_NEG_INF = np.float32(-np.inf)
# topology weights quantize to this binary grid so the weighted mate sum
# accumulates in i32 and rescales by an exact power of two
TOPO_WEIGHT_SCALE = 256


def _steps_bucket(n: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return b


# -- shared round math (torch, the reference's op order) ---------------------


def _codes(ids):
    """Dense codes 0..K-1 of an i32[G] id vector (equal ids, equal code)
    and K."""
    uniq, inv = torch.unique(ids, return_inverse=True)
    return inv, int(uniq.numel())


def _cp_feasible(capacity, used, asks, eligible, job_counts, assigned_sib,
                 distinct):
    """bool[G, N]: capacity room for one more instance ∧ eligible ∧
    distinct_hosts honored against existing allocs AND same-job
    instances rounded earlier in this pass."""
    proposed = used[None, :, :] + asks[:, None, :]  # [G, N, D]
    fits = (proposed <= capacity[None, :, :]).all(dim=-1)
    taken = (job_counts + assigned_sib) > 0
    return fits & eligible & ~(distinct[:, None] & taken)


def _cp_siblings(jobgrp, assigned):
    """Two i32[G, N] views of same-job commits this pass: ``sib_all``
    counts every same-job instance (what distinct_hosts must honor),
    ``sib_other`` excludes the group's own. The reference's ``same @
    assigned`` as a per-(job, node) count table — exact integer sums."""
    code, k = _codes(jobgrp)
    table = torch.zeros((k, assigned.shape[1]), dtype=torch.int32,
                        device=assigned.device)
    table.index_add_(0, code, assigned)
    sib_all = table[code]
    return sib_all, sib_all - assigned


def _cp_priced(scores, lam, sib):
    """f32[G, N] priced utilities (elementwise)."""
    return scores - lam[None, :] - float(ANTI) * sib.to(torch.float32)


def _cp_gang_priced(scores, lam, sib, topo):
    """f32[G, N] priced utilities with the signed topology term added."""
    return scores - lam[None, :] - float(ANTI) * sib.to(torch.float32) + topo


def _cp_winners(umask, feas, active, prio):
    """One auction round's selection. Every unfinished group claims its
    argmax feasible node; each claimed node admits the claimant with the
    highest (priority, priced utility) — two masked maxes, first index.
    Returns (claim i32[G], claimable bool[G], won bool[G], win i32[N],
    has bool[N], claims i32[N])."""
    g, n = umask.shape
    ar_g = torch.arange(g, device=umask.device)
    ar_n = torch.arange(n, device=umask.device)
    claim, _ = _first_argmax(umask)
    claimable = active & feas.any(dim=1)
    claim_m = claimable[:, None] & (claim[:, None] == ar_n[None, :])
    prio_m = torch.where(claim_m, prio[:, None], -torch.inf)
    maxprio = prio_m.amax(dim=0)  # f32[N]
    uclaim = umask[ar_g, claim]
    conf_ok = claim_m & (prio[:, None] == maxprio[None, :])
    conf_m = torch.where(conf_ok, uclaim[:, None], -torch.inf)
    win, _ = _first_argmax(conf_m.T)
    has = claim_m.any(dim=0)
    won = claimable & has[claim] & (win[claim] == ar_g)
    claims = claim_m.to(torch.int32).sum(dim=0, dtype=torch.int32)
    return claim.to(torch.int32), claimable, won, win.to(torch.int32), has, claims


def _cp_topo_quant(w):
    """i32[G] topology weights on the 1/256 grid (round-half-even)."""
    return torch.round(w * TOPO_WEIGHT_SCALE).to(torch.int32)


def _onehot_ids(oh, what="level_oh"):
    """i32[N] level coordinate ids of an i32[N, W] one-hot (0 = no
    coordinate: an all-zero row). Raises unless every row holds at most
    one 1, column 0 (the coordinate-less id) is zero, as ``topo_onehot``
    builds them."""
    bad = (oh < 0) | (oh > 1)
    # one host sync: the kernel indexes its coordinate tables by these ids
    if bool(bad.any() | (oh.sum(dim=1) > 1).any() | (oh[:, 0] != 0).any()):  # nta: allow=NTA002
        raise ValueError(f"{what}: not a one-hot with column 0 zeroed")
    return torch.where(oh.any(dim=1), oh.argmax(dim=1), 0).to(torch.int32)


def _cp_topo_mates(gang, assigned, level_oh):
    """i32[G, N]: for each group row, how many gang-mate instances
    (itself included) are already committed on nodes sharing each node's
    coordinate at one topology level, from an i32[N, W] one-hot — the
    reference's one-hot product as a per-(gang, coordinate) count
    table."""
    return _cp_topo_mates_ids(
        gang, assigned, _onehot_ids(level_oh).long(), level_oh.shape[1]
    )


def _cp_topo_mates_ids(gang, assigned, ids, width):
    """``_cp_topo_mates`` from the level's i64[N] coordinate ids in [0,
    width). Gang id 0 and coordinate 0 count nothing."""
    g, n = assigned.shape
    dev = assigned.device
    member = gang > 0
    code, k = _codes(torch.where(member, gang, 0))
    # code 0 is gang id 0 when any group is gang-less; send those rows to
    # a row that is never read back
    slot = torch.where(member, code, k)
    per_gang = torch.zeros((k + 1, n), dtype=torch.int32, device=dev)
    per_gang.index_add_(0, slot, assigned)
    table = torch.zeros((k + 1, width), dtype=torch.int32, device=dev)
    table.index_add_(1, ids, per_gang)
    table[:, 0] = 0
    table[k] = 0
    return table[slot][:, ids]


def _cp_topo_term(q_rack, q_pod, q_ici, mates_rack, mates_pod, mates_ici):
    """f32[G, N] signed topology term: an integer weighted sum over the
    three levels, then one exact power-of-two rescale."""
    acc = (
        q_rack[:, None] * mates_rack
        + q_pod[:, None] * mates_pod
        + q_ici[:, None] * mates_ici
    )
    return acc.to(torch.float32) * (1.0 / TOPO_WEIGHT_SCALE)


def _auction_plain(capacity, used0, asks, counts, eligible, scores, prio,
                   job_counts, distinct, jobgrp, lam0, steps, max_c,
                   topo=None):
    """The reference's while-loop, round by round. ``topo(assigned)``
    gives the gang term; None runs the plain auction."""
    g, n = scores.shape
    dev = scores.device
    ar_g = torch.arange(g, device=dev)
    ar_n = torch.arange(n, device=dev)
    used = used0.clone()
    placed = torch.zeros(g, dtype=torch.int32, device=dev)
    assigned = torch.zeros((g, n), dtype=torch.int32, device=dev)
    choices = torch.full((g, max_c), -1, dtype=torch.int32, device=dev)
    choice_scores = torch.zeros((g, max_c), dtype=torch.float32, device=dev)
    lam = lam0.clone()
    waits = torch.zeros(g, dtype=torch.int32, device=dev)
    it = rounds = 0
    progress = True
    while it < steps and progress:
        sib_all, sib_other = _cp_siblings(jobgrp, assigned)
        feas = _cp_feasible(
            capacity, used, asks, eligible, job_counts, sib_all, distinct
        )
        active = placed < counts
        if topo is None:
            priced = _cp_priced(scores, lam, sib_other)
        else:
            priced = _cp_gang_priced(scores, lam, sib_other, topo(assigned))
        umask = torch.where(feas, priced, -torch.inf)
        claim, claimable, won, win, has, claims = _cp_winners(
            umask, feas, active, prio
        )
        waits = waits + (claimable & ~won).to(torch.int32)
        delta = torch.where(has[:, None], asks[win.long()], 0.0)
        used = used + delta
        slot = torch.clamp(placed, max=max_c - 1).long()
        old_c = choices[ar_g, slot]
        old_s = choice_scores[ar_g, slot]
        choices[ar_g, slot] = torch.where(won, claim, old_c)
        choice_scores[ar_g, slot] = torch.where(
            won, scores[ar_g, claim.long()], old_s
        )
        onehot = won[:, None] & (claim[:, None] == ar_n[None, :])
        assigned = assigned + onehot.to(torch.int32)
        placed = placed + won.to(torch.int32)
        lam = lam + float(ETA) * torch.clamp(claims - 1, min=0).to(torch.float32)
        lam = torch.where(
            claims == 0, torch.clamp(lam - float(ETA), min=0.0), lam
        )
        progress = bool(claimable.any())
        rounds += int(progress)
        it += 1
    rounds_t = torch.tensor(rounds, dtype=torch.int32, device=dev)
    return choices, choice_scores, used, rounds_t, lam, waits


def _cp_specs(capacity, used0, asks, counts, eligible, scores, prio,
              job_counts, distinct, jobgrp, lam0):
    g, n = scores.shape
    return [
        ("capacity", capacity, torch.float32, (n, 4)),
        ("used0", used0, torch.float32, (n, 4)),
        ("asks", asks, torch.float32, (g, 4)),
        ("counts", counts, torch.int32, (g,)),
        ("eligible", eligible, torch.bool, (g, n)),
        ("scores", scores, torch.float32, (g, n)),
        ("prio", prio, torch.float32, (g,)),
        ("job_counts", job_counts, torch.int32, (g, n)),
        ("distinct", distinct, torch.bool, (g,)),
        ("jobgrp", jobgrp, torch.int32, (g,)),
        ("lam0", lam0, torch.float32, (n,)),
    ]


def _gang_specs(g, gang, w_rack, w_pod, w_ici):
    return [
        ("gang", gang, torch.int32, (g,)),
        ("w_rack", w_rack, torch.float32, (g,)),
        ("w_pod", w_pod, torch.float32, (g,)),
        ("w_ici", w_ici, torch.float32, (g,)),
    ]


def _check_cp(what, common, max_c) -> None:
    same_device(common, common[0].device, what)
    n = common[5].shape[1]
    _check_inputs(what, _cp_specs(*common))
    if n < 1 or max_c < 1:
        raise ValueError(f"{what}: unsupported shape N={n} C={max_c}")


def _gang_ids(what, common, gang, w_rack, w_pod, w_ici, rack_oh, pod_oh, ici_oh):
    """The gang inputs of the one-hot signature checked, as the id form
    ``cp_gang_place_ids`` takes: (gang, w_rack, w_pod, w_ici, level_ids
    i32[3, N], widths)."""
    levels = (rack_oh, pod_oh, ici_oh)
    same_device([gang, w_rack, w_pod, w_ici, *levels], common[0].device, what)
    g, n = common[5].shape
    _check_inputs(what, _gang_specs(g, gang, w_rack, w_pod, w_ici) + [
        (name, oh, torch.int32, (n, oh.shape[1]))
        for name, oh in zip(("rack_oh", "pod_oh", "ici_oh"), levels)
    ])
    widths = tuple(int(oh.shape[1]) for oh in levels)
    if min(widths) < 1:
        raise ValueError(f"{what}: unsupported level widths {widths}")
    level_ids = torch.stack([
        _onehot_ids(oh, name) for name, oh in zip(("rack_oh", "pod_oh", "ici_oh"), levels)
    ])
    return gang, w_rack, w_pod, w_ici, level_ids, widths


def _check_gang(what, common, gang_args) -> None:
    """The id form's gang inputs: shapes, and every id in [0, width)
    (one host sync)."""
    gang, w_rack, w_pod, w_ici, level_ids, widths = gang_args
    same_device([gang, w_rack, w_pod, w_ici, level_ids], common[0].device, what)
    g, n = common[5].shape
    _check_inputs(what, _gang_specs(g, gang, w_rack, w_pod, w_ici) + [
        ("level_ids", level_ids, torch.int32, (3, n)),
    ])
    if len(widths) != 3 or min(widths) < 1:
        raise ValueError(f"{what}: unsupported level widths {tuple(widths)}")
    top = torch.tensor(widths, dtype=torch.int32, device=level_ids.device)
    # one host sync: the kernel indexes its coordinate tables by these ids
    if bool(((level_ids < 0) | (level_ids >= top[:, None])).any()):  # nta: allow=NTA002
        raise ValueError(f"{what}: a level id outside [0, width)")


def _gang_plain(common, gang_args, steps, max_c):
    gang, w_rack, w_pod, w_ici, level_ids, widths = gang_args
    q = [_cp_topo_quant(w) for w in (w_rack, w_pod, w_ici)]
    ids = level_ids.long()

    def topo(assigned):
        mates = [_cp_topo_mates_ids(gang, assigned, ids[i], widths[i]) for i in range(3)]
        return _cp_topo_term(*q, *mates)

    return _auction_plain(*common, steps, max_c, topo=topo)


def cp_place_plain(capacity, used0, asks, counts, eligible, scores, prio,
                   job_counts, distinct, jobgrp, lam0, steps: int, max_c: int):
    """Plain PyTorch version of ``cp_place``."""
    common = (capacity, used0, asks, counts, eligible, scores, prio,
              job_counts, distinct, jobgrp, lam0)
    _check_cp("cp_place_plain", common, max_c)
    return _auction_plain(*common, steps, max_c)[:5]


def cp_gang_place_plain(capacity, used0, asks, counts, eligible, scores,
                        prio, job_counts, distinct, jobgrp, gang, w_rack,
                        w_pod, w_ici, rack_oh, pod_oh, ici_oh, lam0,
                        steps: int, max_c: int):
    """Plain PyTorch version of ``cp_gang_place``."""
    common = (capacity, used0, asks, counts, eligible, scores, prio,
              job_counts, distinct, jobgrp, lam0)
    _check_cp("cp_gang_place_plain", common, max_c)
    gang_args = _gang_ids("cp_gang_place_plain", common, gang, w_rack, w_pod,
                          w_ici, rack_oh, pod_oh, ici_oh)
    return _gang_plain(common, gang_args, steps, max_c)


def cp_gang_place_ids_plain(capacity, used0, asks, counts, eligible, scores,
                            prio, job_counts, distinct, jobgrp, gang, w_rack,
                            w_pod, w_ici, level_ids, widths, lam0,
                            steps: int, max_c: int):
    """Plain PyTorch version of ``cp_gang_place_ids``."""
    common = (capacity, used0, asks, counts, eligible, scores, prio,
              job_counts, distinct, jobgrp, lam0)
    gang_args = (gang, w_rack, w_pod, w_ici, level_ids, tuple(widths))
    _check_cp("cp_gang_place_ids_plain", common, max_c)
    _check_gang("cp_gang_place_ids_plain", common, gang_args)
    return _gang_plain(common, gang_args, steps, max_c)


# -- the kernels ---------------------------------------------------------------


_CP_ARGTYPES = (
    [ctypes.c_void_p] * 9  # capacity, asks, counts, eligible, scores, prio,
    # job_counts, distinct, job_code
    + [ctypes.c_int]  # n_jobs
    + [ctypes.c_void_p] * 5  # gang_code, q_rack, q_pod, q_ici, level ids
    + [ctypes.c_int] * 8  # n_gangs, widths (3), g, n, steps, max_c
    + [ctypes.c_void_p] * 8  # scratch, used, lam, choices, choice_scores,
    # rounds, waits, stream
)
_SCRATCH_ARGTYPES = [ctypes.c_int] * 8  # g, n, jobs, gangs, widths (3), gang?


def _cp_library(symbol: str, argtypes):
    fn = getattr(cuda_library("cp"), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_longlong if symbol.endswith("words") else ctypes.c_int
    return fn


def _launch_auction(what, common, steps, max_c, gang_args=None):
    """Outputs allocated, codes derived, one launch of ``nomad_cp_place``
    (the gang term on when ``gang_args``, the id form, is given), counted
    on the wrapper ``what``. Returns (choices, choice_scores, used,
    rounds, lam, waits)."""
    call = _auction_call(what, common, steps, max_c, gang_args)
    if call is None:
        return _auction_outputs(common, max_c)
    call()
    # the module-level name, so a stand-in for the wrapper sees the count
    count_launch(globals()[what])
    return call.outputs


def _auction_outputs(common, max_c):
    """Fresh outputs holding the pass's initial values."""
    used0, scores, lam0 = common[1], common[5], common[10]
    g = scores.shape[0]
    dev = scores.device
    return (
        torch.full((g, max_c), -1, dtype=torch.int32, device=dev),
        torch.zeros((g, max_c), dtype=torch.float32, device=dev),
        used0.clone(),
        torch.zeros((), dtype=torch.int32, device=dev),
        lam0.clone(),
        torch.zeros(g, dtype=torch.int32, device=dev),
    )


class _AuctionCall:
    """One prepared launch: the derived inputs (dense job and gang codes,
    quantized weights), the zero-filled scratch and the
    outputs. Calling it resets the outputs and the scratch, then launches
    on the current stream, with no host sync (``chip_smoke.py`` times it
    so)."""

    def __init__(self, what, common, steps, max_c, gang_args):
        (capacity, used0, asks, counts, eligible, scores, prio, job_counts,
         distinct, jobgrp, lam0) = common
        self.what, self.common = what, common
        self.steps, self.max_c = int(steps), int(max_c)
        g, n = scores.shape
        self.dev = dev = capacity.device
        job_code, self.n_jobs = _codes(jobgrp)
        self.job_code = job_code.to(torch.int32)
        self.gang = []  # keeps the derived gang tensors alive
        self.n_gangs, self.widths = 0, [1, 1, 1]
        if gang_args is not None:
            gang, w_rack, w_pod, w_ici, level_ids, widths = gang_args
            member = gang > 0
            code, self.n_gangs = _codes(torch.where(member, gang, 0))
            q = torch.stack([_cp_topo_quant(w) for w in (w_rack, w_pod, w_ici)])
            self.gang = [
                torch.where(member, code, -1).to(torch.int32), q[0], q[1], q[2],
                level_ids,
            ]
            self.widths = [int(w) for w in widths]
        with torch.cuda.device(dev):
            words = _cp_library("nomad_cp_scratch_words", _SCRATCH_ARGTYPES)(
                g, n, self.n_jobs, self.n_gangs, *self.widths,
                int(gang_args is not None),
            )
        if words < 0:
            raise RuntimeError(f"{what}: scratch sizing failed with cudaError {-words}")
        self.scratch = torch.zeros(int(words), dtype=torch.int32, device=dev)
        self.outputs = _auction_outputs(common, max_c)

    def reset(self):
        choices, choice_scores, used, rounds, lam, waits = self.outputs
        choices.fill_(-1)
        choice_scores.zero_()
        used.copy_(self.common[1])
        rounds.zero_()
        lam.copy_(self.common[10])
        waits.zero_()
        self.scratch.zero_()

    def __call__(self, reset=False):
        if reset:
            self.reset()
        c, out = self.common, self.outputs
        g, n = c[5].shape
        gang_ptrs = [t.data_ptr() for t in self.gang] or [None] * 5
        with torch.cuda.device(self.dev):
            status = _cp_library("nomad_cp_place", _CP_ARGTYPES)(
                *[t.data_ptr() for t in (c[0], *c[2:9])],
                self.job_code.data_ptr(), self.n_jobs, *gang_ptrs,
                self.n_gangs, *self.widths, g, n, self.steps, self.max_c,
                self.scratch.data_ptr(),
                *[out[i].data_ptr() for i in (2, 4, 0, 1, 3, 5)],
                current_stream(self.dev),
            )
        check_launch(status, self.what)


def _auction_call(what, common, steps, max_c, gang_args=None):
    """The prepared launch, or None when there is nothing to run."""
    if common[5].shape[0] == 0 or steps < 1:
        return None
    return _AuctionCall(what, common, steps, max_c, gang_args)


@guarded(
    "cp_place_kernel",
    sharded=lambda *a, **kw: cp_place_sharded(*a, **kw),
    # a build budget of 1: the one load of csrc/cp.cu a process makes
    build_budget=1,
    library="cp",
    symbols=("nomad_cp_place", "nomad_sharded_cp"),
)
def cp_place(
    capacity,  # f32[N, 4]
    used0,  # f32[N, 4]
    asks,  # f32[G, 4]
    counts,  # i32[G]
    eligible,  # bool[G, N]
    scores,  # f32[G, N] dense score matrix (registry score_group finals)
    prio,  # f32[G] job priority (exact small ints)
    job_counts,  # i32[G, N] existing same-job allocs per node
    distinct,  # bool[G] distinct_hosts groups
    jobgrp,  # i32[G] job grouping codes (same job → same code)
    lam0,  # f32[N] initial prices
    steps: int,
    max_c: int,
):
    """Iterated proportional rounding — the port of ``cp_place_kernel``.
    Returns (choices i32[G, C], choice_scores f32[G, C], used f32[N, 4],
    rounds i32 (0-dim), lam f32[N]). CPU tensors run the plain version;
    CUDA tensors launch ``csrc/cp.cu``."""
    common = (capacity, used0, asks, counts, eligible, scores, prio,
              job_counts, distinct, jobgrp, lam0)
    if capacity.device.type == "cpu":
        return cp_place_plain(*common, steps, max_c)
    _check_cp("cp_place", common, max_c)
    return _launch_auction("cp_place", common, steps, max_c)[:5]


cp_place.launches = 0
cp_place.plain_calls = 0  # a CPU mesh's gathered calls


@guarded(
    "cp_gang_place_kernel",
    sharded=lambda *a, **kw: cp_gang_place_sharded(*a, **kw),
    # a build budget of 1: the one load of csrc/cp.cu a process makes
    build_budget=1,
    library="cp",
    symbols=("nomad_cp_place", "nomad_sharded_cp"),
)
def cp_gang_place(
    capacity, used0, asks, counts, eligible, scores, prio, job_counts,
    distinct, jobgrp,
    gang,  # i32[G] gang ids (0 = not ganged)
    w_rack,  # f32[G] signed rack-level topology weight (+colocate/−spread)
    w_pod,  # f32[G] signed pod-level topology weight
    w_ici,  # f32[G] signed ici-level topology weight
    rack_oh,  # i32[N, R] one-hot rack ids (col 0 zeroed)
    pod_oh,  # i32[N, P] one-hot pod ids (col 0 zeroed)
    ici_oh,  # i32[N, I] one-hot ici slice ids (col 0 zeroed)
    lam0,  # f32[N]
    steps: int,
    max_c: int,
):
    """cp_place plus gang topology pricing and reservation holds — the
    port of ``cp_gang_place_kernel``. Returns cp_place's tuple plus
    ``waits`` i32[G]: rounds a group was claimable but lost its node.
    CPU tensors run the plain version; CUDA tensors launch
    ``csrc/cp.cu``."""
    common = (capacity, used0, asks, counts, eligible, scores, prio,
              job_counts, distinct, jobgrp, lam0)
    if capacity.device.type == "cpu":
        return cp_gang_place_plain(*common[:10], gang, w_rack, w_pod, w_ici,
                                   rack_oh, pod_oh, ici_oh, lam0, steps, max_c)
    _check_cp("cp_gang_place", common, max_c)
    gang_args = _gang_ids("cp_gang_place", common, gang, w_rack, w_pod, w_ici,
                          rack_oh, pod_oh, ici_oh)
    return _launch_auction("cp_gang_place", common, steps, max_c, gang_args)


cp_gang_place.launches = 0
cp_gang_place.plain_calls = 0


@guarded(
    "cp_gang_place_kernel",
    sharded=lambda *a, **kw: cp_gang_place_ids_sharded(*a, **kw),
    # a build budget of 1: the one load of csrc/cp.cu a process makes
    build_budget=1,
    library="cp",
    symbols=("nomad_cp_place", "nomad_sharded_cp"),
)
def cp_gang_place_ids(
    capacity, used0, asks, counts, eligible, scores, prio, job_counts,
    distinct, jobgrp, gang, w_rack, w_pod, w_ici,
    level_ids,  # i32[3, N] rack / pod / ici coordinate ids (0 = none)
    widths,  # (R, P, I): each level's id bound
    lam0,
    steps: int,
    max_c: int,
):
    """``cp_gang_place`` on per-node coordinate ids instead of one-hots:
    the same outputs, without an [N, W] one-hot per level to build and
    move. The kernel object's path; a launch counts on
    ``cp_gang_place``. CPU tensors run the plain version; CUDA tensors
    launch ``csrc/cp.cu``."""
    common = (capacity, used0, asks, counts, eligible, scores, prio,
              job_counts, distinct, jobgrp, lam0)
    if capacity.device.type == "cpu":
        return cp_gang_place_ids_plain(*common[:10], gang, w_rack, w_pod, w_ici,
                                       level_ids, widths, lam0, steps, max_c)
    gang_args = (gang, w_rack, w_pod, w_ici, level_ids, tuple(widths))
    _check_cp("cp_gang_place_ids", common, max_c)
    _check_gang("cp_gang_place_ids", common, gang_args)
    return _launch_auction("cp_gang_place", common, steps, max_c, gang_args)


# -- the auction under a node-axis mesh ----------------------------------------
#
# Cell (i, j) of a dp x mp mesh holds groups row i's slice of the groups
# (g0 its first) and column j's slice of the nodes (col0 its first), and
# keeps what a round reads of them: the usage and prices of its nodes,
# its groups' assignments there, the per-(job, node) sibling counts of
# its nodes, its groups' placements, and a copy of the per-(gang,
# coordinate) topology tables (integer counts, the same in every cell).
# A round:
#  - ``cp_shard_claim``, a launch a cell: each of its groups short of its
#    count prices the cell's nodes as the one-device row pass does and
#    reports its best word (order key of u, global node; infeasible nodes
#    at -inf, the lowest node first on ties), whether any node of the
#    cell is feasible, score[g, node]'s bits and the node's coordinates;
#  - ``cp_round_merge``, on the mesh lead over every group: each group's
#    claim (the best word over the columns), then per claimed node the
#    claims, the highest (priority, u) and the least group reaching it:
#    the winner, whose ask the node's usage grows by, and the -inf rule
#    for group 0, as the one-device settle; the winners' slots, placed,
#    waits and rounds; the round's record (the claimed nodes sorted by
#    node);
#  - ``cp_shard_settle``, a launch a cell: on every node of the cell,
#    usage += (claims ? ask : 0.0) and the price update, then the winners'
#    assignments, sibling counts, placements and topology counts.
# A round where no group can claim runs (its decay stands) and ends the
# pass: its record's state is 1, and every later round's is 2 (nothing).

# the round's record: state (0 a round, 1 the last round, 2 past the
# end), the number M of claimed nodes, then M entries sorted by node
_CREC_STATE, _CREC_M, _CREC_HEAD = 0, 1, 2
# an entry: node, claims, winner (-1 none), the winner's job code and gang
# code (-1 none), the node's rack, pod and ici ids, the ask's 4 bits
CP_ENTRY = 12
_E_NODE, _E_CLAIMS, _E_WON, _E_JOB, _E_GANG, _E_IDS, _E_ASK = 0, 1, 2, 3, 4, 5, 8
# a candidate: u's order key (0: the group is done), the global node,
# any feasible node, score[g, node]'s bits, the node's rack, pod, ici ids
CP_CAND = 7
# ints a group of the merge's scratch takes (csrc/cp.cu kMergeWords)
_CP_MERGE_WORDS = 11


def cp_record_words(g: int) -> int:
    return _CREC_HEAD + g * CP_ENTRY


def _mates(table, gang_code, ids):
    """i32[G, n] gang-mate counts at one level from a per-(gang,
    coordinate) table: 0 for gang-less groups and coordinate 0."""
    gc = gang_code.long()
    ids = ids.long()
    m = table[gc.clamp(min=0)][:, ids]
    return torch.where((gc >= 0)[:, None] & (ids > 0)[None, :], m, 0)


def cp_shard_claim_plain(capacity, used, asks, counts, eligible, scores, job_counts,
                         distinct, job_code, lam, assigned, sib, placed, col0: int,
                         gang=None, cells: int = 1):
    """The plain version of ``cp_shard_claim``: the candidates
    i32[cells, G, 7] of ``cells`` cells side by side on the node axis
    (each ``n / cells`` nodes, the first global node ``col0``). ``sib``
    i32[jobs, n] holds the per-(job, node) counts of the cell's nodes,
    ``job_code`` i32[G] its groups' rows of it; ``gang`` (gang_code,
    q_rack, q_pod, q_ici, level_ids i32[3, n], t_rack, t_pod, t_ici) adds
    the topology term."""
    g, n = scores.shape
    seg = n // cells
    dev = scores.device
    sib_all = sib[job_code.long()]
    feas = _cp_feasible(capacity, used, asks, eligible, job_counts, sib_all, distinct)
    if gang is None:
        priced = _cp_priced(scores, lam, sib_all - assigned)
    else:
        gang_code, q_rack, q_pod, q_ici, level_ids, *tables = gang
        mates = [_mates(t, gang_code, level_ids[i]) for i, t in enumerate(tables)]
        topo = _cp_topo_term(q_rack, q_pod, q_ici, *mates)
        priced = _cp_gang_priced(scores, lam, sib_all - assigned, topo)
    u = torch.where(feas, priced, -torch.inf)
    keys = _order_keys(u).view(g, cells, seg)
    best = keys.amax(dim=2)
    ar = torch.arange(seg, device=dev)
    low = torch.where(keys == best[..., None], ar, seg).amin(dim=2)  # [G, cells]
    active = (placed < counts)[:, None]
    node = low + col0 + torch.arange(cells, device=dev)[None, :] * seg
    flat = low + torch.arange(cells, device=dev)[None, :] * seg  # local to the call
    out = torch.zeros((cells, g, CP_CAND), dtype=torch.int32, device=dev)
    out[..., 0] = torch.where(active, _i32(best), 0).T
    out[..., 1] = torch.where(active, node, -1).T.to(torch.int32)
    out[..., 2] = (feas.view(g, cells, seg).any(dim=2) & active).T.to(torch.int32)
    sbits = torch.gather(scores, 1, flat).view(torch.int32)
    out[..., 3] = torch.where(active, sbits, 0).T
    if gang is not None:
        for i in range(3):
            out[..., 4 + i] = torch.where(active, gang[4][i][flat], 0).T
    return out


def cp_round_merge_plain(cand, prio, asks, job_code, gang_code, placed, waits, rounds,
                         choices, choice_scores, record):
    """The plain version of ``cp_round_merge``: the columns' candidates
    ``cand`` i32[S, G, 7] become the round's claims, winners and record.
    ``record`` is the previous round's: past the end of the pass (its
    state not 0) the round does nothing (state 2). Returns (record,
    placed, waits, rounds, choices, choice_scores), the inputs left as
    they were."""
    s, g, _ = cand.shape
    dev = cand.device
    placed, waits, rounds = placed.clone(), waits.clone(), rounds.clone()
    choices, choice_scores = choices.clone(), choice_scores.clone()
    out = torch.zeros(cp_record_words(g), dtype=torch.int32, device=dev)
    if int(record[_CREC_STATE]) != 0:
        out[_CREC_STATE] = 2
        return out, placed, waits, rounds, choices, choice_scores
    key = cand[..., 0].long() & 0xFFFFFFFF
    rank = torch.where(key > 0, key * 2**31 + (2**31 - 1 - cand[..., 1].long()), -1)
    best = torch.gather(cand, 0, rank.argmax(dim=0)[None, :, None].expand(1, g, CP_CAND))[0]
    claimable = (cand[..., 2] != 0).any(dim=0)
    node = best[:, 1].long()
    ukey = best[:, 0].long() & 0xFFFFFFFF
    pkey = _order_keys(prio)
    ar = torch.arange(g, device=dev)
    same = claimable[:, None] & claimable[None, :] & (node[:, None] == node[None, :])
    claims = same.sum(dim=1)
    maxp = torch.where(same, pkey[None, :], -1).amax(dim=1, keepdim=True)
    at_top = same & (pkey[None, :] == maxp)
    top_u = torch.where(at_top, ukey[None, :], -1).amax(dim=1, keepdim=True)
    least = torch.where(at_top & (ukey[None, :] == top_u), ar[None, :], g).amin(dim=1)
    finite = top_u[:, 0] > _NEG_INF_KEY
    zero_here = claimable[0] & (node == node[0]) if g else claimable
    won_n = torch.where(finite, least, torch.where(zero_here, 0, -1))
    ask_row = torch.where(finite, least, 0)
    won = claimable & (won_n == ar)
    waits += (claimable & ~won).to(torch.int32)
    slot = torch.clamp(placed, max=choices.shape[1] - 1).long()
    w = ar[won]
    choices[w, slot[won]] = node[won].to(torch.int32)
    choice_scores[w, slot[won]] = best[won, 3].view(torch.float32)
    placed += won.to(torch.int32)
    progress = bool(claimable.any())
    rounds += int(progress)
    rep = claimable & ~(same & (ar[None, :] < ar[:, None])).any(dim=1)
    reps = ar[rep]
    reps = reps[torch.argsort(node[reps])]
    m = reps.numel()
    entries = torch.zeros((m, CP_ENTRY), dtype=torch.int32, device=dev)
    wn = won_n[reps]
    has = wn >= 0
    entries[:, _E_NODE] = node[reps].to(torch.int32)
    entries[:, _E_CLAIMS] = claims[reps].to(torch.int32)
    entries[:, _E_WON] = wn.to(torch.int32)
    entries[:, _E_JOB] = torch.where(has, job_code[wn.clamp(min=0)], -1)
    entries[:, _E_GANG] = (torch.where(has, gang_code[wn.clamp(min=0)], -1)
                           if gang_code is not None else -1)
    entries[:, _E_IDS:_E_IDS + 3] = best[reps, 4:7]
    entries[:, _E_ASK:] = asks[ask_row[reps]].contiguous().view(torch.int32)
    out[_CREC_STATE] = 0 if progress else 1
    out[_CREC_M] = m
    out[_CREC_HEAD:_CREC_HEAD + m * CP_ENTRY] = entries.reshape(-1)
    return out, placed, waits, rounds, choices, choice_scores


def cp_shard_settle_plain(record, used, lam, assigned, sib, placed, col0: int, g0: int,
                          t_rack=None, t_pod=None, t_ici=None):
    """The plain version of ``cp_shard_settle``: one cell's state after a
    round's record — usage f32[n, 4] and prices f32[n] of nodes [col0,
    col0 + n) (every node: usage += (claims ? ask : 0.0), the price
    update), its groups' assignments i32[g, n] and placements i32[g]
    (groups [g0, g0 + g)), the sibling counts i32[jobs, n] and, when
    given, the topology tables. Returns them all, the inputs left as they
    were."""
    used, lam, assigned, sib, placed = (x.clone() for x in (used, lam, assigned, sib, placed))
    tables = [] if t_rack is None else [t.clone() for t in (t_rack, t_pod, t_ici)]
    out = (used, lam, assigned, sib, placed, *tables)
    if int(record[_CREC_STATE]) == 2:
        return out
    m = int(record[_CREC_M])
    e = record[_CREC_HEAD:_CREC_HEAD + m * CP_ENTRY].view(m, CP_ENTRY).long()
    n, g = used.shape[0], placed.shape[0]
    node = e[:, _E_NODE] - col0
    inside = (node >= 0) & (node < n)
    claims = torch.zeros(n, dtype=torch.int32, device=used.device)
    claims[node[inside]] = e[inside, _E_CLAIMS].to(torch.int32)
    delta = torch.zeros_like(used)
    delta[node[inside]] = e[inside, _E_ASK:].to(torch.int32).view(torch.float32)
    used += delta
    lam += float(ETA) * torch.clamp(claims - 1, min=0).to(torch.float32)
    lam.copy_(torch.where(claims == 0, torch.clamp(lam - float(ETA), min=0.0), lam))
    won = e[:, _E_WON]
    row = won - g0
    mine = (won >= 0) & (row >= 0) & (row < g)
    here = (won >= 0) & inside
    assigned[row[mine & inside], node[mine & inside]] += 1
    sib[e[here, _E_JOB], node[here]] += 1
    placed[row[mine]] += 1
    if tables:
        ganged = (won >= 0) & (e[:, _E_GANG] >= 0)
        for i, t in enumerate(tables):
            ids = e[:, _E_IDS + i]
            hit = ganged & (ids > 0)
            t.index_put_((e[hit, _E_GANG], ids[hit]),
                         torch.ones(int(hit.sum()), dtype=torch.int32, device=t.device),
                         accumulate=True)
    return out


def _cp_fn(symbol: str):
    fn = getattr(cuda_library("cp"), symbol)
    if fn.argtypes is None:
        fn.argtypes = _CP_MESH_ARGTYPES[symbol]
        fn.restype = ctypes.c_int
    return fn


_CP_MESH_ARGTYPES = {
    # capacity ... placed (13), gang_code, q_rack, q_pod, q_ici, level_ids,
    # t_rack, t_pod, t_ici (8); wr, wp, wi, g, n, col0; cand, stream
    "nomad_cp_shard_claim": [ctypes.c_void_p] * 21 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2,
    # cand; cells, g; prio, asks, job_code, gang_code; max_c; placed,
    # waits, rounds, choices, choice_scores, record, scratch, stream
    "nomad_cp_round_merge": (
        [ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int]
        + [ctypes.c_void_p] * 8
    ),
    # record, used, lam, assigned, sib, placed, t_rack, t_pod, t_ici;
    # wr, wp, wi, n, g, col0, g0; stream
    "nomad_cp_shard_settle": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    # rows, mp, devices, ptrs, gseg, seg, jobs, gangs, wr, wp, wi, gang,
    # steps, max_c, poll, launched
    "nomad_sharded_cp": (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 10 + [ctypes.c_void_p] * 2
    ),
    "nomad_cp_cell_ptrs": [],
}


def _widths_of(tables):
    """The topology tables' widths, or 1s (read by no launch) without them."""
    return [int(t.shape[1]) for t in tables] if tables else [1, 1, 1]


@inside_guard(
    "cp_shard_claim",
    # it launches inside the auction's guard
    guard="cp_place_kernel",
    # a build budget of 1: it shares csrc/cp.cu's one load
    build_budget=1,
    library="cp",
    symbols=("nomad_cp_shard_claim",),
)
def cp_shard_claim(capacity, used, asks, counts, eligible, scores, job_counts, distinct,
                   job_code, lam, assigned, sib, placed, col0: int, gang=None):
    """One mesh cell's candidates i32[1, G, 7] for a round of the sharded
    auction (see ``cp_shard_claim_plain``). CPU tensors run the plain
    version; CUDA tensors launch ``csrc/cp.cu``'s
    ``cp_shard_claim_kernel``, a block a group."""
    args = (capacity, used, asks, counts, eligible, scores, job_counts, distinct, job_code,
            lam, assigned, sib, placed)
    if capacity.device.type == "cpu":
        return cp_shard_claim_plain(*args, col0, gang)
    dev = capacity.device
    g, n = scores.shape
    same_device([*args, *(gang or ())], dev, "cp_shard_claim")
    _check_inputs("cp_shard_claim", [
        ("capacity", capacity, torch.float32, (n, 4)),
        ("used", used, torch.float32, (n, 4)),
        ("asks", asks, torch.float32, (g, 4)),
        ("counts", counts, torch.int32, (g,)),
        ("eligible", eligible, torch.bool, (g, n)),
        ("scores", scores, torch.float32, (g, n)),
        ("job_counts", job_counts, torch.int32, (g, n)),
        ("distinct", distinct, torch.bool, (g,)),
        ("job_code", job_code, torch.int32, (g,)),
        ("lam", lam, torch.float32, (n,)),
        ("assigned", assigned, torch.int32, (g, n)),
        ("sib", sib, torch.int32, (sib.shape[0], n)),
        ("placed", placed, torch.int32, (g,)),
    ] + ([] if gang is None else [
        (name, t, torch.int32, (g,))
        for name, t in zip(("gang_code", "q_rack", "q_pod", "q_ici"), gang[:4])
    ] + [("level_ids", gang[4], torch.int32, (3, n))] + [
        (name, t, torch.int32, (t.shape[0], t.shape[1]))
        for name, t in zip(("t_rack", "t_pod", "t_ici"), gang[5:])
    ]))
    cand = torch.zeros((1, g, CP_CAND), dtype=torch.int32, device=dev)
    if g == 0:
        return cand
    gang_ptrs = [None] * 8 if gang is None else [t.data_ptr() for t in gang]
    status = _cp_fn("nomad_cp_shard_claim")(
        *[t.data_ptr() for t in args], *gang_ptrs,
        *_widths_of(() if gang is None else gang[5:]), g, n, int(col0),
        cand.data_ptr(), current_stream(dev),
    )
    check_launch(status, "cp_shard_claim")
    count_launch(cp_shard_claim)
    return cand


cp_shard_claim.launches = 0
cp_shard_claim.plain_calls = 0  # a CPU mesh's round loop: its plain calls


@inside_guard(
    "cp_round_merge",
    guard="cp_place_kernel",
    # a build budget of 1: it shares csrc/cp.cu's one load
    build_budget=1,
    library="cp",
    symbols=("nomad_cp_round_merge",),
)
def cp_round_merge(cand, prio, asks, job_code, gang_code, placed, waits, rounds, choices,
                   choice_scores, record):
    """One round's merge on the mesh lead (see ``cp_round_merge_plain``);
    returns (record, placed, waits, rounds, choices, choice_scores), the
    inputs left as they were. CPU tensors run the plain version; CUDA
    tensors launch ``csrc/cp.cu``'s ``cp_round_merge_kernel``, one
    block."""
    dev = cand.device
    if dev.type == "cpu":
        return cp_round_merge_plain(cand, prio, asks, job_code, gang_code, placed, waits,
                                    rounds, choices, choice_scores, record)
    s, g, _ = cand.shape
    max_c = choices.shape[1]
    _check_inputs("cp_round_merge", [
        ("cand", cand, torch.int32, (s, g, CP_CAND)),
        ("prio", prio, torch.float32, (g,)),
        ("asks", asks, torch.float32, (g, 4)),
        ("job_code", job_code, torch.int32, (g,)),
        ("placed", placed, torch.int32, (g,)),
        ("waits", waits, torch.int32, (g,)),
        ("rounds", rounds, torch.int32, ()),
        ("choices", choices, torch.int32, (g, max_c)),
        ("choice_scores", choice_scores, torch.float32, (g, max_c)),
        ("record", record, torch.int32, (cp_record_words(g),)),
    ] + ([] if gang_code is None else [("gang_code", gang_code, torch.int32, (g,))]))
    same_device([prio, asks, job_code, gang_code, placed, waits, rounds, choices,
                 choice_scores, record], dev, "cp_round_merge")
    placed, waits, rounds = placed.clone(), waits.clone(), rounds.clone()
    choices, choice_scores, record = choices.clone(), choice_scores.clone(), record.clone()
    if g == 0:
        record.zero_()
        record[_CREC_STATE] = 1
        return record, placed, waits, rounds, choices, choice_scores
    record[_CREC_M:] = 0  # the entries past M stay zero, as the plain version's
    scratch = torch.empty(g * _CP_MERGE_WORDS, dtype=torch.int32, device=dev)
    status = _cp_fn("nomad_cp_round_merge")(
        cand.data_ptr(), s, g, prio.data_ptr(), asks.data_ptr(), job_code.data_ptr(),
        None if gang_code is None else gang_code.data_ptr(), max_c,
        *[t.data_ptr() for t in (placed, waits, rounds, choices, choice_scores, record,
                                 scratch)],
        current_stream(dev),
    )
    check_launch(status, "cp_round_merge")
    count_launch(cp_round_merge)
    return record, placed, waits, rounds, choices, choice_scores


cp_round_merge.launches = 0
cp_round_merge.plain_calls = 0


@inside_guard(
    "cp_shard_settle",
    guard="cp_place_kernel",
    # a build budget of 1: it shares csrc/cp.cu's one load
    build_budget=1,
    library="cp",
    symbols=("nomad_cp_shard_settle",),
)
def cp_shard_settle(record, used, lam, assigned, sib, placed, col0: int, g0: int,
                    t_rack=None, t_pod=None, t_ici=None):
    """One mesh cell's state after a round (see ``cp_shard_settle_plain``),
    the inputs left as they were. CPU tensors run the plain version;
    CUDA tensors launch ``csrc/cp.cu``'s ``cp_shard_settle_kernel``, a
    thread a node."""
    dev = record.device
    if dev.type == "cpu":
        return cp_shard_settle_plain(record, used, lam, assigned, sib, placed, col0, g0,
                                     t_rack, t_pod, t_ici)
    n, g = used.shape[0], placed.shape[0]
    tables = (t_rack, t_pod, t_ici)
    _check_inputs("cp_shard_settle", [
        ("record", record, torch.int32, (record.shape[0],)),
        ("used", used, torch.float32, (n, 4)),
        ("lam", lam, torch.float32, (n,)),
        ("assigned", assigned, torch.int32, (g, n)),
        ("sib", sib, torch.int32, (sib.shape[0], n)),
        ("placed", placed, torch.int32, (g,)),
    ] + [(name, t, torch.int32, (t.shape[0], t.shape[1]))
         for name, t in zip(("t_rack", "t_pod", "t_ici"), tables) if t is not None])
    same_device([used, lam, assigned, sib, placed, *tables], dev, "cp_shard_settle")
    used, lam, assigned, sib, placed = (x.clone() for x in (used, lam, assigned, sib, placed))
    tables = [] if t_rack is None else [t.clone() for t in tables]
    status = _cp_fn("nomad_cp_shard_settle")(
        *[t.data_ptr() for t in (record, used, lam, assigned, sib, placed)],
        *([t.data_ptr() for t in tables] or [None] * 3),
        *_widths_of(tables), n, g, int(col0), int(g0), current_stream(dev),
    )
    check_launch(status, "cp_shard_settle")
    count_launch(cp_shard_settle)
    return (used, lam, assigned, sib, placed, *tables)


cp_shard_settle.launches = 0
cp_shard_settle.plain_calls = 0

# (name, axes) of the auction's inputs, in cp_place's order (lam0 last):
# the reference's layout (nomad_tpu/scheduler/cp.py, its shard_put calls)
_CP_AXES = (
    ("capacity", ("nodes", None)),
    ("used0", ("nodes", None)),
    ("asks", ("groups", None)),
    ("counts", ("groups",)),
    ("eligible", ("groups", "nodes")),
    ("scores", ("groups", "nodes")),
    ("prio", ("groups",)),
    ("job_counts", ("groups", "nodes")),
    ("distinct", ("groups",)),
    ("jobgrp", ("groups",)),
    ("lam0", ("nodes",)),
)
# the gang inputs of the id form, after jobgrp (widths apart)
_GANG_AXES = (
    ("gang", ("groups",)),
    ("w_rack", ("groups",)),
    ("w_pod", ("groups",)),
    ("w_ici", ("groups",)),
    ("level_ids", (None, "nodes")),
)


def cp_place_sharded(capacity, used0, asks, counts, eligible, scores, prio, job_counts,
                     distinct, jobgrp, lam0, steps: int, max_c: int):
    """``cp_place`` with its inputs laid out over a mesh (any of them a
    ``ShardedTensor``): the round loop over the cells (the groups axis
    splits when it divides G, else groups row 0 alone runs), one merge a
    round on the mesh lead over all G. Returns cp_place's tuple on the
    lead, identical to the one-device pass. A node axis the mesh does not
    divide runs the one-device kernel on the lead (gathered)."""
    common = (capacity, used0, asks, counts, eligible, scores, prio, job_counts, distinct,
              jobgrp, lam0)
    return _cp_sharded(cp_place, common, None, steps, max_c)[:5]


def cp_gang_place_ids_sharded(capacity, used0, asks, counts, eligible, scores, prio,
                              job_counts, distinct, jobgrp, gang, w_rack, w_pod, w_ici,
                              level_ids, widths, lam0, steps: int, max_c: int):
    """``cp_gang_place_ids`` with its inputs laid out over a mesh (see
    ``cp_place_sharded``): each cell prices its gang groups from its copy
    of the topology tables, which every cell grows by every winner."""
    common = (capacity, used0, asks, counts, eligible, scores, prio, job_counts, distinct,
              jobgrp, lam0)
    # its launches count on cp_gang_place, as the one-device id form's
    return _cp_sharded(cp_gang_place, common,
                       (gang, w_rack, w_pod, w_ici, level_ids, tuple(widths)), steps, max_c)


def cp_gang_place_sharded(capacity, used0, asks, counts, eligible, scores, prio, job_counts,
                          distinct, jobgrp, gang, w_rack, w_pod, w_ici, rack_oh, pod_oh,
                          ici_oh, lam0, steps: int, max_c: int):
    """``cp_gang_place`` with its inputs laid out over a mesh: the
    one-hots become per-node coordinate ids on the lead, laid out over
    the node axis, and the id form runs (``cp_gang_place_ids_sharded``)."""
    common = (capacity, used0, asks, counts, eligible, scores, prio, job_counts, distinct,
              jobgrp, lam0)
    cfg = next(x.cfg for x in (*common, gang, w_rack, w_pod, w_ici, rack_oh, pod_oh, ici_oh)
               if is_sharded(x))
    lead = cfg.lead
    levels = [gather(x, lead) for x in (rack_oh, pod_oh, ici_oh)]
    weights = [gather(x, lead) for x in (gang, w_rack, w_pod, w_ici)]
    flat = [gather(x, lead) for x in common]
    *gang_ids, level_ids, widths = _gang_ids("cp_gang_place", flat, *weights, *levels)
    level_ids = shard_put(level_ids, (None, "nodes"), cfg)
    return _cp_sharded(cp_gang_place, common, (gang, w_rack, w_pod, w_ici, level_ids, widths),
                       steps, max_c, cfg)


def _cp_sharded(wrapper, common, gang_args, steps, max_c, cfg=None):
    """The sharded auction (``gang_args`` the id form's gang inputs, or
    None). Returns (choices, choice_scores, used, rounds, lam, waits)."""
    ins = common[:10] + (gang_args[:5] if gang_args is not None else ()) + common[10:]
    axes = _CP_AXES[:10] + (_GANG_AXES if gang_args is not None else ()) + _CP_AXES[10:]
    cfg = cfg or next(x.cfg for x in ins if is_sharded(x))
    lead = cfg.lead
    g, n = common[5].shape
    if n % cfg.mp != 0:
        kwargs = dict(zip([name for name, _ in axes], ins), steps=steps, max_c=max_c)
        if gang_args is not None:
            kwargs["widths"] = gang_args[5]
        fn = cp_gang_place_ids if gang_args is not None else cp_place
        out = _gathered(fn.__wrapped__, lead, [], kwargs)
        if lead.type == "cpu":  # the plain version ran where the card launches
            count_launch(wrapper, "plain_calls", layout="gathered")
        return out if gang_args is not None else (*out, None)
    if g == 0 or steps < 1:
        return _auction_outputs(tuple(gather(x, lead) for x in common), max_c)
    rows_split = cfg.dp if g % cfg.dp == 0 else 1
    gseg, seg = g // rows_split, n // cfg.mp
    cells = _mesh_cells(cfg, ins, axes, rows_split, gseg, seg)
    for (i, j), parts in cells.items():  # every cell's shapes, and its ids in range
        part = tuple(parts[name] for name, _ in _CP_AXES)
        _check_cp(f"{wrapper.__name__} (sharded)", part, max_c)
        if gang_args is not None and i == 0:
            _check_gang(f"{wrapper.__name__} (sharded)", part,
                        tuple(parts[name] for name, _ in _GANG_AXES) + (gang_args[5],))
    every = {"prio": gather(common[6], lead), "asks": gather(common[2], lead)}
    job_code, n_jobs = _codes(gather(common[9], lead))
    every["job_code"] = job_code.to(torch.int32)
    every["gang_code"], n_gangs, widths = None, 0, [1, 1, 1]
    if gang_args is not None:
        gang = gather(gang_args[0], lead)
        member = gang > 0
        code, n_gangs = _codes(torch.where(member, gang, 0))
        every["gang_code"] = torch.where(member, code, -1).to(torch.int32)
        widths = [int(w) for w in gang_args[5]]
    for (i, j), parts in cells.items():
        dev = parts["capacity"].device
        gs = slice(i * gseg, (i + 1) * gseg)
        parts["job_code"] = every["job_code"][gs].to(dev)
        if gang_args is not None:
            parts["gang_code"] = every["gang_code"][gs].to(dev)
            for name in ("w_rack", "w_pod", "w_ici"):
                parts["q" + name[1:]] = _cp_topo_quant(parts[name])
    run = _cp_loop_cpu if lead.type == "cpu" else _cp_loop_cuda
    return run(cfg, cells, every, rows_split, gseg, seg, n_jobs, n_gangs, widths,
               gang_args is not None, int(steps), int(max_c))


def _cp_state(parts, gseg, seg, n_jobs, n_gangs, widths, gang, dev):
    """A cell's round state at the start of a pass."""
    state = {
        "used": parts["used0"].clone(),
        "lam": parts["lam0"].clone(),
        "assigned": torch.zeros((gseg, seg), dtype=torch.int32, device=dev),
        "sib": torch.zeros((n_jobs, seg), dtype=torch.int32, device=dev),
        "placed": torch.zeros(gseg, dtype=torch.int32, device=dev),
    }
    for name, w in zip(("t_rack", "t_pod", "t_ici"), widths):
        state[name] = (torch.zeros((max(n_gangs, 1), w), dtype=torch.int32, device=dev)
                       if gang else None)
    return state


def _cp_outputs(g, max_c, dev):
    return {
        "lead_placed": torch.zeros(g, dtype=torch.int32, device=dev),
        "waits": torch.zeros(g, dtype=torch.int32, device=dev),
        "rounds": torch.zeros((), dtype=torch.int32, device=dev),
        "choices": torch.full((g, max_c), -1, dtype=torch.int32, device=dev),
        "choice_scores": torch.zeros((g, max_c), dtype=torch.float32, device=dev),
        "master": torch.zeros(cp_record_words(g), dtype=torch.int32, device=dev),
    }


def _cp_loop_cpu(cfg, cells, every, rows_split, gseg, seg, n_jobs, n_gangs, widths, gang,
                 steps, max_c):
    """The round loop through the plain versions (a CPU mesh): each
    round every cell's claim as one call (the rows' groups one after
    another, the columns' nodes side by side, each column's candidates
    from its own nodes), the merge, and every cell's settle as one call,
    each counted (``plain_calls``) and filed under the card's layout."""
    mp = cfg.mp
    names = [name for name, _ in _CP_AXES] + ["job_code"] + (
        ["gang_code", "q_rack", "q_pod", "q_ici", "level_ids"] if gang else [])
    axes = dict(_CP_AXES, job_code=("groups",), gang_code=("groups",), q_rack=("groups",),
                q_pod=("groups",), q_ici=("groups",), level_ids=(None, "nodes"))
    t = {name: _stacked(cells, name, axes[name], rows_split, mp) for name in names}
    g, n = t["scores"].shape
    dev = t["scores"].device
    st = _cp_state(t, g, n, n_jobs, n_gangs, widths, gang, dev)
    lead = _cp_outputs(g, max_c, dev)
    record = lead["master"]
    for _ in range(steps):
        tables = [st["t_rack"], st["t_pod"], st["t_ici"]]
        cand = cp_shard_claim_plain(
            t["capacity"], st["used"],
            *[t[k] for k in ("asks", "counts", "eligible", "scores", "job_counts", "distinct",
                             "job_code")],
            st["lam"], st["assigned"], st["sib"], st["placed"], 0,
            gang=(t["gang_code"], t["q_rack"], t["q_pod"], t["q_ici"], t["level_ids"], *tables)
            if gang else None,
            cells=mp,
        )
        count_launch(cp_shard_claim, "plain_calls", layout="shard")
        record, *rest = cp_round_merge_plain(
            cand, every["prio"], every["asks"], every["job_code"], every["gang_code"],
            lead["lead_placed"], lead["waits"], lead["rounds"], lead["choices"],
            lead["choice_scores"], record,
        )
        lead.update(zip(("lead_placed", "waits", "rounds", "choices", "choice_scores"), rest))
        count_launch(cp_round_merge, "plain_calls", layout="merge")
        out = cp_shard_settle_plain(record, st["used"], st["lam"], st["assigned"], st["sib"],
                                    st["placed"], 0, 0, *(tables if gang else ()))
        st.update(zip(("used", "lam", "assigned", "sib", "placed", "t_rack", "t_pod", "t_ici"),
                      out))
        count_launch(cp_shard_settle, "plain_calls", layout="shard")
        if int(record[_CREC_STATE]) != 0:  # the last round ran: the pass is over
            break
    return (lead["choices"], lead["choice_scores"], st["used"], lead["rounds"], st["lam"],
            lead["waits"])


# the per-cell pointers of the C round loop, in csrc/cp.cu's CpPtr order
_CP_CELL_INPUTS = (
    "capacity", "asks", "counts", "eligible", "scores", "job_counts", "distinct", "job_code",
    "gang_code", "q_rack", "q_pod", "q_ici", "level_ids",
)
_CP_CELL_STATE = (
    "used", "lam", "assigned", "sib", "t_rack", "t_pod", "t_ici", "placed", "cand", "record",
    "gathered", "every_prio", "every_asks", "every_job_code", "every_gang_code",
    "lead_placed", "waits", "rounds", "choices", "choice_scores", "master", "merge_scratch",
)


def _cp_loop_cuda(cfg, cells, every, rows_split, gseg, seg, n_jobs, n_gangs, widths, gang,
                  steps, max_c):
    """The round loop as one C call (``nomad_sharded_cp``). It reports
    the launches it made, counted in C where each kernel launches; they
    are added here to each wrapper's count under its layout."""
    lead = cfg.lead
    per_cell = _cp_fn("nomad_cp_cell_ptrs")()
    assert per_cell == len(_CP_CELL_INPUTS) + len(_CP_CELL_STATE) + 1
    g = rows_split * gseg
    n_cells = rows_split * cfg.mp
    ptrs = (ctypes.c_void_p * (n_cells * per_cell))()
    devices = (ctypes.c_int * n_cells)()
    keep = []
    for i in range(rows_split):
        for j in range(cfg.mp):
            dev = cfg.device(i, j)
            parts = cells[i, j]
            state = _cp_state(parts, gseg, seg, n_jobs, n_gangs, widths, gang, dev)
            state["cand"] = torch.empty((gseg, CP_CAND), dtype=torch.int32, device=dev)
            state["record"] = torch.zeros(cp_record_words(g), dtype=torch.int32, device=dev)
            if (i, j) == (0, 0):
                state.update(_cp_outputs(g, max_c, dev))
                state.update(
                    gathered=torch.empty((cfg.mp, g, CP_CAND), dtype=torch.int32, device=dev),
                    every_prio=every["prio"], every_asks=every["asks"],
                    every_job_code=every["job_code"], every_gang_code=every["gang_code"],
                    merge_scratch=torch.empty(g * _CP_MERGE_WORDS, dtype=torch.int32,
                                              device=dev),
                )
            c = i * cfg.mp + j
            row = [parts.get(name) for name in _CP_CELL_INPUTS] + [
                state.get(name) for name in _CP_CELL_STATE
            ]
            for k, x in enumerate(row):
                ptrs[c * per_cell + k] = None if x is None else x.data_ptr()
            ptrs[c * per_cell + len(row)] = current_stream(dev)
            devices[c] = dev.index
            keep.append((parts, state))
    poll = torch.zeros(1, dtype=torch.int32, pin_memory=True)
    launched = (ctypes.c_longlong * 3)()  # claims, merges, settles
    status = _cp_fn("nomad_sharded_cp")(
        rows_split, cfg.mp, devices, ptrs, gseg, seg, n_jobs, max(n_gangs, 1), *widths,
        int(bool(gang)), steps, max_c, poll.data_ptr(), launched,
    )
    for fn, layout, k in zip((cp_shard_claim, cp_round_merge, cp_shard_settle),
                             ("shard", "merge", "shard"), launched):
        if k:
            count_launch(fn, layout=layout, n=k)
    check_launch(status, "cp auction (sharded)")
    st0 = keep[0][1]
    used = torch.cat([keep[j][1]["used"].to(lead) for j in range(cfg.mp)])
    lam = torch.cat([keep[j][1]["lam"].to(lead) for j in range(cfg.mp)])
    return st0["choices"], st0["choice_scores"], used, st0["rounds"], lam, st0["waits"]


# -- host helpers ------------------------------------------------------------


def topo_onehot(ids: np.ndarray, width: int) -> np.ndarray:
    """i32[N, W] one-hot of per-node topology level ids with id 0 (the
    coordinate-less "") zeroed out: a node without a coordinate is
    adjacent to nothing, not to every other bare node. ``width`` is the
    bucket-padded vocab size."""
    n = ids.shape[0]
    oh = np.zeros((n, width), dtype=np.int32)
    mask = ids > 0
    oh[np.arange(n)[mask], ids[mask]] = 1
    return oh


def release_incomplete_gangs(
    choices: np.ndarray,
    choice_scores: np.ndarray,
    used: np.ndarray,
    asks: np.ndarray,
    counts: np.ndarray,
    gang: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, list[int]]:
    """Host post-pass over the pass's outputs: any gang with a member
    short of its count releases every member's placements — capacity
    back to ``used``, choices to -1 — so a partially-placed gang can
    never leave the solver layer. Returns (choices, choice_scores, used,
    released_gang_ids)."""
    choices = choices.copy()
    choice_scores = choice_scores.copy()
    used = used.copy()
    released: list[int] = []
    placed = (choices >= 0).sum(axis=1).astype(np.int32)
    for gid in np.unique(gang[gang > 0]):
        members = np.flatnonzero(gang == gid)
        if bool(np.all(placed[members] >= counts[members])):
            continue
        released.append(int(gid))
        for g in members:
            for slot in range(choices.shape[1]):
                node = int(choices[g, slot])
                if node >= 0:
                    used[node] -= asks[g]
            choices[g, :] = -1
            choice_scores[g, :] = np.float32(0.0)
    return choices, choice_scores, used, released


def topology_term_host(gang, w_rack, w_pod, w_ici, level_ids, widths,
                       assigned) -> np.ndarray:
    """f32[G, N] topology term of a final assignment, from host arrays
    (``level_ids`` i32[3, N] with their ``widths``) — the explanations'
    and the gang quality block's valuation."""
    t = torch.from_numpy
    q = [_cp_topo_quant(t(np.asarray(w, dtype=np.float32)))
         for w in (w_rack, w_pod, w_ici)]
    a = t(np.ascontiguousarray(assigned, dtype=np.int32))
    g = t(np.asarray(gang, dtype=np.int32))
    ids = t(np.asarray(level_ids, dtype=np.int64))
    mates = [_cp_topo_mates_ids(g, a, ids[i], int(widths[i])) for i in range(3)]
    return _cp_topo_term(*q, *mates).numpy()
