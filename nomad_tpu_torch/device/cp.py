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
    check_launch,
    count_launch,
    cuda_library,
    current_stream,
    guarded,
    same_device,
)
from .score import _check_inputs, _first_argmax

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
    # a build budget of 1: the one load of csrc/cp.cu a process makes
    build_budget=1,
    library="cp",
    symbols=("nomad_cp_place",),
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


@guarded(
    "cp_gang_place_kernel",
    # a build budget of 1: the one load of csrc/cp.cu a process makes
    build_budget=1,
    library="cp",
    symbols=("nomad_cp_place",),
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


@guarded(
    "cp_gang_place_kernel",
    # a build budget of 1: the one load of csrc/cp.cu a process makes
    build_budget=1,
    library="cp",
    symbols=("nomad_cp_place",),
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
