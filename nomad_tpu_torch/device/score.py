"""The batched placement kernels, on PyTorch and CUDA.

Ports ``nomad_tpu/device/score.py``'s placement and scoring programs:
the closed-form top-k placement for groups with no cross-node coupling,
the three coupled placements for groups whose spread blocks or
distinct_property caps couple nodes through per-value counts (the exact
value scan, the chunked scan and the one-per-value scan), and the dense
[G, N] score matrix. The scoring semantics are the reference's,
component by component (see that module's docstring for each
component's citation):

- binpack/spread fit from 10^x of the cpu and memory free fractions,
  normalized by ``BINPACK_MAX_SCORE``;
- job anti-affinity, −(collisions+1)/desired_count on nodes already
  holding the job;
- the reschedule penalty, −1;
- node affinity, pre-normalized on the host;
- spread: one component summing per-block boosts (target and even
  modes), joining the mean only where the total boost is nonzero;
- distinct_property: not a score, a per-value cap carried through the
  scan's count state;
- the mean over contributing components.

Each device function has two halves in this module: a plain PyTorch
version, which is what a CPU tensor runs, and a wrapper that launches
the hand-written kernel on a CUDA tensor (``csrc/closed_form.cu``,
``csrc/coupled.cu`` and ``score_triton.py``). A CUDA tensor never runs
the plain version here: the wrapper launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import logging
from dataclasses import dataclass, field
from typing import Optional

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
from ..obs.trace import global_tracer as _tracer
from ..structs.resources import BINPACK_MAX_SCORE

_LN10 = 2.302585092994046

# value-block kinds (ValueBlocks.kinds; see flatten.py)
BLOCK_TARGET_SPREAD = 0
BLOCK_EVEN_SPREAD = 1
BLOCK_DISTINCT_CAP = 2
BLOCK_INACTIVE = -1

# extra greedy candidates emitted beyond ``count`` per lane, consumed by
# repair_batch_conflicts when optimistic batch lanes collide on a node
OVERFLOW_CANDIDATES = 16

# exact stepwise scan only for small groups; larger spread groups place in
# chunks (boost tables frozen for CHUNK placements — spread counts move
# slowly, and the host repair walk re-verifies every placement anyway)
EXACT_SCAN_MAX_COUNT = 32
CHUNK = 16

# Device memory one closed-form launch may hold. The reference budgeted
# ~4 GB of live f32 [chunk, N, J] planes on a 16 GB v5e; the port's
# kernel keeps no plane (it recomputes each node's column per pass), so
# per lane it holds only its 8-byte top-k slots and the dense [G, N]
# inputs, 14 bytes per node (eligible and penalty as bytes, job_counts
# i32, affinity and slot caps f32). 8 GiB is a tenth of the H100's
# 80 GB: at the headline shape (16,384 padded nodes, k 1,024: 0.24 MB per
# lane) that is ~36,000 lanes per launch, so a pass splits only for
# group counts far beyond any batch the schedulers build.
SCRATCH_BUDGET_BYTES = 8 << 30


def _pow10(x):
    return torch.exp(_LN10 * x)


def _div(x, c: float):
    """``x / c`` as one IEEE division. PyTorch's CUDA division by a
    Python (or CPU) scalar multiplies by the rounded reciprocal instead,
    one ulp off the kernels' and the reference's quotient; a 0-dim
    tensor on ``x``'s device takes the true division."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _lane(x, dtype=None):
    """[G] per-lane scalars as a [G, 1, 1] broadcast against planes."""
    return x[:, None, None] if dtype is None else x.to(dtype)[:, None, None]


# -- score matrix (dense [G, N], no sequential state) ------------------------


def component_scores(
    capacity,  # f32[N, D]
    used,  # f32[N, D]
    asks,  # f32[G, D]
    eligible,  # bool[G, N]
    job_counts,  # i32[G, N]
    desired_totals,  # f32[G] anti-affinity denominators
    penalty_nodes,  # bool[G, N]
    affinity_scores,  # f32[G, N]
    has_affinities,  # bool[G]
    distinct_hosts,  # bool[G]
    algorithm_spread: bool,
    throughputs=None,  # f32[G, N] normalized [0, 1] class-throughput share
):
    """Per-(group, node) normalized score for placing one instance of
    each group's ask: the reference ``component_scores`` with the group
    axis written out, and the plain PyTorch version of ``score_matrix``. The spread component is always off on this path
    (the reference passes a zero boost), so it is not carried. Returns
    (final f32[G, N] with −inf infeasible, fits bool[G, N])."""
    proposed = used[None, :, :] + asks[:, None, :]  # [G, N, D]
    fits = torch.all(proposed <= capacity[None], dim=-1) & eligible
    fits &= torch.where(distinct_hosts[:, None], job_counts == 0, True)
    if throughputs is not None:
        fits &= throughputs > 0.0

    cap = capacity[None]
    free_frac = torch.where(
        cap > 0, (cap - proposed) / torch.clamp(cap, min=1e-9), 1.0
    )
    pow_sum = _pow10(free_frac[..., 0]) + _pow10(free_frac[..., 1])
    binpack = torch.clamp(20.0 - pow_sum, 0.0, BINPACK_MAX_SCORE)
    spread_fit = torch.clamp(pow_sum - 2.0, 0.0, BINPACK_MAX_SCORE)
    fit_score = _div(spread_fit if algorithm_spread else binpack, BINPACK_MAX_SCORE)

    collisions = job_counts.to(torch.float32)
    anti = torch.where(
        job_counts > 0,
        -(collisions + 1.0) / torch.clamp(desired_totals, min=1.0)[:, None],
        0.0,
    )
    resched = torch.where(penalty_nodes, -1.0, 0.0)
    aff = torch.where(has_affinities[:, None], affinity_scores, 0.0)
    n_comp = (
        1.0
        + (job_counts > 0)
        + penalty_nodes
        + torch.where(has_affinities, 1.0, 0.0)[:, None]
    )
    total = fit_score + anti + resched + aff
    if throughputs is not None:
        total = total + throughputs
        n_comp = n_comp + 1.0
    final = total / n_comp
    return torch.where(fits, final, -torch.inf), fits


@guarded("score_matrix_kernel")
def score_matrix(
    capacity,  # f32[N, D]
    used,  # f32[N, D]
    asks,  # f32[G, D]
    eligible,  # bool[G, N]
    job_counts,  # i32[G, N]
    desired_totals,  # f32[G]
    penalty_nodes,  # bool[G, N]
    affinity_scores,  # f32[G, N]
    has_affinities,  # bool[G]
    distinct_hosts,  # bool[G]
    algorithm_spread: bool,
    throughputs=None,  # f32[G, N] or None
):
    """The dense groups×nodes score matrix — the port of
    ``score_matrix_kernel``: (final f32[G, N], fits bool[G, N]). CPU
    tensors run the plain version; CUDA tensors run the Triton kernel
    (``score_triton.score_matrix_triton``)."""
    if capacity.device.type == "cpu":
        return component_scores(
            capacity, used, asks, eligible, job_counts, desired_totals,
            penalty_nodes, affinity_scores, has_affinities, distinct_hosts,
            algorithm_spread, throughputs,
        )
    from .score_triton import score_matrix_triton

    return score_matrix_triton(
        capacity, used, asks, eligible, job_counts, desired_totals,
        penalty_nodes, affinity_scores, has_affinities, distinct_hosts,
        algorithm_spread, throughputs,
    )


# -- closed-form greedy ------------------------------------------------------
#
# For one group placing ``count`` identical asks with no per-value
# coupling, the score of "the (j+1)-th instance on node n" is closed
# form, and the per-node sequence made monotone by a running-min clamp
# turns greedy placement into one top-k over the node-major [N·J] plane
# (reference: device/score.py place_closed_form_kernel).


def _score_planes(
    capacity,  # f32[N, D]
    used0,  # f32[N, D]
    asks,  # f32[G, D]
    elig,  # bool[G, N]
    jc0,  # i32[G, N]
    dt,  # f32[G] anti-affinity denominators
    pen,  # bool[G, N]
    aff,  # f32[G, N]
    has_aff,  # bool[G]
    dh,  # bool[G] distinct_hosts
    caps,  # f32[G, N] per-node device-slot caps
    algorithm_spread: bool,
    max_j: int,
    jitter=None,  # f32[N] tie-break noise
):
    """The [G, N, J] candidate planes: numerator (sum of components),
    denominator (contributing-component count) and feasibility — the
    reference ``_score_planes`` with the group axis written out."""
    dev = capacity.device
    js = torch.arange(max_j, dtype=torch.float32, device=dev)  # [J]
    mult = js + 1.0
    # used0 + (j+1)·ask ≤ cap in every dim ⇔ j < min_d floor((cap−used0)/ask);
    # the 1e-6 nudge absorbs float division round-down on exact fits
    free0 = capacity - used0  # [N, D]
    ask = asks[:, None, :]  # [G, 1, D]
    per_dim = torch.where(
        ask > 0,
        torch.floor(free0[None] / torch.clamp(ask, min=1e-9) + 1e-6),
        torch.inf,
    )
    jmax = per_dim.amin(dim=-1)  # [G, N]
    jmax = torch.where(elig, jmax, 0.0)
    jmax = torch.minimum(jmax, caps)
    jmax = torch.where(
        dh[:, None],
        torch.where(jc0 == 0, torch.clamp(jmax, max=1.0), 0.0),
        jmax,
    )
    fits = js[None, None, :] < jmax[:, :, None]  # [G, N, J]

    pow_sum = torch.zeros(fits.shape, dtype=torch.float32, device=dev)
    for d in (0, 1):  # cpu, mem drive the fit score
        cap_d = capacity[None, :, d : d + 1]  # [1, N, 1]
        prop_d = used0[None, :, d : d + 1] + mult[None, None, :] * _lane(asks[:, d])
        free_d = torch.where(
            cap_d > 0, (cap_d - prop_d) / torch.clamp(cap_d, min=1e-9), 1.0
        )
        pow_sum = pow_sum + _pow10(free_d)
    binpack = torch.clamp(20.0 - pow_sum, 0.0, BINPACK_MAX_SCORE)
    spread_fit = torch.clamp(pow_sum - 2.0, 0.0, BINPACK_MAX_SCORE)
    fit_score = _div(spread_fit if algorithm_spread else binpack, BINPACK_MAX_SCORE)

    coll = jc0.to(torch.float32)[:, :, None] + js  # after j placed
    has_coll = coll > 0
    anti = torch.where(
        has_coll, -(coll + 1.0) / _lane(torch.clamp(dt, min=1.0)), 0.0
    )
    resched = torch.where(pen[:, :, None], -1.0, 0.0)
    aff_c = torch.where(_lane(has_aff), aff[:, :, None], 0.0)
    num = fit_score + anti + resched + aff_c
    if jitter is not None:
        num = num + jitter[None, :, None]
    den = 1.0 + has_coll + pen[:, :, None] + _lane(has_aff, torch.float32)
    return num, den, fits


def place_closed_form_plain(
    capacity, used0, asks, eligible, job_counts, desired_totals,
    penalty_nodes, affinity_scores, has_affinities, distinct_hosts,
    slot_caps, algorithm_spread: bool, max_j: int, k: int, jitter=None,
):
    """The plain PyTorch version of ``place_closed_form``. The top-k is a
    stable descending sort: ``lax.top_k`` orders by (value desc, index
    asc) and ``torch.topk`` promises no order among ties, which the
    homogeneous clusters have everywhere."""
    num, den, fits = _score_planes(
        capacity, used0, asks, eligible, job_counts, desired_totals,
        penalty_nodes, affinity_scores, has_affinities, distinct_hosts,
        slot_caps, algorithm_spread, max_j, jitter=jitter,
    )
    s_raw = torch.where(fits, num / den, -torch.inf)
    # selection runs on the running-min clamp: it restores the prefix
    # rule "(n, j) requires (n, j-1)" that a plain top-k needs
    s_sel = torch.cummin(s_raw, dim=2).values
    g = s_raw.shape[0]
    flat_sel = s_sel.reshape(g, -1)
    flat_raw = s_raw.reshape(g, -1)
    k_eff = min(k, flat_sel.shape[1])
    top_sel, top_idx = torch.sort(flat_sel, dim=1, descending=True, stable=True)
    top_sel, top_idx = top_sel[:, :k_eff], top_idx[:, :k_eff]
    if k_eff < k:
        pad = k - k_eff
        top_sel = torch.cat(
            [top_sel, top_sel.new_full((g, pad), -torch.inf)], dim=1
        )
        top_idx = torch.cat([top_idx, top_idx.new_zeros((g, pad))], dim=1)
    # report the TRUE (unclamped) score of each chosen (n, j)
    top_raw = torch.gather(flat_raw, 1, top_idx)
    node_rows = torch.div(top_idx, max_j, rounding_mode="floor").to(torch.int32)
    ok = top_sel > -torch.inf
    choices = torch.where(ok, node_rows, -1).to(torch.int32)
    scores = torch.where(ok, top_raw, -torch.inf)
    return choices, scores


_CLOSED_FORM_ARGTYPES = (
    [ctypes.c_void_p] * 12  # capacity … jitter
    + [ctypes.c_int] * 9  # algorithm_spread, g, n, j, k, k_eff, kpad, cluster, cached
    + [ctypes.c_void_p] * 4  # cand, choices, scores, stream
)


def _closed_form_library():
    lib = cuda_library("closed_form")
    fn = lib.nomad_place_closed_form
    if fn.argtypes is None:
        fn.argtypes = _CLOSED_FORM_ARGTYPES
        fn.restype = ctypes.c_int
        lib.nomad_closed_form_cluster.argtypes = [ctypes.c_int] * 4 + [
            ctypes.POINTER(ctypes.c_int)
        ] * 3
        lib.nomad_closed_form_cluster.restype = ctypes.c_int
    return lib, fn


_closed_form_plans: dict = {}


def closed_form_plan(g: int, n: int, kpad: int, blocks: int = 0) -> tuple[int, int]:
    """(blocks a lane, columns a cluster block keeps a node) of the
    closed-form kernel at G lanes, N nodes and kpad top-k slots, on the
    current device (``nomad_closed_form_cluster``). ``blocks`` 0 picks
    the thread-block cluster's size by shape, never rising with G: 16
    while G x 16 is within the SM count, 8 while all G clusters of 8 can
    be resident at once, else 4; or 1, the one-block form, where a
    block's share does not fit in shared memory. A size from 1 to 16 asks for
    that form, and is refused where its share does not fit. Where no
    cluster of the size can be resident (``cudaOccupancyMaxActiveClusters``)
    it is halved until one can, and the choice is logged. The kept
    columns are the most (2 to 6) at which all G clusters stay resident;
    0 in the one-block form."""
    key = (torch.cuda.current_device(), g, n, kpad, blocks)
    plan = _closed_form_plans.get(key)
    if plan is None:
        lib, _ = _closed_form_library()
        by_shape, size, cached = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
        status = lib.nomad_closed_form_cluster(
            g, n, kpad, blocks, ctypes.byref(by_shape), ctypes.byref(size),
            ctypes.byref(cached),
        )
        check_launch(status, "place_closed_form")
        if size.value != by_shape.value:
            logging.getLogger(__name__).warning(
                "place_closed_form: no cluster of %d blocks can be resident "
                "at G=%d N=%d kpad=%d; a lane runs on %d block(s)",
                by_shape.value, g, n, kpad, size.value,
            )
        plan = _closed_form_plans[key] = (size.value, cached.value)
    return plan


def _lane_specs(capacity, used0, asks, eligible, job_counts, desired_totals,
                penalty_nodes, affinity_scores, has_affinities, distinct_hosts,
                slot_caps, jitter):
    """(name, tensor, dtype, shape) of the inputs every placement kernel
    takes."""
    n = capacity.shape[0]
    g = asks.shape[0]
    want = [
        ("capacity", capacity, torch.float32, (n, 4)),
        ("used0", used0, torch.float32, (n, 4)),
        ("asks", asks, torch.float32, (g, 4)),
        ("eligible", eligible, torch.bool, (g, n)),
        ("job_counts", job_counts, torch.int32, (g, n)),
        ("desired_totals", desired_totals, torch.float32, (g,)),
        ("penalty_nodes", penalty_nodes, torch.bool, (g, n)),
        ("affinity_scores", affinity_scores, torch.float32, (g, n)),
        ("has_affinities", has_affinities, torch.bool, (g,)),
        ("distinct_hosts", distinct_hosts, torch.bool, (g,)),
        ("slot_caps", slot_caps, torch.float32, (g, n)),
    ]
    if jitter is not None:
        want.append(("jitter", jitter, torch.float32, (n,)))
    return want


def _check_inputs(what: str, want) -> None:
    for name, t, dtype, shape in want:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{what}: {name} must be {dtype} {shape}, "
                f"got {t.dtype} {tuple(t.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


@guarded("place_closed_form_kernel")
def place_closed_form(
    capacity,  # f32[N, 4] shared
    used0,  # f32[N, 4] shared snapshot usage
    asks,  # f32[G, 4]
    eligible,  # bool[G, N]
    job_counts,  # i32[G, N]
    desired_totals,  # f32[G]
    penalty_nodes,  # bool[G, N]
    affinity_scores,  # f32[G, N]
    has_affinities,  # bool[G]
    distinct_hosts,  # bool[G]
    slot_caps,  # f32[G, N] (+inf where uncapped)
    algorithm_spread: bool,
    max_j: int,  # most instances of one group per node
    k: int,  # top-k width (≥ max count in batch + overflow)
    jitter=None,  # f32[N] tie-break noise, shared across lanes
):
    """Returns (choices i32[G, k], scores f32[G, k]) in greedy order —
    the port of ``place_closed_form_kernel``. Entries past a lane's
    feasible candidates are −1/−inf; entries in [count, k) are overflow
    candidates for conflict repair. CPU tensors run the plain version;
    CUDA tensors launch ``csrc/closed_form.cu`` in the form
    ``closed_form_plan`` picks for the shape."""
    dev = capacity.device
    if dev.type == "cpu":
        return place_closed_form_plain(
            capacity, used0, asks, eligible, job_counts, desired_totals,
            penalty_nodes, affinity_scores, has_affinities, distinct_hosts,
            slot_caps, algorithm_spread, max_j, k, jitter,
        )
    inputs = (
        capacity, used0, asks, eligible, job_counts, desired_totals,
        penalty_nodes, affinity_scores, has_affinities, distinct_hosts,
        slot_caps, jitter,
    )
    same_device(inputs, dev, "place_closed_form")
    _check_inputs("place_closed_form", _lane_specs(*inputs))
    g, n = eligible.shape
    m = n * max_j
    if m >= 2**32 - 1 or max_j < 1 or k < 1:
        raise ValueError(
            f"place_closed_form: unsupported shape N={n} J={max_j} k={k}"
        )
    k_eff = min(k, m)
    kpad = 1
    while kpad < k_eff:
        kpad <<= 1
    choices = torch.empty((g, k), dtype=torch.int32, device=dev)
    scores = torch.empty((g, k), dtype=torch.float32, device=dev)
    if g == 0:
        return choices, scores
    _, fn = _closed_form_library()
    with torch.cuda.device(dev):  # the form is chosen for this card
        blocks, cached = closed_form_plan(g, n, kpad)
    # scratch: the top-k words, kpad a lane (one-block form); or a block's
    # words above the threshold and their scores, 2 * kpad words a block
    # (cluster form)
    cand = torch.empty(
        (g * blocks, kpad if blocks == 1 else 2 * kpad), dtype=torch.int64, device=dev
    )
    status = fn(
        *[None if t is None else t.data_ptr() for t in inputs],
        int(bool(algorithm_spread)), g, n, max_j, k, k_eff, kpad, blocks, cached,
        cand.data_ptr(), choices.data_ptr(), scores.data_ptr(),
        current_stream(dev),
    )
    check_launch(status, "place_closed_form")
    count_launch(place_closed_form, form=blocks)
    return choices, scores


place_closed_form.launches = 0
place_closed_form.forms = {}  # launches by blocks a lane


# -- coupled placement (spread / distinct_property groups) -------------------
#
# Groups whose spread blocks or distinct_property caps couple nodes
# through per-value counts place greedily step by step: each step reads
# every node's next column of the [N, J] planes, adds the per-value boost
# table derived from the counts so far, and picks (reference:
# device/score.py place_value_scan_kernel, place_spread_chunked_kernel,
# place_spread_opv_kernel). The plain versions below are Python loops
# over those steps with no host synchronization, so a CUDA graph can
# capture them whole.


def _block_tables(c, desired, caps, weights, kinds):
    """Per-(block, value) boost and allowance tables from the count state
    ``c`` [..., B, V] (reference ``_block_tables``).

    Target mode: boost = (desired − (c+1))/desired × weight (weight is
    already w/Σw); desired ≤ 0 marks an untargeted value, flat −1. Even
    mode: from the min/max of *positive* counts — at the minimum
    (max−min)/min, or −1 where min = max; elsewhere (min−c)/min; 0 when
    no count is positive. Distinct caps: allow = c < cap."""
    t_boost = torch.where(
        desired > 0,
        (desired - (c + 1.0)) / torch.clamp(desired, min=1e-9) * weights[..., None],
        -1.0,
    )
    pos = c > 0
    any_pos = pos.any(dim=-1, keepdim=True)
    minc = torch.where(pos, c, torch.inf).amin(dim=-1, keepdim=True)
    maxc = torch.where(pos, c, -torch.inf).amax(dim=-1, keepdim=True)
    e_boost = torch.where(
        c == minc,
        torch.where(
            minc == maxc, -1.0, (maxc - minc) / torch.clamp(minc, min=1e-9)
        ),
        (minc - c) / torch.clamp(minc, min=1e-9),
    )
    e_boost = torch.where(any_pos, e_boost, 0.0)
    boost = torch.where(
        (kinds == BLOCK_TARGET_SPREAD)[..., None],
        t_boost,
        torch.where((kinds == BLOCK_EVEN_SPREAD)[..., None], e_boost, 0.0),
    )
    allow = torch.where((kinds == BLOCK_DISTINCT_CAP)[..., None], c < caps, True)
    return boost, allow


def _first_argmax(x):
    """(index, value) of the max over the last dim, the first index on
    ties — ``jnp.argmax``'s order, spelled out (an all −inf row gives 0)."""
    m = x.amax(dim=-1, keepdim=True)
    ar = torch.arange(x.shape[-1], device=x.device)
    idx = torch.where(x == m, ar, x.shape[-1]).amin(dim=-1)
    return idx, m[..., 0]


class _Coupling:
    """The per-lane block inputs of one coupled pass, in the shapes the
    plain versions index: value ids as int64 [G, B, N], their clamped
    gather indices, and the block-kind masks."""

    def __init__(self, vids, kinds):
        self.vids = vids.long()
        self.safe = self.vids.clamp(min=0)
        self.has_value = self.vids >= 0
        is_spread = (kinds == BLOCK_TARGET_SPREAD) | (kinds == BLOCK_EVEN_SPREAD)
        self.is_spread = is_spread[..., None]  # [G, B, 1]
        self.has_spread_any = is_spread.any(dim=1)[:, None]  # [G, 1]
        self.capped = (kinds == BLOCK_DISTINCT_CAP)[..., None] & self.has_value

    def node_terms(self, tbl, allow):
        """Summed spread boost f32[G, N] (blocks in index order from 0.0,
        −1 for a node with no value) and distinct allowance bool[G, N]."""
        contrib = torch.where(self.has_value, torch.gather(tbl, 2, self.safe), -1.0)
        contrib = torch.where(self.is_spread, contrib, 0.0)
        boost = torch.zeros_like(contrib[:, 0])
        for b in range(contrib.shape[1]):
            boost = boost + contrib[:, b]
        allowed = torch.where(
            self.capped, torch.gather(allow, 2, self.safe), True
        ).all(dim=1)
        return boost, allowed

    def scores(self, head_num, head_den, head_ok, boost, allowed):
        """(num + boost)/(den + 1) where the boost is on, num/den
        elsewhere; −inf where the head does not fit or a cap is full."""
        spread_on = self.has_spread_any & (boost != 0.0)
        den_t = head_den + torch.where(spread_on, 1.0, 0.0)
        score = (head_num + torch.where(spread_on, boost, 0.0)) / den_t
        return torch.where(head_ok & allowed, score, -torch.inf)

    def bump(self, c, rows, take):
        """c + one count per taken pick's value in every block; ``rows``
        and ``take`` are [G, P]."""
        g, nb, _ = self.vids.shape
        picked = torch.gather(self.vids, 2, rows[:, None, :].expand(g, nb, rows.shape[1]))
        upd = take[:, None, :] & (picked >= 0)
        ar_v = torch.arange(c.shape[2], device=c.device)
        onehot = (picked[..., None] == ar_v) & upd[..., None]  # [G, B, P, V]
        return c + onehot.sum(dim=2).to(c.dtype)


def _heads(num, den, fits, jn, max_j: int):
    """Each node's numerator, denominator and fit at its next column."""
    head_j = jn.clamp(max=max_j - 1)[..., None]
    head_fit = torch.gather(fits, 2, head_j)[..., 0] & (jn < max_j)
    return (
        torch.gather(num, 2, head_j)[..., 0],
        torch.gather(den, 2, head_j)[..., 0],
        head_fit,
    )


def place_value_scan_plain(
    capacity, used0, asks, eligible, job_counts, desired_totals,
    penalty_nodes, affinity_scores, has_affinities, distinct_hosts,
    slot_caps, block_value_ids, block_counts0, block_desired, block_caps,
    block_weights, block_kinds, algorithm_spread: bool, counts,
    max_j: int, max_steps: int, jitter=None,
):
    """The plain PyTorch version of ``place_value_scan``: exact stepwise
    greedy, the tables re-derived from the counts before every step."""
    num, den, fits = _score_planes(
        capacity, used0, asks, eligible, job_counts, desired_totals,
        penalty_nodes, affinity_scores, has_affinities, distinct_hosts,
        slot_caps, algorithm_spread, max_j, jitter=jitter,
    )
    g, n = eligible.shape
    cp = _Coupling(block_value_ids, block_kinds)
    ar = torch.arange(n, device=capacity.device)
    jn = torch.zeros((g, n), dtype=torch.int64, device=capacity.device)
    c = block_counts0.clone()
    choices, scores = [], []
    for i in range(max_steps):
        head_num, head_den, head_fit = _heads(num, den, fits, jn, max_j)
        boost, allowed = cp.node_terms(
            *_block_tables(c, block_desired, block_caps, block_weights, block_kinds)
        )
        score = cp.scores(head_num, head_den, head_fit, boost, allowed)
        best, best_val = _first_argmax(score)
        ok = (best_val > -torch.inf) & (i < counts)
        jn = jn + ((ar == best[:, None]) & ok[:, None])
        c = cp.bump(c, best[:, None], ok[:, None])
        choices.append(torch.where(ok, best, -1))
        scores.append(torch.where(ok, best_val, -torch.inf))
    return (
        torch.stack(choices, dim=1).to(torch.int32),
        torch.stack(scores, dim=1),
    )


def place_spread_chunked_plain(
    capacity, used0, asks, eligible, job_counts, desired_totals,
    penalty_nodes, affinity_scores, has_affinities, distinct_hosts,
    slot_caps, block_value_ids, block_counts0, block_desired, block_caps,
    block_weights, block_kinds, algorithm_spread: bool, counts,
    max_j: int, chunk: int, n_chunks: int, jitter=None,
):
    """The plain PyTorch version of ``place_spread_chunked``: per step,
    the tables frozen, the [N, J] plane re-scored from each node's next
    column under a running-min clamp, and its top ``chunk`` taken
    (value desc, flat index asc; a stable sort, as for the closed form);
    each pick reports its unclamped score."""
    num, den, fits = _score_planes(
        capacity, used0, asks, eligible, job_counts, desired_totals,
        penalty_nodes, affinity_scores, has_affinities, distinct_hosts,
        slot_caps, algorithm_spread, max_j, jitter=jitter,
    )
    g, n = eligible.shape
    dev = capacity.device
    cp = _Coupling(block_value_ids, block_kinds)
    ar = torch.arange(n, device=dev)
    js = torch.arange(max_j, device=dev)
    ar_chunk = torch.arange(chunk, device=dev)
    jn = torch.zeros((g, n), dtype=torch.int64, device=dev)
    c = block_counts0.clone()
    n_placed = torch.zeros(g, dtype=torch.int64, device=dev)
    choices, scores = [], []
    for _ in range(n_chunks):
        boost, allowed = cp.node_terms(
            *_block_tables(c, block_desired, block_caps, block_weights, block_kinds)
        )
        spread_on = cp.has_spread_any & (boost != 0.0)
        den_t = den + torch.where(spread_on, 1.0, 0.0)[..., None]
        s_raw = (num + torch.where(spread_on, boost, 0.0)[..., None]) / den_t
        consumed = js < jn[..., None]
        feas = fits & allowed[..., None] & ~consumed
        # consumed columns (j < jn) must not poison the running min
        s_for_min = torch.where(
            consumed, torch.inf, torch.where(feas, s_raw, -torch.inf)
        )
        s_sel = torch.where(feas, torch.cummin(s_for_min, dim=2).values, -torch.inf)
        vals, idx = torch.sort(
            s_sel.reshape(g, -1), dim=1, descending=True, stable=True
        )
        vals, idx = vals[:, :chunk], idx[:, :chunk]
        take = (ar_chunk + n_placed[:, None] < counts[:, None]) & (vals > -torch.inf)
        rows = torch.div(idx, max_j, rounding_mode="floor")
        true_scores = torch.gather(s_raw.reshape(g, -1), 1, idx)
        jn = jn + ((ar == rows[..., None]) & take[..., None]).sum(dim=1)
        c = cp.bump(c, rows, take)
        n_placed = n_placed + take.sum(dim=1)
        choices.append(torch.where(take, rows, -1))
        scores.append(torch.where(take, true_scores, -torch.inf))
    return (
        torch.cat(choices, dim=1).to(torch.int32),
        torch.cat(scores, dim=1),
    )


def place_spread_opv_plain(
    capacity, used0, asks, eligible, job_counts, desired_totals,
    penalty_nodes, affinity_scores, has_affinities, distinct_hosts,
    slot_caps, block_value_ids, block_counts0, block_desired, block_caps,
    block_weights, block_kinds, enforce_idx, algorithm_spread: bool, counts,
    max_j: int, k_seg: int, n_chunks: int, jitter=None,
):
    """The plain PyTorch version of ``place_spread_opv``. Per step: the
    first pick by argmax under the frozen tables, its values counted, the
    tables re-derived; then one more pick per value segment of the
    enforced block (value-less nodes form segment V), the first pick's
    segment excluded, behind the rotation guard: the top ``k_seg − 1``
    segment maxima (value desc, segment asc), each taking the first-index
    argmax inside its segment."""
    num, den, fits = _score_planes(
        capacity, used0, asks, eligible, job_counts, desired_totals,
        penalty_nodes, affinity_scores, has_affinities, distinct_hosts,
        slot_caps, algorithm_spread, max_j, jitter=jitter,
    )
    g, n = eligible.shape
    nv = block_counts0.shape[2]
    dev = capacity.device
    cp = _Coupling(block_value_ids, block_kinds)
    ar = torch.arange(n, device=dev)
    ar_v = torch.arange(nv, device=dev)
    ar_r = torch.arange(k_seg - 1, device=dev)
    eidx = enforce_idx.long()
    evids = torch.gather(cp.vids, 1, eidx[:, None, None].expand(g, 1, n))[:, 0]
    seg = torch.where(evids >= 0, evids, nv)  # [G, N]; nv = no-value segment
    seg_plane = seg[:, None, :] == torch.arange(nv + 1, device=dev)[:, None]
    # enforce-block values held by an eligible node: V is padded to a
    # power of two, and a phantom value must not read as empty
    present_v = ((evids[:, None, :] == ar_v[:, None]) & eligible[:, None, :]).any(dim=2)
    even_enforce = torch.gather(block_kinds, 1, eidx[:, None])[:, 0] == BLOCK_EVEN_SPREAD
    value_less = torch.ones((g, 1), dtype=torch.bool, device=dev)

    def node_scores(head, c):
        return cp.scores(*head, *cp.node_terms(
            *_block_tables(c, block_desired, block_caps, block_weights, block_kinds)
        ))

    jn = torch.zeros((g, n), dtype=torch.int64, device=dev)
    c = block_counts0.clone()
    n_placed = torch.zeros(g, dtype=torch.int64, device=dev)
    choices, scores = [], []
    for _ in range(n_chunks):
        head = _heads(num, den, fits, jn, max_j)
        score0 = node_scores(head, c)
        first, first_val = _first_argmax(score0)
        ok0 = (first_val > -torch.inf) & (n_placed < counts)
        v_first = torch.gather(seg, 1, first[:, None])
        c1 = cp.bump(c, first[:, None], ok0[:, None])

        score1 = torch.where(seg == v_first, -torch.inf, node_scores(head, c1))
        # rotation guard over the enforced block's counts after the bump
        ecounts = torch.gather(c1, 1, eidx[:, None, None].expand(g, 1, nv))[:, 0]
        pos1 = ecounts > 0
        minc1 = torch.where(pos1, ecounts, torch.inf).amin(dim=1, keepdim=True)
        maxc1 = torch.where(pos1, ecounts, -torch.inf).amax(dim=1, keepdim=True)
        empty_v = ~pos1 & present_v
        no_empty = ~empty_v.any(dim=1, keepdim=True)
        rotate_ok = torch.where(
            no_empty, pos1 & (ecounts <= minc1) & (maxc1 > minc1), empty_v
        )
        seg_allowed = torch.cat(
            [torch.where(even_enforce[:, None], rotate_ok, True), value_less], dim=1
        )
        seg_max = torch.where(seg_plane, score1[:, None, :], -torch.inf).amax(dim=2)
        seg_max = torch.where(seg_allowed, seg_max, -torch.inf)
        vals, vsel = torch.sort(seg_max, dim=1, descending=True, stable=True)
        vals, vsel = vals[:, : k_seg - 1], vsel[:, : k_seg - 1]
        take_r = (
            (ar_r + n_placed[:, None] + ok0[:, None].long() < counts[:, None])
            & (vals > -torch.inf)
            & ok0[:, None]
        )
        in_seg = seg[:, None, :] == vsel[..., None]  # [G, k_seg−1, N]
        rows_r, _ = _first_argmax(torch.where(in_seg, score1[:, None, :], -torch.inf))

        rows = torch.cat([first[:, None], rows_r], dim=1)
        take = torch.cat([ok0[:, None], take_r], dim=1)
        vals_all = torch.cat([first_val[:, None], vals], dim=1)
        jn = jn + ((ar == rows[..., None]) & take[..., None]).sum(dim=1)
        c = cp.bump(c1, rows_r, take_r)
        n_placed = n_placed + take.sum(dim=1)
        choices.append(torch.where(take, rows, -1))
        scores.append(torch.where(take, vals_all, -torch.inf))
    return (
        torch.cat(choices, dim=1).to(torch.int32),
        torch.cat(scores, dim=1),
    )


# The coupled kernels' C entry points share a leading parameter list:
# the lane inputs, the block inputs, jitter and counts (19 pointers),
# then algorithm_spread, G, N, J, B and V.
_COUPLED_HEAD = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 6
_COUPLED_TAIL = [ctypes.c_void_p] * 4  # scratch, choices, scores, stream
_COUPLED_ARGTYPES = {
    "nomad_place_value_scan": _COUPLED_HEAD + [ctypes.c_int] + _COUPLED_TAIL,
    "nomad_place_spread_chunked": _COUPLED_HEAD + [ctypes.c_int] * 2 + _COUPLED_TAIL,
    "nomad_place_spread_opv": (
        _COUPLED_HEAD + [ctypes.c_void_p] + [ctypes.c_int] * 2 + _COUPLED_TAIL
    ),
}


def _coupled_library(symbol: str):
    lib = cuda_library("coupled")
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = _COUPLED_ARGTYPES[symbol]
        fn.restype = ctypes.c_int
        lib.nomad_coupled_scratch_bytes.argtypes = [ctypes.c_int] * 4 + [
            ctypes.POINTER(ctypes.c_size_t)
        ]
        lib.nomad_coupled_scratch_bytes.restype = ctypes.c_int
    return lib, fn


def coupled_scratch_bytes(symbol: str, n: int, nb: int, nv: int) -> int:
    """Global scratch bytes per lane that the coupled kernel ``symbol``
    needs at N nodes, B blocks and V values: 0 where the lane's working
    state fits in the block's shared memory."""
    lib, _ = _coupled_library(symbol)
    out = ctypes.c_size_t(0)
    status = lib.nomad_coupled_scratch_bytes(
        int(symbol == "nomad_place_spread_opv"), n, nb, nv, ctypes.byref(out)
    )
    check_launch(status, symbol)
    return out.value


def coupled_cluster_size(symbol: str, n: int, nb: int, nv: int) -> int:
    """Blocks a lane of the coupled kernel ``symbol`` runs on at N nodes,
    B blocks and V values, decided by shape alone: the thread-block
    cluster's size, or 1 where the lane runs as one block (the block's
    share of the replicated tables and its node slice too large for
    shared memory; for the one-per-value kernel also V + 1 above
    1,024)."""
    lib, _ = _coupled_library(symbol)
    fn = lib.nomad_coupled_cluster
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    status = fn(int(symbol == "nomad_place_spread_opv"), n, nb, nv, ctypes.byref(out))
    check_launch(status, symbol)
    return out.value


def _launch_coupled(what, symbol, lane, blocks, counts, algorithm_spread,
                    max_j, slots, extra, jitter):
    """Check a coupled kernel's inputs, allocate its outputs (and its
    scratch where the working state does not fit in shared memory), launch
    it on the current stream and count the launch on the wrapper ``what``.
    ``lane`` holds the eleven lane inputs in kernel order, ``blocks`` the
    six block inputs, ``extra`` the kernel's own arguments between the
    shared head and the scratch (the enforce index tensor or ints)."""
    vids, counts0, desired, caps, weights, kinds = blocks
    dev = lane[0].device  # capacity
    g, n = lane[3].shape  # eligible
    nb, nv = counts0.shape[1], counts0.shape[2]
    want = _lane_specs(*lane, jitter) + [
        ("block_value_ids", vids, torch.int32, (g, nb, n)),
        ("block_counts0", counts0, torch.float32, (g, nb, nv)),
        ("block_desired", desired, torch.float32, (g, nb, nv)),
        ("block_caps", caps, torch.float32, (g, nb, nv)),
        ("block_weights", weights, torch.float32, (g, nb)),
        ("block_kinds", kinds, torch.int32, (g, nb)),
        ("counts", counts, torch.int32, (g,)),
    ] + [
        ("enforce_idx", e, torch.int32, (g,))
        for e in extra if isinstance(e, torch.Tensor)
    ]
    same_device([t for _, t, _, _ in want], dev, what)
    _check_inputs(what, want)
    # the kernels keep a node's next column in 16 bits
    if not 1 <= max_j < 2**16 or nb < 1 or nv < 1 or n < 1:
        raise ValueError(f"{what}: unsupported shape N={n} J={max_j} B={nb} V={nv}")
    choices = torch.empty((g, slots), dtype=torch.int32, device=dev)
    scores = torch.empty((g, slots), dtype=torch.float32, device=dev)
    if g == 0 or slots == 0:
        return choices, scores
    _, fn = _coupled_library(symbol)
    per_lane = coupled_scratch_bytes(symbol, n, nb, nv)
    scratch = (
        torch.empty((g, per_lane), dtype=torch.uint8, device=dev) if per_lane else None
    )
    ptrs = [t.data_ptr() for t in lane + blocks]
    status = fn(
        *ptrs, None if jitter is None else jitter.data_ptr(), counts.data_ptr(),
        int(bool(algorithm_spread)), g, n, max_j, nb, nv,
        *[e.data_ptr() if isinstance(e, torch.Tensor) else int(e) for e in extra],
        None if scratch is None else scratch.data_ptr(),
        choices.data_ptr(), scores.data_ptr(), current_stream(dev),
    )
    check_launch(status, what)
    # the module-level name, so a stand-in for the wrapper sees the count
    count_launch(globals()[what])
    return choices, scores


@guarded("place_value_scan_kernel")
def place_value_scan(
    capacity, used0, asks, eligible, job_counts, desired_totals,
    penalty_nodes, affinity_scores, has_affinities, distinct_hosts,
    slot_caps, block_value_ids, block_counts0, block_desired, block_caps,
    block_weights, block_kinds, algorithm_spread: bool, counts,
    max_j: int, max_steps: int, jitter=None,
):
    """Greedy sequential placement with per-value count coupling — the
    port of ``place_value_scan_kernel``: (choices i32[G, max_steps],
    scores f32[G, max_steps]), −1/−inf in steps that took nothing. CPU
    tensors run the plain version; CUDA tensors launch
    ``csrc/coupled.cu``."""
    args = (
        capacity, used0, asks, eligible, job_counts, desired_totals,
        penalty_nodes, affinity_scores, has_affinities, distinct_hosts,
        slot_caps, block_value_ids, block_counts0, block_desired, block_caps,
        block_weights, block_kinds,
    )
    if capacity.device.type == "cpu":
        return place_value_scan_plain(
            *args, algorithm_spread, counts, max_j, max_steps, jitter
        )
    return _launch_coupled(
        "place_value_scan", "nomad_place_value_scan", args[:11], args[11:],
        counts, algorithm_spread, max_j, max_steps, [max_steps], jitter,
    )


place_value_scan.launches = 0


@guarded("place_spread_chunked_kernel")
def place_spread_chunked(
    capacity, used0, asks, eligible, job_counts, desired_totals,
    penalty_nodes, affinity_scores, has_affinities, distinct_hosts,
    slot_caps, block_value_ids, block_counts0, block_desired, block_caps,
    block_weights, block_kinds, algorithm_spread: bool, counts,
    max_j: int, chunk: int, n_chunks: int, jitter=None,
):
    """Chunked greedy placement for large spread-coupled groups — the
    port of ``place_spread_chunked_kernel``: (choices i32[G, n_chunks ·
    chunk], scores f32[…]). CPU tensors run the plain version; CUDA
    tensors launch ``csrc/coupled.cu``."""
    args = (
        capacity, used0, asks, eligible, job_counts, desired_totals,
        penalty_nodes, affinity_scores, has_affinities, distinct_hosts,
        slot_caps, block_value_ids, block_counts0, block_desired, block_caps,
        block_weights, block_kinds,
    )
    if capacity.device.type == "cpu":
        return place_spread_chunked_plain(
            *args, algorithm_spread, counts, max_j, chunk, n_chunks, jitter
        )
    if not 1 <= chunk <= CHUNK:
        raise ValueError(f"place_spread_chunked: chunk {chunk} outside [1, CHUNK]")
    return _launch_coupled(
        "place_spread_chunked", "nomad_place_spread_chunked", args[:11],
        args[11:], counts, algorithm_spread, max_j, n_chunks * chunk,
        [chunk, n_chunks], jitter,
    )


place_spread_chunked.launches = 0


@guarded("place_spread_opv_kernel")
def place_spread_opv(
    capacity, used0, asks, eligible, job_counts, desired_totals,
    penalty_nodes, affinity_scores, has_affinities, distinct_hosts,
    slot_caps, block_value_ids, block_counts0, block_desired, block_caps,
    block_weights, block_kinds, enforce_idx, algorithm_spread: bool, counts,
    max_j: int, k_seg: int, n_chunks: int, jitter=None,
):
    """One-per-value chunked placement for even-mode spread groups — the
    port of ``place_spread_opv_kernel``: (choices i32[G, n_chunks ·
    k_seg], scores f32[…]). CPU tensors run the plain version; CUDA
    tensors launch ``csrc/coupled.cu``."""
    args = (
        capacity, used0, asks, eligible, job_counts, desired_totals,
        penalty_nodes, affinity_scores, has_affinities, distinct_hosts,
        slot_caps, block_value_ids, block_counts0, block_desired, block_caps,
        block_weights, block_kinds,
    )
    if capacity.device.type == "cpu":
        return place_spread_opv_plain(
            *args, enforce_idx, algorithm_spread, counts, max_j, k_seg,
            n_chunks, jitter,
        )
    if not 2 <= k_seg <= min(CHUNK, block_counts0.shape[2] + 1):
        raise ValueError(f"place_spread_opv: k_seg {k_seg} outside [2, min(CHUNK, V+1)]")
    return _launch_coupled(
        "place_spread_opv", "nomad_place_spread_opv", args[:11], args[11:],
        counts, algorithm_spread, max_j, n_chunks * k_seg,
        [enforce_idx, k_seg, n_chunks], jitter,
    )


place_spread_opv.launches = 0


def _steps_bucket(n: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return b


def _dummy_ask(pn: int):
    """Zero-count padding lane for the group axis: eligible nowhere, so
    the kernel places nothing and its lane is dropped on unpack."""
    from .flatten import GroupAsk

    return GroupAsk(
        job_id="",
        tg_name="",
        count=0,
        desired_total=1,
        ask=np.zeros(4, dtype=np.float32),
        eligible=np.zeros(pn, dtype=bool),
        job_counts=np.zeros(pn, dtype=np.int32),
        penalty_nodes=np.zeros(pn, dtype=bool),
        affinity_scores=np.zeros(pn, dtype=np.float32),
        has_affinities=False,
        distinct_hosts=False,
    )


def _pad_group_axis(asks: list, pn: int) -> list:
    """Pad the ask list so the group axis takes only two kinds of size:
    1 (single-eval path) or a power of two ≥ 16 (batched path), as the
    reference buckets it. Kept so both packages run the same lanes."""
    n = len(asks)
    g = 1 if n == 1 else max(16, _steps_bucket(n))
    if g == n:
        return asks
    dummy = _dummy_ask(pn)
    return asks + [dummy] * (g - n)


def _shared_batch(asks: list, pn: int) -> dict:
    """Host-side assembly of the dense kernel inputs. The reference
    bit-packs masks and collapses degenerate lanes to [G, 1] for its
    tunnel-attached TPU; here every per-node input is a dense [G, N]
    array, which is what the kernels take."""
    caps = np.stack(
        [
            a.slot_caps
            if a.slot_caps is not None
            else np.full(pn, np.inf, dtype=np.float32)
            for a in asks
        ]
    ).astype(np.float32)
    return dict(
        asks=np.stack([a.ask for a in asks]).astype(np.float32),
        eligible=np.stack([a.eligible for a in asks]).astype(bool),
        job_counts=np.stack([a.job_counts for a in asks]).astype(np.int32),
        desired_totals=np.array(
            [a.desired_total for a in asks], dtype=np.float32
        ),
        penalty_nodes=np.stack([a.penalty_nodes for a in asks]).astype(bool),
        affinity_scores=np.stack(
            [a.affinity_scores for a in asks]
        ).astype(np.float32),
        has_affinities=np.array([a.has_affinities for a in asks], dtype=bool),
        distinct_hosts=np.array([a.distinct_hosts for a in asks], dtype=bool),
        slot_caps=caps,
    )


def _device_batch(batch: dict, device: torch.device) -> dict:
    """Move a host batch dict onto ``device`` (fresh arrays from
    ``_shared_batch``, so aliasing them on the CPU is safe)."""
    return {
        k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
        for k, v in batch.items()
    }


@dataclass
class PlacementResult:
    """Host-side result for one group: chosen node rows (−1 = failed) and
    their normalized scores, in placement order; plus overflow candidates
    (the next entries greedy would have taken) for conflict repair."""

    node_rows: np.ndarray
    scores: np.ndarray
    overflow_rows: np.ndarray = field(
        default_factory=lambda: np.empty(0, dtype=np.int32)
    )
    overflow_scores: np.ndarray = field(
        default_factory=lambda: np.empty(0, dtype=np.float32)
    )
    # score provenance (obs/explain.PlacementExplanation), attached only
    # when the pass ran with explain=True; purely observational
    explanation: Optional[object] = None


def used_device(cluster, used0, device: torch.device) -> torch.Tensor:
    """The one seam every kernel's per-pass ``used`` upload routes
    through. With incremental rescoring on (the tensors carry a
    ``score_cache``), the DeviceStateCache serves a device-resident
    tensor bitwise equal to ``used0`` — only dirty rows travelled;
    otherwise the from-scratch upload, byte for byte the
    pre-incremental one. The tensor has the same shape and dtype either
    way, and no kernel writes into it. ``used0`` is the very array the
    kernel reads (padded rows included), so the cache diffs what the
    kernel sees."""
    cache = getattr(cluster, "score_cache", None)
    if cache is not None:
        dev = cache.score_view(cluster, used0)
        if dev is not None:
            return dev
    return torch.from_numpy(
        np.ascontiguousarray(used0, dtype=np.float32)
    ).to(device)


def capacity_on(cluster, device: torch.device) -> torch.Tensor:
    """The cluster's f32[N, 4] capacity on ``device``: the
    DeviceStateCache's resident tensor when one rode along on the tensors
    and lies there, else a fresh upload."""
    dev = cluster.device_capacity
    if isinstance(dev, torch.Tensor) and dev.device == device:
        return dev
    return torch.from_numpy(
        np.ascontiguousarray(cluster.capacity, dtype=np.float32)
    ).to(device)


class PlacementKernel:
    """Host wrapper: pads a list of GroupAsks into batch tensors on
    ``device``, routes each group to its placement kernel, unpacks
    results."""

    def __init__(
        self,
        algorithm: str = "binpack",
        force_scan: bool = False,
        mesh=None,
        device="cuda",
    ):
        if mesh is not None:
            raise NotImplementedError(
                "nomad_tpu_torch: node-axis sharding over a mesh is not "
                "ported yet (ROADMAP A13)"
            )
        self.device = resolve_device(device)
        self.algorithm = algorithm
        self.algorithm_spread = algorithm == "spread"
        self.force_scan = force_scan  # parity testing: disable the fast path

    def place(
        self,
        cluster,
        asks: list,
        *,
        overflow: int = OVERFLOW_CANDIDATES,
        decorrelate: bool = False,
        decorrelate_salt: int = 0,
        decorrelate_workers: int = 1,  # concurrent batching workers
        used_override=None,  # [pn, D] usage to score against instead
        explain: bool = False,  # attach score provenance (obs/explain)
    ) -> list[PlacementResult]:
        """``overflow`` = extra greedy candidates emitted per lane for
        conflict repair. ``used_override`` replaces the cluster's usage
        as the pass's base (the server's optimistic overlay, or the
        parity stream's own commits). ``decorrelate``: stripe each lane
        onto a disjoint node partition so concurrent-eval lanes stop
        argmaxing onto the same nodes — the vector analog of the
        reference's per-worker shuffle sampling (stack.go:74-90); repair
        re-scores any shortfall against the full node set, so
        partitioning is purely an optimization. ``decorrelate_salt``
        (worker id, or the first eval's job lane) permutes the stripes
        and seeds the tie-break jitter, one f32[N] every kernel of the
        pass takes, so concurrent workers' batches collide at ~1/stripes
        instead of stripe-for-stripe.

        While the breakers are degraded the reference counts a fallback
        pass and finishes refused calls on the CPU. The port has no such
        path: with every breaker forced open the pass raises
        ``KernelUnavailable`` before any work; with one breaker open, the
        kernel guard refuses that kernel's launch alone, so a pass can
        still reach the breaker's half-open probe."""
        if not asks:
            return []
        from ..resilience.breaker import forced_open

        if forced_open():
            from ..resilience.errors import KernelUnavailable

            raise KernelUnavailable("placement pass", "forced_open")
        used0 = np.asarray(
            cluster.used if used_override is None else used_override
        )
        work = asks
        jitter = None
        if decorrelate:
            work = _decorrelate_lanes(
                cluster, asks, salt=decorrelate_salt, used0=used0,
                n_workers=decorrelate_workers,
            )
            rows = np.arange(cluster.padded_n, dtype=np.int64)
            h = (rows * 2654435761 + (decorrelate_salt + 1) * 40503) & 0xFFFFFFFF
            jitter = torch.from_numpy(
                ((h % 65536).astype(np.float32) / 65536.0) * 2e-5
            ).to(self.device)
        # routing: uncoupled groups → closed-form top-k; large
        # spread-coupled groups → chunked (one-per-value variant when an
        # even block is present); small / capped groups → exact scan
        fast, chunked, opv, scan = [], [], [], []
        for i, a in enumerate(work):
            coupled = a.blocks is not None and a.blocks.num_blocks > 0
            if self.force_scan or (coupled and self._needs_exact_scan(a)):
                scan.append(i)
            elif coupled:
                if bool((a.blocks.kinds == BLOCK_EVEN_SPREAD).any()):
                    opv.append(i)
                else:
                    chunked.append(i)
            else:
                fast.append(i)
        out: list[Optional[PlacementResult]] = [None] * len(asks)
        # the span carries the routing split so a trace shows which
        # kernel scored each pass
        with _tracer.span(
            "kernel.place",
            tags={
                "lanes": len(asks),
                "fast": len(fast),
                "chunked": len(chunked),
                "opv": len(opv),
                "scan": len(scan),
            },
        ):
            for idxs, fn in (
                (fast, self._place_closed_form),
                (chunked, self._place_spread_chunked),
                (opv, self._place_spread_opv),
                (scan, self._place_scan_batch),
            ):
                if idxs:
                    results = fn(
                        cluster, [work[i] for i in idxs], overflow, jitter, used0
                    )
                    for i, r in zip(idxs, results):
                        out[i] = r
        if explain:
            # explanations are built host-side against the ORIGINAL asks
            # and the pass's base usage — decorrelation stripes and
            # jitter are a placement optimization repair undoes, not
            # part of the score semantics being explained
            from ..obs.explain import explain_group

            for a, res in zip(asks, out):
                res.explanation = explain_group(
                    cluster, a, used0,
                    algorithm=self.algorithm,
                    algorithm_spread=self.algorithm_spread,
                )
        return out

    @staticmethod
    def _needs_exact_scan(a) -> bool:
        """Cap (distinct_property) blocks can overshoot a per-value
        budget within one chunk, and small groups make short exact scans
        anyway — both stay on the stepwise path."""
        if a.count <= EXACT_SCAN_MAX_COUNT:
            return True
        return bool((a.blocks.kinds == BLOCK_DISTINCT_CAP).any())

    @staticmethod
    def _j_bucket(n: int) -> int:
        """Multiples of 16 up to 128, then multiples of 64 (the
        reference's buckets, so both packages build the same planes)."""
        if n <= 16:
            return 16
        if n <= 24:
            return 24
        if n <= 128:
            return -(-n // 16) * 16
        return -(-n // 64) * 64

    def _max_j(self, cluster, asks: list) -> int:
        """J bound: most instances of one identical ask any node could
        hold, bucketed (see _j_bucket)."""
        cap_max = np.asarray(cluster.capacity).max(axis=0)  # [D]
        max_j = 1
        for a in asks:
            pos = a.ask > 0
            if pos.any():
                j = int(np.floor(np.min(cap_max[pos] / a.ask[pos]))) + 1
            else:
                j = a.count
            max_j = max(max_j, min(j, a.count))
        return self._j_bucket(max_j)

    def _place_closed_form(
        self, cluster, asks: list, overflow: int, jitter, used0,
    ) -> list[PlacementResult]:
        pn = cluster.padded_n
        max_count = max(a.count for a in asks)
        k = _steps_bucket(max(max_count + overflow, 1))
        max_j = self._max_j(cluster, asks)

        # chunk the group axis so one launch's scratch stays within
        # SCRATCH_BUDGET_BYTES (derivation at its definition)
        bytes_per_lane = k * 8 + pn * 14
        chunk = max(1, SCRATCH_BUDGET_BYTES // bytes_per_lane)
        if len(asks) > chunk:
            out: list[PlacementResult] = []
            for i in range(0, len(asks), chunk):
                out.extend(
                    self._place_closed_form(
                        cluster, asks[i:i + chunk], overflow, jitter, used0
                    )
                )
            return out

        real_n = len(asks)
        asks = _pad_group_axis(asks, pn)
        batch = _shared_batch(asks, pn)
        dev = self.device
        choices_t, scores_t = place_closed_form(
            capacity_on(cluster, self.device),
            used_device(cluster, used0, dev),
            **_device_batch(batch, dev),
            algorithm_spread=self.algorithm_spread,
            max_j=max_j,
            k=k,
            jitter=jitter,
        )
        # writable host copies: repair mutates rows in place
        choices = choices_t.cpu().numpy().copy()
        scores = scores_t.cpu().numpy().copy()
        return [
            PlacementResult(
                node_rows=choices[gi, : a.count],
                scores=scores[gi, : a.count],
                overflow_rows=choices[gi, a.count :],
                overflow_scores=scores[gi, a.count :],
            )
            for gi, a in enumerate(asks[:real_n])
        ]


    def _coupled_batch(self, cluster, asks: list, used0) -> dict:
        """Device tensors of a coupled pass: the lane inputs, the padded
        value blocks, capacity and the base usage."""
        from .flatten import pad_value_blocks

        pn = cluster.padded_n
        batch = _shared_batch(asks, pn)
        batch.update(pad_value_blocks([a.blocks for a in asks], pn))
        out = _device_batch(batch, self.device)
        out["capacity"] = capacity_on(cluster, self.device)
        out["used0"] = used_device(cluster, used0, self.device)
        return out

    def _lane_counts(self, asks: list, overflow: int, cap: int):
        """Placements each lane emits: its count plus the overflow slots,
        at most ``cap``; zero-count padding lanes stay inert."""
        counts = np.array([a.count for a in asks], dtype=np.int64)
        return torch.from_numpy(
            np.where(counts > 0, np.minimum(counts + overflow, cap), 0).astype(np.int32)
        ).to(self.device)

    def _place_scan_batch(
        self, cluster, asks: list, overflow: int, jitter, used0,
    ) -> list[PlacementResult]:
        real_n = len(asks)
        asks = _pad_group_axis(asks, cluster.padded_n)
        max_count = max(a.count for a in asks)
        max_steps = _steps_bucket(max(max_count + overflow, 1))
        max_j = self._max_j(cluster, asks)
        choices, scores = place_value_scan(
            **self._coupled_batch(cluster, asks, used0),
            algorithm_spread=self.algorithm_spread,
            counts=self._lane_counts(asks, overflow, max_steps),
            max_j=max_j,
            max_steps=max_steps,
            jitter=jitter,
        )
        return self._unpack_coupled(choices, scores, asks[:real_n], overflow)

    def _place_spread_chunked(
        self, cluster, asks: list, overflow: int, jitter, used0,
    ) -> list[PlacementResult]:
        real_n = len(asks)
        asks = _pad_group_axis(asks, cluster.padded_n)
        max_count = max(a.count for a in asks)
        max_j = self._max_j(cluster, asks)
        # round the chunk count to a multiple of 4, not a power of two:
        # the sequential depth is the dominant cost
        n_chunks = max(4, -(-max(-(-(max_count + overflow) // CHUNK), 1) // 4) * 4)
        choices, scores = place_spread_chunked(
            **self._coupled_batch(cluster, asks, used0),
            algorithm_spread=self.algorithm_spread,
            counts=self._lane_counts(asks, overflow, n_chunks * CHUNK),
            max_j=max_j,
            chunk=CHUNK,
            n_chunks=n_chunks,
            jitter=jitter,
        )
        return self._unpack_coupled(choices, scores, asks[:real_n], overflow)

    def _place_spread_opv(
        self, cluster, asks: list, overflow: int, jitter, used0,
    ) -> list[PlacementResult]:
        real_n = len(asks)
        asks = _pad_group_axis(asks, cluster.padded_n)
        max_j = self._max_j(cluster, asks)
        batch = self._coupled_batch(cluster, asks, used0)
        nv = batch["block_counts0"].shape[2]
        k_seg = min(CHUNK, nv + 1)

        # per lane: the dominant even block, and how many picks one chunk
        # can yield (values of that block held by an eligible node, +1
        # for eligible value-less nodes) — lanes with few values need
        # more sequential chunks
        enforce_idx = np.zeros(len(asks), dtype=np.int32)
        lane_steps = 1
        for gi, a in enumerate(asks):
            b = a.blocks
            if b is None or a.count <= 0:
                continue
            even = np.flatnonzero(b.kinds == BLOCK_EVEN_SPREAD)
            if even.size:
                enforce_idx[gi] = even[np.argmax(b.weights[even])]
            ev = b.value_ids[enforce_idx[gi]]
            elig = a.eligible
            v_act = len(np.unique(ev[(ev >= 0) & elig])) + int(
                ((ev < 0) & elig).any()
            )
            per_chunk = max(1, min(k_seg, v_act))
            lane_steps = max(lane_steps, -(-(a.count + overflow) // per_chunk))
        # multiple-of-4 rounding; +2 slack chunks: the rotation guard makes
        # a chunk starting from uneven counts yield fewer than v_act picks
        n_chunks = max(4, -(-(lane_steps + 2) // 4) * 4)
        # each step picks distinct nodes, so a node gains at most one
        # instance per step: its column never passes n_chunks
        max_j = min(max_j, self._j_bucket(n_chunks + 1))
        choices, scores = place_spread_opv(
            **batch,
            enforce_idx=torch.from_numpy(enforce_idx).to(self.device),
            algorithm_spread=self.algorithm_spread,
            counts=self._lane_counts(asks, overflow, n_chunks * k_seg),
            max_j=max_j,
            k_seg=k_seg,
            n_chunks=n_chunks,
            jitter=jitter,
        )
        return self._unpack_coupled(choices, scores, asks[:real_n], overflow)

    @staticmethod
    def _unpack_coupled(choices, scores, asks, overflow):
        """Compact each lane's valid picks (greedy emission order) into
        count primary + overflow slots. The one-per-value kernel can leave
        empty slots between chunks (a chunk is capped at one pick per
        value, not by feasibility), so valid picks are compacted rather
        than sliced positionally."""
        choices = choices.cpu().numpy()
        scores = scores.cpu().numpy()
        out = []
        for gi, a in enumerate(asks):
            row = choices[gi]
            valid = row >= 0
            vrows = row[valid]
            vscores = scores[gi][valid]
            node_rows = np.full(a.count, -1, dtype=np.int32)
            sc = np.full(a.count, -np.inf, dtype=np.float32)
            n_primary = min(a.count, vrows.shape[0])
            node_rows[:n_primary] = vrows[:n_primary]
            sc[:n_primary] = vscores[:n_primary]
            of_rows = np.full(overflow, -1, dtype=np.int32)
            of_sc = np.full(overflow, -np.inf, dtype=np.float32)
            n_of = min(overflow, max(0, vrows.shape[0] - a.count))
            of_rows[:n_of] = vrows[a.count : a.count + n_of]
            of_sc[:n_of] = vscores[a.count : a.count + n_of]
            out.append(
                PlacementResult(
                    node_rows=node_rows,
                    scores=sc,
                    overflow_rows=of_rows,
                    overflow_scores=of_sc,
                )
            )
        return out


def _decorrelate_lanes(
    cluster, asks: list, salt: int = 0, used0=None, n_workers: int = 1
) -> list:
    """Stripe each batch lane onto a disjoint subset of node rows
    (row % n_lanes == lane). Concurrent lanes scoring the same snapshot
    otherwise compute near-identical greedy sequences and pile onto the
    same nodes — the r3 bench measured a 92.9% conflict-fallback rate.
    The reference decorrelates its parallel workers by per-worker node
    shuffling + limit sampling (stack.go:74-90); a 1/L stripe of a 10k
    cluster still offers each lane more candidates than the reference's
    ≥100-node sample. Lanes whose stripe leaves thin headroom (or whose
    constraints concentrate eligibility) keep the full node set — repair
    resolves whatever conflicts remain."""
    from dataclasses import replace

    n_lanes = len(asks)
    if n_lanes < 2:
        return asks
    pn = cluster.padded_n
    # stripes decorrelate lanes WITHIN one batch; concurrent workers are
    # decorrelated by the score jitter (mod-l permutations of the row
    # index only relabel the same congruence classes, so salting the
    # stripe math cross-worker is a no-op — the salt instead rotates
    # which lane gets which class, and seeds the jitter in place())
    rows = np.arange(pn)
    # Stripe on a HASHED row index, not the raw row: raw `rows % l_eff`
    # interacts arithmetically with any attribute laid out periodically
    # over rows (racks assigned round-robin: rack = row % n_racks). When
    # gcd(l_eff, n_racks) > 1 each stripe reaches only n_racks/gcd of the
    # rack values, the reachability guard below rejects every lane, and
    # the whole batch falls back to the full node set — measured as a
    # 34× repair blow-up at 64 lanes × 25 racks. A multiplicative hash
    # de-correlates stripe membership from any row-periodic attribute, so
    # each stripe samples all values ~uniformly.
    row_hash = (rows.astype(np.uint64) * np.uint64(2654435761)) & np.uint64(
        0xFFFFFFFF
    )
    # CONCURRENT batching workers must not share stripes at all: the salt
    # only rotates lane→stripe assignment within the same congruence
    # classes, so two workers' passes land one lane from each on every
    # stripe and argmax the same best nodes (measured 0.83+ conflict at
    # 2×32 deep). Partition the node universe by worker FIRST (a second,
    # independent hash so it doesn't alias the lane stripes), then stripe
    # within each worker's slice.
    worker_universe = None
    if n_workers > 1:
        h2 = (rows.astype(np.uint64) * np.uint64(0x9E3779B1)) & np.uint64(
            0xFFFFFFFF
        )
        worker_universe = (h2 % np.uint64(n_workers)).astype(np.int64) == (
            salt % n_workers
        )
    free = np.asarray(cluster.capacity) - (
        np.asarray(cluster.used) if used0 is None else np.asarray(used0)
    )  # [pn, D]
    out = []
    for i, a in enumerate(asks):
        if a.count <= 0:
            out.append(a)
            continue
        # Widest stripe count that still leaves this lane comfortable
        # headroom, measured in feasible INSTANCE SLOTS (Σ per-node jmax),
        # not node count — a node holds many instances of one ask, and
        # sizing by nodes (the old 2×count heuristic) capped l_eff at
        # ~N/(2·count), forcing lanes to share stripes and collide (the
        # measured 11.7 s repair blow-up at 64 lanes). When even the
        # slot-based 1/n_lanes stripe is too thin, lanes SHARE coarser
        # stripes (conflicts only within a stripe group) instead of
        # abandoning decorrelation entirely.
        pos = a.ask > 0
        if pos.any():
            jn = np.floor(
                np.min(free[:, pos] / a.ask[pos], axis=1)
            ).clip(min=0)
        else:
            jn = np.full(pn, float(a.count))
        jn = np.where(a.eligible, jn, 0.0)

        # full-set value vocabulary per block, computed ONCE per ask —
        # the reachability closure runs up to twice per lane in the hot
        # decorrelation path
        full_vals_per_block = (
            [
                np.unique(
                    a.blocks.value_ids[b][
                        (a.blocks.value_ids[b] >= 0) & a.eligible
                    ]
                ).shape[0]
                for b in range(a.blocks.num_blocks)
            ]
            if a.blocks is not None
            else []
        )

        def values_reachable(mask) -> bool:
            # a node subset must not silently amputate spread/cap values:
            # every value reachable from the full eligible set must stay
            # reachable from the subset (rack-contiguous row orderings
            # with racks smaller than the lane count would otherwise skew
            # the spread with no error surfaced)
            if a.blocks is None:
                return True
            for b in range(a.blocks.num_blocks):
                vids = a.blocks.value_ids[b]
                sub_vals = np.unique(vids[(vids >= 0) & mask])
                if full_vals_per_block[b] != sub_vals.shape[0]:
                    return False
            return True

        # this worker's node slice first (cross-worker disjointness),
        # provided it still holds the lane's ask comfortably — else fall
        # back to the full set and let repair/applier arbitrate
        from ..utils.metrics import global_metrics as _metrics

        base_elig = a.eligible
        if worker_universe is not None:
            wu_elig = a.eligible & worker_universe
            if (
                float(jn[wu_elig].sum()) >= 2 * a.count
                and int(wu_elig.sum()) >= 8
                and values_reachable(wu_elig)
            ):
                base_elig = wu_elig
                _metrics.incr("nomad.kernel.lane_universe_applied")
            else:
                _metrics.incr("nomad.kernel.lane_universe_skipped")
        jn_w = np.where(base_elig, jn, 0.0)
        total_elig = int(base_elig.sum())
        slots = float(jn_w.sum())
        l_eff = min(
            n_lanes,
            max(1, min(
                int(slots // max(4 * a.count, 1)), total_elig // 8
            )),
        )
        if l_eff < 2:
            out.append(
                replace(a, eligible=base_elig)
                if base_elig is not a.eligible
                else a
            )
            continue
        in_stripe = (
            (row_hash % np.uint64(l_eff)).astype(np.int64)
            == ((i + salt) % l_eff)
        )
        elig = base_elig & in_stripe
        # the stripe must still hold 2× the lane's ask in feasible slots
        ok = float(jn_w[elig].sum()) >= 2 * a.count and int(
            elig.sum()
        ) >= 8
        if ok:
            ok = values_reachable(elig)
        if ok:
            _metrics.incr("nomad.kernel.lane_striped")
            out.append(replace(a, eligible=elig))
        elif base_elig is not a.eligible:
            # stripe rejected but the worker slice is viable: keep
            # cross-worker disjointness at least
            _metrics.incr("nomad.kernel.lane_universe_only")
            out.append(replace(a, eligible=base_elig))
        else:
            _metrics.incr("nomad.kernel.lane_full_set")
            out.append(a)
    return out


def _host_block_tables(c, blocks):
    """NumPy mirror of _block_tables for one lane's [B, V] count state."""
    boost = np.zeros_like(c)
    allow = np.ones_like(c, dtype=bool)
    for b in range(blocks.num_blocks):
        kind = blocks.kinds[b]
        if kind == BLOCK_TARGET_SPREAD:
            d = blocks.desired[b]
            boost[b] = np.where(
                d > 0,
                (d - (c[b] + 1.0)) / np.maximum(d, 1e-9) * blocks.weights[b],
                -1.0,
            )
        elif kind == BLOCK_EVEN_SPREAD:
            pos = c[b] > 0
            if pos.any():
                minc = float(c[b][pos].min())
                maxc = float(c[b][pos].max())
                at_min = c[b] == minc
                boost[b] = np.where(
                    at_min,
                    -1.0 if minc == maxc else (maxc - minc) / max(minc, 1e-9),
                    (minc - c[b]) / max(minc, 1e-9),
                )
        elif kind == BLOCK_DISTINCT_CAP:
            allow[b] = c[b] < blocks.caps[b]
    return boost, allow


def _rescore_pick(capacity, used, a, placed_on_node, counts, algorithm_spread):
    """Exact host-side argmax for one additional placement of ``a``
    against a usage overlay — the same component semantics as the device
    kernels (see module docstring), in one vectorized NumPy pass. Used by
    repair when a lane's precomputed overflow candidates run out, so a
    conflicted placement is re-placed instead of aborting the whole eval.
    Returns (row, score) with row −1 when nothing fits."""
    prop = used + a.ask[None, :]
    fits = np.all(prop <= capacity, axis=1) & a.eligible
    jc = a.job_counts + placed_on_node
    if a.distinct_hosts:
        fits &= jc == 0
    if a.slot_caps is not None:
        fits &= placed_on_node < a.slot_caps
    blocks = a.blocks
    boost = np.zeros(capacity.shape[0], dtype=np.float32)
    has_spread_any = False
    if blocks is not None:
        tbl_boost, tbl_allow = _host_block_tables(counts, blocks)
        for b in range(blocks.num_blocks):
            vids = blocks.value_ids[b]
            safe = np.maximum(vids, 0)
            if blocks.kinds[b] == BLOCK_DISTINCT_CAP:
                fits &= np.where(vids >= 0, tbl_allow[b][safe], True)
            elif blocks.kinds[b] in (BLOCK_TARGET_SPREAD, BLOCK_EVEN_SPREAD):
                has_spread_any = True
                boost += np.where(vids >= 0, tbl_boost[b][safe], -1.0)
    if not fits.any():
        return -1, -np.inf
    free = np.where(
        capacity > 0, (capacity - prop) / np.maximum(capacity, 1e-9), 1.0
    )
    pow_sum = 10.0 ** free[:, 0] + 10.0 ** free[:, 1]
    binpack = np.clip(20.0 - pow_sum, 0.0, BINPACK_MAX_SCORE)
    spread_fit = np.clip(pow_sum - 2.0, 0.0, BINPACK_MAX_SCORE)
    fit_score = (spread_fit if algorithm_spread else binpack) / BINPACK_MAX_SCORE
    coll = jc.astype(np.float32)
    anti = np.where(jc > 0, -(coll + 1.0) / max(a.desired_total, 1.0), 0.0)
    resched = np.where(a.penalty_nodes, -1.0, 0.0)
    aff = a.affinity_scores if a.has_affinities else 0.0
    spread_on = has_spread_any & (boost != 0.0)
    num = fit_score + anti + resched + aff + np.where(spread_on, boost, 0.0)
    den = (
        1.0
        + (jc > 0)
        + a.penalty_nodes
        + (1.0 if a.has_affinities else 0.0)
        + spread_on
    )
    score = np.where(fits, num / den, -np.inf)
    row = int(np.argmax(score))
    return row, float(score[row])


def repair_batch_conflicts(
    cluster,
    asks: list,
    results: list,
    algorithm_spread: bool = False,
    fail_on_contention: bool = False,
    lane_groups: Optional[list] = None,
    used_override=None,  # [pn, D] optimistic base usage (pipelined passes)
) -> list[bool]:
    """Host-side optimistic-conflict resolution for one batched pass.

    Every lane scored against the same snapshot ``used0``, so lanes can
    pile onto the same best nodes (true argmax removes the decorrelation
    the reference gets from per-worker shuffle sampling, stack.go:74-90;
    ``_decorrelate_lanes`` removes most of it up front). Walk the lanes
    in order with a usage overlay: placements that no longer
    fit move to the lane's next overflow candidate, and when overflow
    runs out an exact NumPy re-score places them directly — only the
    *conflicted placement* is re-placed, never the whole eval. Kernel
    failures (row −1, e.g. a lane whose candidates ran out) get the same
    re-score. The plan applier's per-node AllocsFit re-check
    (plan_apply.go:638-689) remains the authority.

    Mutates each PlacementResult in place. Returns per-lane ``ok`` —
    False only when a placement is unplaceable under the batch overlay
    but WOULD fit without the other lanes' placements (true cross-eval
    contention): that eval should re-run individually against fresh
    state, where preemption and retries apply. Intrinsically infeasible
    placements (caps exhausted, cluster full even alone) stay −1 with
    ok=True — they'd fail individually too, and become blocked evals.

    ``lane_groups`` (optional, parallel to ``asks``) marks lanes that
    belong to one EVAL (a multi-task-group eval spans several lanes and
    the caller discards the whole eval when any lane fails): a contention
    failure releases the overlay reservations of EVERY processed lane in
    the group and skips its remaining lanes — sibling placements of a
    discarded plan must not stay reserved against later lanes.
    """
    capacity = np.asarray(cluster.capacity)
    used0 = (
        np.asarray(cluster.used)
        if used_override is None
        else np.asarray(used_override)
    )
    used = used0.copy()
    ok_lanes: list[bool] = []
    # group id -> [(placed_on_node, ask), ...] commit journal for rollback
    group_commits: dict = {}
    failed_groups: set = set()
    for lane_idx, (a, res) in enumerate(zip(asks, results)):
        group = lane_groups[lane_idx] if lane_groups is not None else lane_idx
        if group in failed_groups:
            # a sibling lane of this eval already hit contention: the
            # whole eval re-runs individually, so don't reserve anything
            ok_lanes.append(False)
            continue
        ok = True
        # within-lane placements per node (distinct_hosts, slot caps,
        # anti-affinity collisions all key off it)
        placed_on_node: dict[int, int] = {}
        blocks = a.blocks
        counts = blocks.counts0.copy() if blocks is not None else None
        overflow = list(
            zip(res.overflow_rows.tolist(), res.overflow_scores.tolist())
        )
        of_idx = 0
        dead = False  # lane-intrinsic infeasibility: stop re-scoring

        def commit(row: int) -> None:
            used[row] += a.ask
            placed_on_node[row] = placed_on_node.get(row, 0) + 1
            if blocks is not None:
                for b in range(blocks.num_blocks):
                    v = blocks.value_ids[b, row]
                    if v >= 0:
                        counts[b, v] += 1

        def acceptable(row: int) -> bool:
            if row < 0:
                return False
            if not np.all(used[row] + a.ask <= capacity[row]):
                return False
            mine = placed_on_node.get(row, 0)
            if a.distinct_hosts and (a.job_counts[row] + mine) > 0:
                return False
            if a.slot_caps is not None and mine >= a.slot_caps[row]:
                return False
            if blocks is not None:
                for b in range(blocks.num_blocks):
                    if blocks.kinds[b] != BLOCK_DISTINCT_CAP:
                        continue
                    v = blocks.value_ids[b, row]
                    if v >= 0 and counts[b, v] >= blocks.caps[b, v]:
                        return False
            return True

        def rescore(i: int) -> str:
            """Exact re-place of placement ``i``. Returns 'placed',
            'contention' (fits alone, not under the overlay), or
            'intrinsic'."""
            pm = np.zeros(capacity.shape[0], dtype=np.float32)
            for r, m in placed_on_node.items():
                pm[r] = m
            row, sc = _rescore_pick(
                capacity, used, a, pm, counts, algorithm_spread
            )
            if row >= 0:
                res.node_rows[i] = row
                res.scores[i] = sc
                commit(row)
                return "placed"
            # would it fit with only this lane's own placements applied?
            lane_used = used0 + pm[:, None] * a.ask[None, :]
            row, _sc = _rescore_pick(
                capacity, lane_used, a, pm, counts, algorithm_spread
            )
            return "contention" if row >= 0 else "intrinsic"

        for i, row in enumerate(res.node_rows.tolist()):
            if row >= 0 and acceptable(row):
                commit(row)
                continue
            if dead:
                res.node_rows[i] = -1
                res.scores[i] = -np.inf
                continue
            # conflicted or unplaced: advance through overflow candidates
            repl = -1
            while of_idx < len(overflow):
                cand, sc = overflow[of_idx]
                of_idx += 1
                if acceptable(cand):
                    repl = cand
                    res.node_rows[i] = cand
                    res.scores[i] = sc
                    commit(cand)
                    break
            if repl >= 0:
                continue
            outcome = rescore(i)
            if outcome == "contention" and not fail_on_contention:
                # this eval re-runs individually on fresh state — its plan
                # is NOT submitted, so its already-committed placements
                # must not stay reserved in the shared overlay (phantom
                # reservations would cascade later lanes into serial
                # fallbacks a fresh-state rerun would avoid). Release this
                # lane AND every processed sibling lane of the same eval.
                for r, m in placed_on_node.items():
                    used[r] -= m * a.ask
                for sib_placed, sib_ask in group_commits.get(group, ()):
                    for r, m in sib_placed.items():
                        used[r] -= m * sib_ask
                failed_groups.add(group)
                ok = False
                break
            if outcome in ("intrinsic", "contention"):
                # fail_on_contention (single-eval path): there is no
                # fresher state to retry against, so an unplaceable
                # placement becomes a recorded failure instead of a
                # shipped-overcommitted row the applier would bounce
                res.node_rows[i] = -1
                res.scores[i] = -np.inf
                dead = True
        if ok and lane_groups is not None:
            group_commits.setdefault(group, []).append(
                (placed_on_node, a.ask)
            )
        ok_lanes.append(ok)
    return ok_lanes
