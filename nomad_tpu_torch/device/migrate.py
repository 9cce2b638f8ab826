"""Bounded-budget migration planning on the dense (allocs × nodes) grid,
on PyTorch and CUDA.

Ports ``nomad_tpu/device/migrate.py``, the device half of the migration
plane. Given the dense score matrix over candidate allocs (rows) and
nodes (columns), select a bounded set of moves maximizing score-delta
gain minus a per-alloc migration cost, with the auction machinery of
``device/cp.py``:

  1. price the grid: ``gain[a, n] = score[a, n] − cur_score[a]
     − move_cost[a] − λ[n]`` (λ = per-node congestion price, risen by
     exact integer claim counts × a power-of-two step);
  2. a move is feasible only where the replacement fits on top of the
     node's committed ``used`` — the source node is never credited back
     inside the pass (during a two-phase move the old alloc still runs
     while the replacement starts), on an eligible node other than the
     current one, with strictly positive priced gain;
  3. every unmoved alloc claims its argmax node (first index on ties);
     each claimed node admits one claimant, the highest priced gain and
     the first alloc on ties (``_cp_winners`` with a flat priority row);
  4. an exclusive integer prefix over node index caps committed moves at
     ``budget``; λ rises on contested nodes and decays on unclaimed ones,
     and the loop repeats until a round finds no claimant or the budget
     is spent.

``migrate_plan_plain`` is the reference's round spelled out in torch
ops, the CPU path and the oracle ``chip_smoke.py`` holds the kernel
against; ``migrate_plan`` launches the hand-written kernel of
``csrc/migrate.cu`` on a CUDA tensor or raises. Both are bit-identical
to the reference: every carried value is f32/i32, every op elementwise,
argmax or an exact integer sum or prefix, ties on the first index.
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
from .cp import _NEG_INF, ETA, _cp_winners
from .score import _check_inputs

# the kernel reads capacity and sizes as one float4 per row
_D = 4


# -- shared round math (torch, the reference's op order) ---------------------


def _mig_feasible(capacity, used, sizes, eligible, cur, gain):
    """bool[A, N]: replacement fits on top of committed ``used`` ∧
    eligible ∧ not the current node ∧ strictly positive priced gain."""
    proposed = used[None, :, :] + sizes[:, None, :]  # [A, N, D]
    fits = (proposed <= capacity[None, :, :]).all(dim=-1)
    ar_n = torch.arange(capacity.shape[0], device=capacity.device)
    not_cur = cur[:, None] != ar_n[None, :]
    return fits & eligible & not_cur & (gain > 0.0)


def _mig_gain(scores, cur_scores, move_cost, lam):
    """f32[A, N] priced move gain (elementwise)."""
    return scores - cur_scores[:, None] - move_cost[:, None] - lam[None, :]


def _mig_allow(has, claim, moves, budget):
    """bool[A] per-claimant budget admission: an exclusive integer prefix
    over node index ranks this round's claimed nodes; only the first
    ``budget − moves`` of them commit."""
    has_i = has.to(torch.int32)
    rank = torch.cumsum(has_i, 0) - has_i
    allow_node = (moves + rank) < budget
    return allow_node[claim.long()]


def _mig_specs(capacity, used0, sizes, cur, eligible, scores, cur_scores,
               move_cost, lam0):
    a, n = scores.shape
    d = capacity.shape[1] if capacity.dim() == 2 else -1
    return [
        ("capacity", capacity, torch.float32, (n, d)),
        ("used0", used0, torch.float32, (n, d)),
        ("sizes", sizes, torch.float32, (a, d)),
        ("cur", cur, torch.int32, (a,)),
        ("eligible", eligible, torch.bool, (a, n)),
        ("scores", scores, torch.float32, (a, n)),
        ("cur_scores", cur_scores, torch.float32, (a,)),
        ("move_cost", move_cost, torch.float32, (a,)),
        ("lam0", lam0, torch.float32, (n,)),
    ]


def _check_migrate(what, inputs, budget) -> None:
    same_device(inputs, inputs[0].device, what)
    if inputs[5].dim() != 2:
        raise ValueError(f"{what}: scores must be [A, N]")
    _check_inputs(what, _mig_specs(*inputs))
    if inputs[5].shape[1] < 1:
        raise ValueError(f"{what}: unsupported shape N=0")
    if not -(2**31) <= int(budget) < 2**31:
        raise ValueError(f"{what}: budget {budget} outside int32")


def _initial_outputs(used0, scores, lam0):
    """(dest, gains, used, moves, rounds, lam) before any round."""
    a = scores.shape[0]
    dev = scores.device
    return (
        torch.full((a,), -1, dtype=torch.int32, device=dev),
        torch.zeros(a, dtype=torch.float32, device=dev),
        used0.clone(),
        torch.zeros((), dtype=torch.int32, device=dev),
        torch.zeros((), dtype=torch.int32, device=dev),
        lam0.clone(),
    )


def migrate_plan_plain(capacity, used0, sizes, cur, eligible, scores,
                       cur_scores, move_cost, budget, lam0, steps: int):
    """Plain PyTorch version of ``migrate_plan``: the reference's
    while-loop, round by round (one host sync a round). An empty alloc
    axis plans nothing."""
    inputs = (capacity, used0, sizes, cur, eligible, scores, cur_scores,
              move_cost, lam0)
    _check_migrate("migrate_plan_plain", inputs, budget)
    dest, gains, used, moves_t, rounds_t, lam = _initial_outputs(used0, scores, lam0)
    a = scores.shape[0]
    if a == 0:
        return dest, gains, used, moves_t, rounds_t, lam
    dev = scores.device
    budget = int(budget)
    ar_a = torch.arange(a, device=dev)
    prio = torch.zeros(a, dtype=torch.float32, device=dev)  # flat: pure gain
    moves = rounds = it = 0
    progress = True
    while it < steps and progress:
        gain = _mig_gain(scores, cur_scores, move_cost, lam)
        feas = _mig_feasible(capacity, used, sizes, eligible, cur, gain)
        active = dest < 0
        umask = torch.where(feas, gain, float(_NEG_INF))
        claim, claimable, won, win, has, claims = _cp_winners(
            umask, feas, active, prio
        )
        won = won & _mig_allow(has, claim, moves, budget)
        has_i = has.to(torch.int32)
        has_won = has & ((moves + torch.cumsum(has_i, 0) - has_i) < budget)
        delta = torch.where(has_won[:, None], sizes[win.long()], 0.0)
        used = used + delta
        dest = torch.where(won, claim, dest)
        gains = torch.where(won, gain[ar_a, claim.long()], gains)
        moves += int(won.sum())
        lam = lam + float(ETA) * torch.clamp(claims - 1, min=0).to(torch.float32)
        lam = torch.where(
            claims == 0, torch.clamp(lam - float(ETA), min=0.0), lam
        )
        any_claim = bool(claimable.any())
        progress = any_claim and moves < budget
        rounds += int(any_claim)
        it += 1
    moves_t.fill_(moves)
    rounds_t.fill_(rounds)
    return dest, gains, used, moves_t, rounds_t, lam


# -- the kernel ----------------------------------------------------------------


_MIGRATE_ARGTYPES = (
    [ctypes.c_void_p] * 7  # capacity, sizes, cur, eligible, scores,
    # cur_scores, move_cost
    + [ctypes.c_int] * 5  # a, n, d, budget, steps
    + [ctypes.c_void_p] * 8  # scratch, used, lam, dest, gains, moves,
    # rounds, stream
)


def _migrate_library(symbol: str):
    fn = getattr(cuda_library("migrate"), symbol)
    if fn.argtypes is None:
        if symbol == "nomad_migrate_scratch_words":
            fn.argtypes = [ctypes.c_int] * 2  # a, n
            fn.restype = ctypes.c_longlong
        else:
            fn.argtypes = _MIGRATE_ARGTYPES
            fn.restype = ctypes.c_int
    return fn


class _MigrateCall:
    """One prepared launch: the zero-filled scratch (mostly each row's
    list of its best candidate nodes, up to 1,024 of them, 8 bytes each)
    and the outputs.
    Calling it launches on the current stream with no host sync;
    ``reset`` puts the outputs and the scratch back to their initial
    values (``chip_smoke.py`` times it so)."""

    def __init__(self, inputs, budget, steps):
        self.inputs = inputs
        self.budget, self.steps = int(budget), int(steps)
        capacity, used0, scores, lam0 = inputs[0], inputs[1], inputs[5], inputs[8]
        self.dev = capacity.device
        for name, t in (("capacity", capacity), ("sizes", inputs[2])):
            if t.data_ptr() % 16:
                raise ValueError(f"migrate_plan: {name} must be 16-byte aligned")
        with torch.cuda.device(self.dev):
            words = _migrate_library("nomad_migrate_scratch_words")(*scores.shape)
        if words < 0:
            raise RuntimeError(
                f"migrate_plan: scratch sizing failed with cudaError {-words}"
            )
        self.scratch = torch.zeros(int(words), dtype=torch.int32, device=self.dev)
        self.outputs = _initial_outputs(used0, scores, lam0)

    def reset(self):
        dest, gains, used, moves, rounds, lam = self.outputs
        dest.fill_(-1)
        gains.zero_()
        used.copy_(self.inputs[1])
        moves.zero_()
        rounds.zero_()
        lam.copy_(self.inputs[8])
        self.scratch.zero_()

    def __call__(self):
        capacity, _, sizes, cur, eligible, scores, cur_scores, move_cost, _ = self.inputs
        dest, gains, used, moves, rounds, lam = self.outputs
        a, n = scores.shape
        with torch.cuda.device(self.dev):
            status = _migrate_library("nomad_migrate_plan")(
                *[t.data_ptr() for t in (capacity, sizes, cur, eligible, scores,
                                         cur_scores, move_cost)],
                a, n, capacity.shape[1], self.budget, self.steps,
                *[t.data_ptr() for t in (self.scratch, used, lam, dest, gains,
                                         moves, rounds)],
                current_stream(self.dev),
            )
        check_launch(status, "migrate_plan")


def _migrate_call(inputs, budget, steps):
    """The prepared launch, or None when there is nothing to run."""
    if inputs[5].shape[0] == 0 or steps < 1:
        return None
    return _MigrateCall(inputs, budget, steps)


def _launch_migrate(inputs, budget, steps):
    """Checked inputs, one launch of ``nomad_migrate_plan`` counted on
    ``migrate_plan`` once it is accepted. Returns the six outputs."""
    _check_migrate("migrate_plan", inputs, budget)
    if inputs[0].shape[1] != _D:
        raise ValueError(f"migrate_plan: the kernel takes D={_D} resource dims")
    call = _migrate_call(inputs, budget, steps)
    if call is None:
        return _initial_outputs(inputs[1], inputs[5], inputs[8])
    call()
    # the module-level name, so a stand-in for the wrapper sees the count
    count_launch(globals()["migrate_plan"])
    return call.outputs


@guarded(
    "migrate_plan_kernel",
    # a build budget of 1: the one load of csrc/migrate.cu a process makes
    build_budget=1,
    library="migrate",
    symbols=("nomad_migrate_plan",),
)
def migrate_plan(
    capacity,  # f32[N, D]
    used0,  # f32[N, D] committed usage (sources NOT pre-freed)
    sizes,  # f32[A, D] per-alloc resource vectors
    cur,  # i32[A] current node row per candidate alloc
    eligible,  # bool[A, N] feasibility mask for the replacement
    scores,  # f32[A, N] dense score matrix
    cur_scores,  # f32[A] score at the alloc's current node
    move_cost,  # f32[A] per-alloc migration cost (priced against gain)
    budget,  # int: max moves this plan
    lam0,  # f32[N] initial prices
    steps: int,
):
    """Auction rounds — the port of ``migrate_plan_kernel``. Returns
    (dest i32[A] (-1 = stay), gains f32[A] (0 where staying), used
    f32[N, D] with every planned replacement committed, moves i32 (0-dim),
    rounds i32 (0-dim), lam f32[N]). CPU tensors run the plain version;
    CUDA tensors launch ``csrc/migrate.cu``."""
    inputs = (capacity, used0, sizes, cur, eligible, scores, cur_scores,
              move_cost, lam0)
    if capacity.device.type == "cpu":
        return migrate_plan_plain(*inputs[:8], budget, lam0, steps)
    return _launch_migrate(inputs, budget, steps)


migrate_plan.launches = 0


# -- host helpers ------------------------------------------------------------


def packing_efficiency(
    capacity: np.ndarray, used: np.ndarray, ready: np.ndarray
) -> float:
    """Fleet packing efficiency in [0, 1]: how many ready nodes are
    COMPLETELY empty versus the most that could be, were the current
    load repacked perfectly (per-dim ceiling over a homogeneous fleet's
    max node capacity). 1.0 = load is as consolidated as arithmetic
    allows; fragmented fleets score low because load is smeared thinly
    across many nodes. The defrag gate measures recovery of this gauge."""
    ready = np.asarray(ready, dtype=bool)
    cap = np.asarray(capacity, dtype=np.float64)[ready]
    use = np.asarray(used, dtype=np.float64)[ready]
    n = int(ready.sum())
    if n == 0:
        return 1.0
    total = use.sum(axis=0)
    per_node = cap.max(axis=0)
    need = 0
    for d in range(cap.shape[1]):
        if per_node[d] <= 0.0:
            continue
        need = max(need, int(np.ceil(total[d] / per_node[d])))
    ideal_empty = n - min(need, n)
    if ideal_empty <= 0:
        return 1.0
    empty = int((use.sum(axis=1) == 0.0).sum())
    return float(empty) / float(ideal_empty)
