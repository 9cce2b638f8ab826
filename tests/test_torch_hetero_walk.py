"""The hetero-greedy kernel's list walk (``csrc/hetero.cu``), modelled in
NumPy and held against the port's plain version and the JAX reference, on
the CPU.

The CUDA kernel cannot run here, so its design is checked through a model
that takes the same decisions in the same order:

- each group's eligible nodes with throughput > 0 in one list, ordered by
  the 64-bit word (order_key(node key) << 32 | ~node) descending;
- a head per group, the first entry that fits, every entry before it
  unfit; the cached job key, +inf once a group is done or its list spent;
- a step: the first-index argmin of the cached keys, the commit from the
  head's cached usage (every row whose head is the committed node takes
  the new usage), then the rows whose head is the committed node and no
  longer fits walk on from it; with a negative (or NaN) ask, also the committed node's column for
  every unfinished row: a row it now fits before its head takes it as
  head at its place in the list (binary search).

The model's outputs must equal ``hetero_place_plain`` and the reference's
``oracle_hetero_place`` bit for bit (uint32 views), on ``hypothesis``
inputs and on the edge cases: all-tie keys, all-infeasible rows, -0.0 in
used0, negative asks, G > 32 and G > 1,024, and cost at or below 1e-9.
On the edge cases the plain version is also held against the reference's
jitted program (``hetero_place_kernel.jitted``: the ``traced_jit``
wrapper cannot run on this jax, ROADMAP C-R1). A test marked ``cuda``
holds the kernel itself against the plain version on the card.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from nomad_tpu.scheduler import hetero as ref_hetero
from nomad_tpu_torch.scheduler import hetero as port_hetero

F32 = np.float32
EPS = F32(1e-9)
MAXMIN, MAKESPAN, COST = 0, 1, 2
INF = F32(np.inf)


def order_key(x) -> int:
    """The kernels' float order as an unsigned 32-bit key (-0 folds onto +0)."""
    x = F32(0.0) if x == 0 else F32(x)
    u = int(np.array(x, F32).view(np.uint32))
    return (~u & 0xFFFFFFFF) if u & 0x80000000 else (u | 0x80000000)


def node_key(policy, tp, cost):
    return F32(tp / np.fmax(cost, EPS)) if policy == COST else F32(tp)


def node_word(key, n) -> int:
    return (order_key(key) << 32) | (0xFFFFFFFF - n)


def word_node(w) -> int:
    return 0xFFFFFFFF - (w & 0xFFFFFFFF)


def job_key(policy, count, tpmax, placed, acc):
    c = F32(count)
    if policy == MAXMIN:
        return F32(acc / np.fmax(F32(c * tpmax), EPS))
    if policy == MAKESPAN:
        return F32(-F32(c / np.fmax(acc, EPS)))
    return F32(-F32(c - F32(placed)))


def list_walk_place(capacity, used0, asks, counts, eligible, tp, tpmax, cost,
                    policy, steps, max_c, stats=None):
    """The kernel's pass, decision for decision. ``stats`` (a dict) gets
    the heads' moves: 'entries' walked, 'walks', 'backward' (monotone
    passes must keep it 0) and 'adopted'."""
    g, n = tp.shape
    used = used0.astype(F32).copy()
    monotone = bool(np.all(asks >= 0))
    lists = []
    for r in range(g):
        words = [node_word(node_key(policy, tp[r, m], cost[m]), m)
                 for m in range(n) if eligible[r, m] and tp[r, m] > 0]
        lists.append(sorted(words, reverse=True))
    placed = np.zeros(g, np.int64)
    accum = np.zeros(g, F32)
    jkey = np.array([job_key(policy, counts[r], tpmax[r], 0, F32(0)) if counts[r] > 0
                     else INF for r in range(g)], F32)
    pos = np.full(g, -1, np.int64)
    hword = [0] * g
    head_used = np.zeros((g, 4), F32)
    choices = np.full((g, max_c), -1, np.int32)
    choice_tp = np.zeros((g, max_c), F32)
    st_ = stats if stats is not None else {}
    for key in ("entries", "walks", "backward", "adopted"):
        st_.setdefault(key, 0)

    def room(r, m):
        return bool(np.all(used[m] + asks[r] <= capacity[m]))

    def walk(r, start):
        st_["walks"] += 1
        for i in range(start, len(lists[r])):
            st_["entries"] += 1
            if room(r, word_node(lists[r][i])):
                if i < pos[r]:
                    st_["backward"] += 1
                pos[r], hword[r] = i, lists[r][i]
                head_used[r] = used[word_node(lists[r][i])]
                return
        pos[r], hword[r] = len(lists[r]), 0
        jkey[r] = INF

    def adopt(r, w):
        st_["adopted"] += 1
        lo, hi = 0, len(lists[r])
        while lo < hi:
            mid = (lo + hi) // 2
            if lists[r][mid] > w:
                lo = mid + 1
            else:
                hi = mid
        pos[r], hword[r] = lo, w
        head_used[r] = used[word_node(w)]
        jkey[r] = job_key(policy, counts[r], tpmax[r], placed[r], accum[r])

    for r in range(g):
        walk(r, 0)
    for _ in range(steps):
        if not np.any(jkey < INF):
            break
        j = int(np.argmin(jkey))
        x = word_node(hword[j])
        # the cached usage of the head is the node's usage, bit for bit
        assert (head_used[j].view(np.uint32) == used[x].view(np.uint32)).all()
        used[x] = head_used[j] + asks[j]
        slot = int(placed[j])
        t = tp[j, x]
        choices[j, slot] = x
        choice_tp[j, slot] = t
        placed[j] = slot + 1
        accum[j] = F32(accum[j] + t)
        jkey[j] = (job_key(policy, counts[j], tpmax[j], placed[j], accum[j])
                   if placed[j] < counts[j] else INF)
        queue = []
        for r in range(g):
            on_x = hword[r] != 0 and word_node(hword[r]) == x
            live = jkey[r] < INF if monotone else placed[r] < counts[r]
            if live and on_x:
                head_used[r] = used[x]
            if monotone:
                if live and on_x and not room(r, x):
                    queue.append((r, "walk"))
            elif live:
                if on_x:
                    if not room(r, x):
                        queue.append((r, "walk"))
                elif (eligible[r, x] and tp[r, x] > 0 and room(r, x)
                      and node_word(node_key(policy, tp[r, x], cost[x]), x) > hword[r]):
                    queue.append((r, "adopt"))
        for r, mode in queue:
            if mode == "walk":
                walk(r, pos[r] + 1)
            else:
                adopt(r, node_word(node_key(policy, tp[r, x], cost[x]), x))
    return choices, choice_tp, used


def assert_bits_equal(got, want, what=""):
    for i, (a, b) in enumerate(zip(got, want)):
        a = np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
        b = np.asarray(b)
        assert a.shape == b.shape, (what, i)
        assert (a.view(np.uint32) == b.astype(a.dtype).view(np.uint32)).all(), (what, i)


def _tpmax(eligible, tp):
    return np.where(eligible, tp, F32(0)).max(axis=1, initial=F32(0)).astype(F32)


def random_inputs(seed, g, n, negative=False, ties=False, tiny_cost=False,
                  cut=False):
    """Small seeded inputs on coarse grids, so keys tie, nodes fill within
    a few steps and rows run out: (args, steps, max_c)."""
    rng = np.random.default_rng(seed)
    cap = rng.choice(np.array([2, 3, 4, 6], F32), size=(n, 4))
    used = rng.choice(np.array([0.0, -0.0, 0.5, 1.0], F32), size=(n, 4))
    asks = rng.choice(np.array([0.0, -0.0, 1.0, 2.0], F32), size=(g, 4))
    if negative:
        asks[rng.random((g, 4)) < 0.2] = F32(-1.0)
    counts = rng.integers(-1, 6, g).astype(np.int32)
    eligible = rng.random((g, n)) < 0.8
    eligible[rng.random(g) < 0.1] = False  # all-infeasible rows
    if ties:
        tp = np.ones((g, n), F32)
    else:
        tp = rng.choice(np.array([0.0, -1.0, 0.5, 1.0, 2.0, 4.0], F32), size=(g, n))
    cost_grid = [1e-10, 0.0, -1.0, 1e-9] if tiny_cost else [1.0, 2.5, 5.0, 1e-10]
    cost = rng.choice(np.array(cost_grid, F32), size=n)
    total = int(np.clip(counts, 0, None).sum())
    steps = max(1, total // 2 if cut else total + 2)
    max_c = max(1, int(counts.max()))
    return (cap, used, asks, counts, eligible, tp, _tpmax(eligible, tp), cost), steps, max_c


def run_all(args, policy, steps, max_c, stats=None):
    model = list_walk_place(*args, policy, steps, max_c, stats=stats)
    plain = port_hetero.hetero_place_plain(
        *[torch.from_numpy(np.ascontiguousarray(a)) for a in args], policy, steps, max_c
    )
    oracle = ref_hetero.oracle_hetero_place(*args, policy, steps, max_c)
    return model, plain, oracle


@settings(max_examples=60, deadline=None, derandomize=True)
@given(
    seed=st.integers(0, 2**32 - 1),
    g=st.integers(1, 40),
    n=st.integers(1, 24),
    policy=st.sampled_from([MAXMIN, MAKESPAN, COST]),
    negative=st.booleans(),
    ties=st.booleans(),
    tiny_cost=st.booleans(),
    cut=st.booleans(),
)
def test_list_walk_model_matches_plain_and_oracle(seed, g, n, policy, negative, ties,
                                                  tiny_cost, cut):
    """The model of the kernel's walk equals the plain version and the
    reference's oracle bit for bit; with no negative ask no head moves
    backward and no row adopts a node."""
    args, steps, max_c = random_inputs(seed, g, n, negative, ties, tiny_cost, cut)
    stats = {}
    model, plain, oracle = run_all(args, policy, steps, max_c, stats)
    assert_bits_equal(plain, oracle, "plain vs oracle")
    assert_bits_equal(model, oracle, "model vs oracle")
    if np.all(args[2] >= 0):
        assert stats["backward"] == 0 and stats["adopted"] == 0


def edge_case(name):
    """(args, steps, max_c, policy) of one named edge case."""
    if name == "all_ties":
        args, steps, max_c = random_inputs(5, 12, 20, ties=True)
        return args, steps, max_c, MAXMIN
    if name == "infeasible_rows_neg0":
        args, steps, max_c = random_inputs(6, 10, 16)
        args[4][:4] = False  # all-infeasible rows
        args[1][:] = np.where(args[1] == 0, F32(-0.0), args[1])
        return args, steps, max_c, MAKESPAN
    if name == "negative_asks":
        args, steps, max_c = random_inputs(7, 16, 20, negative=True)
        return args, steps, max_c, COST
    if name == "negative_asks_ties":
        args, steps, max_c = random_inputs(8, 16, 20, negative=True, ties=True)
        return args, steps, max_c, MAXMIN
    if name == "g40":
        args, steps, max_c = random_inputs(9, 40, 24)
        return args, steps, max_c, MAXMIN
    if name == "tiny_cost":
        args, steps, max_c = random_inputs(10, 12, 20, tiny_cost=True)
        return args, steps, max_c, COST
    if name == "g1030":
        # more groups than the kernel's 1,024 threads: one instance each
        # on 8 nodes with room for about 60 in all
        rng = np.random.default_rng(11)
        g, n = 1030, 8
        cap = np.tile(np.array([16, 16, 100, 100], F32), (n, 1))
        used = np.zeros((n, 4), F32)
        asks = rng.choice(np.array([1.0, 2.0, 3.0], F32), size=(g, 4))
        asks[:, 2:] = F32(0.0)
        counts = np.ones(g, np.int32)
        eligible = rng.random((g, n)) < 0.9
        tp = rng.choice(np.array([0.5, 1.0, 2.0], F32), size=(g, n))
        cost = np.ones(n, F32)
        args = (cap, used, asks, counts, eligible, tp, _tpmax(eligible, tp), cost)
        return args, 128, 1, MAKESPAN
    raise ValueError(name)


EDGE_CASES = ["all_ties", "infeasible_rows_neg0", "negative_asks", "negative_asks_ties",
              "g40", "tiny_cost", "g1030"]


@pytest.mark.parametrize("name", EDGE_CASES)
def test_list_walk_model_edge_cases(name):
    args, steps, max_c, policy = edge_case(name)
    stats = {}
    model, plain, oracle = run_all(args, policy, steps, max_c, stats)
    assert_bits_equal(plain, oracle, f"{name}: plain vs oracle")
    assert_bits_equal(model, oracle, f"{name}: model vs oracle")
    assert int((np.asarray(model[0]) >= 0).sum()) > 0, name
    if "negative" in name:
        assert stats["walks"] > 0


@pytest.mark.parametrize("name", EDGE_CASES)
def test_plain_matches_reference_program_on_edge_cases(name):
    """The plain version against the reference's jitted program."""
    args, steps, max_c, policy = edge_case(name)
    ref = ref_hetero.hetero_place_kernel.jitted(
        *args, policy=policy, steps=steps, max_c=max_c
    )
    plain = port_hetero.hetero_place_plain(
        *[torch.from_numpy(np.ascontiguousarray(a)) for a in args], policy, steps, max_c
    )
    assert_bits_equal(plain, [np.asarray(r) for r in ref], name)


def test_hetero_scratch_covers_the_kernel_layout():
    """The wrapper's scratch size follows the kernel's layout: two 8-byte
    words a (group, node) slot, nodes rounded up to the 2,048-node sort
    chunk, the 16-byte aligned list lengths, 56 bytes of state a group."""
    assert port_hetero.hetero_scratch_bytes(1, 1) == 16 * 2048 + 16 + 56
    assert port_hetero.hetero_scratch_bytes(3, 2049) == 16 * 3 * 4096 + 16 + 3 * 56
    assert port_hetero.hetero_scratch_bytes(100, 16384) == 16 * 100 * 16384 + 400 + 5600


@pytest.mark.cuda
@pytest.mark.parametrize("name", EDGE_CASES)
def test_cuda_hetero_kernel_matches_plain_on_edge_cases(name):
    """On the card: the kernel against its plain version, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: the hetero-greedy CUDA kernel runs only on the card")
    args, steps, max_c, policy = edge_case(name)
    dev = torch.device("cuda")
    targs = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in args]
    got = port_hetero.hetero_place(*targs, policy, steps, max_c)
    want = port_hetero.hetero_place_plain(*targs, policy, steps, max_c)
    assert_bits_equal([t.cpu() for t in got], [t.cpu().numpy() for t in want], name)
