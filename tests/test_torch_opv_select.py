"""The one-per-value kernel's segment selection (``csrc/coupled.cu``,
``opv_cluster_kernel``), modelled in Python and held against the loop it
replaces and against the plain version's selection, on the CPU; then the
plain version against the JAX reference at the widths that pick the
kernel's forms.

Per step, after the first pick, the kernel knows each segment's best
word (order_key(score) << 32 | ~node; segment V holds the value-less
nodes) and which segments the rotation guard allows. The one-block form
takes up to k_seg - 1 of them round by round: the largest allowed
(value, segment) word, stopping at the first round whose value is -inf or
past the group's count. The cluster form takes them in one selection:
each allowed candidate's rank among the candidates' words is its pick's
place. The model holds the two equal, and equal to the plain version's
stable descending sort, for V + 1 not a power of two, value-less nodes
and ties in value. It also holds the cluster form's segment maxima —
lanes on one segment reduced as two 32-bit maxima (the high word, then
the low word among the lanes holding the highest), folded into a warp's
partial table — to the plain 64-bit maximum.

The reference runs through its jitted program
(``place_spread_opv_kernel.jitted``: ``traced_jit`` cannot run on this
jax, ROADMAP C-R1), with the tolerance of test_torch_coupled.py.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from nomad_tpu.device import parity as ref_parity
from nomad_tpu.device import score as ref_score
from nomad_tpu_torch.device import score as port_score
from test_torch_coupled import J, _assert_same, _counts, _enforce_idx, _inputs, _run

F32 = np.float32
NEG_INF = F32(-np.inf)


def order_key(x) -> int:
    x = F32(0.0) if x == 0 else F32(x)
    u = int(np.array(x, F32).view(np.uint32))
    return (~u & 0xFFFFFFFF) if u & 0x80000000 else (u | 0x80000000)


def key_value(k: int) -> F32:
    u = (k & 0x7FFFFFFF) if k & 0x80000000 else (~k & 0xFFFFFFFF)
    return np.array(u, np.uint32).view(F32)[()]


def pack(value, idx: int) -> int:
    return (order_key(value) << 32) | (0xFFFFFFFF - idx)


def packed_value(w: int) -> F32:
    return key_value(w >> 32)


def packed_index(w: int) -> int:
    return 0xFFFFFFFF - (w & 0xFFFFFFFF)


def segment_words(scores, segs, n_seg):
    """seg_best[s]: the largest (score, ~node) word of segment s, 0 where
    the segment has no node — the one-block form's 64-bit atomicMax."""
    best = [0] * n_seg
    for n, (x, s) in enumerate(zip(scores, segs)):
        best[s] = max(best[s], pack(x, n))
    return best


def segment_words_by_warps(scores, segs, n_seg, partials=32):
    """The cluster form's maxima: nodes in warps of 32 lanes (warp w takes
    nodes w*32 .. w*32+31, then w + warps ...); the lanes on one segment
    reduce the high words, then the low words among the lanes at the
    highest, and their leader folds the word into the warp's partial
    table; the tables merge by max."""
    tables = [[0] * n_seg for _ in range(partials)]
    for w0 in range(0, len(scores), 32):
        lanes = range(w0, min(w0 + 32, len(scores)))
        words = {n: pack(scores[n], n) for n in lanes}
        table = tables[(w0 // 32) % partials]
        for s in {segs[n] for n in lanes}:
            peers = [n for n in lanes if segs[n] == s]
            top = max(words[n] >> 32 for n in peers)
            low = max((words[n] & 0xFFFFFFFF) if words[n] >> 32 == top else 0 for n in peers)
            table[s] = max(table[s], (top << 32) | low)
    return [max(t[s] for t in tables) for s in range(n_seg)]


def candidate(seg_best, seg_ok, s):
    return packed_value(seg_best[s]) if seg_ok[s] and seg_best[s] != 0 else NEG_INF


def round_by_round(seg_best, seg_ok, k_seg, n_placed, count):
    """The one-block form's loop: [(segment, node, value)] in pick order."""
    ok = list(seg_ok)
    picks = []
    for r in range(k_seg - 1):
        top = max(pack(candidate(seg_best, ok, s), s) for s in range(len(seg_best)))
        val = packed_value(top)
        if not (r + n_placed + 1 < count and val > NEG_INF):
            break
        s = packed_index(top)
        picks.append((s, packed_index(seg_best[s]), val))
        ok[s] = False
    return picks


def one_selection(seg_best, seg_ok, k_seg, n_placed, count):
    """The cluster form: each candidate's rank is its place."""
    n_seg = len(seg_best)
    vals = [candidate(seg_best, seg_ok, s) for s in range(n_seg)]
    cw = [pack(v, s) if v > NEG_INF else 0 for s, v in enumerate(vals)]
    ncand = sum(1 for w in cw if w)
    limit = max(0, min(k_seg - 1, ncand, count - n_placed - 1))
    picks = [None] * limit
    for s in range(n_seg):
        if cw[s]:
            above = sum(1 for w in cw if w > cw[s])
            if above < limit:
                picks[above] = (s, packed_index(seg_best[s]), vals[s])
    return picks


def plain_selection(scores, segs, seg_ok, k_seg, n_placed, count):
    """The plain version's step (place_spread_opv_plain, one lane):
    segment maxima masked by the guard, a stable descending sort, each
    taken segment's first-index argmax."""
    n_seg = len(seg_ok)
    score1 = torch.from_numpy(np.asarray(scores, F32))[None]
    seg = torch.tensor(segs)[None]
    seg_plane = seg[:, None, :] == torch.arange(n_seg)[:, None]
    seg_max = torch.where(seg_plane, score1[:, None, :], -torch.inf).amax(dim=2)
    seg_max = torch.where(torch.tensor(seg_ok)[None], seg_max, -torch.inf)
    vals, vsel = torch.sort(seg_max, dim=1, descending=True, stable=True)
    vals, vsel = vals[:, : k_seg - 1], vsel[:, : k_seg - 1]
    take = (torch.arange(k_seg - 1) + n_placed + 1 < count) & (vals > -torch.inf)
    in_seg = seg[:, None, :] == vsel[..., None]
    rows, _ = port_score._first_argmax(torch.where(in_seg, score1[:, None, :], -torch.inf))
    return [
        (int(vsel[0, r]), int(rows[0, r]), F32(vals[0, r]))
        for r in range(k_seg - 1) if bool(take[0, r])
    ]


def same_picks(a, b):
    return len(a) == len(b) and all(
        s1 == s2 and r1 == r2 and v1 == v2 for (s1, r1, v1), (s2, r2, v2) in zip(a, b)
    )


@settings(max_examples=150, deadline=None, derandomize=True)
@given(
    seed=st.integers(0, 2**32 - 1),
    n_seg=st.one_of(st.integers(2, 40), st.sampled_from([33, 257])),
    n=st.integers(1, 300),
    k_seg=st.integers(2, 16),
    n_placed=st.integers(0, 20),
    count=st.integers(0, 40),
    grid=st.sampled_from([2, 5, 50]),
)
def test_one_selection_matches_the_round_loop_and_plain(seed, n_seg, n, k_seg, n_placed,
                                                        count, grid):
    """One selection = the round-by-round loop = the plain version's sort,
    with segment maxima from the cluster form's warp reduction."""
    k_seg = min(k_seg, n_seg)
    rng = np.random.default_rng(seed)
    # scores on a coarse grid (ties in value), some -inf (unfit heads or
    # the first pick's segment), -0.0 beside +0.0
    scores = (rng.integers(-grid, grid + 1, n) / grid).astype(F32)
    scores[rng.random(n) < 0.15] = NEG_INF
    scores[(scores == 0) & (rng.random(n) < 0.5)] = F32(-0.0)
    # value ids, -1 (no value, segment V) on some nodes
    vids = rng.integers(-1, n_seg - 1, n)
    segs = [int(v) if v >= 0 else n_seg - 1 for v in vids]
    seg_ok = list(rng.random(n_seg) < 0.8)
    seg_ok[-1] = True  # value-less nodes are always allowed

    seg_best = segment_words(scores, segs, n_seg)
    assert segment_words_by_warps(scores, segs, n_seg) == seg_best
    assert segment_words_by_warps(scores, segs, n_seg, partials=4) == seg_best
    loop = round_by_round(seg_best, seg_ok, k_seg, n_placed, count)
    one = one_selection(seg_best, seg_ok, k_seg, n_placed, count)
    assert same_picks(one, loop)
    assert same_picks(one, plain_selection(scores, segs, seg_ok, k_seg, n_placed, count))


def test_one_selection_breaks_value_ties_by_segment():
    """Equal values: the lower segment first, as the loop and the sort."""
    scores = [F32(1.0)] * 6 + [F32(0.5)]
    segs = [4, 2, 2, 0, 3, 1, 5]
    seg_best = segment_words(scores, segs, 6)
    ok = [True] * 6
    picks = one_selection(seg_best, ok, 16, 0, 100)
    assert [p[0] for p in picks] == [0, 1, 2, 3, 4, 5]
    assert picks[2][1] == 1  # segment 2's first-index node
    assert same_picks(picks, round_by_round(seg_best, ok, 16, 0, 100))
    # the count stop: two placed of four leaves one more pick
    assert len(one_selection(seg_best, ok, 16, 2, 4)) == 1


def opv_case(racks, value_less_every=0, n_nodes=600):
    """A config-3 style lane pair over ``racks`` rack values; every
    ``value_less_every``-th real node without a value (segment V)."""
    ct, asks = ref_parity.build_config3(n_nodes=n_nodes, n_jobs=2, count=60, racks=racks)
    if value_less_every:
        for a in asks:
            a.blocks.value_ids[0][:n_nodes:value_less_every] = -1
    return ct, asks


@pytest.mark.parametrize("racks,value_less", [(32, 0), (32, 7), (256, 0), (256, 5), (200, 3)])
def test_opv_plain_matches_reference_at_kernel_widths(racks, value_less):
    """V + 1 = 33 and 257 (uint8 and uint16 value ids in the cluster
    form), value-less nodes, and V padded past its racks."""
    ct, asks = opv_case(racks, value_less)
    ref, port = _run("opv", ct, asks, None)
    _assert_same(ref, port)
    assert (port[0] >= 0).sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("racks,value_less", [(32, 0), (32, 7), (256, 5), (1023, 0), (4096, 0)])
def test_cuda_opv_kernel_matches_plain_at_kernel_widths(racks, value_less):
    """On the card: the one-per-value kernel (cluster form up to V + 1 =
    1,024, the one-block form above) against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: the one-per-value CUDA kernel runs only on the card")
    dev = torch.device("cuda")
    ct, asks = opv_case(racks, value_less, n_nodes=max(600, 2 * racks))
    b = _inputs(ct, asks)
    kw = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
    kw["capacity"] = torch.from_numpy(ct.capacity).to(dev)
    kw["used0"] = torch.from_numpy(ct.used).to(dev)
    kw["enforce_idx"] = torch.from_numpy(_enforce_idx(asks)).to(dev)
    static = dict(max_j=J, k_seg=16, n_chunks=12)
    kw["counts"] = torch.from_numpy(_counts(asks, 12 * 16)).to(dev)
    ch, sc = port_score.place_spread_opv(**kw, algorithm_spread=False, **static)
    chp, scp = port_score.place_spread_opv_plain(**kw, algorithm_spread=False, **static)
    assert torch.equal(ch, chp)
    assert torch.equal(sc, scp)
