"""The closed-form kernel's cluster decomposition (``csrc/closed_form.cu``,
``closed_form_cluster_kernel``), modelled in NumPy and held against the
plain version, on the CPU; then the plain version against the JAX
reference on the same edge cases.

The cluster form runs a lane over S blocks of one thread-block cluster,
block r over the contiguous node slice [r * ceil(N / S), ...), so index
order is (slice, local index). The model follows the kernel step by
step on the plane of clamped keys (``order_key`` of the running minimum
of each node's column, which the plain version's arithmetic gives):

- each block stages its slice's heads (the j = 0 keys; the kernel stages
  the unclamped scores of columns 0 and 1, which changes what it computes
  again, not what it selects);
- the floor, when N >= k_eff: the k_eff-th largest head, by radix select
  on 11/11/10-bit digits: each block's histogram and its sums over groups
  of 32 bins, the group sums summed over the S blocks to find the group,
  then that group's bins summed to find the digit;
- the threshold: the k_eff-th largest key at or above the floor, the
  same way (a block's keys are its columns' walks down to the floor, and
  with the floor at -inf the -inf tails too); ``need`` of the keys equal
  to it are picks;
- per node the keys above the threshold (a prefix j < above of its
  non-increasing column) and equal to it (the next ``equal``); each
  block's ties are taken from the tie rank of the slices before it on,
  below ``need``, and go to slot ``n_gt + rank``, the node of each found
  by a binary search of the block's prefix of the equal counts;
- the words (key << 32 | ~index) above the threshold are ranked: each
  block places a 1/S chunk of them at the count of words above it;
- ties at -inf, and slots past k_eff, are row -1 / score -inf.

Held, choices and uint32 score views, against ``place_closed_form_plain``
at S = 1, 2, 8 and 16 by a ``hypothesis`` test and edge cases: flat
all-tie columns (homogeneous binpack), ties across slice boundaries, N
not a multiple of S, k_eff above the finite picks, k = 1, k_eff above
4,096, jitter, the spread algorithm and distinct_hosts. The reference
runs through its jitted program (``traced_jit`` cannot run on this jax,
ROADMAP C-R1), with the tolerance of ``test_torch_score.py``.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from nomad_tpu.device import score as ref_score
from nomad_tpu_torch.device import score as port_score
from test_torch_score import _assert_same_picks

FORMS = (1, 2, 8, 16)
INPUTS = (
    "capacity", "used0", "asks", "eligible", "job_counts", "desired_totals",
    "penalty_nodes", "affinity_scores", "has_affinities", "distinct_hosts",
    "slot_caps",
)


def order_key(x):
    """csrc/candidate.cuh's order_key on float32: a larger float gives a
    larger u32 key; -0 folds onto +0."""
    x = np.where(x == 0, np.float32(0), x).astype(np.float32)
    u = x.view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


NINF_KEY = int(order_key(np.array([-np.inf], np.float32))[0])


def _inputs(n, g, j, seed, *, homogeneous=False, flat=False, eligible_rows=None,
            jitter=False, distinct=False, knobs=True):
    """Seeded numpy inputs: three node classes (one where ``homogeneous``)
    at a few usage levels, 500 MHz / 512 MiB asks with some lanes asking
    double, and where ``knobs`` job counts, penalties, affinities and slot
    caps on a share of the nodes. ``flat``: identical empty nodes each
    holding one alloc of the job, with anti-affinity below an ulp, so
    every column is flat at its head and every head ties."""
    rng = np.random.default_rng(seed)
    cls = np.zeros(n, np.int64) if homogeneous or flat else rng.integers(0, 3, n)
    cap = np.zeros((n, 4), np.float32)
    cap[:, 0] = np.choose(cls, [2000, 4000, 8000])
    cap[:, 1] = np.choose(cls, [4096, 8192, 16384])
    cap[:, 2] = 100_000
    cap[:, 3] = 1000
    used = np.zeros_like(cap)
    if not flat:
        used[:, :2] = cap[:, :2] * rng.choice([0.0, 0.25, 0.5], (n, 1)).astype(np.float32)
    asks = np.tile(np.array([500, 512, 100, 0], np.float32), (g, 1))
    asks[rng.random(g) < 0.3, :2] *= 2
    eligible = rng.random((g, n)) < 0.9
    if eligible_rows is not None:
        eligible[:, eligible_rows:] = False
    job_counts = np.zeros((g, n), np.int32)
    penalty = np.zeros((g, n), bool)
    affinity = np.zeros((g, n), np.float32)
    has_aff = np.zeros(g, bool)
    caps = np.full((g, n), np.inf, np.float32)
    desired = np.full(g, 40.0, np.float32)
    if flat:
        eligible[:] = True
        job_counts[:] = 1
        desired[:] = 1e30
    elif knobs:
        job_counts = ((rng.random((g, n)) < 0.2) * rng.integers(1, 3, (g, n))).astype(np.int32)
        penalty = rng.random((g, n)) < 0.05
        has_aff = rng.random(g) < 0.5
        affinity = rng.choice([-0.5, 0.0, 0.5], (g, n)).astype(np.float32)
        caps = np.where(rng.random((g, n)) < 0.2, rng.integers(0, 4, (g, n)), np.inf)
    distinct_hosts = np.full(g, distinct)
    args = dict(
        capacity=cap, used0=used, asks=asks, eligible=eligible, job_counts=job_counts,
        desired_totals=desired, penalty_nodes=penalty, affinity_scores=affinity,
        has_affinities=has_aff, distinct_hosts=distinct_hosts,
        slot_caps=caps.astype(np.float32),
    )
    jit = None
    if jitter:
        rows = np.arange(n, dtype=np.int64)
        h = (rows * 2654435761 + 40503) & 0xFFFFFFFF
        jit = ((h % 65536).astype(np.float32) / 65536.0) * 2e-5
    return args, jit


def _torch(args, jitter):
    t = [torch.from_numpy(np.ascontiguousarray(args[key])) for key in INPUTS]
    return t, None if jitter is None else torch.from_numpy(jitter)


def _plain(args, spread, max_j, k, jitter):
    t, tj = _torch(args, jitter)
    ch, sc = port_score.place_closed_form_plain(*t, spread, max_j, k, tj)
    return ch.numpy(), sc.numpy()


def _plane(args, spread, max_j, jitter):
    """The unclamped scores [G, N, J] (-inf where a candidate does not
    fit) and the clamped keys, from the plain version's own arithmetic."""
    t, tj = _torch(args, jitter)
    num, den, fits = port_score._score_planes(*t, spread, max_j, jitter=tj)
    raw = torch.where(fits, num / den, -torch.inf).numpy()
    return raw, order_key(np.minimum.accumulate(raw, axis=2))


def _radix_select(block_keys, s, rank):
    """The rank-th largest key over the cluster's blocks, by 11/11/10-bit
    digits. Each digit: every block's histogram and its sums over groups
    of 32 bins; the group sums summed over the s blocks, the group holding
    the rem-th largest found from the top; that group's bins summed over
    the blocks, the bin found the same way. Returns (key, how many equal
    to it are among the top rank)."""
    prefix, rem = 0, rank
    for width, shift in ((11, 21), (11, 10), (10, 0)):
        high = shift + width
        hists = []
        for r in range(s):
            keys = block_keys(r).astype(np.int64)
            if high < 32:
                keys = keys[(keys >> high) == prefix]
            hists.append(np.bincount((keys >> shift) & ((1 << width) - 1),
                                     minlength=1 << width))
        groups = sum(h.reshape(-1, 32).sum(axis=1) for h in hists)
        cum = 0
        for group in range(len(groups) - 1, -1, -1):
            if cum + groups[group] >= rem:
                break
            cum += groups[group]
        bins = sum(h[32 * group:32 * group + 32] for h in hists)
        for b in range(31, -1, -1):
            if cum + bins[b] >= rem:
                digit, rem = 32 * group + b, rem - cum
                break
            cum += bins[b]
        prefix = (prefix << width) | digit
    return prefix, rem


def cluster_lane(raw, keys, k, s, cross_slice_ties=True):
    """One lane of the cluster form over s blocks: (choices i32[k], scores
    f32[k]). ``cross_slice_ties=False`` drops the tie ranks of the slices
    before a block (a broken kernel the tests must catch)."""
    n, j = keys.shape
    k_eff = min(k, n * j)
    width = -(-n // s)
    blocks = [(min(n, r * width), min(n, (r + 1) * width)) for r in range(s)]
    heads = keys[:, 0]  # staged by each block
    floor = NINF_KEY
    if n >= k_eff:
        floor, _ = _radix_select(lambda r: heads[blocks[r][0]:blocks[r][1]], s, k_eff)

    def walked(r):  # each column down to the first key under the floor
        cols = keys[blocks[r][0]:blocks[r][1]]
        return cols[cols >= floor]

    thresh, need = _radix_select(walked, s, k_eff)
    n_gt = k_eff - need
    above = (keys > thresh).sum(axis=1)
    equal = (keys == thresh).sum(axis=1)
    eq_total = [int(equal[lo:hi].sum()) for lo, hi in blocks]
    choices = np.full(k, -1, np.int32)
    scores = np.full(k, -np.inf, np.float32)
    words = []
    for r, (lo, hi) in enumerate(blocks):
        before_slices = sum(eq_total[:r]) if cross_slice_ties else 0
        take = 0 if before_slices >= need else min(eq_total[r], need - before_slices)
        prefix = np.cumsum(equal[lo:hi])
        for t in range(take):
            i = int(np.searchsorted(prefix, t, side="right"))
            before = int(prefix[i - 1]) if i else 0
            node = lo + i
            if thresh != NINF_KEY:
                choices[n_gt + before_slices + t] = node
                scores[n_gt + before_slices + t] = raw[node, above[node] + t - before]
        for node in range(lo, hi):
            for col in range(above[node]):
                words.append((int(keys[node, col]) << 32) | (0xFFFFFFFF - (node * j + col)))
    assert len(words) == n_gt
    words = np.array(words, np.uint64)
    chunk = -(-n_gt // s)
    for r in range(s):
        for p in range(min(n_gt, r * chunk), min(n_gt, (r + 1) * chunk)):
            place = int((words > words[p]).sum())
            node, col = divmod(0xFFFFFFFF - int(words[p] & np.uint64(0xFFFFFFFF)), j)
            choices[place] = node
            scores[place] = raw[node, col]
    return choices, scores


def cluster_model(args, spread, max_j, k, jitter, s, **kw):
    raw, keys = _plane(args, spread, max_j, jitter)
    lanes = [cluster_lane(raw[g], keys[g], k, s, **kw) for g in range(raw.shape[0])]
    return np.stack([c for c, _ in lanes]), np.stack([v for _, v in lanes])


def _assert_bits(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1].view(np.uint32), want[1].view(np.uint32))


# (name, inputs keywords, spread, max_j, k)
EDGE_CASES = {
    "flat_all_tie_columns": (dict(n=64, g=2, j=8, seed=1, flat=True), False, 8, 40),
    "ties_across_slices": (dict(n=64, g=2, j=8, seed=2, homogeneous=True, knobs=False),
                           False, 8, 48),
    "n_not_multiple_of_s": (dict(n=37, g=3, j=8, seed=3), False, 8, 24),
    "k_above_finite_picks": (dict(n=48, g=2, j=8, seed=4, eligible_rows=5), False, 8, 64),
    "k_one": (dict(n=40, g=2, j=8, seed=5), False, 8, 1),
    "k_eff_above_4096": (dict(n=600, g=1, j=16, seed=6, homogeneous=True, knobs=False),
                         False, 16, 4500),
    "jitter": (dict(n=50, g=2, j=8, seed=7, jitter=True), False, 8, 32),
    "spread": (dict(n=50, g=2, j=8, seed=8), True, 8, 32),
    "distinct_hosts": (dict(n=50, g=2, j=8, seed=9, distinct=True), False, 8, 32),
}


def _edge(name):
    kw, spread, max_j, k = EDGE_CASES[name]
    args, jitter = _inputs(**kw)
    return args, spread, max_j, k, jitter


@pytest.mark.parametrize("s", FORMS)
@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_cluster_model_matches_plain_on_edge_cases(name, s):
    args, spread, max_j, k, jitter = _edge(name)
    want = _plain(args, spread, max_j, k, jitter)
    _assert_bits(cluster_model(args, spread, max_j, k, jitter, s), want)


def test_edge_cases_exercise_what_they_name():
    """Each edge case has the shape its name promises on the plain
    version's picks."""
    raw, keys = _plane(*[_edge("flat_all_tie_columns")[i] for i in (0, 1, 2, 4)])
    fits = np.isfinite(raw[0])
    heads = keys[0][fits[:, 0], 0]
    assert (keys[0][fits] == heads[0]).all(), "columns are not flat and tied"
    ch, _ = _plain(*_edge("ties_across_slices"))
    rows = np.unique(ch[ch >= 0])
    assert any(len(set(rows // (-(-64 // s)))) > 1 for s in (2, 8, 16))
    ch, sc = _plain(*_edge("k_above_finite_picks"))
    assert (ch == -1).any() and (ch >= 0).any() and np.isneginf(sc[ch == -1]).all()
    assert 37 % 2 and 37 % 8 and 37 % 16
    assert min(4500, 600 * 16) > 4096


@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_plain_matches_reference_on_edge_cases(name):
    args, spread, max_j, k, jitter = _edge(name)
    fused = np.asarray(
        ref_score.place_closed_form_kernel.jitted(
            args["capacity"], args["used0"],
            **{key: args[key] for key in INPUTS[2:]},
            algorithm_spread=np.asarray(spread),
            counts=np.zeros(len(args["asks"]), np.int32),
            max_j=max_j, k=k, jitter=jitter,
        )
    )
    ref = fused[:, :k], fused[:, k:].view(np.float32)
    _assert_same_picks(*ref, *_plain(args, spread, max_j, k, jitter))


def test_dropping_the_cross_slice_tie_prefix_breaks_the_model():
    """The tie ranks of the slices before a block are what put the lowest
    indices first: without them the model differs from plain."""
    args, spread, max_j, k, jitter = _edge("ties_across_slices")
    want = _plain(args, spread, max_j, k, jitter)
    got = cluster_model(args, spread, max_j, k, jitter, 8, cross_slice_ties=False)
    assert not np.array_equal(got[0], want[0])


@settings(max_examples=60, deadline=None, derandomize=True)
@given(
    n=st.integers(1, 70),
    g=st.integers(1, 3),
    j=st.sampled_from([1, 2, 3, 8, 16]),
    k_frac=st.floats(0.0, 1.2),
    seed=st.integers(0, 2**16),
    s=st.sampled_from(FORMS),
    spread=st.booleans(),
    tied=st.booleans(),
    jitter=st.booleans(),
    distinct=st.booleans(),
)
def test_cluster_model_matches_plain(n, g, j, k_frac, seed, s, spread, tied, jitter, distinct):
    args, jit = _inputs(n, g, j, seed, homogeneous=tied, knobs=not tied, jitter=jitter,
                        distinct=distinct)
    k = max(1, int(k_frac * n * j))
    want = _plain(args, spread, j, k, jit)
    _assert_bits(cluster_model(args, spread, j, k, jit, s), want)


# -- on the card ----------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_cuda_every_form_matches_plain(name, monkeypatch):
    """On the card: the kernel in the one-block form and as a cluster of
    2, 8 and 16 blocks a lane, choices and uint32 score views against the
    plain version on the same card (the CPU's exp may round a last bit
    otherwise than the card's, which the kernel and the plain version
    there share)."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: the closed-form CUDA kernel runs only on the card")
    args, spread, max_j, k, jitter = _edge(name)
    dev = torch.device("cuda")
    t, tj = _torch(args, jitter)
    t = [x.to(dev) for x in t]
    tj = None if tj is None else tj.to(dev)
    want = [x.cpu().numpy()
            for x in port_score.place_closed_form_plain(*t, spread, max_j, k, tj)]
    plan = port_score.closed_form_plan
    for s in FORMS:
        monkeypatch.setattr(port_score, "closed_form_plan",
                            lambda g, n, kpad, _s=s: plan(g, n, kpad, _s))
        port_score.place_closed_form.forms.clear()
        ch, sc = port_score.place_closed_form(*t, spread, max_j, k, tj)
        assert port_score.place_closed_form.forms == {s: 1}
        _assert_bits((ch.cpu().numpy(), sc.cpu().numpy()), want)


@pytest.mark.cuda
def test_cuda_form_is_chosen_by_lane_count():
    """On the card: one lane takes a cluster of 16 blocks, a card's worth
    of lanes 4 blocks each and twice that 4 too, the size never rising
    with the lane count; a share past shared memory the one-block form."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: the closed-form CUDA kernel runs only on the card")
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def size(g, n=16384):
        return port_score.closed_form_plan(g, n, 1024)[0]

    assert size(1) == 16 and size(sms) == 4 and size(2 * sms) == 4
    sizes = [size(g) for g in range(1, 2 * sms + 1)]
    assert all(a >= b for a, b in zip(sizes, sizes[1:])), sizes
    assert port_score.closed_form_plan(1, 1 << 22, 1024) == (1, 0)
