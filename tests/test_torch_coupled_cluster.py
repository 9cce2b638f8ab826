"""The chunked scan's cluster decomposition (``csrc/coupled.cu``,
``chunked_cluster_kernel``), modelled in NumPy and held against the
plain versions, on the CPU; then the plain versions against the JAX
reference at the widths and edge cases the cluster form meets.

The cluster form runs a lane over 8 blocks, each over a slice of
ceil(N / 8) nodes. Per step (chunk), with the tables frozen, each block
finds its own slice's top ``want`` = min(chunk, count - placed) entries
of the running-min-clamped plane, in the order of the reference's top-k
(value desc, node asc, column asc), stopping at the first -inf. Every
block then merges the 8 walks: an entry's place is its place in its own
walk plus the entries of the other walks above it, and it is taken below
``want``; each block keeps the taken prefix of its walk, and every pick's
values are counted in merge order. That merge is exact because the slices
are disjoint and each node's clamped sequence is non-increasing.

Two walks are modelled, each held against the plain versions through the
same merge:

- the speculative walk: rounds of argmax over the slice's clamped heads,
  a pick's node advanced while a round follows; after the merge the
  block undoes its advances past the kept prefix, latest first, and
  advances a kept last round's node (with chunk 1, the value scan, the
  only one);
- the kernel's walk: each warp's top ``want`` heads (a thread's nodes are
  t, t + 1,024, ...) down to the want-th largest of the warps' best
  heads, merged into the slice's top ``want`` heads, whose nodes are the
  only ones that can hold a top entry; each candidate's
  next ``want`` columns clamped by their running minimum; those column
  lists merged. After the merge each node moves by the columns kept.

Held, choices and uint32 score views, against ``place_spread_chunked_plain``
(chunk 16) and ``place_value_scan_plain`` (chunk 1) by a ``hypothesis``
test and edge cases: all-tie scores, a count that stops mid-chunk, a lane
that goes -inf mid-chunk, N not a multiple of 8, value-less nodes, B = 2
with a distinct_property cap, V + 1 = 33 and 257. The reference runs
through its jitted programs (``traced_jit`` cannot run on this jax,
ROADMAP C-R1), with the tolerance of test_torch_coupled.py.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from nomad_tpu.device import parity as ref_parity
from nomad_tpu.device import score as ref_score
from nomad_tpu.device.flatten import ValueBlocks
from nomad_tpu_torch.device import score as port_score
from test_torch_coupled import J, _assert_same, _counts, _inputs, _run
from test_torch_opv_select import pack, packed_index, packed_value

F32 = np.float32
NEG_INF = F32(-np.inf)
CLUSTER = 8
CHUNK = 16


def speculative_walk(lo, hi, jn, head, want):
    """A block's walk as rounds of argmax over the slice's clamped heads,
    each pick's node advanced speculatively while a round follows:
    [(word, node, raw score)] and apply(kept) -> the slice's columns once
    the merge kept the first ``kept`` entries (later advances undone,
    latest first; a kept last round's node advanced)."""
    local = {n: int(jn[n]) for n in range(lo, hi)}
    sel = {n: head(n, local[n]) for n in range(lo, hi)}
    walk, undo = [], []
    for r in range(want):
        best = max((pack(sel[n], n) for n in range(lo, hi)), default=0)
        if best == 0 or not packed_value(best) > NEG_INF:
            break
        n = packed_index(best)
        walk.append((best, n, head(n, local[n])))
        undo.append((n, local[n], r + 1 < want))
        if r + 1 < want:
            local[n] += 1
            sel[n] = min(sel[n], head(n, local[n]))

    def apply(kept):
        for n, prev, advanced in reversed(undo[kept:]):
            if advanced:
                local[n] = prev
        for n, _, advanced in undo[:kept]:
            if not advanced:
                local[n] += 1
        return local

    return walk, apply


def candidate_walk(lo, hi, jn, head, want):
    """The kernel's walk: each warp's top ``want`` heads (thread t holds
    nodes lo + t, lo + t + 1,024, ...) down to the want-th largest of the
    warps' best heads, merged into the slice's top ``want`` heads; each
    candidate's next ``want`` columns clamped by their running minimum;
    those column lists merged. Words order (value desc, node asc, column
    asc). apply(kept) moves each node by its kept columns, which must be
    its next ones."""
    warps = {}
    for n in range(lo, hi):
        w = pack(head(n, jn[n]), n * CHUNK)
        if packed_value(w) > NEG_INF:
            warps.setdefault((n - lo) % 1024 // 32, []).append(w)
    # each warp's heads down to the want-th largest of the warps' best
    best = sorted((max(ws) for ws in warps.values()), reverse=True)
    floor = best[want - 1] if len(best) >= want else 0
    lists = [sorted((w for w in ws if w >= floor), reverse=True)[:want]
             for ws in warps.values()]
    tops = sorted((w for ws in lists for w in ws), reverse=True)[:want]
    columns = []
    for w in tops:
        n = packed_index(w) // CHUNK
        clamped = F32(np.inf)
        for k in range(want):
            raw = head(n, jn[n] + k)
            clamped = min(clamped, raw)
            if not clamped > NEG_INF:
                break
            columns.append((pack(clamped, n * CHUNK + k), n, raw))
    walk = sorted(columns, reverse=True)[:want]

    def apply(kept):
        local = {n: int(jn[n]) for n in range(lo, hi)}
        for r, (w, n, _) in enumerate(walk[:kept]):
            assert packed_index(w) % CHUNK == local[n] - jn[n]
            local[n] += 1
        return local

    return walk, apply


def _merge(walks, want):
    """Each entry's place: its place in its own walk plus the entries of
    the other walks above it. Returns [(node, raw)] in merge order and
    the entries each walk keeps."""
    picks = {}
    kept = [0] * len(walks)
    for b, walk in enumerate(walks):
        for r, (w, n, raw) in enumerate(walk):
            pos = r + sum(
                1 for o, other in enumerate(walks) if o != b for e in other if e[0] > w
            )
            if pos < want:
                picks[pos] = (n, raw)
                kept[b] += 1
    assert sorted(picks) == list(range(len(picks)))
    return [picks[p] for p in range(len(picks))], kept


def cluster_scan(kw, chunk, n_chunks, max_j, walk=candidate_walk):
    """The cluster form's choices and scores for the plain version's
    inputs ``kw`` (CPU tensors), each block's walk by ``walk``: chunk 1
    is the value scan."""
    num, den, fits = port_score._score_planes(
        *[kw[k] for k in (
            "capacity", "used0", "asks", "eligible", "job_counts", "desired_totals",
            "penalty_nodes", "affinity_scores", "has_affinities", "distinct_hosts",
            "slot_caps",
        )],
        False, max_j,
    )
    g, n = kw["eligible"].shape
    ns = -(-n // CLUSTER)
    choices = np.full((g, n_chunks * chunk), -1, np.int32)
    scores = np.full((g, n_chunks * chunk), NEG_INF, F32)
    for lane in range(g):
        sl = slice(lane, lane + 1)
        cp = port_score._Coupling(kw["block_value_ids"][sl], kw["block_kinds"][sl])
        c = kw["block_counts0"][sl].clone()
        jn = np.zeros(n, np.int64)
        count = int(kw["counts"][lane])
        placed = 0
        for step in range(n_chunks):
            want = min(chunk, count - placed)
            if want <= 0:
                break
            boost, allowed = cp.node_terms(*port_score._block_tables(
                c, kw["block_desired"][sl], kw["block_caps"][sl],
                kw["block_weights"][sl], kw["block_kinds"][sl],
            ))
            on = cp.has_spread_any & (boost != 0.0)
            raw = ((num[lane] + torch.where(on, boost, 0.0)[0, :, None])
                   / (den[lane] + torch.where(on, 1.0, 0.0)[0, :, None])).numpy()
            feas = (fits[lane] & allowed[0, :, None]).numpy()

            def head(m, j):  # noqa: B023 -- the step's frozen tables
                return F32(raw[m, j]) if j < max_j and feas[m, j] else NEG_INF

            walked = [walk(b * ns, min(n, (b + 1) * ns), jn, head, want)
                      for b in range(CLUSTER)]
            picks, kept = _merge([w for w, _ in walked], want)
            after = jn.copy()
            for m, _ in picks:
                after[m] += 1
            for (_, apply), k in zip(walked, kept):
                for m, j in apply(k).items():
                    jn[m] = j
            assert (jn == after).all()
            for p, (m, s) in enumerate(picks):
                choices[lane, step * chunk + p] = m
                scores[lane, step * chunk + p] = s
            rows = torch.tensor([[m for m, _ in picks] or [0]])
            c = cp.bump(c, rows, torch.tensor([[True] * len(picks) or [False]]))
            if not picks:
                break
            placed += len(picks)
    return choices, scores


def _plain(kw, chunk, n_chunks, max_j):
    args = dict(kw, algorithm_spread=False, max_j=max_j)
    if chunk == 1:
        out = port_score.place_value_scan_plain(**args, max_steps=n_chunks)
    else:
        out = port_score.place_spread_chunked_plain(**args, chunk=chunk, n_chunks=n_chunks)
    return out[0].numpy(), out[1].numpy()


def assert_cluster_equals_plain(kw, chunk, n_chunks, max_j=J):
    """Both walks' cluster scans against the plain version, choices and
    uint32 score views."""
    want = _plain(kw, chunk, n_chunks, max_j)
    for walk in (candidate_walk, speculative_walk):
        got = cluster_scan(kw, chunk, n_chunks, max_j, walk)
        np.testing.assert_array_equal(got[0], want[0], err_msg=walk.__name__)
        np.testing.assert_array_equal(got[1].view(np.uint32), want[1].view(np.uint32),
                                      err_msg=walk.__name__)
    return want


def _kw(ct, asks, n=None, steps=None):
    """The plain version's inputs for ``asks`` as CPU tensors, cut to the
    first ``n`` nodes; counts with test_torch_coupled's overflow."""
    b = _inputs(ct, asks)
    b["capacity"], b["used0"] = ct.capacity, ct.used
    if n is not None:
        for k, v in b.items():
            if k in ("capacity", "used0"):
                b[k] = v[:n]
            elif k == "block_value_ids":
                b[k] = v[:, :, :n]
            elif v.ndim == 2 and v.shape[1] == ct.padded_n:
                b[k] = v[:, :n]
    kw = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}
    kw["counts"] = torch.from_numpy(_counts(asks, steps or 10**6))
    return kw


def _blocks(value_ids, kinds, nv, caps=None, desired=None):
    nb = len(kinds)
    return ValueBlocks(
        value_ids=np.stack(value_ids).astype(np.int32),
        counts0=np.zeros((nb, nv), np.float32),
        desired=np.full((nb, nv), -1.0, np.float32) if desired is None else desired,
        caps=np.full((nb, nv), np.inf, np.float32) if caps is None else caps,
        weights=np.full(nb, 1.0 / nb, np.float32),
        kinds=np.array(kinds, np.int32),
    )


def edge_case(name):
    """(cluster, asks, nodes kept) of one edge case: reference objects."""
    n_keep = None
    if name == "all_ties":
        # one node shape, no affinity, no load: every score ties, and the
        # lowest node index wins each tie
        ct, asks = ref_parity.build_config3(n_nodes=200, n_jobs=2, count=40, racks=8)
        ct.capacity[: ct.num_nodes] = ct.capacity[0]
        ct.used[:] = 0.0
        for a in asks:
            a.has_affinities = False
            a.affinity_scores[:] = 0.0
            a.ask = asks[0].ask.copy()
    elif name == "count_mid_chunk":
        ct, asks = ref_parity.build_config3(n_nodes=200, n_jobs=2, count=21, racks=8)
        asks[1].count = 5
    elif name == "inf_mid_chunk":
        # 7 eligible nodes of 2-3 instances: the plane runs out mid-chunk
        ct, asks = ref_parity.build_config3(n_nodes=200, n_jobs=2, count=40, racks=8)
        for a in asks:
            a.eligible = a.eligible & (np.arange(ct.padded_n) % 29 == 3)
            a.slot_caps = np.where(np.arange(ct.padded_n) % 2 == 0, 2.0, 3.0).astype(np.float32)
    elif name == "n_not_multiple_of_8":
        ct, asks = ref_parity.build_config3(n_nodes=203, n_jobs=2, count=40, racks=8)
        n_keep = 203
    elif name == "value_less":
        ct, asks = ref_parity.build_config3(n_nodes=300, n_jobs=2, count=50, racks=8)
        for a in asks:
            a.blocks.value_ids[0][:300:5] = -1
    elif name == "b2_distinct_cap":
        # an even rack spread and a distinct_property cap of 2 per zone
        ct, asks = ref_parity.build_config3(n_nodes=240, n_jobs=2, count=30, racks=8)
        zone = np.pad((np.arange(240) % 6).astype(np.int32), (0, ct.padded_n - 240),
                      constant_values=-1)
        for a in asks:
            caps = np.full((2, 8), np.inf, np.float32)
            caps[1, :6] = 2.0
            a.blocks = _blocks([a.blocks.value_ids[0], zone],
                               [ref_score.BLOCK_EVEN_SPREAD, ref_score.BLOCK_DISTINCT_CAP],
                               8, caps=caps)
    elif name in ("v33", "v257"):
        racks = 32 if name == "v33" else 256
        ct, asks = ref_parity.build_config3(n_nodes=600, n_jobs=2, count=40, racks=racks)
    else:
        raise ValueError(name)
    return ct, asks, n_keep


EDGE_CASES = ["all_ties", "count_mid_chunk", "inf_mid_chunk", "n_not_multiple_of_8",
              "value_less", "b2_distinct_cap", "v33", "v257"]


@pytest.mark.parametrize("chunk", [1, CHUNK])
@pytest.mark.parametrize("case", EDGE_CASES)
def test_cluster_model_matches_plain_on_edge_cases(case, chunk):
    ct, asks, n_keep = edge_case(case)
    n_chunks = 48 if chunk == 1 else 4
    kw = _kw(ct, asks, n=n_keep, steps=n_chunks * chunk)
    choices, scores = assert_cluster_equals_plain(kw, chunk, n_chunks)
    placed = (choices >= 0).sum(axis=1)
    assert placed[0] > 0
    if case == "count_mid_chunk":
        assert placed[1] == 5 + 16 and (chunk == 1 or placed[0] == 37)
    if case == "inf_mid_chunk":
        assert (placed < n_chunks * chunk).all() and np.isneginf(scores[0, -1])
    if case == "all_ties":
        assert choices[0, 0] == 0  # the first tie goes to the lowest node


@settings(max_examples=40, deadline=None, derandomize=True)
@given(
    seed=st.integers(0, 2**32 - 1),
    n=st.integers(9, 160),
    racks=st.integers(1, 40),
    chunk=st.sampled_from([1, 3, CHUNK]),
    count=st.integers(0, 70),
    value_less=st.sampled_from([0, 3, 7]),
    capped=st.booleans(),
    grid=st.sampled_from([2, 8, 0]),
)
def test_cluster_model_matches_plain(seed, n, racks, chunk, count, value_less, capped, grid):
    """Seeded nodes, loads, affinities and value blocks (an even or a
    target spread, and with ``capped`` a distinct cap), capacities on a
    coarse grid (``grid`` > 0: many exact ties), any N."""
    rng = np.random.default_rng(seed)
    ct, asks = ref_parity.build_config3(n_nodes=n, n_jobs=2, count=max(count, 1), racks=racks)
    pn = ct.padded_n
    if grid:
        ct.used[:n, :2] = np.floor(ct.used[:n, :2] * grid / 4000) * 4000 / grid
    nv = 1 << max(0, (racks - 1).bit_length())
    for gi, a in enumerate(asks):
        a.count = count if gi == 0 else int(rng.integers(0, 30))
        vids = np.pad(rng.integers(0, racks, n).astype(np.int32), (0, pn - n),
                      constant_values=-1)
        if value_less:
            vids[:n:value_less] = -1
        kind = [ref_score.BLOCK_EVEN_SPREAD, ref_score.BLOCK_TARGET_SPREAD][gi % 2]
        desired = np.full((1, nv), -1.0, np.float32)
        desired[0, : min(racks, 4)] = rng.integers(1, 12, min(racks, 4))
        value_ids, kinds = [vids], [kind]
        caps = np.full((1, nv), np.inf, np.float32)
        if capped:
            value_ids.append(np.roll(vids, 3))
            kinds.append(ref_score.BLOCK_DISTINCT_CAP)
            desired = np.concatenate([desired, np.full((1, nv), -1.0, np.float32)])
            caps = np.concatenate([caps, rng.integers(1, 4, (1, nv)).astype(np.float32)])
        a.blocks = _blocks(value_ids, kinds, nv, caps=caps, desired=desired)
        a.blocks.counts0[:] = rng.integers(0, 3, a.blocks.counts0.shape)
        a.affinity_scores = (rng.choice([-0.5, 0.0, 0.5], pn) * ct.ready).astype(np.float32)
    n_chunks = 40 if chunk == 1 else -(-80 // chunk)
    kw = _kw(ct, asks, n=n, steps=n_chunks * chunk)
    assert_cluster_equals_plain(kw, chunk, n_chunks)


@pytest.mark.parametrize("kernel", ["scan", "chunked"])
@pytest.mark.parametrize("case", ["value_less", "b2_distinct_cap", "v33", "v257", "all_ties"])
def test_plain_matches_reference_at_cluster_widths(case, kernel):
    """The plain versions the model is held to, against the reference's
    programs on the same inputs."""
    ct, asks, _ = edge_case(case)
    ref, port = _run(kernel, ct, asks, None)
    _assert_same(ref, port)
    assert (port[0] >= 0).sum() > 0


def _cuda_kwargs(ct, asks, n_keep, dev, steps):
    return {k: v.to(dev) for k, v in _kw(ct, asks, n=n_keep, steps=steps).items()}


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1, CHUNK])
@pytest.mark.parametrize("case", EDGE_CASES)
def test_cuda_cluster_form_matches_plain(case, chunk):
    """On the card: the chunked kernel (chunk 16) and the value scan
    (chunk 1) in the form their shape picks (the cluster form at these
    widths), choices and uint32 score views against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: the coupled CUDA kernels run only on the card")
    dev = torch.device("cuda")
    ct, asks, n_keep = edge_case(case)
    n_chunks = 48 if chunk == 1 else 4
    kw = _cuda_kwargs(ct, asks, n_keep, dev, n_chunks * chunk)
    n = kw["eligible"].shape[1]
    nb, nv = kw["block_counts0"].shape[1:]
    symbol = "nomad_place_value_scan" if chunk == 1 else "nomad_place_spread_chunked"
    assert port_score.coupled_cluster_size(symbol, n, nb, nv) == CLUSTER
    args = dict(kw, algorithm_spread=False, max_j=J)
    if chunk == 1:
        got = port_score.place_value_scan(**args, max_steps=n_chunks)
        want = port_score.place_value_scan_plain(**args, max_steps=n_chunks)
    else:
        got = port_score.place_spread_chunked(**args, chunk=chunk, n_chunks=n_chunks)
        want = port_score.place_spread_chunked_plain(**args, chunk=chunk, n_chunks=n_chunks)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))


@pytest.mark.cuda
def test_cuda_one_block_form_where_the_tables_do_not_fit():
    """On the card: two blocks of 16,384 values each replicate 393 KB of
    tables, past a block's shared memory: the value scan runs one block a
    lane from global scratch, identical to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: the coupled CUDA kernels run only on the card")
    dev = torch.device("cuda")
    ct, asks = ref_parity.build_config3(n_nodes=600, n_jobs=2, count=30, racks=8)
    node = np.pad(np.arange(600, dtype=np.int32), (0, ct.padded_n - 600), constant_values=-1)
    for a in asks:
        caps = np.full((2, 16384), 1.0, np.float32)
        a.blocks = _blocks([node, node], [ref_score.BLOCK_DISTINCT_CAP] * 2, 16384, caps=caps)
    kw = _cuda_kwargs(ct, asks, None, dev, 64)
    n = kw["eligible"].shape[1]
    assert port_score.coupled_cluster_size("nomad_place_value_scan", n, 2, 16384) == 1
    args = dict(kw, algorithm_spread=False, max_j=J, max_steps=64)
    got = port_score.place_value_scan(**args)
    want = port_score.place_value_scan_plain(**args)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
