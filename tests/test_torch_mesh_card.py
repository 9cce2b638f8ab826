"""The cross-shard top-k merge kernel (``closed_form_topk_merge``,
``csrc/closed_form.cu``) and the sharded closed form on the card.

Imports no JAX: it runs where the card is. Every test is marked ``cuda``
and skips without one. Candidates are made as a shard makes them (a
stable per-shard top-k' of a tie-heavy plane, or the closed form itself
on a shard's node slice) and the kernel's fused output is held bit for
bit (uint32 views) to ``closed_form_topk_merge_plain`` on the same card
and to the stable global sort: at ties, at k' < k (shards forward fewer
than k), at seg x J < k (fewer candidates than k, the tail row -1 /
-inf), at S 1, 2, 4 and 8.
"""

import numpy as np
import pytest
import torch

from nomad_tpu_torch import backend
from nomad_tpu_torch.device import score as S


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: the merge kernel runs only on the card")
    return torch.device("cuda")


def _shard_candidates(flat, s, k, dev):
    """A group's per-shard stable top-k' of each row of ``flat`` [G, N]
    (J = 1: a column is a node), as the shards hand them over."""
    g, n = flat.shape
    seg = n // s
    kl = min(k, seg)
    rows, scores = [], []
    for j in range(s):
        v, i = torch.sort(flat[:, j * seg:(j + 1) * seg], dim=1, descending=True, stable=True)
        rows.append(i[:, :kl].to(torch.int32).contiguous().to(dev))
        scores.append(v[:, :kl].contiguous().to(dev))
    return rows, scores, seg


CASES = {
    # name: (groups, nodes, k, values)
    "ties": (8, 1024, 32, (-np.inf, 0.0, 1.0, 2.0, 3.0)),
    "k_local_below_k": (4, 256, 128, (0.0, 0.5, 1.0)),
    "fewer_than_k": (3, 16, 64, (-np.inf, 1.0, 2.0)),
    "wide": (100, 4096, 128, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [1, 2, 4, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_merge_matches_plain(case, shards):
    dev = _card()
    g, n, k, values = CASES[case]
    rng = np.random.default_rng(shards * 31 + len(case))
    if values is None:
        flat = rng.standard_normal((g, n)).astype(np.float32)
        flat[:, ::7] = -np.inf
    else:
        flat = rng.choice(np.array(values, dtype=np.float32), size=(g, n))
    flat = torch.from_numpy(flat)
    rows, scores, seg = _shard_candidates(flat, shards, k, dev)
    before = S.closed_form_topk_merge.launches
    got = S.closed_form_topk_merge(rows, scores, seg, k)
    assert S.closed_form_topk_merge.launches == before + 1
    want = S.closed_form_topk_merge_plain(rows, scores, seg, k)
    assert torch.equal(got, want), case
    # the stable global sort of the whole plane, -1 / -inf past its end
    v, i = torch.sort(flat, dim=1, descending=True, stable=True)
    m = min(k, n)
    got = got.cpu()
    assert torch.equal(got[:, :m], i[:, :m].to(torch.int32))
    assert torch.equal(got[:, k:k + m], v[:, :m].view(torch.int32))
    assert (got[:, m:k] == -1).all()
    assert torch.isneginf(got[:, k + m:].view(torch.float32)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dp,mp", [(1, 4), (2, 2), (2, 4), (1, 8)])
def test_cuda_sharded_closed_form_matches_one_device(dp, mp):
    """The closed form with inputs laid out over a mesh whose cells all
    name the one card: a shard launch per cell and a merge per groups
    row, identical to the one-device launch and to the plain version."""
    dev = _card()
    rng = np.random.default_rng(dp * 10 + mp)
    g, n, j, k = 8, 4096, 16, 64
    cap = np.tile(np.array([4000, 8192, 102400, 1000], np.float32), (n, 1))
    cap[::3, 0] = 8000
    used = (cap * rng.uniform(0, 0.5, (n, 1))).astype(np.float32)
    batch = dict(
        asks=np.tile(np.array([[500, 256, 300, 0]], np.float32), (g, 1)),
        eligible=rng.random((g, n)) < 0.9,
        job_counts=rng.integers(0, 2, (g, n)).astype(np.int32),
        desired_totals=np.full(g, 40.0, np.float32),
        penalty_nodes=rng.random((g, n)) < 0.05,
        affinity_scores=np.zeros((g, n), np.float32),
        has_affinities=np.zeros(g, bool),
        distinct_hosts=np.zeros(g, bool),
        slot_caps=np.full((g, n), np.inf, np.float32),
    )
    one_in = {k_: torch.from_numpy(v).to(dev) for k_, v in batch.items()}
    cap_t, used_t = torch.from_numpy(cap).to(dev), torch.from_numpy(used).to(dev)
    one = S.place_closed_form(cap_t, used_t, **one_in, algorithm_spread=False, max_j=j, k=k)
    plain = S.place_closed_form_plain(cap_t, used_t, *one_in.values(), False, j, k)
    cfg = backend.make_mesh(dp, mp, dev)
    sharded = {k_: backend.shard_put(v, S._BATCH_SPECS[k_], cfg) for k_, v in batch.items()}
    backend.reset_mesh_layouts()
    got = S.place_closed_form(
        backend.shard_put(cap, ("nodes",), cfg), backend.shard_put(used, ("nodes",), cfg),
        **sharded, algorithm_spread=False, max_j=j, k=k,
    )
    for a, b, c in zip(got, one, plain):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert torch.equal(a.view(torch.int32), c.view(torch.int32))
    layouts = backend.mesh_layouts()
    assert layouts["place_closed_form:shard"] == dp * mp
    assert layouts["closed_form_topk_merge:merge"] == dp


# -- the coupled scans under a mesh -------------------------------------------------


def coupled_batch(rng, g, n, v, kind, b=2):
    """Host inputs of a coupled pass on ``n`` nodes: block 0 of ``kind``
    (0 target spread, 1 even spread, 2 distinct cap) over ``v`` values,
    a quarter of the nodes value-less, block 1 an even spread over
    values that span shards; tied capacities, some ineligible nodes,
    existing counts."""
    cap = np.tile(np.array([4000, 8192, 102400, 1000], np.float32), (n, 1))
    cap[::5, 0] = 8000
    used = (cap * rng.choice([0.0, 0.25, 0.5], (n, 1))).astype(np.float32)
    vids = np.stack([rng.integers(0, v, n), np.arange(n) * v // n]).astype(np.int32)
    vids[0, rng.random(n) < 0.25] = -1
    kinds = np.array([kind, 1], np.int32)
    desired = np.full((g, b, v), -1.0, np.float32)
    desired[:, 0, :] = np.where(kind == 0, rng.integers(1, 8, (g, v)), -1).astype(np.float32)
    caps = np.full((g, b, v), np.inf, np.float32)
    if kind == 2:
        caps[:, 0, :] = 2.0
    return dict(
        capacity=cap, used0=used,
        asks=np.tile(np.array([[500, 256, 300, 0]], np.float32), (g, 1)),
        eligible=rng.random((g, n)) < 0.9,
        job_counts=rng.integers(0, 2, (g, n)).astype(np.int32),
        desired_totals=np.full(g, 40.0, np.float32),
        penalty_nodes=rng.random((g, n)) < 0.05,
        affinity_scores=np.zeros((g, n), np.float32),
        has_affinities=np.zeros(g, bool), distinct_hosts=np.zeros(g, bool),
        slot_caps=np.full((g, n), np.inf, np.float32),
        block_value_ids=np.broadcast_to(vids, (g, b, n)).copy(),
        block_counts0=rng.integers(0, 3, (g, b, v)).astype(np.float32),
        block_desired=desired, block_caps=caps,
        block_weights=np.full((g, b), 0.5, np.float32),
        block_kinds=np.tile(kinds, (g, 1)),
    )


def run_scan(kind, t, counts, j, steps, enforce=None, chunk=S.CHUNK):
    """One of the three scans on the tensors ``t`` (plain or laid out)."""
    if kind == "value_scan":
        return S.place_value_scan(**t, algorithm_spread=False, counts=counts, max_j=j,
                                  max_steps=steps)
    if kind == "chunked":
        return S.place_spread_chunked(**t, algorithm_spread=False, counts=counts, max_j=j,
                                      chunk=chunk, n_chunks=steps)
    return S.place_spread_opv(**t, enforce_idx=enforce, algorithm_spread=False, counts=counts,
                              max_j=j, k_seg=chunk, n_chunks=steps)


def plain_scan(kind, t, counts, j, steps, enforce=None, chunk=S.CHUNK):
    args = [t[name] for name, _ in S._COUPLED_AXES]
    if kind == "value_scan":
        return S.place_value_scan_plain(*args, False, counts, j, steps)
    if kind == "chunked":
        return S.place_spread_chunked_plain(*args, False, counts, j, chunk, steps)
    return S.place_spread_opv_plain(*args, enforce, False, counts, j, chunk, steps)


SCAN_BLOCK = {"value_scan": 2, "chunked": 0, "opv": 1}
SCAN_STEPS = {"value_scan": 24, "chunked": 4, "opv": 4}


@pytest.mark.cuda
@pytest.mark.parametrize("dp,mp", [(1, 4), (2, 2), (2, 4)])
@pytest.mark.parametrize("kind", ["value_scan", "chunked", "opv"])
def test_cuda_sharded_coupled_scan_matches_one_device(kind, dp, mp):
    """Each coupled scan with inputs laid out over a mesh whose cells all
    name the one card: shard steps, merges and applies, identical to the
    one-device kernel and to the plain version (uint32 views), with no
    gathered launch; a node axis the mesh does not divide is gathered."""
    dev = _card()
    rng = np.random.default_rng(dp * 10 + mp + len(kind))
    g, n, v, j = 8, 4096, 24, 16
    batch = coupled_batch(rng, g, n, v, SCAN_BLOCK[kind])
    t = {k_: torch.from_numpy(x).to(dev) for k_, x in batch.items()}
    counts = torch.full((g,), 20 if kind == "value_scan" else 40, dtype=torch.int32, device=dev)
    enforce = torch.ones(g, dtype=torch.int32, device=dev) if kind == "opv" else None
    steps = SCAN_STEPS[kind]
    one = run_scan(kind, t, counts, j, steps, enforce)
    plain = plain_scan(kind, t, counts, j, steps, enforce)
    cfg = backend.make_mesh(dp, mp, dev)
    specs = dict(S._BATCH_SPECS, capacity=("nodes",), used0=("nodes",))
    sharded = {k_: backend.shard_put(x, specs[k_], cfg) for k_, x in batch.items()}
    backend.reset_mesh_layouts()
    got = run_scan(kind, sharded, counts, j, steps, enforce)
    torch.cuda.synchronize()
    for a, b_, c in zip(got, one, plain):
        assert torch.equal(a.view(torch.int32), b_.view(torch.int32)), kind
        assert torch.equal(a.view(torch.int32), c.view(torch.int32)), kind
    assert (got[0] >= 0).any()
    layouts = backend.mesh_layouts()
    sweeps = 2 if kind == "opv" else 1
    assert layouts == {
        "coupled_shard_step:shard": steps * dp * mp * sweeps,
        "coupled_step_merge:merge": steps * dp * sweeps,
        "coupled_shard_apply:shard": steps * dp * mp,
    }, layouts
    # 4,095 nodes: the node axis does not divide, the call is gathered
    cut = {k_: x[..., :-1] if k_ in ("eligible", "job_counts", "penalty_nodes",
                                      "affinity_scores", "slot_caps", "block_value_ids")
           else x[:-1] if k_ in ("capacity", "used0") else x for k_, x in batch.items()}
    cut = {k_: np.ascontiguousarray(x) for k_, x in cut.items()}
    tc = {k_: torch.from_numpy(x).to(dev) for k_, x in cut.items()}
    backend.reset_mesh_layouts()
    got = run_scan(kind, {k_: backend.shard_put(x, specs[k_], cfg) for k_, x in cut.items()},
                   counts, j, steps, enforce)
    one = run_scan(kind, tc, counts, j, steps, enforce)
    for a, b_ in zip(got, one):
        assert torch.equal(a.view(torch.int32), b_.view(torch.int32))
    wrapper = {"value_scan": "place_value_scan", "chunked": "place_spread_chunked",
               "opv": "place_spread_opv"}[kind]
    assert backend.mesh_layouts() == {f"{wrapper}:gathered": 1}


def cell_state(rng, batch, g, n, v, lo, hi, j):
    """One cell's inputs (nodes [lo, hi)), a mid-scan ``jn`` and a record
    with counts and placements, as torch tensors on the CPU."""
    seg = hi - lo
    node_axis = {"capacity": 0, "used0": 0, "eligible": 1, "job_counts": 1,
                 "penalty_nodes": 1, "affinity_scores": 1, "slot_caps": 1,
                 "block_value_ids": 2}
    parts = {}
    for k_, x in batch.items():
        if k_ in node_axis:
            x = np.take(x, np.arange(lo, hi), axis=node_axis[k_])
        parts[k_] = torch.from_numpy(np.ascontiguousarray(x))
    nb = batch["block_kinds"].shape[1]
    record = S._record_start(torch.from_numpy(rng.integers(0, 4, (g, nb, v)).astype(np.float32)),
                             nb, v)
    record[:, S._REC_PLACED] = torch.from_numpy(rng.integers(0, 30, g).astype(np.int32))
    record[:, S._REC_V_FIRST] = torch.from_numpy(rng.integers(0, v + 1, g).astype(np.int32))
    jn = torch.from_numpy(rng.integers(0, j + 1, (g, seg)).astype(np.int32))
    return parts, jn, record


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["chunked", "value", "segments", "segments_first"])
def test_cuda_shard_step_matches_plain(mode):
    """``coupled_shard_step`` on a cell's slice in the middle of a scan
    (columns taken, counts and placements in the record) against its
    plain version, bit for bit, and counted once."""
    dev = _card()
    rng = np.random.default_rng(len(mode))
    g, n, v, j = 6, 2048, 24, 16
    batch = coupled_batch(rng, g, n, v, 1 if mode.startswith("segments") else 0)
    parts, jn, record = cell_state(rng, batch, g, n, v, 512, 1536, j)
    counts = torch.full((g,), 40, dtype=torch.int32)
    enforce = torch.from_numpy(rng.integers(0, 2, g).astype(np.int32))
    kw = dict(algorithm_spread=False, max_j=j, segments=mode.startswith("segments"),
              chunk={"chunked": 16, "value": 1}.get(mode, 16), col0=512,
              first_step=mode == "segments_first")
    args = {k_: x for k_, x in parts.items() if k_ != "block_counts0"}
    want = S.coupled_shard_step_plain(**args, counts=counts, enforce_idx=enforce, jn=jn,
                                      record=record, **kw)
    on = lambda x: x.to(dev)  # noqa: E731
    before = S.coupled_shard_step.launches
    got = S.coupled_shard_step(**{k_: on(x) for k_, x in args.items()}, counts=on(counts),
                               enforce_idx=on(enforce), jn=on(jn), record=on(record), **kw)
    assert S.coupled_shard_step.launches == before + 1
    assert torch.equal(got.cpu(), want), mode
    assert (want[..., 0] != 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["chunked", "first", "segments", "segments_first"])
def test_cuda_step_merge_and_apply_match_plain(mode):
    """``coupled_step_merge`` of four cells' plain candidates, and
    ``coupled_shard_apply`` of its record, against their plain versions,
    bit for bit: equal scores across cells, cells with fewer candidates
    than the chunk, a count that stops mid-chunk."""
    dev = _card()
    rng = np.random.default_rng(7 + len(mode))
    g, n, v, j, cells = 6, 2048, 24, 16, 4
    seg = n // cells
    batch = coupled_batch(rng, g, n, v, 1)
    batch["eligible"][:, seg:2 * seg] = False  # a cell with no candidate
    batch["eligible"][:, 2 * seg + 3:3 * seg] = False  # one with three
    counts = torch.from_numpy(rng.integers(20, 60, g).astype(np.int32))
    enforce = torch.from_numpy(rng.integers(0, 2, g).astype(np.int32))
    segments = mode.startswith("segments")
    record = None
    cands = []
    for c in range(cells):
        parts, jn, rec = cell_state(rng, batch, g, n, v, c * seg, (c + 1) * seg, j)
        record = rec if record is None else record
        args = {k_: x for k_, x in parts.items() if k_ != "block_counts0"}
        cands.append(S.coupled_shard_step_plain(
            **args, counts=counts, enforce_idx=enforce, jn=jn, record=record,
            algorithm_spread=False, max_j=j, segments=segments,
            chunk=1 if mode == "first" else 16, col0=c * seg,
            first_step=mode == "segments_first",
        ))
    gathered = torch.stack(cands)
    record[:, S._REC_OK0] = 1
    present = torch.from_numpy(rng.integers(0, 2, (g, v)).astype(np.int32))
    kinds = torch.from_numpy(batch["block_kinds"])
    merge_mode = "segments" if segments else mode
    want = S.coupled_step_merge_plain(gathered, record, counts, kinds, enforce, present,
                                      merge_mode, 16, mode == "segments_first")
    on = lambda x: x.to(dev)  # noqa: E731
    got = S.coupled_step_merge(on(gathered), on(record), on(counts), on(kinds), on(enforce),
                               on(present), merge_mode, 16, mode == "segments_first")
    for a, b_ in zip(got, want):
        assert torch.equal(a.cpu().view(torch.int32), b_.view(torch.int32)), mode
    jn = torch.from_numpy(rng.integers(0, 4, (g, seg)).astype(np.int32))
    for c in range(cells):
        want_jn = S.coupled_shard_apply_plain(jn, want[0], c * seg)
        assert torch.equal(S.coupled_shard_apply(on(jn), on(want[0]), c * seg).cpu(), want_jn)
