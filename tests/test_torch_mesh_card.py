"""The cross-shard top-k merge kernel (``closed_form_topk_merge``,
``csrc/closed_form.cu``) and the sharded closed form on the card; the
coupled scans' mesh kernels and sharded scans; the hetero pass's and the
CP and gang auctions' mesh kernels (``csrc/hetero.cu``, ``csrc/cp.cu``)
and their sharded passes against the one-device kernels.

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
from nomad_tpu_torch.device import cp as C
from nomad_tpu_torch.device import score as S
from nomad_tpu_torch.scheduler import hetero as H


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


# -- the hetero pass and the CP and gang auctions under a mesh -------------------------


def _same(got, want, what):
    assert len(got) == len(want), what
    for i, (a, b_) in enumerate(zip(got, want)):
        a, b_ = a.cpu(), b_.cpu()
        assert a.shape == b_.shape, (what, i)
        assert torch.equal(a.reshape(-1).view(torch.int32), b_.reshape(-1).view(torch.int32)), \
            (what, i)


def hetero_batch(rng, g=12, n=4096, negative=False):
    """A hetero batch on the port's mixed fleet: (inputs, steps, max_c)."""
    ct = H.build_mixed_fleet(n - 100, seed=int(rng.integers(1 << 16)))
    asks = H.build_mixed_asks(ct, g, 12, seed=int(rng.integers(1 << 16)))
    b = H.build_hetero_batch(ct, asks)
    if negative:
        b.asks[1, 0] = -500.0
        b.asks[3, 1] = -1024.0
    return [b.capacity, b.used, b.asks, b.counts, b.eligible, b.tp, b.tpmax, b.cost], \
        b.steps, b.max_c


def cp_batch(rng, g=24, n=4096, gang=False):
    """A contended CP batch of coarse values (ties), with gang groups on
    racks that span cells when ``gang``: (inputs, gang inputs, steps,
    max_c)."""
    capacity = np.tile(np.array([8000, 16384, 1e5, 1000], np.float32), (n, 1))
    used = (capacity * rng.choice([0.0, 0.25, 0.5], size=(n, 1))).astype(np.float32)
    asks = np.tile(np.array([1000, 2048, 300, 0], np.float32), (g, 1))
    counts = rng.integers(1, 6, size=g).astype(np.int32)
    eligible = rng.random((g, n)) < 0.02
    scores = (rng.integers(0, 8, size=(g, n)) / 8).astype(np.float32)
    prio = rng.choice([50.0, 70.0], size=g).astype(np.float32)
    job_counts = (rng.random((g, n)) < 0.01).astype(np.int32)
    distinct = rng.random(g) < 0.3
    jobgrp = (np.arange(g) // 3).astype(np.int32)
    lam0 = np.zeros(n, np.float32)
    common = [capacity, used, asks, counts, eligible, scores, prio, job_counts, distinct,
              jobgrp, lam0]
    extra = None
    if gang:
        level_ids = np.stack([1 + (np.arange(n) + n // 8) // 512, 1 + np.arange(n) // 2048,
                              1 + np.arange(n) % 5]).astype(np.int32)
        level_ids[:, ::97] = 0
        widths = tuple(int(x.max()) + 1 for x in level_ids)
        extra = [(np.arange(g) // 3 + 1).astype(np.int32) * (np.arange(g) % 4 != 3),
                 rng.choice([1.0, -0.5], size=g).astype(np.float32),
                 np.full(g, 0.25, np.float32), rng.choice([0.0, 0.5], size=g).astype(np.float32),
                 level_ids, widths]
    total = int(counts.sum())
    return common, extra, 1 << total.bit_length(), 8


def _gang_call(fn, common, extra, steps, max_c, put):
    w = [put(x, ()) for x in extra[:4]]
    return fn(*[put(x, ax) for x, ax in zip(common[:10], CP_SPECS[:10])], *w,
              put(extra[4], (None, "nodes")), extra[5], put(common[10], ()), steps, max_c)


HETERO_SPECS = (("nodes",), ("nodes",), ("groups",), ("groups",), ("groups", "nodes"),
                ("groups", "nodes"), ("groups",), ())
CP_SPECS = (("nodes",), ("nodes",), ("groups",), ("groups",), ("groups", "nodes"),
            ("groups", "nodes"), ("groups",), ("groups", "nodes"), ("groups",), (), ())


@pytest.mark.cuda
@pytest.mark.parametrize("dp,mp", [(1, 4), (2, 2), (2, 4)])
@pytest.mark.parametrize("policy", sorted(H.POLICY_IDS))
def test_cuda_sharded_hetero_matches_one_device(policy, dp, mp):
    """The hetero pass laid out over a mesh whose cells all name the one
    card (with and without negative asks): identical to the one-device
    kernel and the plain version, launches only "shard" / "merge"."""
    dev = _card()
    for negative in (False, True):
        rng = np.random.default_rng(dp * 10 + mp + negative)
        args, steps, max_c = hetero_batch(rng, negative=negative)
        pid = H.POLICY_IDS[policy]
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in args]
        one = H.hetero_place(*t, pid, steps, max_c)
        plain = H.hetero_place_plain(*t, pid, steps, max_c)
        cfg = backend.make_mesh(dp, mp, dev)
        backend.reset_mesh_layouts()
        got = H.hetero_place(*[backend.shard_put(a, ax, cfg) for a, ax in zip(args, HETERO_SPECS)],
                             pid, steps, max_c)
        torch.cuda.synchronize()
        _same(got, one, f"hetero {policy} {dp}x{mp} vs the kernel")
        _same(got, plain, f"hetero {policy} {dp}x{mp} vs plain")
        assert (one[0] >= 0).sum() > 0
        layouts = backend.mesh_layouts()
        assert set(layouts) == {"hetero_shard_step:shard", "hetero_step_merge:merge",
                                "hetero_shard_apply:shard", "hetero_place:shard"}, layouts


@pytest.mark.cuda
@pytest.mark.parametrize("dp,mp", [(1, 4), (2, 2), (2, 4)])
@pytest.mark.parametrize("form", ["cp", "gang_ids", "gang_onehot"])
def test_cuda_sharded_auction_matches_one_device(form, dp, mp):
    """The CP auction and its gang forms laid out over a mesh on the one
    card: identical to the one-device kernel and the plain version (every
    output: choices, scores, usage, rounds, prices, waits)."""
    dev = _card()
    rng = np.random.default_rng(dp * 10 + mp + len(form))
    common, extra, steps, max_c = cp_batch(rng, gang=form != "cp")
    cfg = backend.make_mesh(dp, mp, dev)
    on = lambda x, ax=(): torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa: E731
    shard = lambda x, ax: backend.shard_put(x, ax, cfg)  # noqa: E731
    if form == "cp":
        one = C.cp_place(*[on(x) for x in common], steps, max_c)
        plain = C.cp_place_plain(*[on(x) for x in common], steps, max_c)
        backend.reset_mesh_layouts()
        got = C.cp_place(*[shard(x, ax) for x, ax in zip(common, CP_SPECS)], steps, max_c)
    elif form == "gang_ids":
        one = _gang_call(C.cp_gang_place_ids, common, extra, steps, max_c, on)
        plain = _gang_call(C.cp_gang_place_ids_plain, common, extra, steps, max_c, on)
        backend.reset_mesh_layouts()
        got = _gang_call(C.cp_gang_place_ids, common, extra, steps, max_c, shard)
    else:
        ids, widths = extra[4], extra[5]
        onehots = []
        for row, w in zip(ids, widths):
            oh = np.zeros((row.size, w), np.int32)
            oh[np.arange(row.size)[row > 0], row[row > 0]] = 1
            onehots.append(oh)
        args = lambda put: (  # noqa: E731
            *[put(x, ax) for x, ax in zip(common[:10], CP_SPECS[:10])],
            *[put(x, ()) for x in extra[:4]], *[put(oh, ("nodes",)) for oh in onehots],
            put(common[10], ()), steps, max_c)
        one = C.cp_gang_place(*args(on))
        plain = C.cp_gang_place_plain(*args(on))
        backend.reset_mesh_layouts()
        got = C.cp_gang_place(*args(shard))
    torch.cuda.synchronize()
    _same(got, one, f"{form} {dp}x{mp} vs the kernel")
    _same(got, plain, f"{form} {dp}x{mp} vs plain")
    assert int(one[3]) > 1 and (one[0] >= 0).any()
    assert set(backend.mesh_layouts()) == {"cp_shard_claim:shard", "cp_round_merge:merge",
                                           "cp_shard_settle:shard"}, backend.mesh_layouts()


@pytest.mark.cuda
def test_cuda_hetero_mesh_kernels_match_plain():
    """``hetero_shard_step`` on a cell's slice, ``hetero_step_merge`` of
    four cells' candidates and ``hetero_shard_apply`` of its record,
    against their plain versions, bit for bit, each counted once."""
    dev = _card()
    rng = np.random.default_rng(3)
    args, _, max_c = hetero_batch(rng, negative=True)
    capacity, used, asks, counts, eligible, tp, tpmax, cost = [
        torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    g, n = tp.shape
    cells, seg = 4, n // 4
    placed = torch.from_numpy(rng.integers(0, 3, g).astype(np.int32))
    on = lambda x: x.to(dev)  # noqa: E731
    for pid in H.POLICY_IDS.values():
        cands = []
        for c in range(cells):
            ns = slice(c * seg, (c + 1) * seg)
            part = (capacity[ns], used[ns], asks, counts, eligible[:, ns].contiguous(),
                    tp[:, ns].contiguous(), cost[ns], placed)
            want = H.hetero_shard_step_plain(*part, pid, c * seg)
            before = H.hetero_shard_step.launches
            got = H.hetero_shard_step(*[on(x) for x in part], pid, c * seg)
            assert H.hetero_shard_step.launches == before + 1
            assert torch.equal(got.cpu(), want), (pid, c)
            cands.append(want)
        cand = torch.cat(cands)
        state = (placed, (placed * 0.5).to(torch.float32), counts, tpmax, asks,
                 torch.full((g, max_c), -1, dtype=torch.int32),
                 torch.zeros((g, max_c), dtype=torch.float32))
        want = H.hetero_step_merge_plain(cand, *state, pid)
        _same(H.hetero_step_merge(on(cand), *[on(x) for x in state], pid), want, f"merge {pid}")
        assert int(want[0][0]) == 0
        for c in range(cells):
            ns = slice(c * seg, (c + 1) * seg)
            w = H.hetero_shard_apply_plain(want[0], used[ns], placed, c * seg, 0)
            _same(H.hetero_shard_apply(on(want[0]), on(used[ns]), on(placed), c * seg, 0), w,
                  f"apply {pid} {c}")


@pytest.mark.cuda
@pytest.mark.parametrize("gang", [False, True])
def test_cuda_cp_mesh_kernels_match_plain(gang):
    """``cp_shard_claim`` on four cells mid-pass (prices, assignments,
    sibling and topology counts set), ``cp_round_merge`` of their
    candidates and ``cp_shard_settle`` of its record, against their plain
    versions, bit for bit."""
    dev = _card()
    rng = np.random.default_rng(11 + gang)
    common, extra, _, max_c = cp_batch(rng, gang=True)
    (capacity, used, asks, counts, eligible, scores, prio, job_counts, distinct, jobgrp,
     _lam0) = [torch.from_numpy(np.ascontiguousarray(a)) for a in common]
    g, n = scores.shape
    cells, seg = 4, n // 4
    job_code = jobgrp.clone()
    n_jobs = int(job_code.max()) + 1
    lam = torch.from_numpy(rng.choice([0.0, 0.125, 0.25], size=n).astype(np.float32))
    assigned = torch.from_numpy((rng.random((g, n)) < 0.01).astype(np.int32))
    sib = torch.zeros((n_jobs, n), dtype=torch.int32).index_add_(0, job_code.long(), assigned)
    placed = torch.from_numpy(rng.integers(0, 2, g).astype(np.int32))
    gang_args = None
    if gang:
        gid = torch.from_numpy(extra[0])
        code, n_gangs = C._codes(torch.where(gid > 0, gid, 0))
        gang_code = torch.where(gid > 0, code, -1).to(torch.int32)
        q = [C._cp_topo_quant(torch.from_numpy(w)) for w in extra[1:4]]
        level_ids = torch.from_numpy(extra[4])
        tables = [torch.from_numpy(rng.integers(0, 3, (n_gangs + 1, w)).astype(np.int32))
                  for w in extra[5]]
        gang_args = (gang_code, *q, level_ids, *tables)
    on = lambda x: x.to(dev)  # noqa: E731
    cands = []
    for c in range(cells):
        ns = slice(c * seg, (c + 1) * seg)
        part = (capacity[ns], used[ns], asks, counts, eligible[:, ns].contiguous(),
                scores[:, ns].contiguous(), job_counts[:, ns].contiguous(), distinct, job_code,
                lam[ns], assigned[:, ns].contiguous(), sib[:, ns].contiguous(), placed)
        cg = None if gang_args is None else (
            *gang_args[:4], gang_args[4][:, ns].contiguous(), *gang_args[5:])
        want = C.cp_shard_claim_plain(*part, c * seg, cg)
        before = C.cp_shard_claim.launches
        got = C.cp_shard_claim(*[on(x) for x in part], c * seg,
                               None if cg is None else tuple(on(x) for x in cg))
        assert C.cp_shard_claim.launches == before + 1
        assert torch.equal(got.cpu(), want), c
        cands.append(want)
    cand = torch.cat(cands)
    state = (prio, asks, job_code, gang_args[0] if gang else None, placed,
             torch.zeros(g, dtype=torch.int32), torch.tensor(3, dtype=torch.int32),
             torch.full((g, max_c), -1, dtype=torch.int32),
             torch.zeros((g, max_c), dtype=torch.float32),
             torch.zeros(C.cp_record_words(g), dtype=torch.int32))
    want = C.cp_round_merge_plain(cand, *state)
    got = C.cp_round_merge(on(cand), *[None if x is None else on(x) for x in state])
    _same(got, want, "merge")
    assert int(want[0][1]) > 0
    for c in range(cells):
        ns = slice(c * seg, (c + 1) * seg)
        st = (used[ns], lam[ns], assigned[:, ns].contiguous(), sib[:, ns].contiguous(), placed)
        tabs = () if not gang else gang_args[5:]
        w = C.cp_shard_settle_plain(want[0], *st, c * seg, 0, *tabs)
        _same(C.cp_shard_settle(on(want[0]), *[on(x) for x in st], c * seg, 0,
                                *[on(x) for x in tabs]), w, f"settle {c}")
