"""Drive the kernel fleet once with a tiny synthetic workload.

The port of ``nomad_tpu/analysis/jaxlint/exercise.py``, the same
16-node cluster and asks: the four ``PlacementKernel`` families through
the real dispatch (closed form, exact scan, chunked, one-per-value), the
score matrix in its class-less and throughput configs, the two
preemption kernels, the hetero greedy, the CP auction and its gang
form, and the migration auction. Two passes more than the reference's:
the closed form under a 1x2 node-axis mesh (``backend.make_mesh``, both
cells on ``device``), so the mesh's cross-shard merge
(``closed_form_topk_merge``) runs too; one step of the chunked and the
one-per-value scans over two node slices, each of the coupled scans'
mesh kernels called through its wrapper; and one step of the hetero
pass and one round of the CP auction and of its gang form over two node
slices, through their mesh kernels' wrappers. Every registered kernel is
called at least once.

Everything runs on ``device`` (default the card; ``"cpu"`` runs the
plain versions) and is seeded, so the recorded calls are a pure
function of this file. ``exercise_fleet`` returns them
(``backend.KernelCall``: each wrapper call's inputs and outputs).
"""

from __future__ import annotations

N_NODES = 16
D = 4
MESH_SHAPE = (1, 2)


def _t(x, dev):
    import numpy as np
    import torch

    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


def _cluster():
    import numpy as np

    from ...device.flatten import ClusterTensors, node_bucket

    pn = node_bucket(N_NODES)
    capacity = np.zeros((pn, D), dtype=np.float32)
    capacity[:N_NODES, 0] = 16000.0
    capacity[:N_NODES, 1] = 32768.0
    capacity[:N_NODES, 2] = 100 * 1024.0
    capacity[:N_NODES, 3] = 1000.0
    used = np.zeros_like(capacity)
    used[:N_NODES, :2] = capacity[:N_NODES, :2] * 0.1
    ready = np.zeros(pn, dtype=bool)
    ready[:N_NODES] = True
    return ClusterTensors(
        node_ids=[f"jxl-node-{i}" for i in range(N_NODES)],
        index=1,
        num_nodes=N_NODES,
        capacity=capacity,
        used=used,
        ready=ready,
        dc_ids=np.zeros(pn, dtype=np.int32),
        class_ids=np.zeros(pn, dtype=np.int32),
        dc_vocab={"dc1": 0},
        class_vocab={"small": 0},
        class_rep=[0],
        node_row={f"jxl-node-{i}": i for i in range(N_NODES)},
    )


def _ask(ct, job, count, blocks=None):
    import numpy as np

    from ...device.flatten import GroupAsk

    pn = ct.padded_n
    return GroupAsk(
        job_id=f"jxl-{job}",
        tg_name="web",
        count=count,
        desired_total=count,
        ask=np.array([250.0, 512.0, 300.0, 0.0], dtype=np.float32),
        eligible=ct.ready.copy(),
        job_counts=np.zeros(pn, dtype=np.int32),
        penalty_nodes=np.zeros(pn, dtype=bool),
        affinity_scores=np.zeros(pn, dtype=np.float32),
        has_affinities=False,
        distinct_hosts=False,
        blocks=blocks,
    )


def _blocks(ct, kind, values=4):
    """One spread/cap accounting block over a synthetic rack attribute."""
    import numpy as np

    from ...device.flatten import ValueBlocks

    pn = ct.padded_n
    value_ids = np.full((1, pn), -1, dtype=np.int32)
    value_ids[0, :N_NODES] = np.arange(N_NODES) % values
    return ValueBlocks(
        value_ids=value_ids,
        counts0=np.zeros((1, values), dtype=np.float32),
        desired=np.full((1, values), -1.0, dtype=np.float32),
        caps=np.full((1, values), np.inf, dtype=np.float32),
        weights=np.ones(1, dtype=np.float32),
        kinds=np.array([kind], dtype=np.int32),
    )


def _asks(ct):
    from ...device.score import BLOCK_EVEN_SPREAD, BLOCK_TARGET_SPREAD

    return [
        _ask(ct, "fast-a", 3),  # closed-form top-k
        _ask(ct, "fast-b", 2),
        _ask(ct, "scan", 3, blocks=_blocks(ct, BLOCK_TARGET_SPREAD)),
        _ask(ct, "chunked", 40, blocks=_blocks(ct, BLOCK_TARGET_SPREAD)),
        _ask(ct, "opv", 40, blocks=_blocks(ct, BLOCK_EVEN_SPREAD)),
    ]


def run_placement_paths(
    device="cuda", explain: bool = False, incremental: bool = False, mesh=None,
):
    """Route one tiny batch through each PlacementKernel family.
    Returns the placement results.

    With ``incremental`` a DeviceStateCache rides along as the cluster's
    score cache and the batch runs TWICE — full rebuild, then one
    churned row through the dirty-patch path with a generation swap
    between — so the differ observes every incremental code path while
    proving none of them launched another kernel. ``mesh`` (a
    ``backend.MeshConfig``) lays the pass out over a node-axis mesh."""
    from ...device.score import PlacementKernel

    ct = _cluster()
    cache = None
    if incremental:
        from ...device.cache import DeviceStateCache

        cache = DeviceStateCache(device=device)
        ct.score_cache = cache
    asks = _asks(ct)
    kernel = PlacementKernel("binpack", mesh=mesh, device=device)
    results = kernel.place(ct, asks, explain=explain)
    if cache is not None:
        cache.score_commit()
        ct.used[0, 0] += 128.0  # one dirty row → the patch pass
        results = kernel.place(ct, asks, explain=explain)
        cache.score_commit()
    return results


def run_sharded_closed_form(device="cuda"):
    """The closed-form asks under a 1x2 node-axis mesh, both cells on
    ``device``: a shard launch a cell, then the cross-shard merge.
    Returns the placement results."""
    from ... import backend

    mesh = backend.make_mesh(*MESH_SHAPE, devices=device)
    from ...device.score import PlacementKernel

    ct = _cluster()
    asks = _asks(ct)[:2]
    return PlacementKernel("binpack", mesh=mesh, device=device).place(ct, asks)


def run_coupled_mesh_kernels(device="cuda") -> None:
    """One step of the chunked scan and of the one-per-value scan as a
    1x2 node-axis mesh runs them (the "chunked" and "opv" asks over two
    node slices): both cells' candidates (``coupled_shard_step``), the
    row's merges (``coupled_step_merge``) and both cells' applies
    (``coupled_shard_apply``), each through its wrapper."""
    import numpy as np
    import torch

    from ...device import score as S
    from ...device.flatten import pad_value_blocks

    ct = _cluster()
    asks = _asks(ct)[3:5]
    pn = ct.padded_n
    batch = S._shared_batch(asks, pn)
    batch.update(pad_value_blocks([a.blocks for a in asks], pn))
    batch.update(capacity=ct.capacity, used0=ct.used)
    g, nb, nv = batch["block_counts0"].shape
    seg = pn // MESH_SHAPE[1]
    cells = []
    for j in range(MESH_SHAPE[1]):
        cell = {}
        for name, axes in S._COUPLED_AXES:
            if name == "block_counts0":  # the record carries the counts
                continue
            x = batch[name]
            if "nodes" in axes:
                x = np.take(x, np.arange(j * seg, (j + 1) * seg), axis=axes.index("nodes"))
            cell[name] = _t(x, device)
        cells.append(cell)
    counts = _t(np.array([a.count for a in asks], dtype=np.int32), device)
    enforce = _t(np.zeros(g, dtype=np.int32), device)
    kinds = _t(batch["block_kinds"], device)
    present = torch.zeros((g, nv), dtype=torch.int32, device=device)
    start = S._record_start(_t(batch["block_counts0"], device), nb, nv)
    jns = [torch.zeros((g, seg), dtype=torch.int32, device=device) for _ in cells]
    k_seg = min(S.CHUNK, nv + 1)

    def candidates(record, segments, chunk, first_step):
        return torch.stack([
            S.coupled_shard_step(
                **cell, counts=counts, enforce_idx=enforce, jn=jns[j], record=record,
                algorithm_spread=False, max_j=16, segments=segments, chunk=chunk,
                col0=j * seg, first_step=first_step,
            )
            for j, cell in enumerate(cells)
        ])

    chunked, _, _, _ = S.coupled_step_merge(
        candidates(start, False, 4, False), start, counts, kinds, enforce, present,
        "chunked", 4, False,
    )
    first, present, _, _ = S.coupled_step_merge(
        candidates(start, False, 1, False), start, counts, kinds, enforce, present,
        "first", k_seg, False,
    )
    opv, present, _, _ = S.coupled_step_merge(
        candidates(first, True, k_seg, True), first, counts, kinds, enforce, present,
        "segments", k_seg, True,
    )
    for j in range(len(cells)):
        S.coupled_shard_apply(jns[j], chunked, j * seg)
        S.coupled_shard_apply(jns[j], opv, j * seg)


def run_score_matrix(device="cuda") -> None:
    """score_matrix in both configs: class-less (throughputs None — the
    Python gate) and with the throughput axis."""
    import numpy as np

    from ...device.score import score_matrix

    g, n = 2, N_NODES
    capacity = np.full((n, D), 16000.0, dtype=np.float32)
    used = capacity * 0.1
    asks = np.full((g, D), 250.0, dtype=np.float32)
    eligible = np.ones((g, n), dtype=bool)
    job_counts = np.zeros((g, n), dtype=np.int32)
    desired_totals = np.full(g, 3.0, dtype=np.float32)
    penalty = np.zeros((g, n), dtype=bool)
    affinity = np.zeros((g, n), dtype=np.float32)
    has_aff = np.zeros(g, dtype=bool)
    distinct = np.zeros(g, dtype=bool)
    args = [
        _t(x, device) for x in (
            capacity, used, asks, eligible, job_counts, desired_totals,
            penalty, affinity, has_aff, distinct,
        )
    ]
    score_matrix(*args, False)
    tp = np.ones((g, n), dtype=np.float32)
    score_matrix(*args, False, _t(tp, device))


def run_preemption(device="cuda") -> None:
    import numpy as np

    from ...device.preempt import choose_preemption_node, find_preemption

    n, v = N_NODES, 3
    capacity = np.full((n, D), 16000.0, dtype=np.float32)
    used = capacity * 0.9
    ask = np.array([4000.0, 8000.0, 100.0, 0.0], dtype=np.float32)
    eligible = np.ones(n, dtype=bool)
    rng = np.random.default_rng(11)
    victim_res = rng.uniform(
        100.0, 4000.0, size=(n, v, D)
    ).astype(np.float32)
    victim_prio = np.full((n, v), 20, dtype=np.int32)
    victim_mask = np.ones((n, v), dtype=bool)
    args = [
        _t(x, device) for x in (
            capacity, used, ask, eligible, victim_res, victim_prio, victim_mask,
        )
    ]
    find_preemption(*args)
    choose_preemption_node(*args)


def _put(mesh, device):
    """Inputs on ``device``, or laid out over ``mesh`` along the given
    axes (``backend.shard_put``)."""
    from ... import backend

    if mesh is None:
        return lambda x, axes=(): _t(x, device)
    return lambda x, axes=(): backend.shard_put(x, axes, mesh)


def _hetero_inputs():
    import numpy as np

    g, n = 2, N_NODES
    capacity = np.full((n, D), 16000.0, dtype=np.float32)
    return dict(
        capacity=capacity,
        used0=capacity * 0.1,
        asks=np.full((g, D), 250.0, dtype=np.float32),
        counts=np.full(g, 2, dtype=np.int32),
        eligible=np.ones((g, n), dtype=bool),
        tp=np.ones((g, n), dtype=np.float32),
        tpmax=np.ones(g, dtype=np.float32),
        cost=np.ones(n, dtype=np.float32),
    )


def run_hetero(device="cuda", policy: int = 0, mesh=None) -> None:
    """The hetero greedy, on ``device`` or laid out over ``mesh`` as the
    kernel object lays it."""
    from ...scheduler.hetero import _HETERO_AXES, hetero_place

    put = _put(mesh, device)
    x = _hetero_inputs()
    hetero_place(
        *[put(x[name], axes if name != "cost" else ()) for name, axes in _HETERO_AXES],
        policy=policy, steps=8, max_c=4,
    )


def _cp_inputs():
    import numpy as np

    g, n = 2, N_NODES
    capacity = np.full((n, D), 16000.0, dtype=np.float32)
    return dict(
        capacity=capacity,
        used0=capacity * 0.1,
        asks=np.full((g, D), 250.0, dtype=np.float32),
        counts=np.full(g, 2, dtype=np.int32),
        eligible=np.ones((g, n), dtype=bool),
        scores=np.linspace(0.1, 0.9, g * n, dtype=np.float32).reshape(g, n),
        prio=np.full(g, 50.0, dtype=np.float32),
        job_counts=np.zeros((g, n), dtype=np.int32),
        distinct=np.zeros(g, dtype=bool),
        jobgrp=np.arange(g, dtype=np.int32),
        lam0=np.zeros(n, dtype=np.float32),
    )


def _gang_inputs(levels=4):
    import numpy as np

    g, n = 2, N_NODES
    rack_oh = np.zeros((n, levels), dtype=np.int32)
    rack_oh[np.arange(n), 1 + np.arange(n) % (levels - 1)] = 1
    pod_oh = np.zeros((n, 2), dtype=np.int32)
    pod_oh[:, 1] = 1
    ici_oh = np.zeros((n, levels * 2), dtype=np.int32)
    ici_oh[np.arange(n), 1 + np.arange(n) % (levels * 2 - 1)] = 1
    return dict(
        gang=np.ones(g, dtype=np.int32),  # both groups in gang 1
        w_rack=np.full(g, 1.0, dtype=np.float32),
        w_pod=np.zeros(g, dtype=np.float32),
        w_ici=np.full(g, 0.5, dtype=np.float32),
        rack_oh=rack_oh, pod_oh=pod_oh, ici_oh=ici_oh,
    )


def run_cp(device="cuda", mesh=None) -> None:
    """The CP auction, on ``device`` or laid out over ``mesh`` as the
    kernel object lays it."""
    from ...device.cp import _CP_AXES, cp_place

    put = _put(mesh, device)
    x = _cp_inputs()
    cp_place(
        *[put(x[name], () if name in ("jobgrp", "lam0") else axes) for name, axes in _CP_AXES],
        steps=8, max_c=4,
    )


def run_cp_gang(device="cuda", mesh=None) -> None:
    """The gang auction (the reference's one-hot signature), on
    ``device`` or laid out over ``mesh``."""
    import numpy as np

    from ...device.cp import _CP_AXES, cp_gang_place

    put = _put(mesh, device)
    x = dict(_cp_inputs(), jobgrp=np.zeros(2, dtype=np.int32), **_gang_inputs())
    common = [put(x[name], () if name in ("jobgrp", "lam0") else axes) for name, axes in _CP_AXES]
    cp_gang_place(
        *common[:10], *[put(x[k]) for k in ("gang", "w_rack", "w_pod", "w_ici")],
        *[put(x[k], ("nodes",)) for k in ("rack_oh", "pod_oh", "ici_oh")], common[10],
        steps=8, max_c=4,
    )


def run_plugin_passes(device="cuda", mesh=None) -> None:
    """The hetero, CP and gang passes, on ``device`` or under ``mesh``:
    the mesh prover runs them both ways."""
    run_hetero(device, mesh=mesh)
    run_cp(device, mesh=mesh)
    run_cp_gang(device, mesh=mesh)


def run_plugin_mesh_kernels(device="cuda") -> None:
    """One step of the hetero pass and one round of the CP auction and of
    its gang form as a 1x2 node-axis mesh runs them, over two node
    slices: every cell's candidates (``hetero_shard_step``,
    ``cp_shard_claim``), the lead's merge (``hetero_step_merge``,
    ``cp_round_merge``) and every cell's apply or settle
    (``hetero_shard_apply``, ``cp_shard_settle``), each through its
    wrapper."""
    import numpy as np
    import torch

    from ...device import cp as C
    from ...scheduler import hetero as H

    seg = N_NODES // MESH_SHAPE[1]
    cols = range(MESH_SHAPE[1])
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)

    def part(x, j, axis):
        return _t(np.take(x, np.arange(j * seg, (j + 1) * seg), axis=axis), device)

    h = _hetero_inputs()
    g = h["asks"].shape[0]
    asks, counts = _t(h["asks"], device), _t(h["counts"], device)
    placed = torch.zeros(g, **i32)
    used = [part(h["used0"], j, 0) for j in cols]
    cand = torch.cat([
        H.hetero_shard_step(part(h["capacity"], j, 0), used[j], asks, counts,
                            part(h["eligible"], j, 1), part(h["tp"], j, 1),
                            part(h["cost"], j, 0), placed, policy=0, col0=j * seg)
        for j in cols
    ])
    record, *_ = H.hetero_step_merge(
        cand, placed, torch.zeros(g, **f32), counts, _t(h["tpmax"], device), asks,
        torch.full((g, 4), -1, **i32), torch.zeros((g, 4), **f32), policy=0,
    )
    for j in cols:
        H.hetero_shard_apply(record, used[j], placed, j * seg, 0)

    x = dict(_cp_inputs(), **_gang_inputs())
    asks, counts = _t(x["asks"], device), _t(x["counts"], device)
    job_code = _t(x["jobgrp"], device)
    gang_code = torch.zeros(g, **i32)
    q = [C._cp_topo_quant(_t(x[k], device)) for k in ("w_rack", "w_pod", "w_ici")]
    ids = np.stack([oh.argmax(axis=1) for oh in (x["rack_oh"], x["pod_oh"], x["ici_oh"])])
    tables = [torch.zeros((1, x[k].shape[1]), **i32) for k in ("rack_oh", "pod_oh", "ici_oh")]
    for gang in (None, (gang_code, *q)):
        state = [dict(used=part(x["used0"], j, 0), lam=part(x["lam0"], j, 0),
                      assigned=torch.zeros((g, seg), **i32), sib=torch.zeros((g, seg), **i32),
                      placed=torch.zeros(g, **i32)) for j in cols]
        cand = torch.cat([
            C.cp_shard_claim(
                part(x["capacity"], j, 0), state[j]["used"], asks, counts,
                part(x["eligible"], j, 1), part(x["scores"], j, 1),
                part(x["job_counts"], j, 1), _t(x["distinct"], device), job_code,
                state[j]["lam"], state[j]["assigned"], state[j]["sib"], state[j]["placed"],
                col0=j * seg,
                gang=None if gang is None else (*gang, part(ids.astype(np.int32), j, 1), *tables),
            )
            for j in cols
        ])
        record, *_ = C.cp_round_merge(
            cand, _t(x["prio"], device), asks, job_code, None if gang is None else gang_code,
            torch.zeros(g, **i32), torch.zeros(g, **i32), torch.zeros((), **i32),
            torch.full((g, 4), -1, **i32), torch.zeros((g, 4), **f32),
            torch.zeros(C.cp_record_words(g), **i32),
        )
        for j in cols:
            st = state[j]
            C.cp_shard_settle(record, st["used"], st["lam"], st["assigned"], st["sib"],
                              st["placed"], j * seg, 0, *(tables if gang is not None else ()))


def run_migrate(device="cuda") -> None:
    """migrate_plan: the defrag plane's bounded-budget move selection
    over a small fragmented fleet."""
    import numpy as np

    from ...device.migrate import migrate_plan

    a, n = 4, N_NODES
    capacity = np.full((n, D), 16000.0, dtype=np.float32)
    used0 = capacity * 0.2
    sizes = np.full((a, D), 500.0, dtype=np.float32)
    cur = (np.arange(a) % n).astype(np.int32)
    eligible = np.ones((a, n), dtype=bool)
    scores = np.linspace(
        0.1, 0.9, a * n, dtype=np.float32
    ).reshape(a, n)
    cur_scores = scores[np.arange(a), cur]
    move_cost = np.full(a, 0.05, dtype=np.float32)
    lam0 = np.zeros(n, dtype=np.float32)
    t = [_t(x, device) for x in (
        capacity, used0, sizes, cur, eligible, scores, cur_scores, move_cost,
    )]
    migrate_plan(*t, 2, _t(lam0, device), steps=8)


def exercise_fleet(device="cuda", explain: bool = False) -> list:
    """Run the whole fleet exercise on ``device`` (resolved: without
    CUDA the default raises); returns the recorded kernel calls
    (``backend.KernelCall``), in order. Every registered kernel is
    called at least once."""
    from ... import backend
    from .registry import import_fleet

    dev = backend.resolve_device(device)
    import_fleet()
    with backend.recording_calls() as calls:
        run_placement_paths(dev, explain=explain)
        run_sharded_closed_form(dev)
        run_coupled_mesh_kernels(dev)
        run_plugin_mesh_kernels(dev)
        run_score_matrix(dev)
        run_preemption(dev)
        run_hetero(dev)
        run_cp(dev)
        run_cp_gang(dev)
        run_migrate(dev)
    return list(calls)
