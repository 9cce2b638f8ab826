"""The port's coupled placements (value scan, chunked, one-per-value)
against the JAX reference, on the CPU.

The same seeded inputs (made with numpy) go through the reference's raw
jitted programs (``place_value_scan_kernel.jitted``,
``place_spread_chunked_kernel.jitted``, ``place_spread_opv_kernel.jitted``:
the ``traced_jit`` wrappers cannot run on this jax, see ROADMAP C-R1)
and through the port's functions on CPU tensors, which run the plain
PyTorch versions. Every case goes through all three programs: each takes
any value blocks, whichever route the scheduler would give them.

Tolerance: choices must be identical, and scores agree within
``rtol=1e-5, atol=1e-6`` — the bar of test_torch_score.py, for the same
reason: XLA's ``exp`` against PyTorch's, a few ulp on scores in [-2, 2].
"""

import dataclasses
import types

import jax
import jax._src.core
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomad_tpu.device import parity as ref_parity
from nomad_tpu.device import score as ref_score
from nomad_tpu.device.flatten import ValueBlocks
from nomad_tpu.device.flatten import pad_value_blocks as ref_pad_value_blocks
from nomad_tpu.utils import backend as ref_backend
from nomad_tpu_torch import interop
from nomad_tpu_torch.device import parity as port_parity
from nomad_tpu_torch.device import score as port_score

RTOL, ATOL = 1e-5, 1e-6
OVERFLOW = 16
J = 16


def _rack_blocks(ct, racks, kinds, desired=None, caps=None, counts0=None,
                 weights=None):
    """One block per entry of ``kinds`` over node i's rack i % racks."""
    n, pn = ct.num_nodes, ct.padded_n
    rack = np.pad((np.arange(n) % racks).astype(np.int32), (0, pn - n), constant_values=-1)
    nb = len(kinds)
    return ValueBlocks(
        value_ids=np.stack([rack] * nb),
        counts0=np.zeros((nb, racks), np.float32) if counts0 is None else counts0,
        desired=np.full((nb, racks), -1.0, np.float32) if desired is None else desired,
        caps=np.full((nb, racks), np.inf, np.float32) if caps is None else caps,
        weights=np.full(nb, 1.0 / nb, np.float32) if weights is None else weights,
        kinds=np.array(kinds, np.int32),
    )


def _case(name):
    """(cluster, asks, jitter) of one case: reference objects."""
    jitter = None
    if name == "config3":
        ct, asks = ref_parity.build_config3(n_nodes=500, n_jobs=2, count=60)
    elif name == "config4":
        ct, asks = ref_parity.build_config4(n_nodes=500, n_jobs=2, count=60)
    elif name == "target_chunked":
        # racks r0–r4 targeted at 20 %, r5–r7 untargeted (flat −1)
        ct, asks = ref_parity.build_config2(n_nodes=400, n_jobs=2, count=80, seed=3)
        desired = np.full((1, 8), -1.0, np.float32)
        desired[0, :5] = 16.0
        for a in asks:
            a.blocks = _rack_blocks(ct, 8, [ref_score.BLOCK_TARGET_SPREAD], desired=desired)
    elif name == "multi_block_affinity":
        # an even rack block and a target block over 3 "zones", + affinity
        ct, asks = ref_parity.build_config3(n_nodes=400, n_jobs=2, count=50, racks=8)
        zone = np.pad((np.arange(400) % 3).astype(np.int32), (0, ct.padded_n - 400), constant_values=-1)
        for a in asks:
            b = a.blocks
            desired = np.full((2, 8), -1.0, np.float32)
            desired[1, :3] = [25.0, 15.0, 10.0]
            a.blocks = ValueBlocks(
                value_ids=np.stack([b.value_ids[0], zone]),
                counts0=np.zeros((2, 8), np.float32),
                desired=desired,
                caps=np.full((2, 8), np.inf, np.float32),
                weights=np.array([0.6, 0.4], np.float32),
                kinds=np.array([ref_score.BLOCK_EVEN_SPREAD, ref_score.BLOCK_TARGET_SPREAD], np.int32),
            )
    elif name == "existing_counts":
        ct, asks = ref_parity.build_config3(n_nodes=500, n_jobs=2, count=50, racks=10)
        rng = np.random.default_rng(4)
        for a in asks:
            a.blocks.counts0[:] = rng.integers(0, 4, a.blocks.counts0.shape)
    elif name == "distinct_binds":
        # 8 racks × cap 3 < 40 wanted: the cap runs out mid-scan
        ct, asks = ref_parity.build_config2(n_nodes=300, n_jobs=2, count=40, seed=9)
        caps = np.full((1, 8), 3.0, np.float32)
        for a in asks:
            a.blocks = _rack_blocks(ct, 8, [ref_score.BLOCK_DISTINCT_CAP], caps=caps)
    elif name == "jitter":
        ct, asks = ref_parity.build_config3(n_nodes=500, n_jobs=2, count=60)
        rows = np.arange(ct.padded_n, dtype=np.int64)
        h = (rows * 2654435761 + 2 * 40503) & 0xFFFFFFFF
        jitter = ((h % 65536).astype(np.float32) / 65536.0) * 2e-5
    elif name == "zero_count_lane":
        ct, asks = ref_parity.build_config3(n_nodes=300, n_jobs=2, count=40)
        asks[1].count = 0
    elif name == "opv_padded_v":
        # 6 racks pad to V 8; rack 5 holds only ineligible nodes, so two
        # padded values and one real value are absent from every
        # eligible node (the rotation guard's present_v)
        ct, asks = ref_parity.build_config3(n_nodes=360, n_jobs=2, count=50, racks=6)
        rack = asks[0].blocks.value_ids[0]
        for a in asks:
            a.eligible = a.eligible & (rack != 5)
    else:
        raise ValueError(name)
    return ct, asks, jitter


CASES = [
    "config3", "config4", "target_chunked", "multi_block_affinity",
    "existing_counts", "distinct_binds", "jitter", "zero_count_lane",
    "opv_padded_v",
]


def _inputs(ct, asks):
    pn = ct.padded_n
    b = dict(
        asks=np.stack([a.ask for a in asks]).astype(np.float32),
        eligible=np.stack([a.eligible for a in asks]).astype(bool),
        job_counts=np.stack([a.job_counts for a in asks]).astype(np.int32),
        desired_totals=np.array([a.desired_total for a in asks], np.float32),
        penalty_nodes=np.stack([a.penalty_nodes for a in asks]).astype(bool),
        affinity_scores=np.stack([a.affinity_scores for a in asks]).astype(np.float32),
        has_affinities=np.array([a.has_affinities for a in asks], bool),
        distinct_hosts=np.array([a.distinct_hosts for a in asks], bool),
        slot_caps=np.stack(
            [
                a.slot_caps if a.slot_caps is not None
                else np.full(pn, np.inf, np.float32)
                for a in asks
            ]
        ).astype(np.float32),
    )
    b.update(ref_pad_value_blocks([a.blocks for a in asks], pn))
    return b


def _counts(asks, cap):
    c = np.array([a.count for a in asks])
    return np.where(c > 0, np.minimum(c + OVERFLOW, cap), 0).astype(np.int32)


def _enforce_idx(asks):
    out = np.zeros(len(asks), np.int32)
    for gi, a in enumerate(asks):
        even = np.flatnonzero(a.blocks.kinds == ref_score.BLOCK_EVEN_SPREAD)
        if even.size:
            out[gi] = even[np.argmax(a.blocks.weights[even])]
    return out


def _run(kernel, ct, asks, jitter):
    """(reference, port) outputs of one program on one case, as numpy."""
    b = _inputs(ct, asks)
    max_count = max(a.count for a in asks)
    if kernel == "scan":
        steps = ref_score._steps_bucket(max_count + OVERFLOW)
        static = dict(max_j=J, max_steps=steps)
        ref_fn, port_fn = ref_score.place_value_scan_kernel, port_score.place_value_scan
        extra = {}
    elif kernel == "chunked":
        n_chunks = max(4, -(-(-(-(max_count + OVERFLOW) // 16)) // 4) * 4)
        steps = n_chunks * 16
        static = dict(max_j=J, chunk=16, n_chunks=n_chunks)
        ref_fn, port_fn = ref_score.place_spread_chunked_kernel, port_score.place_spread_chunked
        extra = {}
    else:
        k_seg = min(16, b["block_counts0"].shape[2] + 1)
        n_chunks = 12
        steps = n_chunks * k_seg
        static = dict(max_j=J, k_seg=k_seg, n_chunks=n_chunks)
        ref_fn, port_fn = ref_score.place_spread_opv_kernel, port_score.place_spread_opv
        extra = {"enforce_idx": _enforce_idx(asks)}
    counts = _counts(asks, steps)
    ref = ref_fn.jitted(
        ct.capacity, ct.used, **b, **extra,
        algorithm_spread=jnp.asarray(False), counts=counts, **static,
        jitter=jitter,
    )
    t = torch.from_numpy
    port = port_fn(
        t(ct.capacity), t(ct.used), **{k: t(v) for k, v in b.items()},
        **{k: t(v) for k, v in extra.items()},
        algorithm_spread=False, counts=t(counts), **static,
        jitter=None if jitter is None else t(jitter),
    )
    return (
        (np.asarray(ref[0]), np.asarray(ref[1])),
        (port[0].numpy(), port[1].numpy()),
    )


def _assert_same(ref, port):
    (rc, rs), (pc, ps) = ref, port
    assert pc.dtype == np.int32 and pc.shape == rc.shape
    flips = np.argwhere(rc != pc)
    assert len(flips) == 0, (
        f"{len(flips)} choice flips, first at {flips[0].tolist()}: "
        "list any near-tie flip in ROADMAP C"
    )
    fin = np.isfinite(rs)
    assert (np.isfinite(ps) == fin).all()
    np.testing.assert_allclose(ps[fin], rs[fin], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kernel", ["scan", "chunked", "opv"])
@pytest.mark.parametrize("case", CASES)
def test_coupled_plain_matches_reference(case, kernel):
    ct, asks, jitter = _case(case)
    ref, port = _run(kernel, ct, asks, jitter)
    _assert_same(ref, port)
    placed = (port[0] >= 0).sum(axis=1)
    assert placed[0] > 0
    if case == "zero_count_lane":
        assert placed[1] == 0
    if case == "distinct_binds" and kernel == "scan":
        # 24 slots of cap, fewer than the 56 the lane asks for; the exact
        # scan holds the cap (the chunked ones may overshoot within a
        # chunk, as the reference's do, which is why caps route here)
        assert (placed == 24).all()


def test_block_tables_match_reference():
    """The boost/allowance tables on their own, over every kind and the
    corner counts (none positive, all equal, untargeted values)."""
    rng = np.random.default_rng(6)
    c = rng.integers(0, 4, (4, 8)).astype(np.float32)
    c[1] = 0.0
    c[2] = 2.0
    desired = np.where(rng.random((4, 8)) < 0.7, rng.integers(1, 10, (4, 8)), -1.0).astype(np.float32)
    caps = rng.integers(1, 4, (4, 8)).astype(np.float32)
    weights = rng.random(4).astype(np.float32)
    for kinds in ([0, 1, 1, 2], [1, 0, 2, -1], [2, 2, 0, 1]):
        kinds = np.array(kinds, np.int32)
        rb, ra = ref_score._block_tables(c, desired, caps, weights, kinds)
        t = torch.from_numpy
        pb, pa = port_score._block_tables(t(c), t(desired), t(caps), t(weights), t(kinds))
        np.testing.assert_array_equal(pa.numpy(), np.asarray(ra))
        np.testing.assert_allclose(pb.numpy(), np.asarray(rb), rtol=RTOL, atol=ATOL)


def _to_port(ct, asks):
    pct = interop.cluster_from_numpy(
        {f.name: getattr(ct, f.name) for f in dataclasses.fields(ct)}
    )
    pasks = interop.asks_from_numpy([dataclasses.asdict(a) for a in asks])
    return pct, pasks


def _reference_shim(mp):
    """The scoped C-R1 shim of test_torch_e2e.py, set on ``mp``."""
    mp.setattr(
        jax.core, "trace_state_clean", jax._src.core.trace_state_clean,
        raising=False,
    )
    mp.setattr(ref_backend, "_mesh_config", ref_backend.MeshConfig(None, 1, 1, "test"))


def _four_routes():
    """One lane for each route of PlacementKernel.place on one cluster:
    uncoupled (closed form), target spread (chunked), even spread
    (one-per-value), distinct cap (value scan)."""
    ct, asks = ref_parity.build_config3(n_nodes=400, n_jobs=4, count=60, racks=8)
    fast, chunked, opv, scan = asks
    fast.blocks = None
    desired = np.full((1, 8), -1.0, np.float32)
    desired[0, :4] = 15.0
    chunked.blocks = _rack_blocks(ct, 8, [ref_score.BLOCK_TARGET_SPREAD], desired=desired)
    scan.blocks = _rack_blocks(
        ct, 8, [ref_score.BLOCK_DISTINCT_CAP], caps=np.full((1, 8), 6.0, np.float32)
    )
    return ct, asks


def test_placement_kernel_place_matches_reference_on_every_route(monkeypatch):
    ct, asks = _four_routes()
    with monkeypatch.context() as mp:
        _reference_shim(mp)
        ref = ref_score.PlacementKernel().place(ct, asks)
        ref_scan = ref_score.PlacementKernel(force_scan=True).place(ct, asks)
    assert not hasattr(jax.core, "trace_state_clean")
    pct, pasks = _to_port(ct, asks)
    port = port_score.PlacementKernel(device="cpu").place(pct, pasks)
    port_scan = port_score.PlacementKernel(force_scan=True, device="cpu").place(pct, pasks)
    for r, p in list(zip(ref, port)) + list(zip(ref_scan, port_scan)):
        np.testing.assert_array_equal(p.node_rows, r.node_rows)
        np.testing.assert_array_equal(p.overflow_rows, r.overflow_rows)
        for ps, rs in ((p.scores, r.scores), (p.overflow_scores, r.overflow_scores)):
            fin = np.isfinite(rs)
            assert (np.isfinite(ps) == fin).all()
            np.testing.assert_allclose(ps[fin], rs[fin], rtol=RTOL, atol=ATOL)
    # the uncoupled and spread lanes place all 60; the capped lane holds
    # its 6 per rack over 8 racks
    assert all((p.node_rows >= 0).all() for p in port[:3])
    assert (port[3].node_rows >= 0).sum() == 48


def test_place_routes_and_counts_each_coupled_kernel(monkeypatch):
    """The kernel.place span carries the routing split, and each route
    calls its own wrapper once per pass."""
    from nomad_tpu_torch.obs.trace import global_tracer

    ct, asks = _four_routes()
    pct, pasks = _to_port(ct, asks)
    calls = []
    for name in ("place_closed_form", "place_spread_chunked", "place_spread_opv", "place_value_scan"):
        real = getattr(port_score, name)
        monkeypatch.setattr(
            port_score, name,
            lambda *a, _n=name, _r=real, **kw: calls.append(_n) or _r(*a, **kw),
        )
    global_tracer.begin("route-check")
    with global_tracer.activate("route-check"):
        port_score.PlacementKernel(device="cpu").place(pct, pasks)
    [span] = [
        sp for sp in global_tracer.finish("route-check")["spans"]
        if sp["name"] == "kernel.place"
    ]
    assert {k: span["tags"][k] for k in ("lanes", "fast", "chunked", "opv", "scan")} == {
        "lanes": 4, "fast": 1, "chunked": 1, "opv": 1, "scan": 1,
    }
    assert calls == [
        "place_closed_form", "place_spread_chunked", "place_spread_opv", "place_value_scan",
    ]


def test_parity_suite_matches_reference(monkeypatch):
    with monkeypatch.context() as mp:
        _reference_shim(mp)
        ref = ref_parity.run_parity_suite(small=True)
    port = port_parity.run_parity_suite(small=True, device="cpu")
    assert port == ref
    for r in port.values():
        assert r["failed_device"] == 0 and abs(r["score_delta_pct"]) <= 0.5


def _fake_coupled_library(scratch_bytes, status):
    """Stands in for csrc/coupled.cu's library so that the launcher's
    bookkeeping runs on CPU tensors: each entry point records the scratch
    pointer it was given and returns ``status``."""
    launched = []

    def entry(symbol):
        def launch(*args):
            launched.append((symbol, args[-4]))  # scratch, choices, scores, stream
            return status
        return launch

    def scratch(opv, n, b, v, out):
        out._obj.value = scratch_bytes
        return 0

    lib = types.SimpleNamespace(
        nomad_coupled_scratch_bytes=scratch,
        **{symbol: entry(symbol) for symbol in port_score._COUPLED_ARGTYPES},
    )
    for fn in vars(lib).values():
        fn.argtypes = None  # as a ctypes function before its first call
    return lib, launched


@pytest.mark.parametrize("kernel", ["scan", "chunked", "opv"])
def test_coupled_launcher_counts_only_launches(monkeypatch, kernel):
    """A wrapper's count moves by one for each kernel launch that
    succeeds, and by nothing for an empty group axis or a refused launch;
    scratch is allocated only where the library asks for it."""
    name, symbol, extra, slots = {
        "scan": ("place_value_scan", "nomad_place_value_scan", [64], 64),
        "chunked": ("place_spread_chunked", "nomad_place_spread_chunked", [16, 4], 64),
        "opv": ("place_spread_opv", "nomad_place_spread_opv", None, 48),
    }[kernel]
    ct, asks, _ = _case("config3")
    b = {k: torch.from_numpy(v) for k, v in _inputs(ct, asks).items()}
    if extra is None:
        extra = [torch.from_numpy(_enforce_idx(asks)), 16, 3]
    counts = torch.from_numpy(_counts(asks, slots))
    lane = [torch.from_numpy(ct.capacity), torch.from_numpy(ct.used)] + [
        b[k] for k in (
            "asks", "eligible", "job_counts", "desired_totals", "penalty_nodes",
            "affinity_scores", "has_affinities", "distinct_hosts", "slot_caps",
        )
    ]
    blocks = [b[k] for k in (
        "block_value_ids", "block_counts0", "block_desired", "block_caps",
        "block_weights", "block_kinds",
    )]
    monkeypatch.setattr(port_score, "current_stream", lambda dev: 0)

    wrapper = getattr(port_score, name)

    def launch(scratch_bytes, status, g):
        """(launches counted, entry points called with their scratch)."""
        lib, launched = _fake_coupled_library(scratch_bytes, status)
        monkeypatch.setattr(port_score, "cuda_library", lambda lib_name: lib)
        before = wrapper.launches
        lanes = [t[:g] if t.dim() and t.shape[0] == len(asks) else t for t in lane + blocks]
        ex = [e[:g] if isinstance(e, torch.Tensor) else e for e in extra]
        try:
            choices, _ = port_score._launch_coupled(
                name, symbol, lanes[:11], lanes[11:], counts[:g], False, J,
                slots, ex, None,
            )
            assert choices.shape == (g, slots)
        except RuntimeError:
            assert wrapper.launches == before and len(launched) == 1
            raise
        return wrapper.launches - before, launched

    assert launch(0, 0, g=0) == (0, [])
    assert launch(0, 0, g=2) == (1, [(symbol, None)])
    moved, launched = launch(4096, 0, g=2)
    assert moved == 1 and launched[0][1] is not None
    with pytest.raises(RuntimeError, match="cudaError 1"):
        launch(0, 1, g=2)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["scan", "chunked", "opv"])
def test_cuda_coupled_kernels_match_plain_versions(kernel):
    """On the card: each coupled kernel against its plain version on the
    config-3 and config-4 inputs, choices identical and scores exact (the
    comparison chip_smoke.py makes on the spread path's own calls)."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: the coupled CUDA kernels run only on the card")
    dev = torch.device("cuda")
    for case in ("config3", "config4"):
        ct, asks, _ = _case(case)
        b = _inputs(ct, asks)
        kw = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        kw["capacity"] = torch.from_numpy(ct.capacity).to(dev)
        kw["used0"] = torch.from_numpy(ct.used).to(dev)
        name = {"scan": "place_value_scan", "chunked": "place_spread_chunked",
                "opv": "place_spread_opv"}[kernel]
        if kernel == "scan":
            static = dict(max_j=J, max_steps=128)
        elif kernel == "chunked":
            static = dict(max_j=J, chunk=16, n_chunks=8)
        else:
            static = dict(max_j=J, k_seg=min(16, b["block_counts0"].shape[2] + 1), n_chunks=12)
            kw["enforce_idx"] = torch.from_numpy(_enforce_idx(asks)).to(dev)
        slots = static.get("max_steps") or static["n_chunks"] * static.get("chunk", static.get("k_seg"))
        kw["counts"] = torch.from_numpy(_counts(asks, slots)).to(dev)
        before = getattr(port_score, name).launches
        ch, sc = getattr(port_score, name)(**kw, algorithm_spread=False, **static)
        chp, scp = getattr(port_score, f"{name}_plain")(**kw, algorithm_spread=False, **static)
        assert getattr(port_score, name).launches == before + 1
        assert torch.equal(ch, chp)
        assert torch.equal(sc, scp)
