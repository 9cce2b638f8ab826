"""The three coupled scans on the node-axis mesh, on the CPU.

Under a CPU mesh (``backend.make_mesh(dp, mp, "cpu")``) the value scan,
the chunked scan and the one-per-value scan run the sharded algorithm
through the plain versions of its three kernels: every cell's candidates
(``coupled_shard_step_plain``), one merge a step on each groups row's lead
(``coupled_step_merge_plain``) and every cell's apply
(``coupled_shard_apply_plain``). The step loop files each plain call it
makes under the "shard" or "merge" layout (``backend.mesh_layouts``),
one a step for all the cells at once. Held here:

- each scan at 1x2, 1x4, 2x2 and 2x4 against the one-device call and
  against the reference's kernel run under its own mesh of CPU devices;
- a node axis the mesh does not divide runs the one-device call,
  "gathered";
- equal scores across a shard boundary, a shard with fewer feasible
  candidates than the chunk, value ids spanning shards, a binding
  distinct_property cap, jitter, and a one-per-value lane whose enforced
  block has phantom values (padded V, values no eligible node holds);
- a ``hypothesis`` property over small random shapes and meshes;
- a ``PlacementKernel`` spread pass over every coupled route under a 2x4
  mesh against the unsharded pass and the reference's pass under its 2x4
  mesh (the counterpart of ``tests/test_mesh_sharding.py``'s
  ``test_spread_kernel_bit_identical_under_mesh``).

Tolerance: against the port's one-device call, choices and scores bit
for bit (uint32 views); against the reference, choices exactly and
scores within ``rtol=1e-5, atol=1e-6`` (``exp`` differs by an ulp between
the runtimes, see test_torch_score.py). The card's tests of the kernels
are in ``tests/test_torch_mesh_card.py``, which this file borrows
``coupled_batch`` and the scan helpers from.
"""

import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from test_torch_coupled import _case
from test_torch_mesh import (
    SPECS,
    _near,
    _port_cluster,
    _ref_mesh,
    _ref_shard,
    assert_same_bits,
    traced,
)
from test_torch_mesh_card import coupled_batch, plain_scan, run_scan

from nomad_tpu.device import score as ref_score
from nomad_tpu.scheduler.algorithms import make_kernel as ref_make_kernel
from nomad_tpu.utils import backend as ref_backend
from nomad_tpu_torch import backend
from nomad_tpu_torch.device import score as S
from nomad_tpu_torch.scheduler.algorithms import make_kernel

MESHES = [(1, 2), (1, 4), (2, 2), (2, 4)]
KINDS = ["value_scan", "chunked", "opv"]
# the block each scan's batch couples on (coupled_batch's kinds)
BLOCK = {"value_scan": 2, "chunked": 0, "opv": 1}
STEPS = {"value_scan": 16, "chunked": 4, "opv": 4}
J = 16
PORT_SPECS = dict(S._BATCH_SPECS, capacity=("nodes",), used0=("nodes",), jitter=("nodes",))
WRAPPER = {"value_scan": "place_value_scan", "chunked": "place_spread_chunked",
           "opv": "place_spread_opv"}


def _tensors(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _laid_out(batch, cfg):
    return {k: backend.shard_put(v, PORT_SPECS[k], cfg) for k, v in batch.items()}


def _expected_layouts(kind, steps):
    """The plain calls a CPU mesh's step loop makes: each step, every
    cell's candidates in one call and every row's merge in one (twice for
    the one-per-value scan), then every cell's apply in one."""
    sweeps = 2 if kind == "opv" else 1
    return {
        "coupled_shard_step:shard": steps * sweeps,
        "coupled_step_merge:merge": steps * sweeps,
        "coupled_shard_apply:shard": steps,
    }


def _chunk(kind, batch):
    """The chunk a scan takes: CHUNK, or k_seg = min(CHUNK, V + 1)."""
    return min(S.CHUNK, batch["block_counts0"].shape[2] + 1) if kind == "opv" else S.CHUNK


def _run_both(kind, batch, counts, dp, mp, enforce=None, chunk=None, steps=None):
    """(one-device, sharded) outputs of a scan on the host batch, and the
    layouts the sharded call filed."""
    steps = steps or STEPS[kind]
    chunk = chunk or _chunk(kind, batch)
    c = torch.from_numpy(counts)
    e = None if enforce is None else torch.from_numpy(enforce)
    jitter = batch.get("jitter")
    base = {k: v for k, v in batch.items() if k != "jitter"}
    one = run_scan(kind, dict(_tensors(base), **(
        {} if jitter is None else {"jitter": torch.from_numpy(jitter)})), c, J, steps, e, chunk)
    cfg = backend.make_mesh(dp, mp, "cpu")
    backend.reset_mesh_layouts()
    got = run_scan(kind, _laid_out(batch, cfg), c, J, steps, e, chunk)
    return one, got, backend.mesh_layouts()


def _batch(kind, seed, g=8, n=256, v=12):
    rng = np.random.default_rng(seed)
    batch = coupled_batch(rng, g, n, v, BLOCK[kind])
    counts = np.full(g, 12 if kind == "value_scan" else 40, np.int32)
    enforce = np.ones(g, np.int32) if kind == "opv" else None
    return batch, counts, enforce


def _ref_run(kind, batch, counts, enforce, steps, mp, mesh):
    """The reference's kernel on the batch laid out over its mesh."""
    ref_batch = dict(batch, algorithm_spread=np.asarray(False), counts=counts)
    specs = dict(SPECS, enforce_idx=SPECS["counts"])
    if enforce is not None:
        ref_batch["enforce_idx"] = enforce
    laid = _ref_shard(ref_batch, mesh, specs)
    if kind == "value_scan":
        return ref_score.place_value_scan_kernel(**laid, max_j=J, max_steps=steps)
    if kind == "chunked":
        return ref_score.place_spread_chunked_kernel(
            **laid, max_j=J, chunk=S.CHUNK, n_chunks=steps, n_shards=mp
        )
    return ref_score.place_spread_opv_kernel(
        **laid, max_j=J, k_seg=_chunk(kind, batch), n_chunks=steps
    )


@pytest.mark.parametrize("dp,mp", MESHES)
@pytest.mark.parametrize("kind", KINDS)
def test_sharded_scan_matches_one_device_and_reference(kind, dp, mp, monkeypatch):
    batch, counts, enforce = _batch(kind, dp * 10 + mp)
    one, got, layouts = _run_both(kind, batch, counts, dp, mp, enforce)
    assert_same_bits(got, one, f"{kind} {dp}x{mp} vs one device")
    assert (got[0] >= 0).any()
    assert layouts == _expected_layouts(kind, STEPS[kind]), layouts
    assert not any(k.endswith(":gathered") for k in layouts)
    mesh = _ref_mesh(dp, mp)
    with traced(monkeypatch, degenerate=False), mesh:
        ref = _ref_run(kind, batch, counts, enforce, STEPS[kind], mp, mesh)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    _near(got[1], ref[1])


@pytest.mark.parametrize("kind", KINDS)
def test_node_axis_the_mesh_does_not_divide_is_gathered(kind):
    batch, counts, enforce = _batch(kind, 3, n=250)
    one, got, layouts = _run_both(kind, batch, counts, 2, 4, enforce)
    assert_same_bits(got, one, kind)
    assert layouts == {f"{WRAPPER[kind]}:gathered": 1}


def _edge(case, kind, rng, g=4, n=256, v=8):
    """A host batch for one edge case (see the module docstring)."""
    batch = coupled_batch(rng, g, n, v, BLOCK[kind])
    seg = n // 4
    if case == "tie_across_boundary":
        # one capacity and usage everywhere: every score ties, and the
        # lowest global node wins across the shard boundaries
        batch["capacity"][:] = batch["capacity"][0]
        batch["used0"][:] = 0.0
        batch["eligible"][:] = True
        batch["job_counts"][:] = 0
        batch["penalty_nodes"][:] = False
        batch["eligible"][:, : seg - 2] = False  # the best nodes straddle shards 0 and 1
    elif case == "few_candidates_in_shard":
        batch["eligible"][:, seg : 2 * seg] = False
        batch["eligible"][:, seg + 5 : seg + 8] = True  # three in shard 1
        batch["eligible"][:, 2 * seg : 3 * seg] = False  # none in shard 2
    elif case == "values_span_shards":
        batch["block_value_ids"][:, 0, :] = (np.arange(n) * 3 // n).astype(np.int32)
    elif case == "distinct_cap":
        batch["block_kinds"][:, 0] = 2
        batch["block_caps"][:, 0, :] = 1.0
        batch["block_counts0"][:, 0, :] = 0.0
        batch["block_value_ids"][:, 0, :] = (np.arange(n) % 5).astype(np.int32)
    elif case == "jitter":
        h = (np.arange(n, dtype=np.int64) * 2654435761 + 40503) & 0xFFFFFFFF
        batch["jitter"] = ((h % 65536).astype(np.float32) / 65536.0) * 2e-5
    elif case == "phantom_values":
        # V padded to 8, values 5-7 held by no node, value 4 only by
        # ineligible nodes: present_v is the OR over every shard
        ids = (np.arange(n) % 5).astype(np.int32)
        batch["block_value_ids"][:, 0, :] = ids
        batch["block_value_ids"][:, 1, :] = ids
        batch["block_kinds"][:, 0] = 1
        batch["eligible"][:, ids == 4] = False
    return batch


EDGES = ["tie_across_boundary", "few_candidates_in_shard", "values_span_shards",
         "distinct_cap", "jitter", "phantom_values"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", EDGES)
def test_edge_cases_match_one_device(case, kind):
    rng = np.random.default_rng(EDGES.index(case) * 3 + KINDS.index(kind))
    batch = _edge(case, kind, rng)
    g = batch["asks"].shape[0]
    counts = np.full(g, 40, np.int32)
    enforce = np.zeros(g, np.int32) if kind == "opv" else None
    if kind == "opv" and case != "phantom_values":
        enforce[:] = 1
    for dp, mp in ((1, 4), (2, 4)):
        one, got, layouts = _run_both(kind, batch, counts, dp, mp, enforce)
        assert_same_bits(got, one, f"{case} {kind} {dp}x{mp}")
        assert layouts == _expected_layouts(kind, STEPS[kind]), layouts
    plain = plain_scan(kind, _tensors(batch), torch.from_numpy(counts), J, STEPS[kind],
                       None if enforce is None else torch.from_numpy(enforce),
                       _chunk(kind, batch))
    if case != "jitter":  # plain_scan takes no jitter; the one-device call did
        assert_same_bits(got, plain, f"{case} {kind} vs plain")
    placed = (got[0] >= 0).sum(dim=1)
    assert (placed > 0).all(), case
    if case == "distinct_cap" and kind == "value_scan":
        # five values at cap 1 a lane: the exact scan holds the cap
        assert (placed == 5).all()


@settings(max_examples=20, deadline=None, derandomize=True)
@given(
    kind=st.sampled_from(KINDS),
    mesh=st.sampled_from(MESHES),
    n_per=st.sampled_from([4, 8, 16]),
    g=st.integers(1, 4),
    v=st.integers(1, 6),
    count=st.integers(1, 40),
    seed=st.integers(0, 2**16),
)
def test_property_small_shapes(kind, mesh, n_per, g, v, count, seed):
    """Small random shapes: every sharded scan equals the one-device call
    bit for bit, whatever the lanes, values, counts and mesh."""
    dp, mp = mesh
    rng = np.random.default_rng(seed)
    batch = coupled_batch(rng, g, n_per * mp, v, BLOCK[kind])
    counts = rng.integers(0, count + 1, g).astype(np.int32)
    enforce = rng.integers(0, 2, g).astype(np.int32) if kind == "opv" else None
    chunk = min(S.CHUNK, v + 1) if kind == "opv" else 4
    one, got, layouts = _run_both(kind, batch, counts, dp, mp, enforce, chunk=chunk, steps=3)
    assert_same_bits(got, one, f"{kind} {mesh} n={n_per * mp} g={g} v={v}")
    assert layouts == _expected_layouts(kind, 3), layouts


def test_spread_pass_under_mesh_matches_unsharded_and_reference(monkeypatch):
    """A ``PlacementKernel`` spread pass whose groups take all three
    coupled routes (config-3's rack spread, an exact scan, the
    one-per-value chunks) under a 2x4 CPU mesh: the results equal the
    unsharded pass's bit for bit and the reference's under its 2x4 mesh,
    with every coupled launch filed "shard" or "merge"."""
    ct, asks, _jitter = _case("config3")
    small = dataclasses.replace(asks[0], count=8)  # an exact scan
    b = asks[1].blocks
    target = dataclasses.replace(  # a target-only block: the chunked scan
        asks[1], blocks=dataclasses.replace(
            b, kinds=np.full_like(b.kinds, ref_score.BLOCK_TARGET_SPREAD),
            desired=np.full_like(b.desired, 10.0),
        ),
    )
    asks = [asks[0], small, target]
    pct, pasks = _port_cluster(ct, asks)
    one = make_kernel("spread", device="cpu").place(pct, pasks)
    pct, pasks = _port_cluster(ct, asks)
    backend.reset_mesh_layouts()
    got = make_kernel("spread", mesh=backend.make_mesh(2, 4, "cpu"), device="cpu").place(
        pct, pasks
    )
    layouts = backend.mesh_layouts()
    ref_cfg = ref_backend.MeshConfig(_ref_mesh(2, 4), 2, 4, "test")
    with traced(monkeypatch, degenerate=False):
        ref = ref_make_kernel("spread", mesh=ref_cfg).place(ct, asks)
    assert len(got) == len(one) == len(ref)
    for r, o, g in zip(ref, one, got):
        np.testing.assert_array_equal(g.node_rows, o.node_rows)
        np.testing.assert_array_equal(g.scores.view(np.uint32), o.scores.view(np.uint32))
        np.testing.assert_array_equal(g.overflow_rows, o.overflow_rows)
        np.testing.assert_array_equal(g.node_rows, r.node_rows)
        _near(g.scores, r.scores)
    assert layouts.get("coupled_step_merge:merge", 0) > 0, layouts
    assert layouts.get("coupled_shard_step:shard", 0) > 0, layouts
    assert not any(k.endswith(":gathered") for k in layouts), layouts
