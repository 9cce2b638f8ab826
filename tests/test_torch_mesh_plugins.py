"""The plugin kernels, the migration plane and the incremental seam under
the port's node-axis mesh, against the JAX reference, on the CPU.

Mirrors the mesh cases of ``tests/test_cp.py`` (mesh equivalence and the
registry's mesh seam), ``tests/test_gang.py`` (the gang kernel on
sharded inputs, and against its oracle with the scoring laid out over a
mesh), ``tests/test_migrate.py`` (the migration kernel under a mesh
against its oracle) and ``tests/test_incremental.py`` (incremental on
equal to off, bit for bit, under meshes 2x4 / 1x8 / 4x2, and the exact
counter accounting under 2x4), with their test names.

A mesh is 8 CPU devices; the port's kernels here take their node-sharded
inputs gathered onto the lead (``backend.guarded``). Tolerance: the
port's sharded outputs equal its unsharded ones bit for bit (uint32
views); the CP, gang and migration outputs equal the reference's oracle
bit for bit on the same bytes; against the reference's kernel objects,
node rows exactly and the score-matrix-derived slot scores within
``rtol=1e-5, atol=1e-6`` (``exp`` differs by an ulp between the
runtimes). Incremental counters equal the reference's exactly.
"""

import contextlib
import dataclasses

import jax
import jax._src.core
import numpy as np
import pytest
import torch

from nomad_tpu.analysis.jaxlint.exercise import _ask, _cluster
from nomad_tpu.device import cp as ref_cp
from nomad_tpu.device import migrate as ref_mig
from nomad_tpu.device.cache import DeviceStateCache as RefCache
from nomad_tpu.scheduler import cp as ref_scp
from nomad_tpu.scheduler import migrate as ref_smig
from nomad_tpu.scheduler.algorithms import make_kernel as ref_make_kernel
from nomad_tpu.scheduler.hetero import build_mixed_fleet
from nomad_tpu.utils import backend as ref_backend
from nomad_tpu_torch import backend
from nomad_tpu_torch import interop
from nomad_tpu_torch.device import cp as port_cp
from nomad_tpu_torch.device import migrate as port_mig
from nomad_tpu_torch.device.cache import DeviceStateCache
from nomad_tpu_torch.scheduler import algorithms
from nomad_tpu_torch.scheduler import cp as port_scp
from nomad_tpu_torch.scheduler.algorithms import make_kernel
from test_torch_hetero import assert_bits_equal
from test_torch_incremental import _assert_same, _run_passes

RTOL, ATOL = 1e-5, 1e-6
SPECS = ("2,4", "1,8", "4,2")


@contextlib.contextmanager
def traced(monkeypatch):
    """The reference's traced_jit path on this jax, for one block only
    (ROADMAP C-R1); its process mesh is whatever the test set."""
    with monkeypatch.context() as mp:
        mp.setattr(
            jax.core, "trace_state_clean", jax._src.core.trace_state_clean,
            raising=False,
        )
        yield


@pytest.fixture
def mesh_env(monkeypatch):
    """Opt into an active process-wide mesh through the one variable both
    packages read; restores the degenerate CPU default afterwards."""

    def activate(spec):
        monkeypatch.setenv("NOMAD_TPU_MESH", spec)
        backend.reset_mesh()
        ref_backend.reset_mesh()
        return backend.get_mesh()

    yield activate
    monkeypatch.delenv("NOMAD_TPU_MESH", raising=False)
    backend.reset_mesh()
    ref_backend.reset_mesh()


@pytest.fixture
def incr_env(monkeypatch):
    def activate(spec="on"):
        monkeypatch.setenv("NOMAD_TPU_INCREMENTAL", spec)
        backend.reset_incremental()
        ref_backend.reset_incremental()
        return backend.incremental_enabled()

    yield activate
    monkeypatch.delenv("NOMAD_TPU_INCREMENTAL", raising=False)
    backend.reset_incremental()
    ref_backend.reset_incremental()


def _port(ct, asks):
    return (
        interop.cluster_from_numpy(dataclasses.asdict(ct)),
        interop.asks_from_numpy([dataclasses.asdict(a) for a in asks]),
    )


def _spec(spec):
    dp, mp = (int(x) for x in spec.split(","))
    return backend.make_mesh(dp, mp, "cpu")


def _assert_results_bitwise(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.node_rows, w.node_rows)
        np.testing.assert_array_equal(
            np.asarray(g.scores, np.float32).view(np.uint32),
            np.asarray(w.scores, np.float32).view(np.uint32),
        )


# -- cp-pack (tests/test_cp.py) ---------------------------------------------------


class TestMeshEquivalence:
    @pytest.mark.parametrize("spec", SPECS)
    def test_mesh_run_byte_equal_to_degenerate(self, spec, mesh_env, monkeypatch):
        ct = build_mixed_fleet(64, seed=7)
        asks = ref_scp.build_cp_asks(ct, 6, 6, seed=8)
        with traced(monkeypatch):
            ref = ref_scp.CpPlacementKernel().place(ct, asks)
            mesh_env(spec)
            ref_sharded = ref_scp.CpPlacementKernel().place(ct, asks)
        _assert_results_bitwise(ref_sharded, ref)
        one = port_scp.CpPlacementKernel(mesh=backend.MeshConfig(None, 1, 1, "test"),
                                         device="cpu").place(*_port(ct, asks))
        backend.reset_mesh_layouts()
        cfg = _spec(spec)
        got = port_scp.CpPlacementKernel(mesh=cfg, device="cpu").place(*_port(ct, asks))
        _assert_results_bitwise(got, one)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.node_rows, r.node_rows)
            np.testing.assert_allclose(g.scores, r.scores, rtol=RTOL, atol=ATOL)


class TestRegistry:
    def test_cp_pack_registered_with_mesh_seam(self):
        assert algorithms.is_registered("cp-pack")
        kern = algorithms.get_algorithm("cp-pack").make_kernel(device="cpu")
        assert isinstance(kern, port_scp.CpPlacementKernel)
        cfg = backend.get_mesh()
        assert algorithms.make_kernel("cp-pack", mesh=cfg, device="cpu").mesh_cfg() is cfg
        explicit = backend.make_mesh(2, 4, "cpu")
        for name in ("cp-pack", "cp-gang", "hetero-maxmin", "binpack"):
            assert algorithms.make_kernel(name, mesh=explicit, device="cpu").mesh_cfg() is explicit


# -- cp-gang (tests/test_gang.py) --------------------------------------------------

_GANG_AXES = (
    ("nodes",), ("nodes",), ("groups",), ("groups",), ("groups", "nodes"),
    ("groups", "nodes"), ("groups",), ("groups", "nodes"), ("groups",), ("groups",),
    ("groups",), ("groups",), ("groups",), ("groups",),
    ("nodes",), ("nodes",), ("nodes",), ("nodes",),
)


def _gang_io(batch, gi):
    return (
        batch.capacity, batch.used, batch.asks, batch.counts,
        batch.eligible, batch.scores, batch.prio, batch.job_counts,
        batch.distinct, batch.jobgrp, gi.gang, gi.w_rack, gi.w_pod,
        gi.w_ici, gi.rack_oh, gi.pod_oh, gi.ici_oh, batch.lam0,
    )


def _port_gang_io(batch, gi):
    return (
        batch.capacity, batch.used, batch.asks, batch.counts,
        batch.eligible, batch.scores, batch.prio, batch.job_counts,
        batch.distinct, batch.jobgrp, *[x.numpy() for x in gi.tensors("cpu")],
        batch.lam0,
    )


class TestGangMeshEquivalence:
    @pytest.mark.parametrize("spec", SPECS)
    def test_mesh_run_byte_equal_to_degenerate(self, spec, monkeypatch):
        """The gang kernel on node-sharded inputs: the same bytes as on
        one device and as the reference's oracle on the same batch."""
        ct = ref_scp.build_topo_fleet(64, seed=7)
        asks = ref_scp.build_gang_asks(ct, 4, 3, seed=8)
        with traced(monkeypatch):
            batch = ref_scp.build_cp_batch(ct, asks)
        io = _gang_io(batch, ref_scp.build_gang_inputs(ct, asks))
        oracle = ref_cp.oracle_cp_gang_place(*io, batch.steps, batch.max_c)
        one = port_cp.cp_gang_place(
            *[torch.from_numpy(np.ascontiguousarray(a)) for a in io], batch.steps, batch.max_c
        )
        cfg = _spec(spec)
        sharded = [backend.shard_put(a, ax, cfg) for a, ax in zip(io, _GANG_AXES)]
        assert backend.is_sharded(sharded[0])
        got = port_cp.cp_gang_place(*sharded, batch.steps, batch.max_c)
        assert_bits_equal(got, [x.numpy() for x in one], "sharded vs one device")
        assert_bits_equal(got, oracle, f"gang {spec}")

    @pytest.mark.parametrize("spec", ["2,4", "4,2"])
    def test_plugin_matches_oracle_under_active_mesh(self, spec):
        """Whatever batch the sharded scoring produces (the score matrix a
        launch per node slice), the gang kernel's outputs on it equal the
        reference's oracle on the same bytes."""
        ct = ref_scp.build_topo_fleet(64, seed=7)
        asks = ref_scp.build_gang_asks(ct, 4, 3, seed=8)
        pct, pasks = _port(ct, asks)
        cfg = _spec(spec)
        batch = port_scp.build_cp_batch(pct, pasks, device="cpu", mesh=cfg)
        plain = port_scp.build_cp_batch(*_port(ct, asks), device="cpu")
        np.testing.assert_array_equal(batch.scores.view(np.uint32), plain.scores.view(np.uint32))
        gi = port_scp.build_gang_inputs(pct, pasks)
        io = _port_gang_io(batch, gi)
        d = port_cp.cp_gang_place(
            *[backend.shard_put(a, ax, cfg) for a, ax in zip(io, _GANG_AXES)],
            batch.steps, batch.max_c,
        )
        o = ref_cp.oracle_cp_gang_place(*io, batch.steps, batch.max_c)
        np.testing.assert_array_equal(d[0].numpy(), o[0])
        np.testing.assert_array_equal(d[1].numpy().view(np.uint32), o[1].view(np.uint32))


# -- the migration plane (tests/test_migrate.py) -------------------------------------


class TestMigrateMeshEquivalence:
    @pytest.mark.parametrize("spec", SPECS)
    def test_mesh_run_byte_equal_to_oracle(self, spec):
        capacity, used, sizes, cur, _ = ref_smig.build_defrag_fleet(32, 64, seed=42)
        args = list(ref_smig.build_defrag_batch(capacity, used, sizes, cur))
        lam0 = np.zeros(32, np.float32)
        steps = ref_smig._steps_for(64)
        o = ref_mig.oracle_migrate_plan(*args, np.int32(8), lam0, steps)
        cfg = _spec(spec)
        axes = (("nodes",), ("nodes",), (), (), (None, "nodes"), (None, "nodes"), (), ())
        t = [backend.shard_put(a, ax, cfg) for a, ax in zip(args, axes)]
        assert backend.is_sharded(t[0]) and backend.is_sharded(t[4])
        d = port_mig.migrate_plan(*t, 8, backend.shard_put(lam0, ("nodes",), cfg), steps)
        one = port_mig.migrate_plan(
            *[torch.from_numpy(np.ascontiguousarray(a)) for a in args], 8,
            torch.from_numpy(lam0), steps,
        )
        assert_bits_equal(d, [x.numpy() for x in one], "sharded vs one device")
        np.testing.assert_array_equal(d[0].numpy(), o[0])
        for i in (1, 2, 5):
            np.testing.assert_array_equal(d[i].numpy().view(np.uint32), o[i].view(np.uint32))
        assert int(d[3]) == o[3]


# -- the incremental seam (tests/test_incremental.py) ---------------------------------

ALGOS = ("binpack", "spread", "hetero-maxmin", "cp-pack")


class TestBitIdentity:
    @pytest.mark.parametrize("algo", ALGOS)
    @pytest.mark.parametrize("spec", SPECS)
    def test_incremental_matches_scratch_bitwise(self, algo, spec, mesh_env, incr_env):
        """Under each mesh (the process mesh: the kernels and the cache
        lay their views out over it), rows and scores from the cached
        score path equal the from-scratch path byte for byte over three
        passes of churn, equal the mesh-off run, and every generation's
        shards copy back bitwise equal to its mirror."""
        seed = 7
        off, _, _ = _run_passes(algo, seed, incremental=False)
        mesh_env(spec)
        ref, _, _ = _run_passes(algo, seed, incremental=False)
        incr_env("on")
        got, cache, _ = _run_passes(algo, seed, incremental=True)
        _assert_same(got, ref)
        _assert_same(got, off)
        c = cache.device_counters()
        assert c["score_full_rebuilds"] >= 1 and c["score_rows_reused"] > 0
        assert cache.verify_score_view() == []
        state = cache._score_staged or cache._score
        assert backend.is_sharded(state.used_dev)


class TestCounterAccounting:
    def test_rescored_reused_exact(self, mesh_env, incr_env, monkeypatch):
        """16-row cluster, one score view a pass, under the 2x4 mesh: the
        counters after a full rebuild, a one-row churn (one shard patched)
        and a clean pass equal the reference's."""
        mesh_env("2,4")
        incr_env("on")
        sides = []
        for side in ("ref", "port"):
            ct = _cluster()
            asks = [_ask(ct, "a", 3), _ask(ct, "b", 2)]
            if side == "port":
                ct, asks = _port(ct, asks)
                cache, kernel = DeviceStateCache("cpu"), make_kernel("binpack", device="cpu")
            else:
                cache, kernel = RefCache(), ref_make_kernel("binpack")
            ct.score_cache = cache
            seen = []
            with traced(monkeypatch):
                for churn in (None, 128.0, None):
                    if churn is not None:
                        ct.used[0, 0] += churn
                    kernel.place(ct, asks)
                    cache.score_commit()
                    c = cache.device_counters()
                    seen.append({k: c[k] for k in (
                        "score_full_rebuilds", "score_rows_rescored", "score_rows_reused",
                        "score_patch_uploads", "score_swaps", "score_gen",
                    )})
            assert cache.verify_score_view() == []
            sides.append(seen)
        assert sides[0] == sides[1]
        assert sides[1][1]["score_rows_rescored"] == 17
        assert sides[1][1]["score_rows_reused"] == 15
        assert sides[1][2]["score_gen"] == 2
