"""The port's node-axis mesh against the JAX reference's, on the CPU.

Mirrors ``tests/test_mesh_sharding.py`` case for case, with its class and
test names, so every one of its 41 case ids has a counterpart here:

- the seam (``backend.MeshConfig``, ``parse_mesh_spec``,
  ``auto_mesh_shape``, ``get_mesh``, ``shard_put``) against the
  reference's on the same inputs;
- the hierarchical top-k: per-shard stable top-k' plus the port's plain
  cross-shard merge (``closed_form_topk_merge_plain``) against the
  reference's ``_topk_nodes`` and ``lax.top_k``, values and indices;
- the value scan, closed form and score matrix with node-sharded
  inputs, the 1x8 / 4x2 shapes, and the counterpart of the reference's
  ``dryrun_multichip`` at its sizes, through the plain versions;
- the hetero kernel (3 policies x 3 shapes) and the preemption kernels
  (find / choose x 3 shapes) with sharded inputs, gathered onto the lead;
- the production path (``make_kernel(..., mesh=...)``, binpack and
  spread, and a Harness pass) and explain under a mesh;
- the device cache's per-shard capacity view (4 cases).

A mesh here is 8 CPU devices (the reference's test rig forces 8 virtual
host devices). Tolerance: the port's sharded outputs equal its unsharded
ones bit for bit (uint32 views) everywhere; against the reference, node
rows, choices and masks exactly, hetero and preemption outputs bit for
bit (the reference pins them to their oracles) but for the preemption
choice's fit score, and that score and the closed-form, value-scan and
score-matrix scores within ``rtol=1e-5, atol=1e-6``
(``exp`` differs by an ulp between the runtimes, see
test_torch_score.py). Where the reference's own test runs its sharded
program, it is run here too and compared the same way.

The reference's ``traced_jit`` needs the scoped ``trace_state_clean``
monkeypatch (ROADMAP C-R1). The card's tests of the merge kernel are in
``tests/test_torch_mesh_card.py``, which imports no JAX.
"""

import contextlib
import dataclasses
import os
import sys

import jax
import jax._src.core
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import __graft_entry__ as graft  # noqa: E402
import bench  # noqa: E402
from nomad_tpu import mock as ref_mock  # noqa: E402
from nomad_tpu.device import preempt as ref_preempt  # noqa: E402
from nomad_tpu.device import score as ref_score  # noqa: E402
from nomad_tpu.device.cache import DeviceStateCache as RefCache  # noqa: E402
from nomad_tpu.scheduler import Harness as RefHarness  # noqa: E402
from nomad_tpu.scheduler import hetero as ref_hetero  # noqa: E402
from nomad_tpu.scheduler.algorithms import make_kernel as ref_make_kernel  # noqa: E402
from nomad_tpu.state import StateStore as RefStore  # noqa: E402
from nomad_tpu.utils import backend as ref_backend  # noqa: E402
from nomad_tpu_torch import backend  # noqa: E402
from nomad_tpu_torch import interop  # noqa: E402
from nomad_tpu_torch import mock as port_mock  # noqa: E402
from nomad_tpu_torch.chaos.plane import FaultPlane, FaultSpec, install, uninstall  # noqa: E402
from nomad_tpu_torch.device import preempt as port_preempt  # noqa: E402
from nomad_tpu_torch.device import score as S  # noqa: E402
from nomad_tpu_torch.device.cache import DeviceStateCache  # noqa: E402
from nomad_tpu_torch.scheduler import Harness as PortHarness  # noqa: E402
from nomad_tpu_torch.scheduler import hetero as port_hetero  # noqa: E402
from nomad_tpu_torch.scheduler.algorithms import make_kernel  # noqa: E402
from nomad_tpu_torch.state import StateStore as PortStore  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
MESH_SHAPES = [(2, 4), (1, 8), (4, 2)]


@contextlib.contextmanager
def traced(monkeypatch, degenerate=True):
    """The reference's traced_jit path on this jax, for one block only;
    its process mesh held degenerate unless the block opts out."""
    with monkeypatch.context() as mp:
        mp.setattr(
            jax.core, "trace_state_clean", jax._src.core.trace_state_clean,
            raising=False,
        )
        if degenerate:
            mp.setattr(ref_backend, "_mesh_config", ref_backend.MeshConfig(None, 1, 1, "test"))
        yield


def _ref_mesh(dp=2, mp=4):
    return Mesh(np.array(jax.devices()[: dp * mp]).reshape(dp, mp), ("groups", "nodes"))


def _cpu_mesh(dp=2, mp=4):
    return backend.make_mesh(dp, mp, "cpu")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _bits(x):
    x = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
    return x.view(np.uint32) if x.dtype in (np.float32, np.int32) else x


def assert_same_bits(got, want, what=""):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = _bits(g), _bits(w)
        assert g.shape == w.shape, (what, i)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} output {i}")


def _near(got, want):
    np.testing.assert_allclose(
        np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got),
        np.asarray(want), rtol=RTOL, atol=ATOL,
    )


# the reference's PartitionSpecs, and the port's axes for the same inputs
SPECS = dict(
    capacity=P("nodes", None),
    used0=P("nodes", None),
    asks=P("groups", None),
    eligible=P("groups", "nodes"),
    job_counts=P("groups", "nodes"),
    desired_totals=P("groups"),
    penalty_nodes=P("groups", "nodes"),
    affinity_scores=P("groups", "nodes"),
    has_affinities=P("groups"),
    distinct_hosts=P("groups"),
    block_value_ids=P("groups", None, "nodes"),
    block_counts0=P("groups", None, None),
    block_desired=P("groups", None, None),
    block_caps=P("groups", None, None),
    block_weights=P("groups", None),
    block_kinds=P("groups", None),
    slot_caps=P("groups", "nodes"),
    algorithm_spread=P(),
    counts=P("groups"),
)


def _ref_shard(batch, mesh, specs):
    return {k: jax.device_put(v, NamedSharding(mesh, specs[k])) for k, v in batch.items()}


def _port_shard(batch, cfg):
    """The port's batch laid out as the reference's SPECS lay it out."""
    out = {}
    for k, v in batch.items():
        if k == "algorithm_spread":
            continue
        out[k] = backend.shard_put(v, tuple(SPECS[k] if k in SPECS else ("nodes",)), cfg)
    return out


def _port_plain(batch):
    return {k: _t(v) for k, v in batch.items() if k != "algorithm_spread"}


def _value_scan_batch(n_nodes=512, v=4):
    batch = graft._example_batch(n_nodes=n_nodes, n_groups=8, max_steps=8, v=v)
    batch["counts"] = np.full(8, 8, dtype=np.int32)
    batch["desired_totals"] = np.full(8, 8.0, dtype=np.float32)
    return batch


def _closed_form_batch(n_nodes=512, count=16):
    b = graft._closed_form_batch(n_nodes=n_nodes, n_groups=8, count=count)
    b.pop("counts")
    return b


def test_value_scan_kernel_sharded_matches_single_device(monkeypatch):
    batch = _value_scan_batch()
    with traced(monkeypatch):
        ref_c, ref_s = ref_score.place_value_scan_kernel(**batch, max_j=16, max_steps=8)
    mesh = _ref_mesh()
    with traced(monkeypatch, degenerate=False), mesh:
        sc, ss = ref_score.place_value_scan_kernel(
            **_ref_shard(batch, mesh, SPECS), max_j=16, max_steps=8
        )
    np.testing.assert_array_equal(np.asarray(sc), np.asarray(ref_c))

    one = S.place_value_scan(**_port_plain(batch), algorithm_spread=False, max_j=16, max_steps=8)
    got = S.place_value_scan(
        **_port_shard(batch, _cpu_mesh()), algorithm_spread=False, max_j=16, max_steps=8
    )
    assert_same_bits(got, one, "sharded vs one device")
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref_c))
    _near(got[1], ref_s)
    _near(got[1], ss)
    assert (got[0].numpy() >= 0).all()


def _split_fused(fused, k):
    fused = np.asarray(fused)
    return fused[:, :k], fused[:, k:].view(np.float32)


def test_closed_form_kernel_sharded_matches_single_device(monkeypatch):
    batch = _closed_form_batch()
    with traced(monkeypatch):
        ref_c, ref_s = _split_fused(
            ref_score.place_closed_form_kernel(**batch, counts=np.full(8, 16, np.int32),
                                               max_j=16, k=16), 16
        )
    mesh = _ref_mesh()
    with traced(monkeypatch, degenerate=False), mesh:
        specs = {k: SPECS[k] for k in batch}
        sc, _ = _split_fused(
            ref_score.place_closed_form_kernel(
                **_ref_shard(batch, mesh, specs), counts=np.full(8, 16, np.int32),
                max_j=16, k=16,
            ), 16
        )
    np.testing.assert_array_equal(sc, ref_c)

    one = S.place_closed_form(**_port_plain(batch), algorithm_spread=False, max_j=16, k=16)
    got = S.place_closed_form(
        **_port_shard(batch, _cpu_mesh()), algorithm_spread=False, max_j=16, k=16
    )
    assert_same_bits(got, one, "sharded vs one device")
    np.testing.assert_array_equal(got[0].numpy(), ref_c)
    _near(got[1], ref_s)


def _score_args(batch):
    return dict(
        capacity=batch["capacity"], used=batch["used0"], asks=batch["asks"],
        eligible=batch["eligible"], job_counts=batch["job_counts"],
        desired_totals=batch["desired_totals"], penalty_nodes=batch["penalty_nodes"],
        affinity_scores=batch["affinity_scores"], has_affinities=batch["has_affinities"],
        distinct_hosts=batch["distinct_hosts"],
    )


def test_score_matrix_kernel_node_sharded(monkeypatch):
    batch = _value_scan_batch()
    args = _score_args(batch)
    with traced(monkeypatch):
        ref_final, ref_fits = ref_score.score_matrix_kernel(
            **args, algorithm_spread=batch["algorithm_spread"]
        )
    port = {k: _t(v) for k, v in args.items()}
    one = S.score_matrix(**port, algorithm_spread=False)
    cfg = _cpu_mesh()
    sharded = {
        k: backend.shard_put(v, ("nodes",) if k == "used" else tuple(SPECS[k]), cfg)
        for k, v in args.items()
    }
    assert all(backend.is_sharded(v) for k, v in sharded.items() if k != "asks" or True)
    got = S.score_matrix(**sharded, algorithm_spread=False)
    assert_same_bits(got, one, "sharded vs one device")
    _near(got[0], ref_final)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref_fits))


def test_mesh_shapes_1x8_and_4x2(monkeypatch):
    batch = _closed_form_batch(count=8)
    with traced(monkeypatch):
        ref_c, _ = _split_fused(
            ref_score.place_closed_form_kernel(**batch, counts=np.full(8, 8, np.int32),
                                               max_j=8, k=8), 8
        )
    one = S.place_closed_form(**_port_plain(batch), algorithm_spread=False, max_j=8, k=8)
    # and a groups-only split (8 x 1: a launch a group row, no merge)
    for dp, mp in [(1, 8), (4, 2), (8, 1)]:
        got = S.place_closed_form(
            **_port_shard(batch, _cpu_mesh(dp, mp)), algorithm_spread=False, max_j=8, k=8
        )
        assert_same_bits(got, one, f"{dp}x{mp}")
        np.testing.assert_array_equal(got[0].numpy(), ref_c)


def dryrun_multichip(n_devices=8):
    """The port's counterpart of ``__graft_entry__.dryrun_multichip`` at its
    sizes, through the plain versions on an ``n_devices`` CPU mesh: the
    value scan on 10,240 nodes x 75 racks (8 groups x 8, every placement
    made), the closed form on the same batch, and the region-major
    federation (40,960 nodes, a region a device, each group confined to
    its home region); each identical to the unsharded call. Returns the
    three results."""
    dp = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mp = n_devices // dp
    cfg = _cpu_mesh(dp, mp)
    n_nodes = ((10_240 + mp - 1) // mp) * mp
    batch = _value_scan_batch(n_nodes=n_nodes, v=75)
    one = S.place_value_scan(**_port_plain(batch), algorithm_spread=False, max_j=16, max_steps=8)
    got = S.place_value_scan(
        **_port_shard(batch, cfg), algorithm_spread=False, max_j=16, max_steps=8
    )
    assert_same_bits(got, one, "dryrun value scan")
    assert got[0].shape == (8, 8) and (got[0].numpy() >= 0).all()

    cf = {k: v for k, v in batch.items() if not k.startswith("block_") and k != "counts"}
    one_cf = S.place_closed_form(**_port_plain(cf), algorithm_spread=False, max_j=16, k=16)
    got_cf = S.place_closed_form(**_port_shard(cf, cfg), algorithm_spread=False, max_j=16, k=16)
    assert_same_bits(got_cf, one_cf, "dryrun closed form")
    assert (got_cf[0][:, :8].numpy() >= 0).all()

    n_regions = n_devices
    fed_nodes = ((40_960 + n_regions - 1) // n_regions) * n_regions
    per_region = fed_nodes // n_regions
    rb = _closed_form_batch(n_nodes=fed_nodes, count=4)
    rows = np.arange(fed_nodes)
    for g in range(8):
        rb["eligible"][g] = (rows // per_region) == g % n_regions
    region = backend.make_mesh(1, n_regions, "cpu")
    one_r = S.place_closed_form(**_port_plain(rb), algorithm_spread=False, max_j=4, k=4)
    got_r = S.place_closed_form(**_port_shard(rb, region), algorithm_spread=False, max_j=4, k=4)
    assert_same_bits(got_r, one_r, "dryrun federation")
    ch = got_r[0].numpy()
    assert (ch >= 0).all()
    for g in range(8):
        assert ((ch[g] // per_region) == g % n_regions).all(), "left its home region"
    return got, got_cf, got_r


def test_dryrun_multichip_in_process(monkeypatch):
    got, got_cf, got_r = dryrun_multichip(8)
    # the reference's unsharded programs on the same batches
    batch = _value_scan_batch(n_nodes=10_240, v=75)
    with traced(monkeypatch):
        ref_c, _ = ref_score.place_value_scan_kernel(**batch, max_j=16, max_steps=8)
        cf = {k: v for k, v in batch.items() if not k.startswith("block_")}
        ref_cf, _ = _split_fused(ref_score.place_closed_form_kernel(**cf, max_j=16, k=16), 16)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref_c))
    np.testing.assert_array_equal(got_cf[0].numpy(), ref_cf)
    monkeypatch.setenv("NOMAD_TPU_DRYRUN_CHILD", "1")
    with traced(monkeypatch, degenerate=False):
        graft.dryrun_multichip(8)


# -- mesh seam -------------------------------------------------------------------


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


class TestMeshSeam:
    def test_parse_mesh_spec(self):
        for spec in ("off", "0", "none", "auto", "2,4", " 1 , 8 "):
            assert backend.parse_mesh_spec(spec) == ref_backend.parse_mesh_spec(spec)
        assert backend.parse_mesh_spec(" 1 , 8 ") == (1, 8)
        for junk in ("2x4", "2,4,1", "0,4", "2,3"):
            with pytest.raises(ValueError):
                backend.parse_mesh_spec(junk)
            with pytest.raises(ValueError):
                ref_backend.parse_mesh_spec(junk)

    def test_auto_mesh_shape(self):
        for n in (1, 2, 3, 4, 8, 12, 16, 33):
            assert backend.auto_mesh_shape(n) == ref_backend.auto_mesh_shape(n)
        assert backend.auto_mesh_shape(8) == (2, 4)
        assert backend.auto_mesh_shape(16) == (2, 8)

    def test_cpu_default_is_degenerate(self, monkeypatch):
        monkeypatch.delenv("NOMAD_TPU_MESH", raising=False)
        backend.reset_mesh()
        cfg = backend.get_mesh()
        assert not cfg.active and cfg.n_node_shards == 1
        assert cfg.source == "default-off"
        backend.reset_mesh()
        # the process mesh past the CPU's 8 devices is refused
        monkeypatch.setenv("NOMAD_TPU_MESH", "4,4")
        with pytest.raises(ValueError, match="devices"):
            backend.get_mesh()
        backend.reset_mesh()

    def test_env_activates_and_describes(self, mesh_env):
        cfg = mesh_env("2,4")
        ref = ref_backend.get_mesh()
        assert cfg.active and (cfg.dp, cfg.mp) == (2, 4)
        d = cfg.describe()
        assert {k: d[k] for k in ("active", "shape", "axis_names", "source")} == ref.describe()
        assert d["devices"] == ["cpu"] * 8
        assert cfg.lead == torch.device("cpu")

    def test_shard_put_layouts(self, mesh_env):
        cfg = mesh_env("2,4")
        x = np.arange(64 * 4, dtype=np.float32).reshape(64, 4)
        arr = backend.shard_put(x, ("nodes",), cfg)
        ref = ref_backend.shard_put(x, ("nodes",), ref_backend.get_mesh())
        assert arr.axes == ("nodes", None) and ref.sharding.spec == P("nodes")
        np.testing.assert_array_equal(arr.gather().numpy(), x)
        for (i, j), idx, t in arr.pieces():
            np.testing.assert_array_equal(t.numpy(), x[idx])
            assert t.shape == (16, 4) and t.is_contiguous()
        # an axis that does not divide the dim stays whole: a plain tensor
        odd = np.ones((6, 4), dtype=np.float32)
        arr2 = backend.shard_put(odd, ("nodes",), cfg)
        assert isinstance(arr2, torch.Tensor)
        np.testing.assert_array_equal(arr2.numpy(), odd)
        # groups x nodes: a block a cell
        g = np.arange(8 * 64, dtype=np.int32).reshape(8, 64)
        arr3 = backend.shard_put(g, ("groups", "nodes"), cfg)
        assert arr3.block(1, 3).shape == (4, 16)
        np.testing.assert_array_equal(arr3.block(1, 3).numpy(), g[4:8, 48:64])
        # a degenerate config is a plain tensor on the device asked for
        degen = backend.MeshConfig(None, 1, 1, "test")
        plain = backend.shard_put(x, ("nodes",), degen, device="cpu")
        assert isinstance(plain, torch.Tensor) and not backend.is_sharded(plain)


# -- hierarchical cross-shard top-k ------------------------------------------------


def _port_topk_nodes(flat, k, n_shards):
    """Per-shard stable top-k' then the port's plain cross-shard merge:
    (values, indices) as the reference's ``_topk_nodes`` returns them."""
    t = torch.from_numpy(flat)
    seg = flat.shape[0] // n_shards
    kl = min(k, seg)
    rows, scores = [], []
    for s in range(n_shards):
        v, i = torch.sort(t[s * seg:(s + 1) * seg], descending=True, stable=True)
        rows.append(i[:kl].to(torch.int32)[None].contiguous())
        scores.append(v[:kl][None].contiguous())
    fused = S.closed_form_topk_merge_plain(rows, scores, seg, k)[0]
    return fused[k:].view(torch.float32).numpy(), fused[:k].numpy()


class TestHierarchicalTopK:
    @pytest.mark.parametrize("seed", [42, 7])
    @pytest.mark.parametrize("n_shards", [2, 4, 8])
    def test_bit_identical_to_global_topk(self, seed, n_shards):
        rng = np.random.default_rng(seed)
        for _ in range(10):
            flat = rng.choice(
                np.array([-np.inf, 0.0, 1.0, 2.0, 3.0], dtype=np.float32), size=1024
            )
            k = int(rng.integers(1, 33))
            ref_v, ref_i = ref_score._topk_nodes(jax.numpy.asarray(flat), k, n_shards)
            top_v, top_i = jax.lax.top_k(jax.numpy.asarray(flat), k)
            v, i = _port_topk_nodes(flat, k, n_shards)
            np.testing.assert_array_equal(v.view(np.uint32), np.asarray(ref_v).view(np.uint32))
            np.testing.assert_array_equal(i, np.asarray(ref_i))
            np.testing.assert_array_equal(i, np.asarray(top_i))
            np.testing.assert_array_equal(v, np.asarray(top_v))


# -- the hetero kernel with sharded inputs --------------------------------------------


class TestHeteroKernelSharded:
    @pytest.mark.parametrize("policy", sorted(ref_hetero.POLICY_IDS))
    @pytest.mark.parametrize("dp,mp", MESH_SHAPES)
    def test_sharded_matches_single_device(self, policy, dp, mp, monkeypatch):
        ct = ref_hetero.build_mixed_fleet(48, seed=11)
        asks = ref_hetero.build_mixed_asks(ct, 8, 4, seed=12)
        b = ref_hetero.build_hetero_batch(ct, asks)
        pid = ref_hetero.POLICY_IDS[policy]
        with traced(monkeypatch):
            ref = ref_hetero.hetero_place_kernel(
                b.capacity, b.used, b.asks, b.counts, b.eligible, b.tp,
                b.tpmax, b.cost, policy=pid, steps=b.steps, max_c=b.max_c,
            )
        args = (b.capacity, b.used, b.asks, b.counts, b.eligible, b.tp, b.tpmax, b.cost)
        one = port_hetero.hetero_place(*[_t(a) for a in args], pid, b.steps, b.max_c)
        cfg = _cpu_mesh(dp, mp)
        axes = (("nodes",), ("nodes",), ("groups",), ("groups",), ("groups", "nodes"),
                ("groups", "nodes"), ("groups",), ())
        sharded = [backend.shard_put(a, ax, cfg) for a, ax in zip(args, axes)]
        assert backend.is_sharded(sharded[0])
        got = port_hetero.hetero_place(*sharded, pid, b.steps, b.max_c)
        assert_same_bits(got, one, "sharded vs one device")
        assert_same_bits(got, ref, f"{policy} {dp}x{mp}")


# -- the preemption kernels with sharded inputs -----------------------------------------


def _preempt_case(seed, n=64, v=8, d=4):
    rng = np.random.default_rng(seed)
    capacity = rng.uniform(100, 200, size=(n, d)).astype(np.float32)
    used = (capacity * rng.uniform(0.6, 0.98, size=(n, d))).astype(np.float32)
    return dict(
        capacity=capacity,
        used=used,
        ask=np.array([40.0, 30.0, 10.0, 0.0], dtype=np.float32)[:d],
        eligible=rng.random(n) < 0.9,
        victim_res=rng.uniform(5, 40, size=(n, v, d)).astype(np.float32),
        victim_prio=rng.integers(0, 50, size=(n, v)).astype(np.int32),
        victim_mask=rng.random((n, v)) < 0.7,
    )


_PREEMPT_AXES = dict(
    capacity=("nodes",), used=("nodes",), ask=(), eligible=("nodes",),
    victim_res=("nodes",), victim_prio=("nodes",), victim_mask=("nodes",),
)


def _preempt_check(name, seed, dp, mp, monkeypatch):
    case = _preempt_case(seed)
    with traced(monkeypatch):
        ref = getattr(ref_preempt, f"{name}_kernel")(**case)
    fn = getattr(port_preempt, name)
    one = fn(**{k: _t(v) for k, v in case.items()})
    cfg = _cpu_mesh(dp, mp)
    got = fn(**{k: backend.shard_put(v, _PREEMPT_AXES[k], cfg) for k, v in case.items()})
    assert_same_bits(got, one, "sharded vs one device")
    if name == "find_preemption":
        assert_same_bits(got, ref, f"{name} {dp}x{mp}")
        return
    # the choice's fit score takes exp: within tolerance of the reference
    assert_same_bits(got[:5], ref[:5], f"{name} {dp}x{mp}")
    p, r = got[5].numpy(), np.asarray(ref[5])
    np.testing.assert_array_equal(np.isneginf(p), np.isneginf(r))
    fin = np.isfinite(r)
    np.testing.assert_allclose(p[fin], r[fin], rtol=RTOL, atol=ATOL)


class TestPreemptKernelsSharded:
    @pytest.mark.parametrize("dp,mp", MESH_SHAPES)
    def test_find_preemption_sharded_matches(self, dp, mp, monkeypatch):
        _preempt_check("find_preemption", 5, dp, mp, monkeypatch)

    @pytest.mark.parametrize("dp,mp", MESH_SHAPES)
    def test_choose_node_sharded_matches(self, dp, mp, monkeypatch):
        _preempt_check("choose_preemption_node", 9, dp, mp, monkeypatch)


# -- the production path through the registry --------------------------------------------


def _ref_degenerate():
    return ref_backend.MeshConfig(None, 1, 1, "test")


def _port_cluster(ct, asks):
    return (
        interop.cluster_from_numpy(dataclasses.asdict(ct)),
        interop.asks_from_numpy([dataclasses.asdict(a) for a in asks]),
    )


def _placements_match(algo, n_nodes, n_jobs, count, seed, monkeypatch):
    ct = bench.build_cluster(n_nodes, seed=seed)
    asks = bench.build_asks(ct, n_jobs, count, seed=seed + 1)
    with traced(monkeypatch):
        ref = ref_make_kernel(algo, mesh=_ref_degenerate()).place(ct, asks)
    pct, pasks = _port_cluster(ct, asks)
    one = make_kernel(algo, device="cpu").place(pct, pasks)
    pct, pasks = _port_cluster(ct, asks)
    got = make_kernel(algo, mesh=_cpu_mesh(2, 4), device="cpu").place(pct, pasks)
    assert len(got) == len(ref) == len(one)
    for r, o, g in zip(ref, one, got):
        np.testing.assert_array_equal(g.node_rows, o.node_rows)
        np.testing.assert_array_equal(g.scores.view(np.uint32), o.scores.view(np.uint32))
        np.testing.assert_array_equal(g.overflow_rows, o.overflow_rows)
        np.testing.assert_array_equal(g.node_rows, r.node_rows)
        _near(g.scores, r.scores)


class TestProductionPathSharded:
    @pytest.mark.parametrize("seed", [42, 7])
    def test_placement_kernel_bit_identical_under_mesh(self, seed, monkeypatch):
        _placements_match("binpack", 1000, 16, 64, seed, monkeypatch)

    @pytest.mark.parametrize("seed", [42, 7])
    def test_spread_kernel_bit_identical_under_mesh(self, seed, monkeypatch):
        _placements_match("spread", 500, 8, 32, seed, monkeypatch)

    def test_worker_pass_through_harness_matches_single_device(self, monkeypatch):
        """store -> device cache -> flatten -> registry kernel -> plan
        apply: the same alloc -> node assignment with the Harness's mesh
        as without, and as the reference's Harness."""

        def run_once(harness, mock):
            h = harness()
            for i in range(12):
                node = mock.node()
                node.id = f"node-{i:02d}"
                node.datacenter = "dc1" if i % 2 else "dc2"
                h.store.upsert_node(i + 1, node)
            placements = {}
            for j in range(4):
                job = mock.job()
                job.id = f"mesh-job-{j}"
                job.task_groups[0].count = 6
                h.store.upsert_job(h.next_index(), job)
                ev = mock.eval_for(job)
                h.store.upsert_evals(h.next_index(), [ev])
                h.process(ev)
                for a in h.store.allocs_by_job(job.namespace, job.id):
                    placements[(job.id, a.index())] = a.node_id
            return placements, h

        with traced(monkeypatch):
            ref, _ = run_once(RefHarness, ref_mock)
        one, _ = run_once(lambda: PortHarness(device="cpu"), port_mock)
        cfg = _cpu_mesh(2, 4)
        got, h = run_once(lambda: PortHarness(device="cpu", mesh=cfg), port_mock)
        assert got == one == ref
        assert len(got) == 24
        assert h.device_cache.mesh is cfg
        assert backend.is_sharded(h.device_cache._dev_capacity)
        assert h.device_cache.verify_device_view() == []


# -- explain under node sharding ------------------------------------------------------------


class TestExplainUnderMesh:
    def test_explain_gathers_candidates_and_adds_zero_retraces(self, monkeypatch):
        """With the node axis sharded, explain must keep the kernel's top
        pick and add no kernel build or Triton specialisation (the
        reference: no retrace) — the provenance is host work over the
        surfaced candidate rows only."""
        ct = bench.build_cluster(500, seed=3)
        asks = bench.build_asks(ct, 4, 16, seed=4)
        with traced(monkeypatch):
            ref = ref_make_kernel("binpack", mesh=_ref_degenerate()).place(ct, asks, explain=True)
        pct, pasks = _port_cluster(ct, asks)
        kernel = make_kernel("binpack", mesh=_cpu_mesh(2, 4), device="cpu")
        assert kernel.mesh_cfg().active
        kernel.place(pct, pasks)  # warm
        builds = backend._compiles
        results = kernel.place(pct, pasks, explain=True)
        assert backend._compiles == builds, "explain added a kernel build"
        for r, g in zip(ref, results):
            ex = g.explanation
            assert ex is not None and ex.top_candidates
            placed = [int(x) for x in g.node_rows if x >= 0]
            assert int(ex.top_candidates[0].node_row) == placed[0]
            assert int(ex.top_candidates[0].node_row) == int(r.explanation.top_candidates[0].node_row)


# -- the device cache: per-shard refresh ------------------------------------------------------


def _mesh_store(store_cls, mock, n=12):
    store = store_cls()
    for i in range(n):
        node = mock.node()
        node.id = f"node-{i:02d}"
        node.datacenter = "dc1" if i % 2 else "dc2"
        store.upsert_node(i + 1, node)
    return store


def _both_caches(mesh_env):
    """(reference store, cache), (port store, cache) under the 2x4 mesh."""
    cfg = mesh_env("2,4")
    ref_store = _mesh_store(RefStore, ref_mock)
    port_store = _mesh_store(PortStore, port_mock)
    return (ref_store, RefCache()), (port_store, DeviceStateCache("cpu", mesh=cfg))


class TestCachePerShardRefresh:
    def test_steady_state_node_update_uploads_one_shard(self, mesh_env):
        sides = _both_caches(mesh_env)
        counters = []
        for store, cache in sides:
            ct = cache.tensors(store.snapshot())
            assert ct.device_capacity is not None
            assert cache.device_counters()["full_uploads"] == 1
            assert cache.device_counters()["shard_uploads"] == 0
            node = store.snapshot().node_by_id("node-03")
            node.node_resources.cpu = 12_345
            store.upsert_node(100, node)
            ct2 = cache.tensors(store.snapshot())
            assert cache.full_flattens == 1 and cache.incremental_refreshes == 1
            c = cache.device_counters()
            assert c["full_uploads"] == 1 and c["shard_uploads"] == 1
            row = ct2.node_row["node-03"]
            dev = ct2.device_capacity
            got = np.asarray(dev.gather() if backend.is_sharded(dev) else dev)
            np.testing.assert_array_equal(got[row], ct2.capacity[row])
            assert cache.verify_device_view() == []
            counters.append(c)
        assert counters[0] == counters[1]

    def test_alloc_churn_does_not_touch_device_view(self, mesh_env):
        sides = _both_caches(mesh_env)
        counters = []
        for (store, cache), mock in zip(sides, (ref_mock, port_mock)):
            cache.tensors(store.snapshot())
            store.upsert_allocs(200, [mock.alloc(node_id="node-05")])
            cache.tensors(store.snapshot())
            c = cache.device_counters()
            assert c["full_uploads"] == 1 and c["shard_uploads"] == 0
            assert cache.verify_device_view() == []
            counters.append(c)
        assert counters[0] == counters[1]

    def test_chaos_shard_refresh_drop_recovers_via_full_upload(self, mesh_env):
        from nomad_tpu.chaos.plane import FaultPlane as RefPlane
        from nomad_tpu.chaos.plane import FaultSpec as RefSpec
        from nomad_tpu.chaos.plane import install as ref_install
        from nomad_tpu.chaos.plane import uninstall as ref_uninstall

        sides = _both_caches(mesh_env)
        planes = (
            (RefPlane, RefSpec, ref_install, ref_uninstall),
            (FaultPlane, FaultSpec, install, uninstall),
        )
        counters = []
        for (store, cache), (plane_cls, spec, inst, uninst) in zip(sides, planes):
            cache.tensors(store.snapshot())
            node = store.snapshot().node_by_id("node-07")
            node.node_resources.cpu = 9_999
            store.upsert_node(101, node)
            plane = plane_cls(schedule=[spec("mesh.shard_refresh_drop", 0, "drop")])
            inst(plane)
            try:
                ct = cache.tensors(store.snapshot())
            finally:
                uninst()
            c = cache.device_counters()
            assert c["full_uploads"] == 2 and c["shard_uploads"] == 0
            row = ct.node_row["node-07"]
            dev = ct.device_capacity
            got = np.asarray(dev.gather() if backend.is_sharded(dev) else dev)
            np.testing.assert_array_equal(got[row], ct.capacity[row])
            assert cache.verify_device_view() == []
            assert ("mesh.shard_refresh_drop", 0, "drop") in plane.triggered
            counters.append(c)
        assert counters[0] == counters[1]

    def test_region_major_layout_is_contiguous(self, mesh_env):
        sides = _both_caches(mesh_env)
        ids = []
        for store, cache in sides:
            ct = cache.tensors(store.snapshot())
            r = ct.region_ids[: ct.num_nodes]
            assert (np.diff(r) >= 0).all(), "regions must be contiguous"
            assert set(ct.region_vocab.values()) == set(np.unique(r))
            ids.append((list(ct.node_ids[: ct.num_nodes]), r.tolist()))
        assert ids[0] == ids[1]


# -- the port's own: the mesh under the chaos runner, and the layout counts --------------


class TestMeshChaos:
    def test_node_touches_fire_shard_refresh_drop(self, mesh_env):
        """A chaos run under a 1x4 mesh with a node re-registered at every
        settle point reaches the per-shard capacity refresh: the scheduled
        drop fires on the first one and is recovered by a whole upload,
        later refreshes upload shards, and law 12's capacity half passes."""
        from nomad_tpu_torch.chaos import run_chaos

        mesh_env("1,4")
        run = run_chaos(
            seed=5, steps=24, device="cpu", quiesce_timeout=60.0, node_touches=True,
            schedule=[FaultSpec("mesh.shard_refresh_drop", 0, "drop")],
        )
        assert run.ok, run.render()
        assert run.workload["node_touches"] == 3
        assert ("mesh.shard_refresh_drop", 0, "drop") in run.triggered
        assert run.report.info["shard_consistency"]["capacity"] == "checked"
        assert run.report.checked.get("shard_consistency") is True
        cache = run.report.info["device_cache"]
        assert cache["full_uploads"] >= 2 and cache["shard_uploads"] >= 1, cache


class TestLayoutCounts:
    def test_gathered_layout_is_per_thread(self):
        """A launch another thread makes while ``_gathered`` runs is not
        filed under the "gathered" layout."""
        import threading

        def fake():
            pass

        fake.launches = 0
        inside, done = threading.Event(), threading.Event()

        def launch():
            backend.count_launch(fake)
            inside.set()
            assert done.wait(10)

        backend.reset_mesh_layouts()
        t = threading.Thread(
            target=backend._gathered, args=(launch, torch.device("cpu"), [], {})
        )
        t.start()
        assert inside.wait(10)
        backend.count_launch(fake)
        done.set()
        t.join()
        assert fake.launches == 2
        assert backend.mesh_layouts() == {"fake:gathered": 1}
        backend.reset_mesh_layouts()
