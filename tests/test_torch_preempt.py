"""The port's preemption search against the JAX reference, on the CPU.

Four layers, each with the same inputs on both sides:

- the two device programs: seeded numpy inputs through the reference's
  raw jitted programs (``find_preemption_kernel.jitted``,
  ``choose_preemption_node_kernel.jitted``) and the port's wrappers on
  CPU tensors, which run the plain PyTorch versions;
- the host drivers ``build_victim_tensors``, ``rank_preemption_nodes``
  and ``find_preemptions`` on one store, carried across with its alloc
  ids (``interop.store_from_records``);
- the exact host victim selection (``preempt_host``) on every fixture of
  ``tests/test_preemption_vectors.py``;
- whole evaluations through both ``Harness``es: the end-to-end scenarios
  of ``tests/test_preemption.py`` and a mixed cluster, plans compared id
  for id.

Tolerances. On integer-valued resources (MHz, MiB — what schedulers
hand the kernels) feasible, k, net, order and best are identical and the
shortlists equal. The score agrees within ``rtol=1e-5, atol=1e-6`` with
−inf in the same rows: XLA's ``exp`` against PyTorch's, a few ulp. On
fractional resources the reference's ``cumsum`` is an associative scan
and the port's a sequential sum, so a prefix's freed total may differ in
the last bits: order stays identical, and k (with feasible and net) may
differ only on a row where the ask's slack at a prefix both sides
consider, ``capacity − (used − freed + ask)``, is within
``FRACTIONAL_SLACK`` of 0 in some dimension.

The choose program calls the find program through ``traced_jit``, which
calls ``jax.core.trace_state_clean`` — gone in this jax (ROADMAP C-R1).
Every reference call runs inside a monkeypatch scoped to its block, as in
``tests/test_torch_e2e.py``.
"""

import contextlib
import dataclasses

import jax
import jax._src.core
import numpy as np
import pytest
import torch

from nomad_tpu import mock as ref_mock
from nomad_tpu.device import flatten_cluster as ref_flatten_cluster
from nomad_tpu.device import preempt as ref_preempt
from nomad_tpu.scheduler import Harness as RefHarness
from nomad_tpu.scheduler import preempt_host as ref_host
from nomad_tpu.state import SchedulerConfiguration as RefSchedulerConfiguration
from nomad_tpu.state import StateStore as RefStore
from nomad_tpu.structs.job import MigrateStrategy
from nomad_tpu.structs.resources import (
    AllocatedDeviceResource,
    NetworkResource,
    NodeDeviceInstance,
    NodeDeviceResource,
    RequestedDevice,
)
from nomad_tpu.utils import backend as ref_backend
from nomad_tpu_torch import interop
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch.device import flatten_cluster as port_flatten_cluster
from nomad_tpu_torch.device import preempt as port_preempt
from nomad_tpu_torch.scheduler import Harness as PortHarness
from nomad_tpu_torch.scheduler import preempt_host as port_host
from nomad_tpu_torch.state import SchedulerConfiguration as PortSchedulerConfiguration
from nomad_tpu_torch.structs import ALLOC_DESIRED_EVICT
from nomad_tpu_torch.structs import Job as PortJob

RTOL, ATOL = 1e-5, 1e-6
FRACTIONAL_SLACK = 1e-2  # 8 ulp of 16,000 MHz, where the exercise case sits
OUTPUTS = ("best", "feasible", "k", "net", "order", "score")


@contextlib.contextmanager
def reference_runtime(monkeypatch):
    """The reference's traced_jit path on this jax, for one block only."""
    with monkeypatch.context() as mp:
        mp.setattr(
            jax.core, "trace_state_clean", jax._src.core.trace_state_clean,
            raising=False,
        )
        mp.setattr(ref_backend, "_mesh_config", ref_backend.MeshConfig(None, 1, 1, "test"))
        yield


# -- the device programs -------------------------------------------------------


def _inputs(kind: str, v: int, n: int = 96, seed: int = 0):
    """(capacity, used, ask, eligible, victim_res, victim_prio,
    victim_mask) as numpy: mock-node capacities, 0..V victims a node of
    integer resources at four batch priorities, some rows ineligible and
    some with zero memory capacity."""
    rng = np.random.default_rng(seed + 1000 * v)
    cap = np.tile(np.array([3900, 7936, 98304, 1000], np.float32), (n, 1))
    cap[rng.random(n) < 0.1, 1] = 0.0
    nv = rng.integers(0, v + 1, n)
    mask = np.arange(v)[None, :] < nv[:, None]
    if kind == "ties":
        # equal-sized allocs of one job: every key ties, index order decides
        res = np.tile(np.array([600, 1024, 300, 0], np.float32), (n, v, 1))
        prio = np.full((n, v), 30, np.int32)
    else:
        res = np.stack([
            rng.integers(100, 1500, (n, v)), rng.integers(128, 2048, (n, v)),
            rng.integers(0, 4000, (n, v)), rng.integers(0, 100, (n, v)),
        ], -1).astype(np.float32)
        prio = rng.choice([10, 20, 30, 40], (n, v)).astype(np.int32)
    if kind == "all_masked":
        mask[:] = False
    res[~mask] = 0.0
    prio[~mask] = 0
    base = np.array([100, 256, 4096, 0], np.float32)
    used = (res.sum(axis=1) + base).astype(np.float32)
    ask = np.array([1000, 1024, 300, 10], np.float32)
    if kind == "none_feasible":
        ask = np.array([99999, 1024, 300, 10], np.float32)
    eligible = rng.random(n) < 0.9
    return cap, used, ask, eligible, res, prio, mask


def _exercise_fractional():
    """``nomad_tpu/analysis/jaxlint/exercise.py``'s preemption case: 16
    nodes at 90 % of 16,000, three fractional victims each."""
    n, v = 16, 3
    capacity = np.full((n, 4), 16000.0, dtype=np.float32)
    used = capacity * 0.9
    ask = np.array([4000.0, 8000.0, 100.0, 0.0], dtype=np.float32)
    rng = np.random.default_rng(11)
    res = rng.uniform(100.0, 4000.0, size=(n, v, 4)).astype(np.float32)
    return (
        capacity, used, ask, np.ones(n, bool), res,
        np.full((n, v), 20, np.int32), np.ones((n, v), bool),
    )


def _fractional_wide():
    """The same shape of ask over 2,000 nodes of eight fractional
    victims, usage near the fitting edge."""
    rng = np.random.default_rng(5)
    n, v = 2000, 8
    capacity = np.full((n, 4), 16000.0, dtype=np.float32)
    res = rng.uniform(100.0, 4000.0, size=(n, v, 4)).astype(np.float32)
    mask = rng.random((n, v)) < 0.8
    res[~mask] = 0.0
    used = (res.sum(axis=1) * rng.uniform(0.9, 1.1, (n, 1))).astype(np.float32)
    ask = np.array([4000.0, 8000.0, 100.0, 0.0], dtype=np.float32)
    prio = np.where(mask, rng.choice([10, 20], (n, v)), 0).astype(np.int32)
    return capacity, used, ask, np.ones(n, bool), res, prio, mask


def _both(monkeypatch, args):
    with reference_runtime(monkeypatch):
        ref_find = ref_preempt.find_preemption_kernel.jitted(*args)
        ref_choose = ref_preempt.choose_preemption_node_kernel.jitted(*args)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    port_find = port_preempt.find_preemption(*t)
    port_choose = port_preempt.choose_preemption_node(*t)
    ref_out = dict(zip(OUTPUTS, (np.asarray(x) for x in ref_choose)))
    port_out = dict(zip(OUTPUTS, (x.numpy() for x in port_choose)))
    # the standalone pass gives what the choice's own pass gave
    for name, ref_x, port_x in zip(OUTPUTS[1:5], ref_find, port_find):
        np.testing.assert_array_equal(np.asarray(ref_x), ref_out[name])
        np.testing.assert_array_equal(port_x.numpy(), port_out[name])
    return ref_out, port_out


def _assert_scores(ref_out, port_out):
    r, p = ref_out["score"], port_out["score"]
    assert p.dtype == np.float32 and p.shape == r.shape
    np.testing.assert_array_equal(np.isneginf(p), np.isneginf(r))
    fin = np.isfinite(r)
    np.testing.assert_allclose(p[fin], r[fin], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["random", "ties", "none_feasible", "all_masked"])
@pytest.mark.parametrize("v", [1, 2, 8, 64])
def test_programs_match_reference_on_integer_inputs(monkeypatch, kind, v):
    args = _inputs(kind, v)
    ref_out, port_out = _both(monkeypatch, args)
    for name in ("best", "feasible", "k", "net", "order"):
        assert port_out[name].dtype == ref_out[name].dtype, name
        np.testing.assert_array_equal(port_out[name], ref_out[name], err_msg=name)
    _assert_scores(ref_out, port_out)
    feasible = ref_out["feasible"]
    if kind in ("none_feasible", "all_masked"):
        assert not feasible.any() and int(port_out["best"]) == 0
        assert np.isneginf(port_out["score"]).all()
    else:
        assert feasible.any() and not feasible.all()
        # an ineligible node is never feasible, whatever its victims free
        assert not (feasible & ~args[3]).any()


def _slack_near_zero(args, order, row, prefixes) -> bool:
    capacity, used, ask, _, res, _, mask = args
    ordered = np.where(mask[row][order[row]][:, None], res[row][order[row]], 0.0)
    freed = np.cumsum(ordered.astype(np.float64), axis=0)
    for i in prefixes:
        if 0 <= i < len(freed):
            slack = capacity[row] - (used[row] - freed[i] + ask)
            if np.abs(slack).min() <= FRACTIONAL_SLACK:
                return True
    return False


@pytest.mark.parametrize("case", ["exercise", "wide"])
def test_programs_match_reference_on_fractional_inputs(monkeypatch, case):
    args = _exercise_fractional() if case == "exercise" else _fractional_wide()
    ref_out, port_out = _both(monkeypatch, args)
    np.testing.assert_array_equal(port_out["order"], ref_out["order"])
    differs = (
        (port_out["k"] != ref_out["k"])
        | (port_out["feasible"] != ref_out["feasible"])
        | (port_out["net"] != ref_out["net"])
    )
    for row in np.flatnonzero(differs):
        ks = {int(ref_out["k"][row]), int(port_out["k"][row])}
        assert _slack_near_zero(args, ref_out["order"], row, [k - 1 for k in ks]), row
    same = ~differs
    assert same.mean() > 0.99
    r, p = ref_out["score"][same], port_out["score"][same]
    np.testing.assert_array_equal(np.isneginf(p), np.isneginf(r))
    fin = np.isfinite(r)
    np.testing.assert_allclose(p[fin], r[fin], rtol=RTOL, atol=ATOL)


def test_wrappers_check_their_inputs():
    """Shapes and dtypes the kernels do not take are refused before a
    launch; every V up to the kernels' addressing limit passes, 4,097 and
    8,192 among them, and V past it names the limit."""
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in _inputs("random", 8, n=4)]
    bad = list(args)
    bad[5] = bad[5].to(torch.int64)
    with pytest.raises(ValueError, match="victim_prio"):
        port_preempt._check_pass("find_preemption", bad)

    def widened(v, device="cpu"):
        wide = [t.to(device) for t in args]
        wide[4] = torch.zeros((4, v, 4), device=device)
        wide[5] = torch.zeros((4, v), dtype=torch.int32, device=device)
        wide[6] = torch.zeros((4, v), dtype=torch.bool, device=device)
        return wide

    for v in (4097, 8192):
        port_preempt._check_pass("choose_preemption_node", widened(v))
    # past the limit only the shape is looked at: meta tensors hold no data
    limit = port_preempt.MAX_VICTIM_WIDTH
    port_preempt._check_pass("find_preemption", widened(limit, "meta"))
    with pytest.raises(ValueError, match=f"MAX_VICTIM_WIDTH = {limit}"):
        port_preempt._check_pass("choose_preemption_node", widened(limit + 1, "meta"))
    port_preempt._check_pass("find_preemption", args)


def _wide_inputs(v: int, n: int = 8, seed: int = 31):
    """The preemption inputs of ``chip_smoke.py``'s phase 7 at a wide V:
    0..V integer victims a node at four batch priorities, the node's
    usage a share of its victims' total (8 / V of it), so that a short
    prefix frees room and every prefix sum up to it stays exact."""
    rng = np.random.default_rng(seed + v)
    cap = np.tile(np.array([3900, 7936, 98304, 1000], np.float32), (n, 1))
    nv = rng.integers(0, v + 1, n)
    mask = np.arange(v)[None, :] < nv[:, None]
    res = np.stack([
        rng.integers(100, 1500, (n, v)), rng.integers(128, 2048, (n, v)),
        rng.integers(0, 4000, (n, v)), rng.integers(0, 100, (n, v)),
    ], -1).astype(np.float32)
    prio = rng.choice([10, 20, 30, 40], (n, v)).astype(np.int32)
    res[~mask] = 0.0
    prio[~mask] = 0
    used = res.sum(axis=1) * (1.0 / max(v / 8, 1)) + np.array([100, 256, 4096, 0])
    ask = np.array([1000, 1024, 300, 10], np.float32)
    eligible = rng.random(n) < 0.9
    return cap, np.floor(used).astype(np.float32), ask, eligible, res, prio, mask


@pytest.mark.parametrize("v", [5000, 8192])
def test_programs_match_reference_past_the_old_block_limit(monkeypatch, v):
    """V above 4,096, where the card once refused: the plain versions
    against the reference's jitted programs, order, k and feasible
    identical, net and score within the file's tolerances."""
    args = _wide_inputs(v)
    ref_out, port_out = _both(monkeypatch, args)
    for name in ("best", "feasible", "k", "order"):
        np.testing.assert_array_equal(port_out[name], ref_out[name], err_msg=name)
    np.testing.assert_allclose(port_out["net"], ref_out["net"], rtol=RTOL, atol=ATOL)
    _assert_scores(ref_out, port_out)
    assert ref_out["feasible"].any()
    assert int(ref_out["k"].max()) > 1


def test_preemption_score_and_distance_match_reference():
    net = np.array([0, 100, 1024, 2047, 2048, 2049, 4096, 9000], np.float32)
    np.testing.assert_allclose(
        port_preempt.preemption_score(torch.from_numpy(net)).numpy(),
        np.asarray(ref_preempt.preemption_score(net)), rtol=RTOL, atol=ATOL,
    )
    rng = np.random.default_rng(3)
    ask = np.array([1000, 0, 300, 10], np.float32)
    victims = rng.integers(0, 5000, (50, 4)).astype(np.float32)
    # against the distance the reference's jitted kernel computes: XLA
    # fuses the sum of squares into a chain of fused multiply-adds, which
    # the op-by-op eager call does not (ROADMAP C-P3)
    np.testing.assert_array_equal(
        port_preempt.resource_distance(torch.from_numpy(ask), torch.from_numpy(victims)).numpy(),
        np.asarray(jax.jit(ref_preempt.resource_distance)(ask, victims)),
    )


# -- the host drivers on one store ----------------------------------------------


def _loaded_store(n_nodes=24, seed=7):
    """A reference store: mock nodes holding allocs of five jobs at
    priorities 10–70 (batch and service, one with a migrate strategy, one
    holding a reserved port), some terminal."""
    rng = np.random.default_rng(seed)
    s = RefStore()
    nodes = [ref_mock.node() for _ in range(n_nodes)]
    for i, n in enumerate(nodes):
        s.upsert_node(i + 1, n)
    jobs = []
    for prio, cpu, mem in ((10, 900, 1500), (20, 700, 1200), (30, 1100, 900),
                           (40, 500, 2048), (70, 800, 1024)):
        j = ref_mock.batch_job(priority=prio) if prio < 40 else ref_mock.job(priority=prio)
        t = j.task_groups[0].tasks[0]
        t.resources.cpu, t.resources.memory_mb = cpu, mem
        if prio == 20:
            j.task_groups[0].migrate = MigrateStrategy(max_parallel=1)
        if prio == 30:
            t.resources.networks = [NetworkResource(mbits=10, reserved_ports=[8080])]
        jobs.append(j)
        s.upsert_job(100 + prio, j)
    allocs = []
    for n in nodes:
        for _ in range(int(rng.integers(1, 5))):
            j = jobs[int(rng.integers(0, len(jobs)))]
            a = ref_mock.alloc(j, n)
            if rng.random() < 0.1:
                a.client_status = "complete"
                a.desired_status = "stop"
            allocs.append(a)
    s.upsert_allocs(200, allocs)
    return s, nodes, jobs, allocs


def _port_store(nodes, jobs, allocs):
    return interop.store_from_records(
        [dataclasses.asdict(n) for n in nodes],
        [dataclasses.asdict(j) for j in jobs],
        [dataclasses.asdict(a) for a in allocs],
    )


@pytest.fixture
def loaded():
    s, nodes, jobs, allocs = _loaded_store()
    port = _port_store(nodes, jobs, allocs)
    ref_snap, port_snap = s.snapshot(), port.snapshot()
    ref_ct, port_ct = ref_flatten_cluster(ref_snap), port_flatten_cluster(port_snap)
    assert ref_ct.node_ids == port_ct.node_ids
    np.testing.assert_array_equal(ref_ct.used, port_ct.used)
    return ref_snap, port_snap, ref_ct, port_ct, allocs


@pytest.mark.parametrize("priority", [25, 50, 80])
def test_build_victim_tensors_matches_reference(loaded, priority):
    ref_snap, port_snap, ref_ct, port_ct, allocs = loaded
    job = ref_mock.job(priority=priority)
    exclude = frozenset(a.id for a in allocs[::7])
    ref = ref_preempt.build_victim_tensors(ref_ct, ref_snap, job, exclude_ids=exclude)
    port = port_preempt.build_victim_tensors(
        port_ct, port_snap, job, exclude_ids=exclude, device="cpu"
    )
    for r, p in zip(ref[:3], port[:3]):
        assert isinstance(p, torch.Tensor) and p.device.type == "cpu"
        np.testing.assert_array_equal(p.numpy(), r)
    assert port[3] == ref[3]
    assert not any(i in exclude for ids in port[3] for i in ids)


@pytest.mark.parametrize("priority", [50, 80])
@pytest.mark.parametrize("ask", [(1000, 1024, 300, 0), (2500, 4096, 300, 10)])
def test_rank_and_find_preemptions_match_reference(monkeypatch, loaded, priority, ask):
    ref_snap, port_snap, ref_ct, port_ct, allocs = loaded
    job = ref_mock.job(priority=priority)
    ask = np.array(ask, np.float32)
    eligible = ref_ct.ready.copy()
    eligible[::5] = False
    exclude = frozenset(a.id for a in allocs[::9])
    with reference_runtime(monkeypatch):
        ref_rank = ref_preempt.rank_preemption_nodes(
            ref_ct, ref_snap, job, ask, eligible, exclude_ids=exclude
        )
        ref_find = ref_preempt.find_preemptions(
            ref_ct, ref_snap, job, ask, eligible, exclude_ids=exclude
        )
    port_rank = port_preempt.rank_preemption_nodes(
        port_ct, port_snap, job, ask, eligible, exclude_ids=exclude, device="cpu"
    )
    port_find = port_preempt.find_preemptions(
        port_ct, port_snap, job, ask, eligible, exclude_ids=exclude, device="cpu"
    )
    assert port_rank == ref_rank and len(ref_rank) > 0
    assert port_find == ref_find and ref_find[0] is not None


def test_host_drivers_default_to_cuda(monkeypatch, loaded):
    _, port_snap, _, port_ct, _ = loaded
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    job = port_mock.job(priority=80)
    ask = np.array([1000, 1024, 300, 0], np.float32)
    for call in (
        lambda: port_preempt.build_victim_tensors(port_ct, port_snap, job),
        lambda: port_preempt.rank_preemption_nodes(port_ct, port_snap, job, ask, port_ct.ready),
        lambda: port_preempt.find_preemptions(port_ct, port_snap, job, ask, port_ct.ready),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


# -- exact host victim selection: tests/test_preemption_vectors.py's fixtures ---


def _vector_state(allocs_spec, node=None):
    """test_preemption_vectors.build_state: one node, one job per spec
    (priority, cpu, mem_mb, disk_mb, extras)."""
    s = RefStore()
    node = node or ref_mock.node()
    s.upsert_node(1, node)
    jobs, allocs = [], []
    idx = 10
    for spec in allocs_spec:
        prio, cpu, mem, disk = spec[:4]
        extras = spec[4] if len(spec) > 4 else {}
        j = ref_mock.job(priority=prio)
        t = j.task_groups[0].tasks[0]
        t.resources.cpu, t.resources.memory_mb, t.resources.disk_mb = cpu, mem, disk
        if "ports" in extras or "mbits" in extras:
            t.resources.networks = [
                NetworkResource(
                    mbits=extras.get("mbits", 0),
                    reserved_ports=list(extras.get("ports", [])),
                )
            ]
        if "migrate_parallel" in extras:
            j.task_groups[0].migrate = MigrateStrategy(max_parallel=extras["migrate_parallel"])
        s.upsert_job(idx, j)
        a = ref_mock.alloc(j, node)
        if "devices" in extras:
            a.allocated_devices = extras["devices"]
        s.upsert_allocs(idx + 1, [a])
        jobs.append(j)
        allocs.append(a)
        idx += 2
    return s, node, jobs, allocs


def _gpu_node(n_instances=4):
    node = ref_mock.node()
    node.node_resources.devices = [
        NodeDeviceResource(
            vendor="nvidia", type="gpu", name="1080ti",
            instances=[NodeDeviceInstance(id=f"gpu{i}", healthy=True) for i in range(n_instances)],
        ),
        NodeDeviceResource(
            vendor="intel", type="fpga", name="F100",
            instances=[
                NodeDeviceInstance(id="fpga1", healthy=True),
                NodeDeviceInstance(id="fpga2", healthy=False),
            ],
        ),
    ]
    return node


def _gpu(ids, dev=("nvidia", "gpu", "1080ti")):
    return {"devices": [AllocatedDeviceResource(
        vendor=dev[0], type=dev[1], name=dev[2], device_ids=list(ids)
    )]}


# (allocs_spec, job priority, ask vector, ask ports, device asks, node)
TG_VECTORS = {
    "no_preemption_high_priority_existing": (
        [(100, 3200, 7256, 4 * 1024)], 100, [2000, 256, 4 * 1024, 0], (), None),
    "preempting_everything_still_not_enough": (
        [(30, 3200, 7256, 4 * 1024)], 100, [4000, 8192, 4 * 1024, 0], (), None),
    "static_port_held_by_high_priority": (
        [(100, 1200, 2256, 4 * 1024, {"ports": [22]})], 100,
        [600, 1000, 4 * 1024, 0], (22,), None),
    "port_holder_low_priority_is_preempted": (
        [(30, 200, 256, 4 * 1024, {"ports": [22]})], 100,
        [600, 1000, 4 * 1024, 0], (22,), None),
    "all_lows_needed": (
        [(100, 2800, 2256, 40 * 1024, {"mbits": 150}),
         (30, 200, 256, 4 * 1024, {"mbits": 50}),
         (30, 200, 512, 25 * 1024),
         (30, 700, 276, 20 * 1024)], 100, [1000, 3000, 50 * 1024, 50], (), None),
    "close_priority_ignored": (
        [(30, 2800, 2256, 4 * 1024), (30, 200, 256, 4 * 1024)], 35,
        [1100, 1000, 25 * 1024, 0], (), None),
    "delta_boundary_exactly_ten": (
        [(90, 3500, 7000, 4 * 1024)], 100, [1000, 1000, 4 * 1024, 0], (), None),
    "superset_filter_drops_redundant_victim": (
        [(100, 1800, 2256, 4 * 1024, {"mbits": 150}),
         (30, 1500, 256, 5 * 1024, {"mbits": 100}),
         (30, 600, 256, 5 * 1024, {"mbits": 300})], 100, [1000, 256, 5 * 1024, 50], (), None),
    "one_instance_per_alloc": (
        [(30, 500, 256, 300, _gpu(["gpu0"])), (30, 500, 256, 300, _gpu(["gpu1"]))],
        100, [500, 256, 300, 0], (), (4, "nvidia/gpu/1080ti")),
    "multiple_devices_used": (
        [(30, 500, 256, 300, _gpu(["gpu0", "gpu1", "gpu2", "gpu3"])),
         (30, 500, 256, 300, _gpu(["fpga1"], ("intel", "fpga", "F100")))],
        100, [500, 256, 300, 0], (), (4, "nvidia/gpu/1080ti")),
    "more_instances_than_exist": (
        [(30, 500, 256, 300, _gpu(["gpu0"]))], 100, [500, 256, 300, 0], (),
        (6, "nvidia/gpu/1080ti")),
    "high_priority_holders_block_device_preemption": (
        [(100, 500, 256, 300, _gpu(["gpu0", "gpu1"])),
         (30, 500, 256, 300, _gpu(["gpu2", "gpu3"]))], 100, [500, 256, 300, 0], (),
        (4, "nvidia/gpu/1080ti")),
    "low_holder_alone_suffices": (
        [(100, 500, 256, 300, _gpu(["gpu0", "gpu1"])),
         (30, 500, 256, 300, _gpu(["gpu2", "gpu3"]))], 100, [500, 256, 300, 0], (),
        (2, "nvidia/gpu/1080ti")),
}


@pytest.mark.parametrize("name", sorted(TG_VECTORS))
def test_select_victims_matches_reference_on_vectors(name):
    spec, prio, ask, ports, devices = TG_VECTORS[name]
    s, node, jobs, allocs = _vector_state(
        spec, node=_gpu_node() if devices is not None else None
    )
    port = _port_store([node], jobs, allocs)
    job = ref_mock.job(priority=prio)
    tg = job.task_groups[0]
    if ports:
        tg.tasks[0].resources.networks = [NetworkResource(reserved_ports=list(ports))]
    if devices is not None:
        tg.tasks[0].resources.devices = [RequestedDevice(name=devices[1], count=devices[0])]
    port_job = interop.from_record(PortJob, dataclasses.asdict(job))
    ask = np.asarray(ask, np.float32)
    ref_snap, port_snap = s.snapshot(), port.snapshot()
    ref_ct, port_ct = ref_flatten_cluster(ref_snap), port_flatten_cluster(port_snap)
    row = ref_ct.row_of(node.id)
    assert port_ct.row_of(node.id) == row
    ref_ids = ref_host.select_victims(ref_ct, ref_snap, job, tg, ask, row)
    port_ids = port_host.select_victims(
        port_ct, port_snap, port_job, port_job.task_groups[0], ask, row
    )
    assert port_ids == ref_ids
    if devices is not None:
        ref_dev = ref_host.preempt_for_devices(ref_snap, node, job, tg)
        port_dev = port_host.preempt_for_devices(
            port_snap, port_snap.node_by_id(node.id), port_job, port_job.task_groups[0]
        )
        assert (port_dev is None) == (ref_dev is None)
        if ref_dev is not None:
            assert {c.alloc.id for c in port_dev} == {c.alloc.id for c in ref_dev}


def test_existing_evictions_penalized_matches_reference():
    """test_preemption_vectors' maxParallel case (preemption_test.go:910):
    a job already being preempted in-plan is steered away from."""
    s, node, jobs, allocs = _vector_state([
        (100, 1200, 2256, 4 * 1024, {"mbits": 150}),
        (30, 200, 256, 4 * 1024, {"mbits": 500}),
        (30, 200, 256, 4 * 1024, {"mbits": 300, "migrate_parallel": 1}),
    ])
    port = _port_store([node], jobs, allocs)
    low2 = jobs[2]
    prior = {((low2.namespace, low2.id), low2.task_groups[0].name): 1}
    ask = np.array([300.0, 500.0, 5 * 1024.0, 320.0])
    job = ref_mock.job(priority=100)
    out = []
    for host, store in ((ref_host, s), (port_host, port)):
        snap = store.snapshot()
        ct = (ref_flatten_cluster if host is ref_host else port_flatten_cluster)(snap)
        row = ct.row_of(node.id)
        got = host.preempt_for_task_group(
            ct.capacity[row].astype(np.float64), ct.used[row].astype(np.float64),
            ask, host.collect_candidates(snap, node.id, job), prior_counts=prior,
        )
        out.append([c.alloc.id for c in got])
    assert out[0] == out[1] == [allocs[1].id]
    assert port_host.basic_resource_distance(
        np.array([1000.0, 256.0, 5120.0, 0.0]), np.array([1500.0, 256.0, 5120.0, 0.0])
    ) == ref_host.basic_resource_distance(
        np.array([1000.0, 256.0, 5120.0, 0.0]), np.array([1500.0, 256.0, 5120.0, 0.0])
    )


# -- whole evaluations ---------------------------------------------------------


def _low_job(prio, count, cpu=1800, mem=3500, make=None):
    j = (make or ref_mock.job)(priority=prio)
    j.task_groups[0].count = count
    j.task_groups[0].tasks[0].resources.cpu = cpu
    j.task_groups[0].tasks[0].resources.memory_mb = mem
    return j


def _plan_view(h, job):
    """What an eval of ``job`` planned: its placements (node, name,
    victims) and every eviction with its preemptor's node."""
    placed = sorted(
        (a.node_id, a.name, tuple(sorted(a.preempted_allocations)))
        for a in h.store.allocs_by_job(job.namespace, job.id)
        if not a.terminal_status()
    )
    evicted = sorted(
        (a.id, a.node_id, a.job_id)
        for a in h.store.allocs()
        if a.desired_status == ALLOC_DESIRED_EVICT
    )
    return placed, evicted


def _run_both(monkeypatch, nodes, ballast, ballast_allocs, job, config):
    """Ballast jobs and allocs into the reference store, the same records
    into the port's, then one eval of ``job`` through both Harnesses."""
    ref = RefHarness()
    ref.store.set_scheduler_config(1, RefSchedulerConfiguration(**config))
    for i, n in enumerate(nodes):
        ref.store.upsert_node(2 + i, n)
    for j in ballast + [job]:
        ref.store.upsert_job(ref.next_index(), j)
    ref.store.upsert_allocs(ref.next_index(), ballast_allocs)
    records = (
        [dataclasses.asdict(n) for n in nodes],
        [dataclasses.asdict(j) for j in ballast + [job]],
        [dataclasses.asdict(a) for a in ballast_allocs],
    )
    port = PortHarness(interop.store_from_records(*records), device="cpu")
    port.store.set_scheduler_config(port.next_index(), PortSchedulerConfiguration(**config))
    port_job = port.store.job_by_id(job.namespace, job.id)
    with reference_runtime(monkeypatch):
        ref.process(ref_mock.eval_for(job, id="eval-preemptor"))
    port.process(port_mock.eval_for(port_job, id="eval-preemptor"))
    return ref, port, port_job


def _filled(n_nodes, lows, per_node):
    """Nodes each holding ``per_node`` allocs, cycling through ``lows``."""
    nodes = [ref_mock.node() for _ in range(n_nodes)]
    allocs = []
    for i, n in enumerate(nodes):
        for k in range(per_node):
            a = ref_mock.alloc(lows[(i + k) % len(lows)], n)
            a.name = f"{a.job_id}.web[{i * per_node + k}]"
            allocs.append(a)
    return nodes, allocs


SCENARIOS = {
    # tests/test_preemption.py::test_high_priority_job_preempts
    "high_priority_job_preempts": dict(
        n_nodes=2, lows=[(10, 4)], per_node=2, job=(90, 1, 2000, 1024),
        config=dict(preemption_service_enabled=True)),
    # ::test_preemption_creates_victim_job_evals
    "creates_victim_job_evals": dict(
        n_nodes=1, lows=[(10, 2)], per_node=2, job=(90, 1, 2000, 256),
        config=dict(preemption_service_enabled=True)),
    # ::test_preemption_disabled_blocks_instead
    "disabled_blocks_instead": dict(
        n_nodes=1, lows=[(10, 2)], per_node=2, job=(90, 1, 2000, 256), config={}),
    # ::test_minimal_lowest_priority_victims, driven as a whole eval
    "minimal_lowest_priority_victims": dict(
        n_nodes=1, lows=[(20, 1), (40, 1)], per_node=2, job=(70, 1, 1000, 256),
        config=dict(preemption_service_enabled=True)),
    # many nodes, four victim priorities, a batch preemptor several
    # groups' worth of allocs: shortlists reused and `used` updated
    "batch_many_nodes": dict(
        n_nodes=12, lows=[(20, 6), (30, 6), (40, 6), (75, 6)], per_node=2,
        job=(60, 9, 1500, 2048), config=dict(preemption_batch_enabled=True),
        batch=True),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_preemption_plans_match_reference(monkeypatch, name):
    sc = SCENARIOS[name]
    lows = [
        _low_job(prio, count, make=ref_mock.batch_job if prio < 75 and sc.get("batch") else None)
        for prio, count in sc["lows"]
    ]
    nodes, allocs = _filled(sc["n_nodes"], lows, sc["per_node"])
    prio, count, cpu, mem = sc["job"]
    job = _low_job(prio, count, cpu, mem, make=ref_mock.batch_job if sc.get("batch") else None)
    ref, port, port_job = _run_both(monkeypatch, nodes, lows, allocs, job, sc["config"])

    ref_view, port_view = _plan_view(ref, job), _plan_view(port, port_job)
    assert port_view == ref_view
    placed, evicted = ref_view
    preempting = bool(sc["config"])
    assert bool(evicted) == preempting
    if preempting:
        assert placed and all(victims for _, _, victims in placed[:1])
        victim_prios = {ref.store.job_by_id(job.namespace, j).priority for _, _, j in evicted}
        assert max(victim_prios) <= prio - 10
    else:
        assert placed == []

    def created(h):
        return sorted((e.triggered_by, e.job_id, e.status) for e in h.created_evals)

    assert created(port) == created(ref)
    if name == "creates_victim_job_evals":
        assert [e for e in created(ref) if e[0] == "preemption"] == [
            ("preemption", lows[0].id, "pending")
        ]
    assert [(e.id, e.status) for e in port.evals] == [(e.id, e.status) for e in ref.evals]


# -- launches -------------------------------------------------------------------


class _FakeEntry:
    """A C entry point of a stand-in library: records each call and
    returns the status it was given, as a refused or accepted launch."""

    def __init__(self, name, status, launched):
        self.name, self.status, self.launched = name, status, launched
        self.argtypes = None

    def __call__(self, *args):
        self.launched.append(self.name)
        return self.status


@pytest.mark.parametrize("status", [0, 1])
def test_wrappers_count_only_launches(monkeypatch, status):
    """Each wrapper's count moves by one for a launch the library
    accepted and by nothing for one it refused (which raises). At V <= 32
    the choice is one launch that carries the find pass (counted on
    ``find_preemption.carried``, not as a find launch); above, the choice
    runs the pass through ``find_preemption``, whose own count moves."""
    launched = []

    class Lib:
        nomad_find_preemption = _FakeEntry("find", 0, launched)
        nomad_choose_preemption_node = _FakeEntry("choose", status, launched)
        nomad_find_choose_preemption = _FakeEntry("find_choose", status, launched)
        nomad_find_preemption_scratch_words = _FakeEntry("scratch", 0, [])

    monkeypatch.setattr(port_preempt, "cuda_library", lambda name: Lib)
    monkeypatch.setattr(port_preempt, "current_stream", lambda dev: 0)
    monkeypatch.setattr(port_preempt, "_choice_scratch", {})
    # the CPU tensors here would route the wrapper to its plain version
    def find(*inputs):
        return port_preempt._launch_find(inputs)

    find.launches, find.forms, find.carried = 0, {}, 0
    monkeypatch.setattr(port_preempt, "find_preemption", find)
    for v, want, finds in ((8, ["find_choose"], 0), (64, ["find", "choose"], 1)):
        inputs = tuple(torch.from_numpy(a) for a in _inputs("random", v, n=16))
        launched.clear()
        choose_before = port_preempt.choose_preemption_node.launches
        find_before, carried_before = find.launches, find.carried
        if status:
            with pytest.raises(RuntimeError, match="cudaError 1"):
                port_preempt._launch_choose(inputs)
        else:
            best, feasible, k, net, order, score = port_preempt._launch_choose(inputs)
            assert best.shape == () and score.shape == feasible.shape == (16,)
            assert order.shape == (16, v)
        assert launched == want
        assert find.launches - find_before == finds
        assert find.carried - carried_before == (finds == 0 and status == 0)
        assert port_preempt.choose_preemption_node.launches - choose_before == (status == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("v", [8192, 32768])
def test_cuda_wide_find_matches_plain_version(v):
    """On the card: the find pass on wide rows (a row over a thread-block
    cluster at V 8,192 and 32,768) and the choice on it, every output
    identical to the plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    t = [torch.from_numpy(a).cuda() for a in _wide_inputs(v, n=64)]
    got = port_preempt.find_preemption(*t)
    want = port_preempt.find_preemption_plain(*t)
    torch.cuda.synchronize()
    for name, g, w in zip(OUTPUTS[1:5], got, want):
        assert torch.equal(g.cpu(), w.cpu()), name
    got = port_preempt.choose_preemption_node(*t)
    want = port_preempt.choose_preemption_node_plain(*t)
    torch.cuda.synchronize()
    for name, g, w in zip(OUTPUTS, got, want):
        assert torch.equal(g.cpu(), w.cpu()), name


@pytest.mark.cuda
@pytest.mark.parametrize("v", [8, 64, 256])
def test_cuda_kernels_match_plain_versions(v):
    """On the card: both kernels against their plain versions on integer
    inputs (at V 8 the choice's launch carrying the warp form, a warp a
    row above 32) — every output
    identical, scores exact (the comparison chip_smoke.py makes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    for kind in ("random", "ties"):
        t = [torch.from_numpy(a).cuda() for a in _inputs(kind, v, n=2048)]
        got = port_preempt.choose_preemption_node(*t)
        want = port_preempt.choose_preemption_node_plain(*t)
        torch.cuda.synchronize()
        for name, g, w in zip(OUTPUTS, got, want):
            assert torch.equal(g.cpu(), w.cpu()), (kind, name)
