"""ClusterTensors and GroupAsk built by the port equal the reference's,
field for field, from the same records carried across by
``nomad_tpu_torch.interop``.

Tolerance: none. Flattening is host NumPy code copied from the
reference, so every array must be identical (``assert_array_equal``,
NaN-free inputs) and every dict and list equal."""

import dataclasses

import numpy as np
import pytest

from nomad_tpu import mock as ref_mock
from nomad_tpu.device import flatten as ref_flatten
from nomad_tpu.device import parity as ref_parity
from nomad_tpu.state import StateStore as RefStore
from nomad_tpu.structs import Affinity as RefAffinity
from nomad_tpu.structs import Constraint as RefConstraint
from nomad_tpu_torch import interop
from nomad_tpu_torch.device import flatten as port_flatten

CT_FIELDS = [
    "node_ids", "index", "num_nodes", "capacity", "used", "ready", "dc_ids",
    "class_ids", "dc_vocab", "class_vocab", "class_rep", "node_row",
    "device_class_ids", "device_class_vocab", "topo_rack_ids",
    "topo_pod_ids", "topo_ici_ids", "topo_rack_vocab", "topo_pod_vocab",
    "topo_ici_vocab", "attr_cache", "dc_ready_counts", "region_ids",
    "region_vocab", "layout_gen",
]
ASK_ARRAYS = [
    "ask", "eligible", "job_counts", "penalty_nodes", "affinity_scores",
    "slot_caps", "throughputs",
]
ASK_SCALARS = [
    "job_id", "tg_name", "count", "desired_total", "has_affinities",
    "distinct_hosts", "filter_stats", "has_throughputs", "profile",
    "priority", "gang_member", "gang_weight_rack", "gang_weight_pod",
    "gang_weight_ici",
]


def _eq(a, b, what):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert a is not None and b is not None, what
        assert a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


def _assert_ct_equal(ref, port):
    port_names = {f.name for f in dataclasses.fields(port)}
    assert set(CT_FIELDS) <= port_names
    for name in CT_FIELDS:
        _eq(getattr(ref, name), getattr(port, name), name)
    assert [n.id for n in port.nodes] == [n.id for n in ref.nodes]


def _assert_ask_equal(ref, port):
    for name in ASK_ARRAYS:
        r, p = getattr(ref, name), getattr(port, name)
        if r is None:
            assert p is None, name
        else:
            _eq(r, p, name)
    for name in ASK_SCALARS:
        _eq(getattr(ref, name), getattr(port, name), name)
    assert (ref.blocks is None) == (port.blocks is None)
    if ref.blocks is not None:
        for f in dataclasses.fields(ref.blocks):
            _eq(getattr(ref.blocks, f.name), getattr(port.blocks, f.name), f.name)


def _records(seed: int):
    """Reference mock nodes/jobs/allocs: three classes, two datacenters,
    a node-class constraint, an affinity, a distinct_hosts job and a job
    with running allocs (so job_counts are live)."""
    rng = np.random.default_rng(seed)
    nodes = []
    for i in range(60):
        n = ref_mock.node(
            datacenter="dc1" if i % 3 else "dc2",
            node_class=["small", "medium", "large"][i % 3],
        )
        n.attributes["rack"] = f"r{i % 5}"
        if i % 7 == 0:
            n.drivers = {"exec": False}
        n.compute_class()
        nodes.append(n)
    web = ref_mock.job(datacenters=["dc1", "dc2"])
    web.task_groups[0].count = 25
    web.task_groups[0].affinities = [
        RefAffinity(l_target="${node.class}", r_target="large", operand="=", weight=50)
    ]
    dh = ref_mock.job()
    dh.constraints = [RefConstraint(operand="distinct_hosts")]
    cls = ref_mock.job(datacenters=["dc1"])
    cls.constraints = [
        RefConstraint(l_target="${node.class}", r_target="small", operand="!=")
    ]
    allocs = []
    for i in range(8):
        a = ref_mock.alloc(web, nodes[int(rng.integers(0, len(nodes)))])
        a.name = f"{web.id}.web[{i}]"
        allocs.append(a)
    return nodes, [web, dh, cls], allocs


def _stores(seed: int):
    nodes, jobs, allocs = _records(seed)
    ref = RefStore()
    for n in nodes:
        ref.upsert_node(1, n)
    for j in jobs:
        ref.upsert_job(2, j)
    ref.upsert_allocs(3, allocs)
    # records of the stored objects: the upserts' own stamps (indexes,
    # versions) repeat identically on the port's side
    rec = dataclasses.asdict
    port = interop.store_from_records(
        [rec(n) for n in nodes], [rec(j) for j in jobs], [rec(a) for a in allocs]
    )
    return ref, port, jobs


@pytest.mark.parametrize("seed", [0, 1])
def test_cluster_and_asks_equal_from_the_same_records(seed):
    ref_store, port_store, jobs = _stores(seed)
    ref_snap, port_snap = ref_store.snapshot(), port_store.snapshot()
    ref_ct = ref_flatten.flatten_cluster(ref_snap)
    port_ct = port_flatten.flatten_cluster(port_snap)
    _assert_ct_equal(ref_ct, port_ct)
    for job in jobs:
        pjob = port_snap.job_by_id(job.namespace, job.id)
        for tg, ptg in zip(job.task_groups, pjob.task_groups):
            ref_ga = ref_flatten.flatten_group_ask(ref_ct, ref_snap, job, tg, tg.count)
            port_ga = port_flatten.flatten_group_ask(port_ct, port_snap, pjob, ptg, ptg.count)
            _assert_ask_equal(ref_ga, port_ga)
    # the attribute columns built lazily by the asks agree too
    _eq(ref_ct.attr_cache.keys() == port_ct.attr_cache.keys(), True, "attr keys")


def test_interop_cluster_and_asks_round_trip():
    ref_ct, ref_asks = ref_parity.build_config4(n_nodes=64, n_jobs=2, count=10)
    fields = {f.name: getattr(ref_ct, f.name) for f in dataclasses.fields(ref_ct)}
    port_ct = interop.cluster_from_numpy(fields)
    _assert_ct_equal(ref_ct, port_ct)
    assert port_ct.capacity is not ref_ct.capacity  # copied, not aliased
    port_asks = interop.asks_from_numpy([dataclasses.asdict(a) for a in ref_asks])
    for r, p in zip(ref_asks, port_asks):
        _assert_ask_equal(r, p)
        assert type(p.blocks) is port_flatten.ValueBlocks


def test_interop_rejects_unknown_cluster_fields():
    with pytest.raises(ValueError, match="unknown"):
        interop.cluster_from_numpy({"bogus": 1})


def test_store_from_records_rebuilds_nested_structs():
    ref_store, port_store, jobs = _stores(3)
    for job in jobs:
        pjob = port_store.job_by_id(job.namespace, job.id)
        assert dataclasses.asdict(pjob) == dataclasses.asdict(
            ref_store.job_by_id(job.namespace, job.id)
        )
        assert type(pjob.task_groups[0].tasks[0].resources).__module__.startswith(
            "nomad_tpu_torch."
        )
    ref_allocs = sorted(ref_store.allocs(), key=lambda a: a.id)
    port_allocs = sorted(port_store.allocs(), key=lambda a: a.id)
    assert [dataclasses.asdict(a) for a in ref_allocs] == [
        dataclasses.asdict(a) for a in port_allocs
    ]
    assert port_store.latest_index == ref_store.latest_index


def test_device_cache_keeps_capacity_resident_until_nodes_change():
    """The cache uploads capacity once per layout generation and again
    only when a refresh rewrote capacity rows; alloc churn reuses it."""
    import torch

    from nomad_tpu_torch import mock
    from nomad_tpu_torch.device.cache import DeviceStateCache
    from nomad_tpu_torch.state import StateStore
    from nomad_tpu_torch.structs import NodeResources

    store = StateStore()
    nodes = [mock.node() for _ in range(10)]
    for n in nodes:
        store.upsert_node(1, n)
    cache = DeviceStateCache("cpu")
    ct1 = cache.tensors(store.snapshot())
    job = mock.job()
    store.upsert_job(2, job)
    store.upsert_allocs(3, [mock.alloc(job, nodes[0])])
    ct2 = cache.tensors(store.snapshot())
    assert cache.incremental_refreshes == 1
    assert ct2.device_capacity is ct1.device_capacity
    assert ct2.used[ct2.node_row[nodes[0].id]].sum() > 0
    bigger = dataclasses.replace(
        nodes[1], node_resources=NodeResources(cpu=8000, memory_mb=8192, disk_mb=102400)
    )
    store.upsert_node(4, bigger)
    ct3 = cache.tensors(store.snapshot())
    assert ct3.device_capacity is not ct1.device_capacity
    assert torch.equal(ct3.device_capacity, torch.from_numpy(ct3.capacity))
    assert ct3.capacity[ct3.node_row[bigger.id], 0] > ct1.capacity[ct1.node_row[bigger.id], 0]
