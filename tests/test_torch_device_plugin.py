"""The port's out-of-process device plugins
(``nomad_tpu_torch.client.device_plugin``) against the JAX package's, on
the CPU, and the port's ``torch.cuda`` plugin.

- The 5 scenarios of the reference's ``tests/test_device_plugin.py`` on
  both packages: the fake plugin's groups, reservations and stats over
  the stdio transport, a respawn after the plugin's death, an unknown
  plugin refused, and a dev agent whose node advertises the fake group
  and whose task gets the reservation's env. Every outcome both give must
  be equal.
- ``TorchDevicePlugin`` (the port's counterpart of the reference's
  ``JaxDevicePlugin``) with ``torch.cuda`` replaced by a table of two
  named cards: one ``nvidia/gpu/<name>`` group, instances ``cuda-0`` and
  ``cuda-1``, ``reserve(["cuda-1"])`` giving ``CUDA_VISIBLE_DEVICES=1``
  and nothing else; ``[]`` where CUDA is absent; a broken CUDA raising
  into the client's log instead of an empty table. Where the table must
  cross a process, the plugin host is this package's launcher run with
  the table installed first (``python -c``).
- A ``cuda``-marked test of the real plugin, which skips without a card.
- A small GPU fleet through both packages' Harness: 64 nodes, 16 of them
  with an 8-instance group; 3 jobs x 10 allocs asking 1, 2 and 1
  instances (the last with a device affinity): the same ``(job, node)``
  counts and the same device ids per node, none assigned twice.
- ROADMAP C-R12, the JAX package's merged commit admitting one instance
  to two members: the plan applier's verdicts on two members holding the
  same, overlapping and distinct instances of one node (the reference
  admits both every time), and the port's server with one batching
  worker holding each instance of a small GPU fleet once.

The reference schedules through its ``traced_jit`` kernels under the
scoped ``reference_runtime`` shim (ROADMAP C-R1); the port runs on the
CPU. No numeric tolerance applies: everything compared is exact.
"""

import collections
import dataclasses
import io
import json
import logging
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import pytest
import torch

from nomad_tpu import mock as ref_mock
from nomad_tpu.agent import DevAgent as RefDevAgent
from nomad_tpu.client import device_plugin as ref_dp
from nomad_tpu.scheduler import Harness as RefHarness
from nomad_tpu.state import StateStore as RefStore
from nomad_tpu.structs import Affinity as RefAffinity
from nomad_tpu.structs.resources import NodeDeviceInstance as RefInstance
from nomad_tpu.structs.resources import NodeDeviceResource as RefDeviceResource
from nomad_tpu.structs.resources import RequestedDevice as RefRequestedDevice
from nomad_tpu_torch import interop
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch.agent import DevAgent
from nomad_tpu_torch.client import device_plugin as port_dp
from nomad_tpu_torch.client.client import Client
from nomad_tpu_torch.scheduler import Harness as PortHarness
from nomad_tpu_torch.structs.resources import RequestedDevice
from test_torch_hetero import reference_runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 30.0
CARD = "NVIDIA H100 80GB HBM3"

REF = SimpleNamespace(name="reference", dp=ref_dp, mock=ref_mock, DevAgent=RefDevAgent,
                      RequestedDevice=RefRequestedDevice, agent_kw={})
PORT = SimpleNamespace(name="port", dp=port_dp, mock=port_mock, DevAgent=DevAgent,
                       RequestedDevice=RequestedDevice, agent_kw={"device": "cpu"})


def both(fn):
    """``fn(package)`` on the reference and on the port, at once in two
    threads: (reference result, port result)."""
    with ThreadPoolExecutor(2) as pool:
        ref, port = pool.submit(fn, REF), pool.submit(fn, PORT)
        return ref.result(), port.result()


@pytest.fixture()
def fake_devices(monkeypatch):
    monkeypatch.setenv("NOMAD_FAKE_DEVICES", "acme/gpu/model-x:3")


def groups_view(groups):
    return [dataclasses.asdict(g) for g in groups]


# -- TestDevicePluginProtocol --------------------------------------------------


def test_fingerprint_over_subprocess(fake_devices):
    def run(pkg):
        dp = pkg.dp.DevicePluginClient("fake")
        try:
            return groups_view(dp.fingerprint())
        finally:
            dp.close()

    ref, port = both(run)
    assert port == ref
    assert [(g["vendor"], g["type"], g["name"]) for g in port] == [("acme", "gpu", "model-x")]
    assert [i["id"] for i in port[0]["instances"]] == ["model-x-0", "model-x-1", "model-x-2"]
    assert port[0]["attributes"]["memory_mb"] == 1024


def test_reserve_and_stats(fake_devices):
    def run(pkg):
        dp = pkg.dp.DevicePluginClient("fake")
        try:
            return dp.reserve(["model-x-0", "model-x-2"]), dp.stats()
        finally:
            dp.close()

    ref, port = both(run)
    assert port == ref
    res, stats = port
    assert res["envs"]["FAKE_VISIBLE_DEVICES"] == "model-x-0,model-x-2"
    assert "/dev/fake/model-x-0" in res["devices"]
    assert "model-x-0" in stats


def test_plugin_respawns_after_death(fake_devices):
    def run(pkg):
        dp = pkg.dp.DevicePluginClient("fake")
        try:
            first = groups_view(dp.fingerprint())
            dp._proc.kill()
            dp._proc.wait()
            return first, groups_view(dp.fingerprint())  # respawned transparently
        finally:
            dp.close()

    ref, port = both(run)
    assert port == ref
    assert port[0] == port[1] and port[0]


def test_unknown_plugin_rejected():
    def run(pkg):
        dp = pkg.dp.DevicePluginClient("nonexistent")
        with pytest.raises(RuntimeError) as e:
            dp.fingerprint()
        return str(e.value)

    ref, port = both(run)
    assert port == ref


# -- TestClientIntegration -----------------------------------------------------


def _device_job_run(pkg, data_dir):
    agent = pkg.DevAgent(data_dir=str(data_dir), num_workers=1, device_plugins=["fake"],
                         **pkg.agent_kw)
    agent.start()
    try:
        node = agent.client.node
        names = [d.name for d in node.node_resources.devices]
        attr = node.attributes.get("device.fake")
        owner = dict(agent.client.device_group_owner)
        job = pkg.mock.job()
        job.id = "dev-job"
        tg = job.task_groups[0]
        tg.count = 1
        task = tg.tasks[0]
        task.driver = "raw_exec"
        task.config = {"command": "/bin/sh", "args": ["-c", "echo dev=$FAKE_VISIBLE_DEVICES"]}
        task.resources.cpu = 50
        task.resources.memory_mb = 32
        task.resources.devices = [pkg.RequestedDevice(name="gpu", count=2)]
        agent.register_job(job)

        def output():
            allocs = [a for a in agent.store.allocs_by_job(job.namespace, job.id)
                      if a.allocated_devices]
            runner = agent.client.runners.get(allocs[0].id) if allocs else None
            if runner is None:
                return None
            out = os.path.join(runner.alloc_dir, task.name, f"{task.name}.stdout")
            text = open(out).read() if os.path.exists(out) else ""
            return (allocs[0], text) if "dev=" in text else None

        deadline = time.time() + WAIT_S
        while time.time() < deadline and output() is None:
            time.sleep(0.1)
        got = output()
        assert got is not None, f"{pkg.name}: device env did not reach the task"
        alloc, text = got
        ids = alloc.allocated_devices[0].device_ids
        return names, attr, owner, len(ids), all(did in text for did in ids)
    finally:
        agent.shutdown()


def test_devices_surface_on_node_and_env_reaches_task(fake_devices, tmp_path, monkeypatch):
    """A client with the fake device plugin: the node advertises the group
    and an alloc with assigned instances gets the reservation env."""
    with reference_runtime(monkeypatch):
        ref = _device_job_run(REF, tmp_path / "ref")
    port = _device_job_run(PORT, tmp_path / "port")
    assert port == ref
    assert port == (["model-x"], "3", {("acme", "gpu", "model-x"): "fake"}, 2, True)


# -- TorchDevicePlugin: the torch.cuda table -------------------------------------


def two_cards(monkeypatch, name=CARD):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: name)


def test_torch_plugin_reads_the_cuda_table(monkeypatch):
    two_cards(monkeypatch)
    plugin = port_dp.BUILTIN_DEVICE_PLUGINS["torch"]
    assert isinstance(plugin, port_dp.TorchDevicePlugin)
    assert sorted(port_dp.BUILTIN_DEVICE_PLUGINS) == ["fake", "torch"]
    assert plugin.fingerprint() == [{
        "vendor": "nvidia", "type": "gpu", "name": "nvidia-h100-80gb-hbm3",
        "instances": [{"id": "cuda-0", "healthy": True}, {"id": "cuda-1", "healthy": True}],
        "attributes": {"count": 2},
    }]
    res = plugin.reserve(["cuda-1"])
    assert res == {"envs": {"CUDA_VISIBLE_DEVICES": "1"}, "mounts": [], "devices": []}
    # the reference's rule for the ordinal (the digits after the last
    # "-") and for the name (``device_kind`` lowercased, spaces to "-"),
    # without its TPU variables
    ref_res = ref_dp.JaxDevicePlugin().reserve(["cuda-0", "cuda-1"])
    assert plugin.reserve(["cuda-0", "cuda-1"])["envs"] == {
        "CUDA_VISIBLE_DEVICES": ref_res["envs"]["CUDA_VISIBLE_DEVICES"]}
    assert plugin.stats() == {}


def test_torch_plugin_over_the_wire(monkeypatch):
    """The serve loop answers a fingerprint and a reservation with the
    table, and the host side builds the node's device group from it."""
    two_cards(monkeypatch)
    requests = "".join(json.dumps(r) + "\n" for r in (
        {"id": 1, "method": "fingerprint"},
        {"id": 2, "method": "reserve", "params": {"device_ids": ["cuda-1"]}},
        {"id": 3, "method": "shutdown"},
    ))
    out = io.StringIO()
    port_dp.serve_device_plugin(port_dp.TorchDevicePlugin(), stdin=io.StringIO(requests),
                                stdout=out)
    hs, fp, res, bye = [json.loads(line) for line in out.getvalue().splitlines()]
    assert hs == {"type": "handshake", "magic": port_dp.DEVICE_PLUGIN_MAGIC,
                  "version": port_dp.DEVICE_PROTO_VERSION, "plugin": "torch"}
    assert port_dp.DEVICE_PLUGIN_MAGIC == ref_dp.DEVICE_PLUGIN_MAGIC
    assert [i["id"] for i in fp["result"][0]["instances"]] == ["cuda-0", "cuda-1"]
    assert res["result"]["envs"] == {"CUDA_VISIBLE_DEVICES": "1"}
    assert bye == {"id": 3, "result": True}


def test_torch_plugin_without_cuda_advertises_nothing(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_table(*a, **kw):
        raise AssertionError("read the device table without CUDA")

    monkeypatch.setattr(torch.cuda, "device_count", no_table)
    monkeypatch.setattr(torch.cuda, "get_device_name", no_table)
    assert port_dp.TorchDevicePlugin().fingerprint() == []


def test_torch_plugin_subprocess_matches_this_host():
    """The launcher's ``torch`` plugin in its own process: no group on a
    host without CUDA (this one), one ``nvidia/gpu`` group of every
    visible card where there is one."""
    dp = port_dp.DevicePluginClient("torch")
    try:
        groups = dp.fingerprint()
    finally:
        dp.close()
    if not torch.cuda.is_available():
        assert groups == []
    else:
        assert [(g.vendor, g.type, len(g.instances)) for g in groups] == [
            ("nvidia", "gpu", torch.cuda.device_count())]


def patched_host(table: str) -> list:
    """This package's device-plugin launcher in a fresh interpreter, with
    ``torch.cuda`` replaced first by ``table`` (Python run before
    ``_main``)."""
    code = (
        "import sys, torch\n" + table +
        "from nomad_tpu_torch.client.device_plugin import _main\n"
        "sys.argv = ['device_plugin', 'torch']\n_main()\n"
    )
    return [sys.executable, "-c", code]


TWO_CARDS = (
    "torch.cuda.is_available = lambda: True\n"
    "torch.cuda.device_count = lambda: 2\n"
    f"torch.cuda.get_device_name = lambda device=None: {CARD!r}\n"
)
BROKEN = (
    "torch.cuda.is_available = lambda: True\n"
    "torch.cuda.device_count = lambda: 1\n"
    "def broken(device=None):\n"
    "    raise RuntimeError('CUDA error: unknown error')\n"
    "torch.cuda.get_device_name = broken\n"
)


def _client(tmp_path, monkeypatch, table):
    monkeypatch.setattr(port_dp.DevicePluginClient, "default_argv",
                        lambda self, name: patched_host(table))
    monkeypatch.chdir(REPO)
    return Client(rpc=None, data_dir=str(tmp_path), serve_endpoints=False,
                  device_plugins=["torch"])


def test_client_advertises_the_cards(tmp_path, monkeypatch):
    client = _client(tmp_path, monkeypatch, TWO_CARDS)
    try:
        node = client.node
        assert [(d.vendor, d.type, d.name, [i.id for i in d.instances])
                for d in node.node_resources.devices] == [
            ("nvidia", "gpu", "nvidia-h100-80gb-hbm3", ["cuda-0", "cuda-1"])]
        assert node.attributes["device.torch"] == "2"
        assert client.device_group_owner == {("nvidia", "gpu", "nvidia-h100-80gb-hbm3"): "torch"}
        assert client.device_plugins["torch"].reserve(["cuda-1"])["envs"] == {
            "CUDA_VISIBLE_DEVICES": "1"}
    finally:
        client.shutdown()
        for dp in client.device_plugins.values():
            dp.close()


def test_broken_cuda_surfaces_in_the_client_log(tmp_path, monkeypatch, caplog):
    """A CUDA that is present but fails is not a host without a GPU: the
    plugin's error reaches the client's log and no group is advertised."""
    caplog.set_level(logging.WARNING, logger="nomad_tpu_torch.client")
    client = _client(tmp_path, monkeypatch, BROKEN)
    try:
        assert client.node.node_resources.devices == []
        assert "device.torch" not in client.node.attributes
        assert client.device_plugins == {}
        failed = [r for r in caplog.records if r.getMessage() == "device plugin torch failed"]
        assert failed and "CUDA error: unknown error" in str(failed[0].exc_info[1])
    finally:
        client.shutdown()


@pytest.mark.cuda
def test_torch_plugin_on_the_card():
    """The real plugin on a host with CUDA: one group of every visible
    card, named after card 0, and a reservation that pins the ordinal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    dp = port_dp.DevicePluginClient("torch")
    try:
        (g,) = dp.fingerprint()
        n = torch.cuda.device_count()
        assert (g.vendor, g.type) == ("nvidia", "gpu")
        assert g.name == torch.cuda.get_device_name(0).replace(" ", "-").lower()
        assert [i.id for i in g.instances] == [f"cuda-{k}" for k in range(n)]
        assert dp.reserve([f"cuda-{n - 1}"])["envs"] == {"CUDA_VISIBLE_DEVICES": str(n - 1)}
    finally:
        dp.close()


# -- a GPU fleet through both schedulers -----------------------------------------

FLEET_NODES = 64
GPU_EVERY = 4  # 16 nodes with a group
GPU_INSTANCES = 8
GPU_NAME = "a100-sxm4-80gb"
JOB_ASKS = (1, 2, 1)  # instances an alloc asks, a job each; the last with an affinity
JOB_COUNT = 10


def _fleet():
    nodes = []
    for i in range(FLEET_NODES):
        n = ref_mock.node()
        n.id = f"node-{i:03d}"
        n.name = n.id
        if i % GPU_EVERY == 0:
            n.node_resources.devices = [RefDeviceResource(
                vendor="nvidia", type="gpu", name=GPU_NAME,
                instances=[RefInstance(id=f"{n.id}-gpu-{k}") for k in range(GPU_INSTANCES)],
                attributes={"memory_mb": 81920},
            )]
        n.compute_class()
        nodes.append(n)
    jobs = []
    for j, count in enumerate(JOB_ASKS):
        job = ref_mock.job()
        job.id = f"gpu-{j}"
        tg = job.task_groups[0]
        tg.count = JOB_COUNT
        ask = RefRequestedDevice(name="nvidia/gpu", count=count)
        if j == 2:
            ask.affinities = [RefAffinity(l_target="${device.attr.memory_mb}", r_target="40000",
                                          operand=">=", weight=50)]
        tg.tasks[0].resources.devices = [ask]
        jobs.append(job)
    return nodes, jobs


def _placements(store, jobs, nodes):
    by_node = {n.id: n for n in nodes}
    counts, ids, seen = {}, collections.defaultdict(set), collections.Counter()
    for job in jobs:
        allocs = [a for a in store.allocs_by_job(job.namespace, job.id)
                  if not a.terminal_status()]
        counts[job.id] = sorted(collections.Counter(a.node_id for a in allocs).items())
        for a in allocs:
            (ad,) = a.allocated_devices
            group = {i.id for d in by_node[a.node_id].node_resources.devices
                     for i in d.instances}
            assert set(ad.device_ids) <= group, (a.node_id, ad.device_ids)
            ids[a.node_id].update(ad.device_ids)
            seen.update((a.node_id, d) for d in ad.device_ids)
    assert all(v == 1 for v in seen.values()), "a device instance assigned twice"
    return counts, {k: sorted(v) for k, v in ids.items()}


def test_gpu_fleet_places_like_the_reference(monkeypatch):
    nodes, jobs = _fleet()
    eval_ids = [f"eval-{j}" for j in range(len(jobs))]
    store = RefStore()
    for n in nodes:
        store.upsert_node(1, n)
    for j in jobs:
        store.upsert_job(2, j)
    records = ([dataclasses.asdict(n) for n in nodes], [dataclasses.asdict(j) for j in jobs], [])
    ref = RefHarness(store)
    with reference_runtime(monkeypatch):
        for job, eid in zip(jobs, eval_ids):
            ev = ref_mock.eval_for(job, id=eid)
            ref.store.upsert_evals(ref.next_index(), [ev])
            ref.process(ev)
    port_store = interop.store_from_records(*records)
    port = PortHarness(port_store, device="cpu")
    for job, eid in zip(jobs, eval_ids):
        ev = port_mock.eval_for(port_store.job_by_id(job.namespace, job.id), id=eid)
        port.store.upsert_evals(port.next_index(), [ev])
        port.process(ev)

    ref_counts, ref_ids = _placements(ref.store, jobs, nodes)
    port_counts, port_ids = _placements(port.store, jobs, nodes)
    assert port_counts == ref_counts
    assert port_ids == ref_ids
    placed = sum(c for v in port_counts.values() for _, c in v)
    assert placed == JOB_COUNT * len(JOB_ASKS)
    gpu_nodes = {n.id for i, n in enumerate(nodes) if i % GPU_EVERY == 0}
    assert set(port_ids) <= gpu_nodes  # nothing lands on a node without the group
    assert sum(len(v) for v in port_ids.values()) == JOB_COUNT * sum(JOB_ASKS)


# -- C-R12: one device instance in two members of a merged commit --------------


def _merged_verdicts(pkg, ids):
    """Two member plans of one merged commit, each placing an alloc on
    the same 8-instance node and holding the instance ids ``ids[k]``:
    (admitted, rejected) on that node, by member."""
    s = pkg.structs
    node = pkg.mock.node()
    node.node_resources.devices = [s.NodeDeviceResource(
        vendor="nvidia", type="gpu", name=GPU_NAME,
        instances=[s.NodeDeviceInstance(id=f"gpu-{k}") for k in range(GPU_INSTANCES)],
    )]
    store = pkg.StateStore()
    store.upsert_node(1, node)
    plans = []
    for held in ids:
        job = pkg.mock.job()
        alloc = pkg.mock.alloc(job, node)
        alloc.allocated_devices = [s.AllocatedDeviceResource(
            vendor="nvidia", type="gpu", name=GPU_NAME, device_ids=list(held))]
        plans.append(pkg.Plan(job=job, node_allocation={node.id: [alloc]}))
    results = pkg.plan_apply.evaluate_merged_plan(store.snapshot(), plans)
    return [(sorted(r.node_allocation) == [node.id], r.rejected_nodes == [node.id])
            for r in results]


@pytest.mark.parametrize("ids, port_want", [
    ((["gpu-0"], ["gpu-1"]), [(True, False), (True, False)]),
    ((["gpu-0"], ["gpu-0"]), [(True, False), (False, True)]),
    ((["gpu-0", "gpu-1"], ["gpu-1", "gpu-2"]), [(True, False), (False, True)]),
], ids=["distinct", "same", "overlapping"])
def test_merged_commit_refuses_an_instance_twice(ids, port_want):
    """The plan applier admits the second member only where its
    instances are free. The JAX package counts the group's pool alone
    and admits both (ROADMAP C-R12)."""
    from nomad_tpu.broker import plan_apply as ref_plan_apply
    from nomad_tpu.structs import plan as ref_plan
    from nomad_tpu.structs import resources as ref_resources
    from nomad_tpu_torch.broker import plan_apply
    from nomad_tpu_torch.state import StateStore
    from nomad_tpu_torch.structs import plan, resources

    ref = _merged_verdicts(SimpleNamespace(
        mock=ref_mock, structs=ref_resources, StateStore=RefStore, Plan=ref_plan.Plan,
        plan_apply=ref_plan_apply), ids)
    port = _merged_verdicts(SimpleNamespace(
        mock=port_mock, structs=resources, StateStore=StateStore, Plan=plan.Plan,
        plan_apply=plan_apply), ids)
    assert port == port_want
    assert ref == [(True, False), (True, False)]


def test_batched_server_holds_each_instance_once(tmp_path):
    """The port's server, one batching worker merging the evals of a small
    GPU fleet (200 nodes, 50 with 8 instances; 4 jobs x 10 of one
    instance, 2 x 5 of a whole host): every alloc placed, no instance
    held twice, every alloc's ids its node's."""
    from nomad_tpu_torch.server.fsm import MsgType
    from nomad_tpu_torch.structs import Affinity
    from nomad_tpu_torch.structs.resources import NodeDeviceInstance, NodeDeviceResource

    agent = DevAgent(data_dir=str(tmp_path), num_workers=1, device="cpu")
    agent.start()
    try:
        server, store = agent.server, agent.server.store
        server.raft_apply(MsgType.NODE_ELIGIBILITY,
                          {"node_id": agent.client.node.id, "eligibility": "ineligible"})
        nodes = []
        for i in range(200):
            node = port_mock.node()
            if i % GPU_EVERY == 0:
                node.node_resources.devices = [NodeDeviceResource(
                    vendor="nvidia", type="gpu", name=GPU_NAME,
                    instances=[NodeDeviceInstance(id=f"gpu-{k}") for k in range(GPU_INSTANCES)],
                    attributes={"memory_mb": 81920})]
                node.compute_class()
            store.upsert_node(store.latest_index + 1, node)
            nodes.append(node)
        jobs = []
        for kind, n_jobs, count, per in (("svc", 4, 10, 1), ("batch", 2, 5, 8)):
            for j in range(n_jobs):
                job = port_mock.job() if kind == "svc" else port_mock.batch_job()
                job.id = f"gpu-{kind}-{j}"
                job.task_groups[0].count = count
                ask = RequestedDevice(name="nvidia/gpu", count=per)
                if j % 2:
                    ask.affinities = [Affinity(l_target="${device.attr.memory_mb}",
                                               r_target="40000", operand=">=", weight=50)]
                job.task_groups[0].tasks[0].resources.devices = [ask]
                jobs.append(job)
        for job in jobs:
            server.register_job(job)
        assert server.wait_for_evals(timeout=WAIT_S)
        counts, ids = _placements(store, jobs, nodes)
        assert sum(c for v in counts.values() for _, c in v) == 50
        assert sum(len(v) for v in ids.values()) == 4 * 10 + 2 * 5 * 8
    finally:
        agent.shutdown()
