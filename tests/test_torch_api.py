"""The port's dev agent behind its HTTP API (``nomad_tpu_torch.api``,
``agent.py``, ``client/``) against the JAX package's, on the CPU.

An agent pair: the reference's ``DevAgent`` + ``HTTPAgent`` and the
port's ``DevAgent(device="cpu")`` + ``HTTPAgent``, each given a node with
the same id and name, each with one scheduling worker. Every scenario of
the reference's ``tests/test_api.py::TestHTTPAPI`` and
``tests/test_aux_surface.py`` posts the same JSON to both through each
package's own SDK, and the two responses must be equal after
``normalize``.

``normalize`` drops the keys listed in ``DROPPED`` and nothing else: ids
the two stores draw at random (evals, allocs, deployments),
Raft indexes, and times (wall-clock stamps and measured durations). The
agent's own listen addresses and data dir, which differ between two
agents on one host by construction, are written as placeholders. Floats
compare within ``rtol=1e-5, atol=1e-6`` (scores: ``exp`` differs by an
ulp between the runtimes, see test_torch_score.py); everything else is
exact.

Two things differ by design and are checked for their own shape:
``/v1/agent/trace``'s ``kernels`` (the port's guard table, keyed by the
reference's kernel names, with the reference's five keys, beside the
reference's jax profile keyed by module path) with ``kernel_fingerprints``
(``{}`` on the port, ROADMAP A17), and ``version`` (the port's
``__version__``). Profiles and thread dumps (``/v1/agent/pprof``) are
samples of a live process and compare by their keys.

The reference agent schedules through its ``traced_jit`` kernels, which
need the scoped ``trace_state_clean`` monkeypatch (ROADMAP C-R1) for the
pair's whole life; it is undone when the module's fixture stops both
agents (HTTP listeners, client endpoints, workers) in a ``finally``.
Every wait has a deadline.
"""

import dataclasses
import json
import math
import re
import threading
import time
import urllib.request

import pytest

from nomad_tpu import mock as ref_mock
from nomad_tpu.agent import DevAgent as RefDevAgent
from nomad_tpu.api.client import APIException as RefAPIException
from nomad_tpu.api.client import NomadClient as RefNomadClient
from nomad_tpu.api.codec import encode as ref_encode
from nomad_tpu.api.http import HTTPAgent as RefHTTPAgent
from nomad_tpu.client import fingerprint as ref_fp
from nomad_tpu.obs.recorder import flight_recorder as ref_recorder
from nomad_tpu.server import Server as RefServer
from nomad_tpu.server import ServerConfig as RefServerConfig
from nomad_tpu.structs import Node as RefNode
from nomad_tpu.utils import backend as ref_backend
from nomad_tpu.utils.metrics import global_metrics as ref_metrics
from nomad_tpu_torch import __version__ as port_version
from nomad_tpu_torch import backend as port_backend
from nomad_tpu_torch.agent import DevAgent
from nomad_tpu_torch.api.client import APIException, NomadClient
from nomad_tpu_torch.api.http import HTTPAgent
from nomad_tpu_torch.client import fingerprint as port_fp
from nomad_tpu_torch.obs.recorder import flight_recorder as port_recorder
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.structs import Node
from nomad_tpu_torch.utils.metrics import global_metrics as port_metrics
from test_torch_hetero import reference_runtime

RTOL, ATOL = 1e-5, 1e-6
WAIT_S = 20.0
NODE_ID, NODE_NAME = "dev-node-0001", "dev-node"

# Every key normalize() drops, in one place.
DROPPED = frozenset(
    {
        # ids drawn at random by each store (evals, allocs, deployments)
        "id",
        "eval_id",
        "deployment_id",
        "previous_allocation",
        "next_allocation",
        "previous_eval",
        "next_eval",
        "blocked_eval",
        # Raft indexes
        "create_index",
        "modify_index",
        "job_modify_index",
        "alloc_modify_index",
        "snapshot_index",
        # times: wall-clock stamps and measured durations
        "started_at",
        "duration_ms",
        "status_updated_at",
        "allocation_time_ns",
    }
)


# the detectors read these from the host at the moment they run; two
# fingerprints taken moments apart may differ in them, so each agent's
# own reading is written as a placeholder, as its address is
LIVE_READINGS = ("unique.storage.bytesfree",)


def wait_until(cond, timeout=WAIT_S, interval=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return False


@dataclasses.dataclass
class Side:
    """One agent of the pair, with its own package's SDK."""

    name: str
    agent: object
    http: object
    client: object
    api_error: type

    @property
    def address(self):
        return self.http.address

    @property
    def store(self):
        return self.agent.store

    def placeholders(self):
        """The agent's own addresses, paths and live host readings,
        longest first."""
        out = {
            self.address: "<http>",
            self.address.split("://", 1)[-1]: "<http-hostport>",
            self.agent.data_dir: "<data_dir>",
        }
        attrs = self.agent.client.node.attributes
        rpc = attrs.get("nomad.client.rpc_addr")
        if rpc:
            out[rpc] = "<client-rpc>"
        for key in LIVE_READINGS:
            if attrs.get(key):
                out[attrs[key]] = f"<{key}>"
        return dict(sorted(out.items(), key=lambda kv: -len(kv[0])))


def normalize(obj, side=None):
    """``obj`` without the keys of ``DROPPED``, the side's own addresses
    and data dir as placeholders."""
    subs = side.placeholders() if side is not None else {}

    def walk(o):
        if isinstance(o, dict):
            return {walk(k): walk(v) for k, v in o.items() if k not in DROPPED}
        if isinstance(o, (list, tuple)):
            return [walk(v) for v in o]
        if isinstance(o, str):
            for k, v in subs.items():
                o = o.replace(k, v)
        return o

    return walk(obj)


def differences(ref, port, path=""):
    """Where two normalized values differ (floats within RTOL / ATOL)."""
    if isinstance(ref, dict) and isinstance(port, dict):
        out = [f"{path}/{k}: only in {'port' if k in port else 'reference'}"
               for k in sorted(set(ref) ^ set(port), key=str)]
        for k in sorted(set(ref) & set(port), key=str):
            out += differences(ref[k], port[k], f"{path}/{k}")
        return out
    if isinstance(ref, list) and isinstance(port, list):
        if len(ref) != len(port):
            return [f"{path}: {len(ref)} items against {len(port)}"]
        return [d for i, (a, b) in enumerate(zip(ref, port))
                for d in differences(a, b, f"{path}[{i}]")]
    if (isinstance(ref, float) or isinstance(port, float)) and not isinstance(
        ref, bool
    ) and isinstance(ref, (int, float)) and isinstance(port, (int, float)):
        if math.isclose(ref, port, rel_tol=RTOL, abs_tol=ATOL):
            return []
    elif ref == port:
        return []
    return [f"{path}: {ref!r:.120} against {port!r:.120}"]


def assert_same(ref, port, ref_side=None, port_side=None, what=""):
    diffs = differences(normalize(ref, ref_side), normalize(port, port_side))
    assert not diffs, f"{what}:\n" + "\n".join(diffs[:40])


def assert_same_metrics(ref, port):
    """``/v1/metrics`` of the pair since ``AgentPair`` reset both
    registries: the same counters, gauges and samples by name, outside
    the kernel profile (``nomad.kernel.*`` differs by design, as
    ``/v1/agent/trace``'s ``kernels`` does). Their values are measured
    times and counts of timing-dependent events (broker polls, evals that
    client status updates create), which differ between any two runs."""
    assert ref.keys() == port.keys() == {"counters", "gauges", "samples"}

    def named(section):
        return sorted(k for k in section if not k.startswith("nomad.kernel."))

    for section in ref:
        assert named(ref[section]) == named(port[section]), section


class AgentPair:
    """Both dev agents, each with one worker, a node of the same id and
    name, and an HTTP listener on an ephemeral port."""

    def __init__(self, tmp_path_factory, num_workers=1):
        self.ref = self.port = None
        # each package's process-wide registries hold what earlier tests
        # in this process recorded: start both pair members from empty
        for recorder, metrics, backend in (
            (ref_recorder, ref_metrics, ref_backend),
            (port_recorder, port_metrics, port_backend),
        ):
            recorder.clear()
            metrics.reset()
            backend.reset_kernel_profile()
        try:
            ra = RefDevAgent(
                data_dir=str(tmp_path_factory.mktemp("ref-agent")),
                num_workers=num_workers,
                node=RefNode(id=NODE_ID, name=NODE_NAME),
            )
            ra.start()
            rh = RefHTTPAgent(ra.server, ra.client, port=0)
            rh.start()
            self.ref = Side("reference", ra, rh, RefNomadClient(rh.address),
                            RefAPIException)
            pa = DevAgent(
                data_dir=str(tmp_path_factory.mktemp("port-agent")),
                num_workers=num_workers,
                node=Node(id=NODE_ID, name=NODE_NAME),
                device="cpu",
            )
            pa.start()
            ph = HTTPAgent(pa.server, pa.client, port=0)
            ph.start()
            self.port = Side("port", pa, ph, NomadClient(ph.address), APIException)
        except BaseException:
            self.stop()
            raise

    @property
    def sides(self):
        return (self.ref, self.port)

    def both(self, fn):
        """``fn(side)`` on each side: (reference result, port result)."""
        return fn(self.ref), fn(self.port)

    def same(self, fn, what=""):
        ref, port = self.both(fn)
        assert_same(ref, port, self.ref, self.port, what)
        return ref, port

    def stop(self):
        for side in (self.port, self.ref):
            if side is None:
                continue
            try:
                side.http.stop()
            finally:
                side.agent.shutdown()


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    with reference_runtime(pytest.MonkeyPatch()):
        p = AgentPair(tmp_path_factory)
        try:
            yield p
        finally:
            p.stop()


def job_payload(**over):
    """tests/test_api.py's payload: one mock_driver batch task."""
    j = ref_mock.batch_job()
    j.task_groups[0].count = 1
    j.task_groups[0].tasks[0].driver = "mock_driver"
    j.task_groups[0].tasks[0].config = {"run_for": 0.05}
    for k, v in over.items():
        setattr(j, k, v)
    return ref_encode(j)


def by_name(items):
    """A listing whose order follows the store's random ids, in the order
    of (job, alloc name) instead."""
    return sorted(items, key=lambda a: (a.get("job_id", ""), a.get("name", "")))


def complete(side, job_id, count=1):
    allocs = side.client.jobs.allocations(job_id)
    return len(allocs) == count and all(a["client_status"] == "complete" for a in allocs)


# -- tests/test_api.py::TestHTTPAPI -------------------------------------------


def test_register_and_status(pair):
    payload = job_payload()
    ref_out, port_out = pair.same(lambda s: s.client.jobs.register(payload), "register")
    assert ref_out["eval_id"] and port_out["eval_id"]
    for side in pair.sides:
        assert wait_until(lambda s=side: complete(s, payload["id"])), side.name
    pair.same(lambda s: s.client.jobs.info(payload["id"]), "job info")
    _, summary = pair.same(lambda s: s.client.jobs.summary(payload["id"]), "summary")
    assert summary["summary"]["worker"]["complete"] == 1
    pair.same(lambda s: by_name(s.client.jobs.allocations(payload["id"])), "job allocations")
    pair.same(lambda s: s.client.jobs.evaluations(payload["id"]), "job evaluations")


def test_eval_and_alloc_endpoints(pair):
    payload = job_payload()
    outs = dict(zip(("reference", "port"), pair.both(
        lambda s: s.client.jobs.register(payload))))
    for side in pair.sides:
        assert wait_until(
            lambda s=side: s.client.evaluations.info(outs[s.name]["eval_id"])["status"]
            == "complete"
        ), side.name
        assert wait_until(lambda s=side: complete(s, payload["id"])), side.name
    pair.same(lambda s: s.client.evaluations.info(outs[s.name]["eval_id"]), "eval")
    _, alloc = pair.same(
        lambda s: s.client.allocations.info(s.client.jobs.allocations(payload["id"])[0]["id"]),
        "alloc",
    )
    assert alloc["job_id"] == payload["id"]
    assert alloc["metrics"]["scores"]  # placement explainability survives JSON
    pair.same(
        lambda s: s.client.evaluations.placement(outs[s.name]["eval_id"]),
        "eval placement",
    )


def test_node_endpoints(pair):
    _, nodes = pair.same(lambda s: s.client.nodes.list(), "node list")
    assert [n["id"] for n in nodes] == [NODE_ID]
    _, node = pair.same(lambda s: s.client.nodes.info(NODE_ID[:8]), "node info")
    assert node["id"] == NODE_ID and node["attributes"]["kernel.name"]
    # no accelerator on this host: neither fingerprint gives the node a class
    assert "gpu.type" not in node["attributes"] and node["device_class"] == ""
    pair.same(lambda s: by_name(s.client.nodes.allocations(NODE_ID)), "node allocations")


def test_job_plan_dry_run(pair):
    payload = job_payload()
    _, out = pair.same(lambda s: s.client.jobs.plan(payload), "plan")
    assert out["diff_type"] == "added"
    assert out["annotations"]["worker"]["place"] == 1
    # a dry run registers nothing
    for side in pair.sides:
        with pytest.raises(side.api_error) as e:
            side.client.jobs.info(payload["id"])
        assert e.value.status == 404


def test_scheduler_config_roundtrip(pair):
    _, cfg = pair.same(lambda s: s.client.operator.scheduler_config(), "config")
    assert cfg["scheduler_algorithm"] == "binpack"
    pair.same(
        lambda s: s.client.operator.set_scheduler_config(scheduler_algorithm="spread"),
        "set spread",
    )
    pair.same(lambda s: s.client.operator.scheduler_config(), "config spread")
    pair.same(
        lambda s: s.client.operator.set_scheduler_config(scheduler_algorithm="binpack"),
        "set binpack",
    )

    def bogus(s):
        with pytest.raises(s.api_error) as e:
            s.client.operator.set_scheduler_config(scheduler_algorithm="bogus")
        return {"status": e.value.status, "message": str(e.value)}

    _, err = pair.same(bogus, "bogus algorithm")
    assert err["status"] == 400 and "cp-pack" in err["message"]


def test_deregister(pair):
    payload = job_payload()
    pair.same(lambda s: s.client.jobs.register(payload), "register")
    for side in pair.sides:
        assert wait_until(lambda s=side: complete(s, payload["id"])), side.name
    pair.same(lambda s: s.client.jobs.deregister(payload["id"]), "deregister")
    _, job = pair.same(lambda s: s.client.jobs.info(payload["id"]), "stopped job")
    assert job["stop"] is True


def test_agent_self_metrics_and_trace(pair):
    ref, port = pair.both(lambda s: s.client.agent.self())
    # version: each package's own
    assert port.pop("version") == port_version
    ref.pop("version")
    assert_same(ref, port, pair.ref, pair.port, "agent self")
    assert port["stats"]["worker_count"] == 1 and "client" in port

    assert_same_metrics(*pair.both(lambda s: s.client.agent.metrics()))

    # trace: traces and errors as everything else; kernels by design
    ref, port = pair.both(lambda s: s.client.get("/v1/agent/trace"))
    ref_kernels, port_kernels = ref.pop("kernels"), port.pop("kernels")
    ref_fps, port_fps = ref.pop("kernel_fingerprints"), port.pop("kernel_fingerprints")
    assert_same(ref, port, pair.ref, pair.port, "agent trace")
    assert port_fps == {} and isinstance(ref_fps, dict)
    keys = {"calls", "traces", "total_ms", "last_trace_shape", "recent_traces"}
    assert port_kernels["place_closed_form_kernel"]["calls"] >= 1
    by_short = {k.rsplit(".", 1)[-1]: v for k, v in ref_kernels.items()}
    assert set(port_kernels) <= set(by_short) | {"place_closed_form_kernel"}
    for name, row in port_kernels.items():
        assert set(row) == keys == set(by_short.get(name, row)), name
        assert row["calls"] >= row["traces"] >= 0 and row["total_ms"] >= 0.0


def test_404s(pair):
    def misses(s):
        out = []
        for call in (lambda: s.client.jobs.info("nope"),
                     lambda: s.client.allocations.info("nope"),
                     lambda: s.client.evaluations.info("nope"),
                     lambda: s.client.get("/v1/no/such/route")):
            with pytest.raises(s.api_error) as e:
                call()
            out.append((e.value.status, str(e.value)))
        return out

    _, port = pair.same(misses, "404s")
    assert port[0][0] == 404


def test_blocking_query_unblocks_on_write(pair):
    def blocked_then_written(s):
        idx = s.agent.store.latest_index
        result = {}

        def blocked():
            t0 = time.time()
            result["jobs"] = s.client.get("/v1/jobs", index=idx, wait=5)
            result["elapsed"] = time.time() - t0

        t = threading.Thread(target=blocked, daemon=True)
        t.start()
        time.sleep(0.1)
        s.client.jobs.register(job_payload(id="blocking-write"))
        t.join(timeout=10)
        assert not t.is_alive() and result["elapsed"] < 5.0, s.name
        return sorted(j["id"] for j in result["jobs"])

    pair.same(blocked_then_written, "unblocked listing")
    for side in pair.sides:
        assert wait_until(lambda s=side: complete(s, "blocking-write")), side.name


# -- tests/test_aux_surface.py -------------------------------------------------

def _host_node(fp, tmp_path, **kw):
    node = fp.fingerprint_node(data_dir=str(tmp_path), **kw)
    attrs = {k: v for k, v in node.attributes.items() if k not in LIVE_READINGS}
    return node, attrs


def test_fingerprint_detector_breadth(tmp_path):
    ref, ref_attrs = _host_node(ref_fp, tmp_path)
    port, port_attrs = _host_node(port_fp, tmp_path)
    assert port_attrs == ref_attrs
    a = port.attributes
    assert int(a["cpu.numcores"]) >= 1 and int(a["cpu.totalcompute"]) > 0
    assert int(a["memory.totalbytes"]) > 0 and a["kernel.name"] == "linux"
    assert int(a["unique.storage.bytestotal"]) > 0
    assert int(a["unique.storage.bytesfree"]) >= 0
    assert int(a["network.speed"]) > 0
    assert a.get("unique.cgroup.version") in ("v1", "v2", None)
    assert dataclasses.asdict(port.node_resources) == dataclasses.asdict(
        ref.node_resources
    )
    assert port.device_class == ref.device_class == ""
    assert port.topology == ref.topology == {}


def test_fingerprint_detector_failure_isolated(tmp_path, monkeypatch):
    def boom(node, ctx):
        raise RuntimeError("probe exploded")

    for fp in (ref_fp, port_fp):
        monkeypatch.setattr(fp, "DETECTORS", (boom,) + fp.DETECTORS[1:])
    _, ref_attrs = _host_node(ref_fp, tmp_path)
    port, port_attrs = _host_node(port_fp, tmp_path)
    assert port_attrs == ref_attrs and port.attributes["kernel.name"] == "linux"
    assert "cpu.numcores" not in port.attributes


def test_fingerprint_gpu_sets_class_from_card_name(tmp_path, monkeypatch):
    """Where CUDA is available, the node carries the card's count and
    name, and its device class follows from the name."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")
    node = port_fp.fingerprint_node(data_dir=str(tmp_path))
    assert node.attributes["gpu.count"] == "1"
    assert node.attributes["gpu.type"] == "NVIDIA H100 80GB HBM3"
    assert node.device_class == "nvidia-h100-80gb-hbm3"
    assert node.device_class == port_fp.normalize_device_class("NVIDIA H100 80GB HBM3")
    assert set(node.topology) == {"rack", "pod", "ici"}


def test_pprof_and_debug_endpoints():
    def probe(server_cls, config, agent_cls):
        srv = server_cls(config)
        srv.establish_leadership()
        http = agent_cls(srv, None, host="127.0.0.1", port=0)
        http.start()
        try:

            def get(path):
                with urllib.request.urlopen(http.address + path, timeout=10) as r:
                    return json.loads(r.read())

            threads = get("/v1/agent/pprof/goroutine")
            prof = get("/v1/agent/pprof/profile?seconds=0.2")
            heap1 = get("/v1/agent/pprof/heap")
            heap2 = get("/v1/agent/pprof/heap")
            bundle = get("/v1/operator/debug")
            return threads, prof, heap1, heap2, bundle
        finally:
            http.stop()
            srv.shutdown()

    with reference_runtime(pytest.MonkeyPatch()):
        ref = probe(RefServer, RefServerConfig(num_workers=1), RefHTTPAgent)
    port = probe(Server, ServerConfig(num_workers=1, device="cpu"), HTTPAgent)
    threads, prof, heap1, heap2, bundle = port
    assert any("worker" in name for name in threads)
    assert prof["samples"] > 0
    assert heap1.get("started") or heap1.get("top") is not None
    assert heap2.get("top") is not None
    assert "metrics" in bundle and "threads" in bundle and "device_cache" in bundle
    # the same keys in every section, and the same worker threads
    assert prof.keys() == ref[1].keys()
    assert heap2.keys() == ref[3].keys()
    assert bundle.keys() == ref[4].keys()
    assert bundle["device_cache"].keys() == ref[4]["device_cache"].keys()

    def workers(names):  # a dump's names end in the thread's ident
        return sorted(re.sub(r"-\d+$", "", n) for n in names if "worker" in n)

    assert workers(threads) == workers(ref[0])


def test_kernel_profile_counts_a_build_on_its_own_thread():
    """The guard's table files a build under the call whose thread
    started it: a second lane's call that overlaps the build counts as a
    plain call. A call under a caller's span adds a ``kernel:<name>``
    span there; a call outside any span adds none."""
    import torch

    from nomad_tpu_torch.obs.trace import global_tracer
    from nomad_tpu_torch.utils.metrics import global_metrics

    name = "test_profile_kernel"
    dev = torch.device("cpu")
    building, overlapped = threading.Event(), threading.Event()

    def builds():
        port_backend.note_compile()
        building.set()
        assert overlapped.wait(10.0)
        return 1

    def overlaps():
        assert building.wait(10.0)
        overlapped.set()
        return 2

    port_backend.reset_kernel_profile()
    global_metrics.reset()
    other = threading.Thread(
        target=lambda: port_backend.guarded_call(name, dev, overlaps, sig=lambda: "b"))
    other.start()
    try:
        assert port_backend.guarded_call(name, dev, builds, sig=lambda: "a") == 1
    finally:
        other.join(timeout=10.0)
    assert not other.is_alive()
    row = port_backend.kernel_profile()[name]
    assert (row["calls"], row["traces"], row["last_trace_shape"]) == (2, 1, "a")
    assert [e["shape"] for e in row["recent_traces"]] == ["a"]
    assert not any(k.startswith("nomad.kernel.")
                   for k in global_metrics.snapshot()["samples"])

    global_tracer.begin("profile-test")
    with global_tracer.activate("profile-test"):
        port_backend.guarded_call(name, dev, lambda: 3)
    port_backend.guarded_call(name, dev, lambda: 4)  # no span to join
    trace = global_tracer.finish("profile-test")
    port_recorder.clear()
    spans = [s for s in trace["spans"] if s["name"] == f"kernel:{name}"]
    assert len(spans) == 1 and spans[0]["tags"] == {"traced": False}
    assert port_backend.kernel_profile()[name]["calls"] == 4
    port_backend.reset_kernel_profile()
