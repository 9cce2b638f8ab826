"""The port's server (``nomad_tpu_torch.server``: broker → worker → plan
queue → applier over one ``DeviceStateCache``) against the JAX package's
server, on the CPU.

Both servers get the same nodes, jobs and evals (the reference's mock
objects, carried into the port through ``interop.from_record``, so ids
match) and placements are compared as sorted ``(job_id, alloc name,
node_id)`` over live allocs. Each server runs one batching worker, so the
scheduling order is pinned by the script: one eval at a time with a drain
between, or a batch registered while the worker is paused. The
reference's ``traced_jit`` kernels need the scoped ``trace_state_clean``
monkeypatch (ROADMAP C-R1) for the reference server's whole lifetime.

Scenarios: (a) the reference's ``TestServerEndToEnd`` cases that need no
leader service; (b) a spread + affinity stream, one job at a time; (c) ten
jobs in one merged, decorrelated pass; (d) ``_decorrelate_lanes`` and
``place(decorrelate=True)``; (e) ``LaneMap`` on 1,000 job ids and two
lane-mode workers against one; (f) the broker, blocked evals and the plan
queue on scripted sequences; (g) ``InlineRaft`` with a data dir. Also the
seven endpoints that need a leader service, on both servers.

Tolerance: placements, orders and counters exactly; scores of
``place(decorrelate=True)`` within ``rtol=1e-5`` (``exp`` differs by an
ulp between the runtimes, see test_torch_score.py), rows exactly.
"""

import contextlib
import dataclasses
import time
import zlib

import numpy as np
import pytest

from nomad_tpu import mock as ref_mock
from nomad_tpu.broker.blocked import BlockedEvals as RefBlocked
from nomad_tpu.broker.eval_broker import EvalBroker as RefBroker
from nomad_tpu.broker.plan_queue import PlanQueue as RefPlanQueue
from nomad_tpu.device.cache import DeviceStateCache as RefCache
from nomad_tpu.device.flatten import flatten_group_ask as ref_flatten
from nomad_tpu.device.score import PlacementKernel as RefKernel
from nomad_tpu.device.score import _decorrelate_lanes as ref_decorrelate
from nomad_tpu.server import Server as RefServer
from nomad_tpu.server import ServerConfig as RefServerConfig
from nomad_tpu.server.lanes import LaneMap as RefLaneMap
from nomad_tpu.state import StateStore as RefStore
from nomad_tpu.structs import Affinity, Spread
from nomad_tpu.utils.metrics import global_metrics as ref_metrics
from nomad_tpu_torch import interop
from nomad_tpu_torch.broker.blocked import BlockedEvals
from nomad_tpu_torch.broker.eval_broker import EvalBroker
from nomad_tpu_torch.broker.plan_queue import PlanQueue
from nomad_tpu_torch.device.score import PlacementKernel, _decorrelate_lanes
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server.lanes import LaneMap
from nomad_tpu_torch.structs import Evaluation, Job, Node, Plan
from nomad_tpu_torch.utils.metrics import global_metrics as port_metrics
from test_torch_hetero import reference_runtime

WAIT_S = 60.0
RACKS = 6
N_NODES = 48
COUNTERS = (
    "nomad.worker.evals_processed",
    "nomad.worker.batch_evals_completed",
    "nomad.worker.batch_conflict_fallbacks",
    "nomad.worker.batch_single_fallbacks",
    "nomad.worker.solo_evals",
    "nomad.worker.batch_kernel_errors",
    "nomad.plan.merged_commits",
    "nomad.plan.merged_members",
)


def port_of(obj, cls):
    """The port's copy of a reference struct, field for field."""
    return interop.from_record(cls, dataclasses.asdict(obj))


def rack_node(i, racks=RACKS):
    n = ref_mock.node(id=f"node-{i:03d}", name=f"node-{i:03d}")
    n.attributes["platform.rack"] = f"r{i % racks}"
    n.attributes["storage.type"] = "ssd" if i % 4 == 0 else "hdd"
    if i % 3 == 1:
        n.node_resources.cpu = 8000
        n.node_resources.memory_mb = 16384
    n.compute_class()
    return n


def spread_job(j, count):
    job = ref_mock.batch_job() if j % 3 == 2 else ref_mock.job()
    job.id = job.name = f"stream-{j:02d}"
    tg = job.task_groups[0]
    tg.count = count
    tg.tasks[0].resources.cpu = 250 if j % 2 else 500
    job.spreads = [Spread(attribute="${attr.platform.rack}", weight=50)]
    job.affinities = [
        Affinity(l_target="${attr.storage.type}", r_target="ssd", operand="=", weight=50)
    ]
    return job


def placements(server, prefix=""):
    return sorted(
        (a.job_id, a.name, a.node_id)
        for a in server.store.allocs()
        if a.job_id.startswith(prefix) and not a.terminal_status()
    )


def counters(metrics):
    snap = metrics.snapshot()["counters"]
    return {k: int(snap.get(k, 0)) for k in COUNTERS}


class Pair:
    """The reference server and the port's, fed the same calls."""

    def __init__(self, **cfg):
        self.ref = RefServer(RefServerConfig(heartbeat_ttl=3600.0, **cfg))
        self.port = Server(ServerConfig(device="cpu", **cfg))
        self.servers = (self.ref, self.port)

    def start(self):
        for s in self.servers:
            s.establish_leadership()

    def shutdown(self):
        for s in self.servers:
            s.shutdown()

    def node(self, n):
        port_node = port_of(n, Node)
        self.ref.register_node(n)
        self.port.register_node(port_node)

    def job(self, job):
        port_job = port_of(job, Job)
        ref_ev = self.ref.register_job(job)
        port_ev = self.port.register_job(port_job)
        return ref_ev, port_ev

    def call(self, name, *args):
        return [getattr(s, name)(*args) for s in self.servers]

    def drain(self):
        for s in self.servers:
            assert s.wait_for_evals(timeout=WAIT_S)

    @contextlib.contextmanager
    def paused(self):
        """Workers paused while the block runs, so that what it enqueues
        is scheduled together after it, not as it arrives."""
        for s in self.servers:
            for w in s.workers:
                w.pause()
        time.sleep(0.5)  # let a dequeue in flight time out into the pause
        try:
            yield
        finally:
            for s in self.servers:
                for w in s.workers:
                    w.resume()

    def same_placements(self, prefix=""):
        ref, port = placements(self.ref, prefix), placements(self.port, prefix)
        assert port == ref
        return port

    def same_nodes(self, prefix=""):
        """(job_id, node_id) of every live alloc, names left out: for
        replacements, whose names follow the random ids of the allocs
        they replace (ROADMAP C-S1)."""
        ref, port = placements(self.ref, prefix), placements(self.port, prefix)
        assert sorted((j, n) for j, _a, n in port) == sorted((j, n) for j, _a, n in ref)
        assert {a for _j, a, _n in port} == {a for _j, a, _n in ref}
        return port


@contextlib.contextmanager
def server_pair(monkeypatch, **cfg):
    with reference_runtime(monkeypatch):
        pair = Pair(**cfg)
        try:
            pair.start()
            yield pair
        finally:
            pair.shutdown()


def live(server, job_id):
    return [a for a in server.store.allocs_by_job("default", job_id) if not a.terminal_status()]


# -- (a) the reference's TestServerEndToEnd cases -------------------------------


def test_register_and_deregister(monkeypatch):
    with server_pair(monkeypatch, num_workers=1) as p:
        for i in range(3):
            p.node(rack_node(i))
        job = ref_mock.job(id="web", name="web")
        ref_ev, port_ev = p.job(job)
        p.drain()
        assert len(p.same_placements("web")) == 10
        assert p.ref.store.eval_by_id(ref_ev.id).status == "complete"
        assert p.port.store.eval_by_id(port_ev.id).status == "complete"
        p.call("deregister_job", "default", "web")
        p.drain()
        assert p.same_placements("web") == []


def test_node_down_triggers_reschedule(monkeypatch):
    with server_pair(monkeypatch, num_workers=1) as p:
        for i in range(3):
            p.node(rack_node(i))
        p.job(ref_mock.job(id="web", name="web"))
        p.drain()
        victims = p.port.store.allocs_by_node("node-000")
        assert victims
        evals = p.call("update_node_status", "node-000", "down")
        assert [len(e) for e in evals] == [1, 1]
        p.drain()
        # which replacement takes which name follows the lost allocs'
        # random ids, in the reference run to run too (ROADMAP C-S1)
        placed = p.same_nodes("web")
        assert len(placed) == 10 and all(n != "node-000" for _j, _a, n in placed)


def test_blocked_eval_unblocks_on_new_node(monkeypatch):
    with server_pair(monkeypatch, num_workers=1) as p:
        p.node(rack_node(0))
        job = ref_mock.job(id="big", name="big")
        job.task_groups[0].count = 30  # one node cannot hold 30 x 500 MHz
        p.job(job)
        p.drain()
        assert len(p.same_placements("big")) < 30
        assert [s.blocked_evals.blocked_count() for s in p.servers] == [1, 1]
        with p.paused():  # all four nodes in before the unblocked eval runs
            for i in range(1, 5):
                p.node(rack_node(i))
        p.drain()
        assert len(p.same_placements("big")) == 30
        assert [s.blocked_evals.blocked_count() for s in p.servers] == [0, 0]


def test_system_job_covers_new_nodes(monkeypatch):
    with server_pair(monkeypatch, num_workers=1) as p:
        p.node(rack_node(0))
        job = ref_mock.system_job(id="sys", name="sys")
        p.job(job)
        p.drain()
        assert len(p.same_placements("sys")) == 1
        p.node(rack_node(1))
        p.call("update_node_status", "node-001", "ready")
        p.drain()
        assert {n for _j, _a, n in p.same_placements("sys")} == {"node-000", "node-001"}


# -- (b) a spread + affinity stream, one job at a time ---------------------------


def test_spread_affinity_stream_one_job_at_a_time(monkeypatch):
    with server_pair(monkeypatch, num_workers=1) as p:
        for i in range(N_NODES):
            p.node(rack_node(i))
        total = 0
        for j in range(6):
            count = 12 + 4 * (j % 3)
            p.job(spread_job(j, count))
            p.drain()
            total += count
            assert len(p.same_placements("stream-")) == total


# -- (c) ten jobs in one merged, decorrelated pass -------------------------------


def test_ten_jobs_in_one_merged_decorrelated_pass(monkeypatch):
    with server_pair(monkeypatch, num_workers=1) as p:
        for i in range(N_NODES):
            p.node(rack_node(i))
        with p.paused():
            ref_metrics.reset()
            port_metrics.reset()
            for j in range(10):
                p.job(spread_job(j, 10))
        p.drain()
        assert len(p.same_placements("stream-")) == 100
        got, want = counters(port_metrics), counters(ref_metrics)
        assert got == want
        assert got["nomad.worker.batch_evals_completed"] == 10
        assert got["nomad.plan.merged_members"] == 10
        assert got["nomad.worker.batch_kernel_errors"] == 0


# -- (d) lane decorrelation ---------------------------------------------------


def _cluster_and_asks(monkeypatch, n_jobs=6):
    """The reference's ClusterTensors and group asks of ``n_jobs`` jobs on
    the rack cluster (half spread + affinity, half plain), and the port's
    copies of both."""
    store = RefStore()
    for i in range(N_NODES):
        store.upsert_node(1, rack_node(i))
    jobs = []
    for j in range(n_jobs):
        job = spread_job(j, 8 + j) if j % 2 else ref_mock.job(id=f"plain-{j}")
        job.task_groups[0].count = 8 + j
        store.upsert_job(2, job)
        jobs.append(job)
    snap = store.snapshot()
    with reference_runtime(monkeypatch):
        ct = RefCache().tensors(snap)
        asks = [ref_flatten(ct, snap, job, job.task_groups[0], 8 + j)
                for j, job in enumerate(jobs)]
    fields = {f.name: getattr(ct, f.name) for f in dataclasses.fields(ct)}
    port_ct = interop.cluster_from_numpy(fields)
    port_asks = interop.asks_from_numpy([dataclasses.asdict(a) for a in asks])
    return ct, asks, port_ct, port_asks


@pytest.mark.parametrize("salt, workers", [(0, 1), (3, 1), (1, 2)])
def test_decorrelate_lanes_matches_reference(monkeypatch, salt, workers):
    ct, asks, port_ct, port_asks = _cluster_and_asks(monkeypatch)
    used0 = np.asarray(ct.used).copy()
    used0[::5, 0] += 1500.0  # an overlay's in-flight usage
    want = ref_decorrelate(ct, asks, salt=salt, used0=used0, n_workers=workers)
    got = _decorrelate_lanes(port_ct, port_asks, salt=salt, used0=used0, n_workers=workers)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.eligible, w.eligible)
    assert any((g.eligible != a.eligible).any() for g, a in zip(got, port_asks))


@pytest.mark.parametrize("salt", [0, 5])
def test_place_decorrelated_matches_reference(monkeypatch, salt):
    ct, asks, port_ct, port_asks = _cluster_and_asks(monkeypatch)
    with reference_runtime(monkeypatch):
        want = RefKernel().place(ct, asks, decorrelate=True, decorrelate_salt=salt,
                                 overflow=32)
    got = PlacementKernel(device="cpu").place(
        port_ct, port_asks, decorrelate=True, decorrelate_salt=salt, overflow=32
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.node_rows, np.asarray(w.node_rows))
        np.testing.assert_array_equal(g.overflow_rows, np.asarray(w.overflow_rows))
        np.testing.assert_allclose(g.scores, np.asarray(w.scores), rtol=1e-5)


# -- (e) lanes ---------------------------------------------------------------


@pytest.mark.parametrize("lanes, workers", [(16, 1), (16, 3), (7, 4)])
def test_lane_map_matches_reference_on_1000_jobs(lanes, workers):
    ref, port = RefLaneMap(lanes, workers), LaneMap(lanes, workers)
    ids = [f"job-{i}-{zlib.crc32(str(i).encode())}" for i in range(1000)]
    for ns in ("default", "team-a"):
        assert [port.lane_of_job(ns, j) for j in ids] == [ref.lane_of_job(ns, j) for j in ids]
        assert [port.owner_of_job(ns, j) for j in ids] == [ref.owner_of_job(ns, j) for j in ids]
    assert [port.owner_of_node(j) for j in ids] == [ref.owner_of_node(j) for j in ids]
    assert port.assignments() == ref.assignments()


def _lane_stream(workers):
    s = Server(ServerConfig(
        num_workers=workers, num_batch_workers=workers, lane_mode=True, device="cpu",
    ))
    s.establish_leadership()
    try:
        for i in range(12):
            s.register_node(port_of(ref_mock.node(id=f"lane-node-{i:02d}",
                                                  name=f"lane-node-{i:02d}"), Node))
        for seq in range(8):
            job = ref_mock.job(id=f"lane-job-{seq:03d}", name=f"lane-job-{seq:03d}")
            job.task_groups[0].count = 1 + seq % 3
            job.task_groups[0].tasks[0].resources.cpu = 200 + 50 * (seq % 3)
            s.register_job(port_of(job, Job))
            assert s.wait_for_evals(timeout=WAIT_S)
            deadline = time.time() + WAIT_S
            while not (s.lane_claims.drained() and s.lane_claims.settled_count() == 0):
                assert time.time() < deadline
                time.sleep(0.01)
        return placements(s, "lane-job-")
    finally:
        s.shutdown()


def test_two_lane_workers_place_as_one():
    one, two = _lane_stream(1), _lane_stream(2)
    assert one == two
    assert len(one) == sum(1 + seq % 3 for seq in range(8))


# -- (f) the broker, blocked evals and the plan queue --------------------------


class FakeClock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now


def _evals():
    """Ten evals over four jobs, two types, three priorities."""
    out = []
    for i in range(10):
        ev = ref_mock.eval_for(
            ref_mock.batch_job(id=f"job-{i % 4}") if i % 3 == 0
            else ref_mock.job(id=f"job-{i % 4}"),
            priority=(30, 50, 70)[i % 3],
        )
        ev.id = f"eval-{i:02d}"
        out.append(ev)
    return out


def _broker_script(broker_cls, evals, clock):
    broker = broker_cls(nack_delay=5.0, initial_nack_delay=1.0, delivery_limit=2,
                        unack_timeout=30.0, clock=clock)
    broker.set_enabled(True)
    log = []
    broker.enqueue_all(evals[:6])
    ev, tok = broker.dequeue(["service", "batch"], timeout=0)
    log.append(("dequeue", ev.id))
    broker.ack(ev.id, tok)
    got = broker.dequeue_many(["service", "batch"], 3, timeout=0)
    log.append(("many", [e.id for e, _ in got]))
    first, tok1 = got[0]
    broker.nack(first.id, tok1)
    for e, t in got[1:]:
        broker.ack(e.id, t)
    broker.enqueue_all(evals[6:])
    clock.now += 1.5  # the nacked eval's first redelivery is due
    while True:
        ev, tok = broker.dequeue(["service", "batch"], timeout=0)
        if ev is None:
            break
        log.append(("dequeue", ev.id))
        if ev.id == first.id:
            broker.nack(ev.id, tok)  # its second delivery: the failed queue
            clock.now += 10.0
        else:
            broker.ack(ev.id, tok)
    log.append(("failed", broker.failed_eval_ids()))
    return log, dict(broker.counters), dict(broker.stats)


def test_eval_broker_order_and_counters_match_reference():
    evals = _evals()
    want = _broker_script(RefBroker, evals, FakeClock())
    got = _broker_script(EvalBroker, [port_of(e, Evaluation) for e in evals], FakeClock())
    assert got == want
    assert got[1]["nacks"] == 2 and got[0][-1] == ("failed", [got[0][1][1][0]])


def _blocked_script(blocked_cls, broker_cls, evals):
    broker = broker_cls(unack_timeout=None)
    broker.set_enabled(True)
    blocked = blocked_cls(broker=broker)
    blocked.set_enabled(True)
    for ev in evals[:6]:
        ev.status = "blocked"
        blocked.block(ev)
    counts = [blocked.blocked_count()]
    blocked.untrack("default", "job-1")
    counts.append(blocked.blocked_count())
    blocked.unblock(index=10)
    counts.append(blocked.blocked_count())
    order = []
    while True:
        ev, tok = broker.dequeue(["service", "batch"], timeout=0)
        if ev is None:
            break
        order.append(ev.id)
        broker.ack(ev.id, tok)
    return counts, order, sorted(e.id for e in blocked.captured())


def test_blocked_evals_match_reference():
    evals = _evals()
    want = _blocked_script(RefBlocked, RefBroker, evals)
    got = _blocked_script(BlockedEvals, EvalBroker, [port_of(e, Evaluation) for e in evals])
    assert got == want
    assert want[0][0] == 4 and want[1]  # one blocked eval a job


def test_plan_queue_order_matches_reference():
    from nomad_tpu.structs import Plan as RefPlan

    def run(queue_cls, plan_cls):
        q = queue_cls()
        q.set_enabled(True)
        for i, prio in enumerate((50, 70, 30, 70, 50, 100)):
            q.enqueue(plan_cls(eval_id=f"e{i}", priority=prio))
        order = []
        while q.depth():
            order.append(q.pop(timeout=0).plan.eval_id)
        q.set_enabled(False)
        return order

    assert run(PlanQueue, Plan) == run(RefPlanQueue, RefPlan) == [
        "e5", "e1", "e3", "e0", "e4", "e2"]


# -- (g) InlineRaft with a data dir ---------------------------------------------


def _store_rows(store):
    return (
        sorted((n.id, n.status) for n in store.nodes()),
        sorted((j.id, j.version, j.stop) for j in store.jobs()),
        sorted((a.id, a.job_id, a.name, a.node_id, a.desired_status) for a in store.allocs()),
        sorted((e.id, e.status) for e in store.evals()),
        store.latest_index,
    )


def test_server_reboots_from_its_raft_log(tmp_path):
    data_dir = str(tmp_path / "raft")
    s = Server(ServerConfig(num_workers=1, data_dir=data_dir, device="cpu"))
    s.establish_leadership()
    try:
        for i in range(6):
            s.register_node(port_of(rack_node(i), Node))
        for j in range(3):
            s.register_job(port_of(spread_job(j, 5), Job))
        assert s.wait_for_evals(timeout=WAIT_S)
        s.deregister_job("default", "stream-01")
        assert s.wait_for_evals(timeout=WAIT_S)
        before = _store_rows(s.store)
    finally:
        s.shutdown()
    assert len(before[2]) == 15
    rebooted = Server(ServerConfig(num_workers=1, data_dir=data_dir, device="cpu"))
    try:
        assert _store_rows(rebooted.store) == before
    finally:
        rebooted.shutdown()


# -- the endpoints that once waited for a leader service ----------------------


def _scale(p):
    p.job(ref_mock.job(id="web", name="web"))
    p.drain()
    evs = p.call("scale_job", "default", "web", "web", 3)
    assert [e.job_id for e in evs] == ["web", "web"]
    p.drain()
    assert len(p.same_placements("web")) == 3
    assert [s.store.job_by_id("default", "web").task_groups[0].count
            for s in p.servers] == [3, 3]


def _dispatch(p):
    from nomad_tpu.structs.job import ParameterizedJobConfig

    job = ref_mock.batch_job(id="param")
    job.task_groups[0].count = 2
    job.parameterized = ParameterizedJobConfig(meta_required=["who"])
    p.job(job)
    p.drain()
    out = p.call("dispatch_job", "default", "param", b"", {"who": "me"})
    assert [(c.parent_id, c.meta["who"], e.job_id == c.id) for c, e in out] == [
        ("param", "me", True)] * 2
    p.drain()
    got = [sorted((a.name.split(".", 1)[1], a.node_id) for a in s.store.allocs()
                  if a.job_id.startswith("param/dispatch-")) for s in p.servers]
    assert got[0] == got[1] and len(got[0]) == 2


def _drain(p):
    from nomad_tpu.structs import DrainStrategy as RefDrain
    from nomad_tpu_torch.structs import DrainStrategy

    p.job(ref_mock.job(id="web", name="web"))
    p.drain()
    assert [len(e) for e in p.call("update_node_drain", "node-000", None)] == [1, 1]
    p.drain()
    for s, cls in zip(p.servers, (RefDrain, DrainStrategy)):
        s.drainer.stop()
        s.update_node_drain("node-000", cls(deadline_s=-1))
    p.drain()
    for s in p.servers:
        s.drainer.scan()  # the deadline has passed: everything is marked
    p.drain()
    placed = p.same_nodes("web")
    assert len(placed) == 10 and all(n != "node-000" for _j, _a, n in placed)
    assert [s.store.node_by_id("node-000").scheduling_eligibility
            for s in p.servers] == ["ineligible"] * 2


def _volume(p):
    from nomad_tpu.structs import CSIVolume as RefVolume
    from nomad_tpu_torch.structs import CSIVolume

    for s, cls in zip(p.servers, (RefVolume, CSIVolume)):
        s.register_csi_volume(cls(id="vol1", plugin_id="ebs"))


def _register_volume(p):
    _volume(p)
    got = [(v.id, v.plugin_id, v.access_mode, v.schedulable)
           for v in (s.store.csi_volume_by_id("vol1") for s in p.servers)]
    assert got[0] == got[1] == ("vol1", "ebs", got[0][2], True)


def _deregister_volume(p):
    _volume(p)
    p.call("deregister_csi_volume", "vol1")
    assert [s.store.csi_volume_by_id("vol1") for s in p.servers] == [None, None]


def _claim_volume(p):
    _volume(p)
    assert p.call("claim_csi_volume", "vol1", "a", "node-000", False) == [True, True]
    assert [sorted(s.store.csi_volume_by_id("vol1").write_claims)
            for s in p.servers] == [["a"], ["a"]]


def _register_periodic(p):
    from nomad_tpu.structs.job import PeriodicConfig

    job = ref_mock.job(id="cron")
    job.periodic = PeriodicConfig(spec="*/5 * * * *")
    evs = p.job(job)
    assert [e.job_id for e in evs] == ["cron", "cron"]
    # a template: tracked by the dispatcher, no eval of its own
    assert [s.periodic.tracked_count() for s in p.servers] == [1, 1]
    assert [s.store.evals_by_job("default", "cron") for s in p.servers] == [[], []]


LEADER_ENDPOINTS = {
    "scale_job": _scale,
    "dispatch_job": _dispatch,
    "update_node_drain": _drain,
    "register_csi_volume": _register_volume,
    "deregister_csi_volume": _deregister_volume,
    "claim_csi_volume": _claim_volume,
    "register_job_periodic": _register_periodic,
}


@pytest.mark.parametrize("endpoint", sorted(LEADER_ENDPOINTS))
def test_leader_endpoints_match_reference(monkeypatch, endpoint):
    """The seven calls that raised until the leader services were ported
    now do on the port's server what they do on the reference's."""
    with server_pair(monkeypatch, num_workers=1) as p:
        for i in range(3):
            p.node(rack_node(i))
        assert p.port.admission is not None and p.port.eval_broker.admission is p.port.admission
        LEADER_ENDPOINTS[endpoint](p)


def test_commit_ledger_and_made_faults_reach_an_installed_plane():
    """With a fault plane installed (nothing scheduled), the applier
    reports every committed placement to its ledger exactly once, and a
    fault made at a site is registered for swallow accounting."""
    from nomad_tpu_torch import chaos

    plane = chaos.install(chaos.FaultPlane(schedule=[]))
    s = Server(ServerConfig(num_workers=1, device="cpu"))
    s.establish_leadership()
    try:
        for i in range(6):
            s.register_node(port_of(rack_node(i), Node))
        for j in range(3):
            s.register_job(port_of(spread_job(j, 5), Job))
        assert s.wait_for_evals(timeout=WAIT_S)
        placed = {a.id for a in s.store.allocs() if not a.terminal_status()}
        assert len(placed) == 15
        assert plane.committed == {aid: 1 for aid in placed}
        fault = chaos.make_fault("fsm.apply")
        assert plane.raised == [fault] and not fault.accounted
        assert plane.site_counts()["broker.dequeue"] > 0
    finally:
        s.shutdown()
        chaos.uninstall()
