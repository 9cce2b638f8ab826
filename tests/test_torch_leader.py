"""The port's leader services against the JAX package's, on the CPU.

Both servers run one batching worker under the scoped
``reference_runtime`` (ROADMAP C-R1) and get the same nodes, jobs and
calls (reference mock objects carried into the port through
``interop.from_record``). The services that run on timers (drainer,
deployment watcher, periodic dispatch, core GC, volume watcher, defrag)
are stopped after leadership and driven by hand, one step at a time on
both servers (the defrag controller's thread, which runs only when
triggered, stays up and its cycles are called by hand), and a fake client flips pending allocs to running between
steps, so that every step sees the same state on both sides. Times come
from injected clocks (``ServerConfig.clock``, ``launch_time``, GC's
forced ``now``), never from sleeps; the heartbeat test polls only for
the heartbeater's thread to act on its fake clock.

Scenarios: the reference's ``TestServerEndToEnd`` cases that need a
service (failed-alloc replacement, the replacement chain, destructive
update, sysbatch not rerun); heartbeat expiry through ``client_rpc()``;
drains (waves under ``max_parallel``, cancel, deadline, system jobs
last); the deployment watcher through a canary rollout; ``Cron``;
periodic launch, overlap and dispatch; core GC; CSI volumes; namespaces.

Tolerance: placements, counters, levels and decisions exactly;
replacements of allocs on a lost or drained node by ``(job, node)``
counts and the set of names (ROADMAP C-S1).
"""

import contextlib
import copy
import time

import numpy as np
import pytest

from nomad_tpu import mock as ref_mock
from nomad_tpu.server import Server as RefServer
from nomad_tpu.server import ServerConfig as RefServerConfig
from nomad_tpu.structs import DrainStrategy as RefDrain
from nomad_tpu.structs import ReschedulePolicy
from nomad_tpu.structs.job import MigrateStrategy, ParameterizedJobConfig, PeriodicConfig
from nomad_tpu.structs.job import UpdateStrategy
from nomad_tpu.utils.cron import Cron as RefCron
from nomad_tpu.utils.cron import CronParseError as RefCronParseError
from nomad_tpu.utils.metrics import global_metrics as ref_metrics
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.structs import DrainStrategy, Evaluation, Job, Node
from nomad_tpu_torch.utils.cron import Cron, CronParseError
from nomad_tpu_torch.utils.metrics import global_metrics as port_metrics
from test_torch_hetero import reference_runtime
from test_torch_server import Pair, WAIT_S, placements, port_of, rack_node

# the services driven by hand once leadership is established. The defrag
# controller's thread stays up: with no interval it runs a cycle only when
# triggered, and a stopped controller plans but moves nothing.
MANUAL = ("drainer", "deployment_watcher", "periodic", "core_gc",
          "volume_watcher")


class FakeClock:
    """``ServerConfig.clock``: the wall clock stays real (broker
    deadlines), the monotonic face is moved by the test (heartbeat TTLs,
    admission)."""

    def __init__(self):
        self.mono = 1000.0

    def time(self):
        return time.time()

    def monotonic(self):
        return self.mono


class Leaders(Pair):
    """Both servers with every leader service built; the timed ones are
    stopped after leadership and stepped by the test."""

    def __init__(self, heartbeat_ttl=3600.0, **cfg):
        self.ref = RefServer(RefServerConfig(heartbeat_ttl=heartbeat_ttl, **cfg))
        self.port = Server(ServerConfig(heartbeat_ttl=heartbeat_ttl, device="cpu", **cfg))
        self.servers = (self.ref, self.port)

    def start(self):
        super().start()
        for s in self.servers:
            for name in MANUAL:
                getattr(s, name).stop()

    def each(self, fn):
        return [fn(s) for s in self.servers]

    def settle(self):
        """Drain the eval queues, then let the fake client bring every
        pending alloc up, until nothing moves."""
        for _ in range(20):
            self.drain()
            if not any(flip(s) for s in self.servers):
                return
        raise AssertionError("the servers did not settle")

    def drain_step(self):
        """One drainer scan on both servers, then settle."""
        for s in self.servers:
            s.drainer.scan()
        self.settle()

    def counter_deltas(self, names, before):
        return [
            {n: int(m.snapshot()["counters"].get(n, 0)) - b[n] for n in names}
            for m, b in zip((ref_metrics, port_metrics), before)
        ]


def counters_now(names):
    return [{n: int(m.snapshot()["counters"].get(n, 0)) for n in names}
            for m in (ref_metrics, port_metrics)]


def flip(server) -> int:
    """The fake client: every pending alloc that should run comes up
    running, in one client update. Returns how many it flipped."""
    ups = []
    for a in sorted(server.store.allocs(), key=lambda a: (a.job_id, a.name, a.node_id)):
        if a.desired_status == "run" and a.client_status == "pending":
            u = copy.copy(a)
            u.client_status = "running"
            ups.append(u)
    if ups:
        server.update_allocs_from_client(ups)
    return len(ups)


@contextlib.contextmanager
def leaders(monkeypatch, nodes=3, **cfg):
    with reference_runtime(monkeypatch):
        pair = Leaders(num_workers=1, **cfg)
        try:
            pair.start()
            for i in range(nodes):
                pair.node(rack_node(i))
            yield pair
        finally:
            pair.shutdown()


def live(server, job_id, ns="default"):
    return sorted(
        (a for a in server.store.allocs_by_job(ns, job_id) if not a.terminal_status()),
        key=lambda a: a.name,
    )


def live_on(server, node_id):
    return [a for a in server.store.allocs_by_node(node_id)
            if not a.terminal_status() and a.desired_status == "run"]


def client_update(pair, job_id, name, status):
    """Report the alloc ``name`` of ``job_id`` as ``status`` on both."""
    for s in pair.servers:
        (a,) = [x for x in live(s, job_id) if x.name == name]
        upd = a.copy_for_update()
        upd.client_status = status
        s.update_allocs_from_client([upd])


# -- the reference's TestServerEndToEnd cases that need a service --------------


def test_failed_alloc_is_replaced(monkeypatch):
    with leaders(monkeypatch, nodes=2) as p:
        job = ref_mock.job(id="web", name="web")
        job.task_groups[0].count = 2
        p.job(job)
        p.settle()
        name = live(p.port, "web")[0].name
        failed = p.each(lambda s: live(s, "web")[0].id)
        client_update(p, "web", name, "failed")
        p.settle()
        placed = p.same_placements("web")
        assert len(placed) == 2
        for s, aid in zip(p.servers, failed):
            assert aid not in {a.id for a in live(s, "web")}


def test_replacement_chain_no_churn(monkeypatch):
    with leaders(monkeypatch, nodes=2) as p:
        job = ref_mock.job(id="web", name="web")
        job.task_groups[0].count = 2
        job.task_groups[0].reschedule_policy = ReschedulePolicy(delay_s=0, unlimited=True)
        p.job(job)
        p.settle()
        name = live(p.port, "web")[0].name
        failed = p.each(lambda s: live(s, "web")[0].id)
        client_update(p, "web", name, "failed")
        p.settle()
        for s, aid in zip(p.servers, failed):
            old = s.store.alloc_by_id(aid)
            assert old.next_allocation
            repl = s.store.alloc_by_id(old.next_allocation)
            assert repl.previous_allocation == aid and repl.reschedule_tracker is not None
        before = p.same_placements("web")
        # a further no-op eval must not replace again
        ev = ref_mock.eval_for(job)
        p.ref.apply_eval_create([ev])
        p.port.apply_eval_create([port_of(ev, Evaluation)])
        p.settle()
        assert p.same_placements("web") == before and len(before) == 2


def test_destructive_update(monkeypatch):
    with leaders(monkeypatch, nodes=2) as p:
        job = ref_mock.job(id="web", name="web")
        job.task_groups[0].count = 3
        p.job(job)
        p.settle()
        j2 = copy.deepcopy(job)
        j2.task_groups[0].tasks[0].config = {"command": "/bin/other"}
        p.job(j2)
        p.settle()
        # the new version's allocs follow the random ids of the allocs
        # they replace, in the reference too (C-S1)
        assert len(p.same_nodes("web")) == 3
        got = p.each(lambda s: (
            sorted(a.job_version for a in live(s, "web")),
            sum(a.desired_status == "stop" for a in s.store.allocs_by_job("default", "web")),
        ))
        assert got[0] == got[1] == ([1, 1, 1], 3)


def test_sysbatch_completed_not_rerun(monkeypatch):
    with leaders(monkeypatch, nodes=1) as p:
        job = ref_mock.system_job(id="sb", name="sb", type="sysbatch")
        p.job(job)
        p.settle()
        (name,) = [a.name for a in live(p.port, "sb")]
        client_update(p, "sb", name, "complete")
        ev = ref_mock.eval_for(job, triggered_by="node-update")
        p.ref.apply_eval_create([ev])
        p.port.apply_eval_create([port_of(ev, Evaluation)])
        p.settle()
        assert p.each(lambda s: len(s.store.allocs_by_job("default", "sb"))) == [1, 1]


# -- heartbeats through client_rpc() ---------------------------------------------


def test_heartbeat_expiry_marks_node_down_and_reschedules(monkeypatch):
    clocks = (FakeClock(), FakeClock())
    with reference_runtime(monkeypatch):
        p = Leaders(heartbeat_ttl=10.0, num_workers=1)
        p.ref.config.clock, p.port.config.clock = clocks
        # the heartbeaters take their clock at construction
        p.ref.heartbeater._clock = clocks[0].monotonic
        p.port.heartbeater._clock = clocks[1].monotonic
        try:
            p.start()
            p.ref.heartbeater.start()
            p.port.heartbeater.start()
            rpcs = p.each(lambda s: s.client_rpc())
            for i in range(3):
                n = rack_node(i)
                rpcs[0].register_node(n)
                rpcs[1].register_node(port_of(n, Node))
            p.job(ref_mock.job(id="web", name="web"))
            p.settle()
            victims = p.each(lambda s: len(live_on(s, "node-000")))
            assert victims[0] == victims[1] > 0
            for c in clocks:
                c.mono += 6.0
            for r in rpcs:  # every node but node-000 beats in time
                assert [r.heartbeat(f"node-{i:03d}") for i in (1, 2)] == [10.0, 10.0]
            for c in clocks:
                c.mono += 6.0
            deadline = time.time() + WAIT_S
            while p.each(lambda s: s.store.node_by_id("node-000").status) != ["down", "down"]:
                assert time.time() < deadline
                time.sleep(0.05)
            p.settle()
            placed = p.same_nodes("web")
            assert len(placed) == 10 and all(n != "node-000" for _j, _a, n in placed)
            assert p.each(lambda s: s.store.node_by_id("node-001").status) == ["ready"] * 2
            # a beat from the lost node brings it back
            for r in rpcs:
                r.heartbeat("node-000")
            assert p.each(lambda s: s.store.node_by_id("node-000").status) == ["ready"] * 2
        finally:
            p.shutdown()


# -- drains -------------------------------------------------------------------------


DRAIN_COUNTERS = ("nomad.drain.migrated", "nomad.drain.force_stops")


def _serving(server, job_id, victim):
    return len([
        a for a in server.store.allocs_by_job("default", job_id)
        if not a.terminal_status() and not a.desired_transition.migrate
        and (a.client_status == "running" or a.node_id == victim)
    ])


def _drain_state(server, victim):
    node = server.store.node_by_id(victim)
    return (node.drain is None, node.scheduling_eligibility, len(live_on(server, victim)))


@pytest.mark.parametrize("max_parallel", [1, 2])
def test_drain_waves_under_max_parallel(monkeypatch, max_parallel):
    with leaders(monkeypatch, nodes=2) as p:
        job = ref_mock.job(id="web", name="web")
        job.task_groups[0].count = 6
        job.task_groups[0].migrate = MigrateStrategy(max_parallel=max_parallel)
        p.job(job)
        p.settle()
        victim = max(("node-000", "node-001"), key=lambda n: len(live_on(p.port, n)))
        on_victim = len(live_on(p.port, victim))
        assert on_victim == len(live_on(p.ref, victim)) > max_parallel
        before = counters_now(DRAIN_COUNTERS)
        p.call("update_node_drain", victim, None)  # a no-op cancel first
        for s, cls in zip(p.servers, (RefDrain, DrainStrategy)):
            s.update_node_drain(victim, cls(deadline_s=3600))
        p.settle()
        waves = []
        for _ in range(12):
            for s in p.servers:
                s.drainer.scan()
            marked = p.each(lambda s: sum(
                a.desired_transition.migrate for a in s.store.allocs_by_job("default", "web")
                if not a.terminal_status()))
            serving = p.each(lambda s: _serving(s, "web", victim))
            assert marked[0] == marked[1] <= max_parallel
            assert serving[0] == serving[1] >= 6 - max_parallel
            p.settle()
            state = p.each(lambda s: _drain_state(s, victim))
            assert state[0] == state[1]
            waves.append((marked[0], state[0]))
            if state[0][0]:
                break
        assert waves[-1][1] == (True, "ineligible", 0)
        assert len(waves) >= on_victim // max_parallel
        p.same_nodes("web")
        assert all(n != victim for _j, _a, n in placements(p.port, "web"))
        got, want = p.counter_deltas(DRAIN_COUNTERS, before)[::-1]
        assert got == want == {"nomad.drain.migrated": on_victim, "nomad.drain.force_stops": 0}


def test_drain_cancel_clears_migrate_marks(monkeypatch):
    with leaders(monkeypatch, nodes=2) as p:
        job = ref_mock.job(id="web", name="web")
        job.task_groups[0].count = 4
        job.task_groups[0].migrate = MigrateStrategy(max_parallel=1)
        p.job(job)
        p.settle()
        victim = max(("node-000", "node-001"), key=lambda n: len(live_on(p.port, n)))
        for s, cls in zip(p.servers, (RefDrain, DrainStrategy)):
            s.update_node_drain(victim, cls(deadline_s=3600))
        p.drain()
        with p.paused():  # the marks stay until the cancel
            for s in p.servers:
                s.drainer.scan()
            # which alloc is marked follows the frozenset order of the
            # node's random alloc ids, in the reference too (C-S1)
            marked = p.each(lambda s: sum(
                a.desired_transition.migrate for a in s.store.allocs_by_job("default", "web")))
            assert marked == [1, 1]
            p.call("update_node_drain", victim, None)
        p.settle()
        assert p.each(lambda s: any(
            a.desired_transition.migrate for a in s.store.allocs_by_job("default", "web")
            if not a.terminal_status())) == [False, False]
        assert p.each(lambda s: _drain_state(s, victim)[0]) == [True, True]
        p.same_nodes("web")


def test_drain_deadline_forces_remaining(monkeypatch):
    with leaders(monkeypatch, nodes=2) as p:
        job = ref_mock.job(id="web", name="web")
        job.task_groups[0].count = 6
        job.task_groups[0].migrate = MigrateStrategy(max_parallel=1)
        p.job(job)
        p.settle()
        victim = max(("node-000", "node-001"), key=lambda n: len(live_on(p.port, n)))
        on_victim = len(live_on(p.port, victim))
        before = counters_now(DRAIN_COUNTERS)
        for s, cls in zip(p.servers, (RefDrain, DrainStrategy)):
            s.update_node_drain(victim, cls(deadline_s=-1))
        p.settle()
        p.drain_step()  # one scan force-marks everything
        assert p.each(lambda s: len(live_on(s, victim))) == [0, 0]
        p.drain_step()  # and the next completes the drain
        assert p.each(lambda s: _drain_state(s, victim)) == [(True, "ineligible", 0)] * 2
        got, want = p.counter_deltas(DRAIN_COUNTERS, before)[::-1]
        assert got == want == {"nomad.drain.migrated": 0, "nomad.drain.force_stops": on_victim}
        p.same_nodes("web")


@pytest.mark.parametrize("ignore_system_jobs", [False, True])
def test_drain_system_jobs_last(monkeypatch, ignore_system_jobs):
    with leaders(monkeypatch, nodes=2) as p:
        p.job(ref_mock.system_job(id="sys", name="sys"))
        job = ref_mock.job(id="web", name="web")
        job.task_groups[0].count = 2
        job.task_groups[0].migrate = MigrateStrategy(max_parallel=2)
        p.job(job)
        p.settle()
        victim = "node-000"
        for s, cls in zip(p.servers, (RefDrain, DrainStrategy)):
            s.update_node_drain(victim, cls(deadline_s=3600,
                                            ignore_system_jobs=ignore_system_jobs))
        p.settle()
        trail = []
        for _ in range(8):
            p.drain_step()
            on = p.each(lambda s: sorted(a.job_id for a in live_on(s, victim)))
            assert on[0] == on[1]
            trail.append(on[0])
            if p.each(lambda s: _drain_state(s, victim)[0]) == [True, True]:
                break
        # the service allocs leave first; the system alloc after them,
        # or never when system jobs are ignored
        assert "web" not in trail[0]
        assert trail[-1] == (["sys"] if ignore_system_jobs else [])
        assert p.each(lambda s: _drain_state(s, victim)[1]) == ["ineligible"] * 2
        p.same_nodes()


# -- the deployment watcher -----------------------------------------------------------


def _deployment(server, job_id):
    d = server.store.latest_deployment_by_job("default", job_id)
    if d is None:
        return None
    return (d.job_version, d.status, d.requires_promotion(), sorted(
        (name, s.desired_total, s.desired_canaries, s.placed_allocs, s.healthy_allocs,
         s.unhealthy_allocs, s.promoted) for name, s in d.task_groups.items()))


def _watch_step(p):
    for s in p.servers:
        s.deployment_watcher.tick()
    p.settle()
    got = p.each(lambda s: _deployment(s, "web"))
    assert got[0] == got[1]
    return got[0]


def test_deployment_watcher_canary_rollout(monkeypatch):
    with leaders(monkeypatch, nodes=3) as p:
        job = ref_mock.job(id="web", name="web")
        job.task_groups[0].count = 3
        job.task_groups[0].tasks[0].resources.cpu = 100
        job.task_groups[0].update = UpdateStrategy(
            max_parallel=1, min_healthy_time_s=0.0, canary=1, auto_promote=False)
        p.job(job)
        p.settle()
        trail = [_watch_step(p) for _ in range(2)]
        j2 = copy.deepcopy(job)
        j2.task_groups[0].tasks[0].resources.cpu = 130
        p.job(j2)
        p.settle()
        for _ in range(3):
            trail.append(_watch_step(p))
        # one canary, the old version untouched, promotion required
        canaries = p.each(lambda s: sorted((a.name, a.node_id) for a in live(s, "web")
                                           if a.canary))
        assert canaries[0] == canaries[1] and len(canaries[0]) == 1
        assert trail[-1][1] == "running" and trail[-1][2]
        old = p.each(lambda s: sum(a.job_version == 0 for a in live(s, "web")))
        assert old == [3, 3]
        ids = p.each(lambda s: s.store.latest_deployment_by_job("default", "web").id)
        assert [s.deployment_watcher.promote(i) for s, i in zip(p.servers, ids)] == [True] * 2
        p.settle()
        for _ in range(12):
            trail.append(_watch_step(p))
            if trail[-1][1] != "running":
                break
        assert trail[-1][1] == "successful"
        assert p.each(lambda s: sorted(a.job_version for a in live(s, "web"))) == [[1] * 3] * 2
        p.same_placements("web")
        assert p.each(lambda s: s.store.job_by_id("default", "web").stable) == [True, True]


# -- cron and periodic dispatch ---------------------------------------------------------


# specs that fire within days, and rare ones: the search steps a minute
# at a time for up to a year, so the rare ones get two start times each
CRON_SPECS = ("* * * * *", "30 4 * * *", "*/15 9-17 * * 1-5", "5,35 */2 * * 0",
              "@daily", "@hourly", "0 0 * * 7", "0 3 * * 1,3")
RARE_SPECS = ("0 0 1 * *", "59 23 31 12 *", "0 12 29 2 *")


def _next_or_error(cron, t):
    try:
        return cron.next_after(t)
    except Exception as e:  # noqa: BLE001 — compared by class name and text
        return (type(e).__name__, str(e))

BAD_SPECS = ("* * *", "61 * * * *", "a * * * *", "*/0 * * * *", "* 24 * * *")


def test_cron_next_after_matches_reference():
    rng = np.random.default_rng(5)
    times = [1700000000.0, 1709164800.0, 1735689599.5, 951782400.0]
    times += [float(t) for t in rng.uniform(9.0e8, 2.0e9, size=40)]
    for spec in CRON_SPECS + RARE_SPECS:
        at = times if spec in CRON_SPECS else [1706745600.0, 1740787200.0]
        try:
            ref = RefCron(spec)
        except RefCronParseError:
            with pytest.raises(CronParseError):
                Cron(spec)
            continue
        port = Cron(spec)
        for f in ("minute", "hour", "dom", "month", "dow"):
            assert getattr(port, f, None) == getattr(ref, f, None)
        assert [_next_or_error(port, t) for t in at] == [
            _next_or_error(ref, t) for t in at]
    for bad in BAD_SPECS:
        with pytest.raises(RefCronParseError):
            RefCron(bad)
        with pytest.raises(CronParseError):
            Cron(bad)


def _periodic_job(prohibit_overlap=False):
    job = ref_mock.batch_job(id="cron")
    job.name = "cron"
    job.task_groups[0].count = 2
    job.periodic = PeriodicConfig(spec="*/5 * * * *", prohibit_overlap=prohibit_overlap)
    return job


def test_periodic_launch_and_overlap(monkeypatch):
    with leaders(monkeypatch, nodes=2) as p:
        job = _periodic_job(prohibit_overlap=True)
        ref_ev, port_ev = p.job(job)
        p.settle()
        assert p.each(lambda s: s.periodic.tracked_count()) == [1, 1]
        # the template gets no eval of its own
        assert p.each(lambda s: s.store.evals_by_job("default", "cron")) == [[], []]
        assert ref_ev.job_id == port_ev.job_id == "cron"
        templates = p.each(lambda s: s.store.job_by_id("default", "cron"))
        children = [s.periodic.force_launch(t, launch_time=1.7e9)
                    for s, t in zip(p.servers, templates)]
        assert children[0].id == children[1].id == "cron/periodic-1700000000"
        assert [c.parent_id for c in children] == ["cron", "cron"]
        p.settle()
        assert len(p.same_placements("cron/")) == 2
        # the child still runs: an overlapping launch is refused
        assert [s.periodic.force_launch(t, launch_time=1.7e9 + 300)
                for s, t in zip(p.servers, templates)] == [None, None]
        for a in live(p.port, children[1].id):
            client_update(p, children[1].id, a.name, "complete")
        p.settle()
        nxt = [s.periodic.force_launch(t, launch_time=1.7e9 + 300)
               for s, t in zip(p.servers, templates)]
        assert nxt[0].id == nxt[1].id == "cron/periodic-1700000300"
        p.settle()
        assert len(p.same_placements("cron/periodic-1700000300")) == 2
        # a same-second launch must not overwrite the prior child
        nxt = [s.periodic.force_launch(t, launch_time=1.7e9 + 300)
               for s, t in zip(p.servers, templates)]
        assert [c is None for c in nxt] == [True, True]
        p.call("deregister_job", "default", "cron")
        p.settle()
        assert p.each(lambda s: s.periodic.tracked_count()) == [0, 0]


def test_periodic_restore_at_leadership(monkeypatch):
    with reference_runtime(monkeypatch):
        p = Leaders(num_workers=0)
        try:
            job = _periodic_job()
            disabled = copy.deepcopy(job)
            disabled.id = disabled.name = "off"
            disabled.periodic.enabled = False
            for s, conv in ((p.ref, lambda j: j), (p.port, lambda j: port_of(j, Job))):
                s.store.upsert_job(1, conv(job))
                s.store.upsert_job(2, conv(disabled))
            p.start()
            assert p.each(lambda s: s.periodic.tracked_count()) == [1, 1]
            assert p.each(lambda s: sorted(s.periodic._tracked)) == [[("default", "cron")]] * 2
        finally:
            p.shutdown()


def test_parameterized_dispatch(monkeypatch):
    with leaders(monkeypatch, nodes=2) as p:
        job = ref_mock.batch_job(id="param")
        job.name = "param"
        job.task_groups[0].count = 1
        job.parameterized = ParameterizedJobConfig(
            payload="optional", meta_required=["who"], meta_optional=["why"])
        p.job(job)
        p.settle()
        assert p.each(lambda s: s.store.evals_by_job("default", "param")) == [[], []]
        for bad in ({}, {"who": "x", "bad": "y"}):
            for s in p.servers:
                with pytest.raises(ValueError):
                    s.dispatch_job("default", "param", meta=bad)
        out = p.call("dispatch_job", "default", "param", b"data", {"who": "me", "why": "test"})
        for child, ev in out:
            assert child.id.startswith("param/dispatch-")
            assert (child.parent_id, child.payload, child.meta["who"], child.meta["why"],
                    child.parameterized, ev.job_id) == (
                "param", b"data", "me", "test", None, child.id)
        p.settle()
        got = p.each(lambda s: sorted(
            (a.name.split(".", 1)[1], a.node_id) for a in s.store.allocs()
            if a.job_id.startswith("param/dispatch-") and not a.terminal_status()))
        assert got[0] == got[1] and len(got[0]) == 1


# -- core GC ----------------------------------------------------------------------------


def _gc_fixture(s, conv):
    job = ref_mock.batch_job(id="dead")
    job.name = "dead"
    job.stop = True
    job.status = "dead"
    live_job = ref_mock.job(id="alive", name="alive")
    ev = ref_mock.eval_for(job, status="complete")
    ev.id = "eval-dead"
    ev2 = ref_mock.eval_for(live_job, status="complete")
    ev2.id = "eval-alive"
    node = rack_node(9)
    down = rack_node(8)
    down.status = "down"
    a = ref_mock.alloc(job, node, client_status="complete", eval_id=ev.id)
    a.id = "alloc-dead"
    b = ref_mock.alloc(live_job, node, eval_id=ev2.id)
    b.id = "alloc-alive"
    s.store.upsert_node(1, conv(node, Node))
    s.store.upsert_node(2, conv(down, Node))
    s.store.upsert_job(3, conv(job, Job))
    s.store.upsert_job(4, conv(live_job, Job))
    s.store.upsert_evals(5, [conv(ev, Evaluation), conv(ev2, Evaluation)])
    from nomad_tpu_torch.structs import Allocation

    s.store.upsert_allocs(6, [conv(a, Allocation), conv(b, Allocation)])


def _gc_tables(s):
    return (sorted(e.id for e in s.store.evals()), sorted(a.id for a in s.store.allocs()),
            sorted(j.id for j in s.store.jobs()), sorted(n.id for n in s.store.nodes()))


def test_core_gc_at_a_forced_now(monkeypatch):
    from nomad_tpu.server.core_gc import CoreScheduler as RefGC
    from nomad_tpu.server.core_gc import GCConfig as RefGCConfig
    from nomad_tpu_torch.server.core_gc import CoreScheduler, GCConfig
    from nomad_tpu_torch.server.worker import SCHEDULER_TYPES

    assert "_core" in SCHEDULER_TYPES
    with reference_runtime(monkeypatch):
        p = Leaders(num_workers=0)
        try:
            _gc_fixture(p.ref, lambda o, _cls: o)
            _gc_fixture(p.port, port_of)
            thresholds = dict(eval_gc_threshold_s=60.0, job_gc_threshold_s=120.0,
                              node_gc_threshold_s=30.0, deployment_gc_threshold_s=60.0)
            gcs = (RefGC(p.ref, RefGCConfig(**thresholds)),
                   CoreScheduler(p.port, GCConfig(**thresholds)))
            now = 1.7e9
            trail = []
            for dt in (0.0, 31.0, 61.0, 121.0):
                stats = [gc.gc_all(now=now + dt) for gc in gcs]
                assert stats[0] == stats[1]
                tables = p.each(_gc_tables)
                assert tables[0] == tables[1]
                trail.append((stats[1], tables[1]))
            assert trail[0][0] == {"evals": 0, "jobs": 0, "nodes": 0, "deployments": 0}
            assert trail[-1][1] == (["eval-alive"], ["alloc-alive"], ["alive"], ["node-009"])
            # an operator-forced sweep waives the thresholds
            _gc_fixture(p.ref, lambda o, _cls: o)
            _gc_fixture(p.port, port_of)
            forced = [gc.gc_all(now=now + 200.0, force=True) for gc in gcs]
            assert forced[0] == forced[1] and forced[1]["jobs"] == 1
        finally:
            p.shutdown()


# -- CSI volumes ---------------------------------------------------------------------------


def test_csi_register_claim_deregister(monkeypatch):
    from nomad_tpu.structs import CSIVolume as RefVolume
    from nomad_tpu_torch.structs import CSIVolume

    with leaders(monkeypatch, nodes=2) as p:
        for s, cls in zip(p.servers, (RefVolume, CSIVolume)):
            s.register_csi_volume(cls(id="vol1", plugin_id="ebs"))
        assert p.each(lambda s: s.store.csi_volume_by_id("vol1").plugin_id) == ["ebs"] * 2
        got = [p.call("claim_csi_volume", "vol1", claim, node, ro) for claim, node, ro in (
            ("ext-1", "node-000", False), ("ext-2", "node-001", False),
            ("ext-3", "node-001", True))]
        assert got == [[True, True], [False, False], [False, False]]
        # external claims are the API's to release: the watcher keeps them
        assert p.each(lambda s: s.volume_watcher.tick()) == [0, 0]
        claims = p.each(lambda s: (
            sorted(s.store.csi_volume_by_id("vol1").write_claims),
            sorted(s.store.csi_volume_by_id("vol1").read_claims),
            sorted(s.store.csi_volume_by_id("vol1").external_claims)))
        assert claims[0] == claims[1] == (["ext-1"], [], ["ext-1"])
        errors = []
        for s in p.servers:
            with pytest.raises(Exception) as e:
                s.deregister_csi_volume("vol1")
            errors.append((type(e.value).__name__, str(e.value)))
        assert errors[0] == errors[1]
        p.call("deregister_csi_volume", "vol1", True)
        assert p.each(lambda s: s.store.csi_volume_by_id("vol1")) == [None, None]


# -- namespaces -----------------------------------------------------------------------------


def test_namespaces(monkeypatch):
    from nomad_tpu.structs.job import Namespace as RefNamespace
    from nomad_tpu_torch.structs.job import Namespace

    def names(s):
        return sorted(n.name for n in s.store.namespaces())

    with leaders(monkeypatch, nodes=1) as p:
        for s, cls in zip(p.servers, (RefNamespace, Namespace)):
            s.upsert_namespace(cls(name="prod", description="production"))
            with pytest.raises(ValueError):
                s.upsert_namespace(cls(name="bad name!"))
        assert p.each(names) == [["prod"]] * 2
        job = ref_mock.job(id="busy", name="busy", namespace="prod")
        job.task_groups[0].count = 1
        p.job(job)
        p.settle()
        assert len(p.same_placements("busy")) == 1
        errors = []
        for s in p.servers:
            with pytest.raises(Exception) as e:
                s.delete_namespace("prod")
            errors.append((type(e.value).__name__, str(e.value)))
        assert errors[0] == errors[1]
        for s, cls in zip(p.servers, (RefNamespace, Namespace)):
            s.upsert_namespace(cls(name="dev"))
        p.call("delete_namespace", "dev")
        assert p.each(names) == [["prod"]] * 2


def test_server_starts_and_stops_every_service():
    s = Server(ServerConfig(num_workers=1, device="cpu"))
    s.establish_leadership()
    try:
        threads = {name: getattr(s, name)._thread
                   for name in (*MANUAL, "defrag", "heartbeater")}
        assert all(t is not None and t.is_alive() for t in threads.values())
    finally:
        s.shutdown()
    assert not any(t.is_alive() for t in threads.values())
