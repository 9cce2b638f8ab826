"""The port's client core (``nomad_tpu_torch.client``: drivers, task and
alloc runners, local state, health tracking, the fs/logs endpoints)
against the JAX package's, on the CPU.

The scenarios of the reference's ``tests/test_client.py``,
``tests/test_alloc_health.py`` and ``tests/test_alloc_stop.py`` that use
only the builtin drivers (``mock_driver``, ``raw_exec``): each runs on
both packages and the two must give the same task states (state, failed,
restarts), alloc statuses and health verdicts. Driver and tracker
scenarios run on each package's own objects; whole-agent scenarios on the
agent pair of ``test_torch_api.py`` (the same node id and name, one
worker each), jobs registered on both as the reference's mock objects,
carried into the port through ``interop.from_record`` so ids match;
restore and fs/logs scenarios on a server + client of each package.
Allocs compare by name (their ids are random), ``alloc stop``'s output
after ``test_torch_cli.normalize_output``.

The reference's server schedules through its ``traced_jit`` kernels under
the scoped ``trace_state_clean`` monkeypatch (ROADMAP C-R1). Every agent,
server and client stops in a ``finally``; every wait has a deadline. No
numeric tolerance applies: everything compared is exact.
"""

import copy
import dataclasses
import http.server
import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field

import pytest

from nomad_tpu import mock as ref_mock
from nomad_tpu.api.client import NomadClient as RefNomadClient
from nomad_tpu.api.http import HTTPAgent as RefHTTPAgent
from nomad_tpu.cli import main as ref_cli
from nomad_tpu.client import allochealth as ref_health
from nomad_tpu.client import drivers as ref_drivers
from nomad_tpu.client.client import Client as RefClient
from nomad_tpu.client.task_runner import TaskRunner as RefTaskRunner
from nomad_tpu.server.server import Server as RefServer
from nomad_tpu.server.server import ServerConfig as RefServerConfig
from nomad_tpu.structs import Service as RefService
from nomad_tpu.structs import ServiceCheck as RefServiceCheck
from nomad_tpu.structs import Task as RefTask
from nomad_tpu.structs.job import RestartPolicy as RefRestartPolicy
from nomad_tpu.structs.job import UpdateStrategy
from nomad_tpu_torch import interop
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch.api.client import NomadClient
from nomad_tpu_torch.api.http import HTTPAgent
from nomad_tpu_torch.cli import main as port_cli
from nomad_tpu_torch.client import allochealth as port_health
from nomad_tpu_torch.client import drivers as port_drivers
from nomad_tpu_torch.client.client import Client
from nomad_tpu_torch.client.task_runner import TaskRunner
from nomad_tpu_torch.server.server import Server, ServerConfig
from nomad_tpu_torch.structs import Job, Service, ServiceCheck, Task
from nomad_tpu_torch.structs.job import RestartPolicy
from test_torch_api import AgentPair, wait_until
from test_torch_cli import normalize_output
from test_torch_hetero import reference_runtime

WAIT_S = 30.0

# (package name, drivers module, Task, RestartPolicy, TaskRunner)
PACKAGES = (
    ("reference", ref_drivers, RefTask, RefRestartPolicy, RefTaskRunner),
    ("port", port_drivers, Task, RestartPolicy, TaskRunner),
)


def port_of(obj, cls):
    """The port's copy of a reference struct, field for field."""
    return interop.from_record(cls, dataclasses.asdict(obj))


def both(fn):
    """``fn(*package)`` on each package: (reference, port)."""
    return tuple(fn(*pkg) for pkg in PACKAGES)


# -- tests/test_client.py::TestDrivers / TestTaskRunner ------------------------


def _mock_run(drv, Task, config):
    d = drv.MockDriver()
    h = d.start(Task(name="t", driver="mock_driver", config=config), {}, "/tmp")
    return d.wait(h), h.state


@pytest.mark.parametrize(
    "config",
    [{"run_for": 0.05}, {"run_for": 0.01, "exit_code": 2}],
    ids=["completes", "fails"],
)
def test_mock_driver(config):
    ref, port = both(lambda name, drv, Task, *_: _mock_run(drv, Task, config))
    assert port == ref and port[1] == "dead"


def test_mock_driver_start_error():
    def start(name, drv, Task, *_):
        with pytest.raises(drv.DriverError) as e:
            drv.MockDriver().start(Task(name="t", config={"start_error": "boom"}), {}, "/tmp")
        return str(e.value)

    ref, port = both(start)
    assert port == ref


def test_raw_exec_runs_command_and_stop_kills(tmp_path):
    def run(name, drv, Task, *_):
        d = drv.RawExecDriver()
        work = tmp_path / name
        work.mkdir()
        t = Task(name="echo", driver="raw_exec",
                 config={"command": "/bin/sh", "args": ["-c", "echo hello > out.txt"]})
        h = d.start(t, {}, str(work))
        code = d.wait(h, timeout=5)
        sleeper = d.start(Task(name="sleeper", config={"command": "/bin/sleep", "args": ["30"]}),
                          {}, str(work))
        d.stop(sleeper, kill_timeout=1.0)
        killed = d.wait(sleeper, timeout=5)
        return code, (work / "out.txt").read_text(), killed

    ref, port = both(run)
    assert port == ref and port[:2] == (0, "hello\n") and port[2] not in (None, 0)


@pytest.mark.parametrize(
    "config, attempts",
    [({"run_for": 0.0, "exit_code": 1}, 2), ({"run_for": 0.01, "exit_code": 0}, None)],
    ids=["restart_policy_exhaustion", "successful_task_no_restart"],
)
def test_task_runner(tmp_path, config, attempts):
    def run(name, drv, Task, RestartPolicy, TaskRunner):
        kw = {}
        if attempts is not None:
            kw["restart_policy"] = RestartPolicy(attempts=attempts, interval_s=60, delay_s=0.01)
        tr = TaskRunner(task=Task(name="flaky", config=config), driver=drv.MockDriver(),
                        task_dir=str(tmp_path), env={}, **kw)
        tr.start()
        tr.join(timeout=10)
        return tr.state.state, tr.state.failed, tr.state.restarts

    ref, port = both(run)
    assert port == ref == (("dead", True, 2) if attempts else ("dead", False, 0))


# -- whole-agent scenarios (TestDevAgent, check-gated deployments, alloc stop) -


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    with reference_runtime(pytest.MonkeyPatch()):
        p = AgentPair(tmp_path_factory)
        try:
            for side in p.sides:
                side.agent.server.config.deployment_watch_interval = 0.05
                side.agent.server.deployment_watcher.interval = 0.05
            yield p
        finally:
            p.stop()


def register(pair, job):
    """The reference's mock job on both agents, ids equal."""
    pair.ref.agent.register_job(copy.deepcopy(job))
    pair.port.agent.register_job(port_of(job, Job))


def allocs(side, job):
    return sorted(side.agent.store.allocs_by_job(job.namespace, job.id), key=lambda a: a.name)


def alloc_view(side, job):
    """Per alloc, by name: client status and the task states."""
    return [
        (a.name, a.desired_status, a.client_status,
         {t: (s["state"], s["failed"], s["restarts"]) if isinstance(s, dict)
          else (s.state, s.failed, s.restarts)
          for t, s in sorted(a.task_states.items())})
        for a in allocs(side, job)
    ]


def settle(pair, job, cond):
    for side in pair.sides:
        assert wait_until(lambda s=side: cond(allocs(s, job)), timeout=WAIT_S), side.name


def test_end_to_end_batch_job(pair):
    job = ref_mock.batch_job()
    job.task_groups[0].count = 2
    job.task_groups[0].tasks[0].driver = "mock_driver"
    job.task_groups[0].tasks[0].config = {"run_for": 0.05}
    register(pair, job)
    settle(pair, job, lambda al: len(al) == 2 and all(a.client_status == "complete" for a in al))
    ref, port = (alloc_view(s, job) for s in pair.sides)
    assert port == ref


def test_end_to_end_raw_exec(pair):
    job = ref_mock.batch_job()
    job.task_groups[0].count = 1
    t = job.task_groups[0].tasks[0]
    t.driver = "raw_exec"
    t.config = {"command": "/bin/sh", "args": ["-c", "echo ran > $NOMAD_TASK_DIR/proof"]}
    register(pair, job)
    settle(pair, job, lambda al: any(a.client_status == "complete" for a in al))
    assert alloc_view(pair.port, job) == alloc_view(pair.ref, job)
    for side in pair.sides:  # the task wrote through its task dir
        a = allocs(side, job)[0]
        proof = os.path.join(side.agent.data_dir, "allocs", a.id, t.name, "local", "proof")
        assert open(proof).read() == "ran\n", side.name


def test_service_job_runs_and_stops(pair):
    job = ref_mock.job()
    job.task_groups[0].count = 2
    job.task_groups[0].tasks[0].driver = "mock_driver"
    job.task_groups[0].tasks[0].config = {"run_for": 300}
    register(pair, job)
    settle(pair, job, lambda al: len([a for a in al if a.client_status == "running"]) == 2)
    assert alloc_view(pair.port, job) == alloc_view(pair.ref, job)
    before = {s.name: s.agent.client.num_allocs() for s in pair.sides}
    assert before["port"] == before["reference"]
    for side in pair.sides:
        side.agent.deregister_job(job.namespace, job.id)
    settle(pair, job, lambda al: all(a.client_status in ("complete", "failed") for a in al))
    assert alloc_view(pair.port, job) == alloc_view(pair.ref, job)


def test_failed_task_reported(pair):
    job = ref_mock.batch_job()
    job.task_groups[0].count = 1
    job.task_groups[0].tasks[0].driver = "mock_driver"
    job.task_groups[0].tasks[0].config = {"run_for": 0.01, "exit_code": 3}
    job.task_groups[0].restart_policy.attempts = 0
    job.task_groups[0].restart_policy.mode = "fail"
    register(pair, job)
    settle(pair, job, lambda al: any(a.client_status == "failed" for a in al))

    def first_failed(s):  # the reschedule policy may already have replaced it
        a = min((a for a in allocs(s, job) if a.client_status == "failed"),
                key=lambda a: a.create_index)
        return a.name, a.client_status, a.task_states

    ref, port = (first_failed(s) for s in pair.sides)
    assert port == ref
    assert port[2][job.task_groups[0].tasks[0].name] == {
        "state": "dead", "failed": True, "restarts": 0}


@pytest.fixture()
def listener():
    """A live TCP listener the checks point at."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    s.listen(8)

    def drain():
        while True:
            try:
                conn, _ = s.accept()
                conn.close()
            except OSError:
                return

    threading.Thread(target=drain, daemon=True).start()
    try:
        yield s.getsockname()[1]
    finally:
        s.close()


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def checked_job(port, count=2, **update_kw):
    job = ref_mock.job()
    tg = job.task_groups[0]
    tg.count = count
    tg.tasks[0].driver = "mock_driver"
    tg.tasks[0].config = {"run_for": 600}
    tg.tasks[0].resources.cpu = 100
    tg.tasks[0].resources.memory_mb = 64
    tg.tasks[0].services = [RefService(name="web", checks=[
        RefServiceCheck(type="tcp", port=port, interval_s=0.1, timeout_s=0.3)])]
    defaults = dict(max_parallel=1, min_healthy_time_s=0.3, healthy_deadline_s=3.0)
    defaults.update(update_kw)
    tg.update = UpdateStrategy(**defaults)
    return job


def live(side, job):
    return [a for a in allocs(side, job) if not a.terminal_status()]


def deployments(side, job):
    return sorted(
        ((d.job_version, d.status) for d in side.agent.store.deployments() if d.job_id == job.id)
    )


def test_passing_check_promotes_canary(pair, listener):
    job = checked_job(listener, canary=1, auto_promote=True, auto_revert=True)
    register(pair, job)  # version 0 deploys from scratch
    for side in pair.sides:
        assert wait_until(lambda s=side: len(live(s, job)) == 2, timeout=WAIT_S), side.name
    j2 = copy.deepcopy(job)
    j2.task_groups[0].tasks[0].config = {"run_for": 601}
    register(pair, j2)

    def promoted(s):
        d = s.agent.store.latest_deployment_by_job(job.namespace, job.id)
        return d is not None and d.status == "successful"

    for side in pair.sides:
        assert wait_until(lambda s=side: promoted(s), timeout=WAIT_S), side.name
    assert deployments(pair.port, job) == deployments(pair.ref, job)
    for side in pair.sides:
        side.agent.deregister_job(job.namespace, job.id)


def test_failing_check_auto_reverts(pair, listener):
    job = checked_job(listener, auto_revert=True)
    register(pair, job)
    for side in pair.sides:
        assert wait_until(lambda s=side: len(live(s, job)) == 2, timeout=WAIT_S), side.name
    # the new version RUNS, but its check targets a closed port
    j2 = copy.deepcopy(job)
    j2.task_groups[0].tasks[0].config = {"run_for": 602}
    j2.task_groups[0].tasks[0].services[0].checks[0].port = free_port()
    register(pair, j2)

    def reverted(s):
        cur = s.agent.store.job_by_id(job.namespace, job.id)
        return cur.version > j2.version and cur.task_groups[0].tasks[0].config.get(
            "run_for") == 600

    for side in pair.sides:
        assert wait_until(lambda s=side: reverted(s), timeout=40.0), side.name
    failed = {s.name: [v for v, st in deployments(s, job) if st == "failed"] for s in pair.sides}
    assert failed["port"] == failed["reference"] and failed["port"]
    for side in pair.sides:
        side.agent.deregister_job(job.namespace, job.id)


def test_alloc_stop_replaces(pair, capsys):
    """tests/test_alloc_stop.py: ``alloc stop`` through the HTTP API and
    the CLI stops the alloc and the scheduler replaces it."""
    job = ref_mock.job()
    job.id = "stoppable"
    tg = job.task_groups[0]
    tg.count = 1
    tg.tasks[0].driver = "mock_driver"
    tg.tasks[0].config = {"run_for": 600}
    tg.tasks[0].resources.cpu = 50
    tg.tasks[0].resources.memory_mb = 32
    register(pair, job)

    def running(s):
        al = live(s, job)
        return al if al and al[0].client_status == "running" else None

    old, outs = {}, []
    for cli, side in ((ref_cli, pair.ref), (port_cli, pair.port)):
        assert wait_until(lambda s=side: running(s) is not None, timeout=WAIT_S), side.name
        old[side.name] = running(side)[0]
        capsys.readouterr()
        assert cli.main(["--address", side.address, "alloc", "stop",
                         old[side.name].id]) == 0
        outs.append(normalize_output(capsys.readouterr().out, side.agent.store,
                                     side.placeholders()))
    assert outs[0] == outs[1] and "stopping" in outs[1][1]

    def replaced(s):
        cur = allocs(s, job)
        fresh = [a for a in cur if a.id != old[s.name].id and not a.terminal_status()]
        old_now = next((a for a in cur if a.id == old[s.name].id), None)
        return bool(fresh) and (old_now is None or old_now.desired_status != "run")

    for side in pair.sides:
        assert wait_until(lambda s=side: replaced(s), timeout=WAIT_S), side.name
    assert pair.port.agent.server.stop_alloc("nonexistent") is None
    assert pair.ref.agent.server.stop_alloc("nonexistent") is None
    for side in pair.sides:
        side.agent.deregister_job(job.namespace, job.id)


# -- tests/test_alloc_health.py: checks and the tracker ------------------------


def test_evaluate_check(listener):
    class H(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            self.send_response(200 if self.path == "/ok" else 500)
            self.end_headers()

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        hp = srv.server_address[1]
        cases = [
            dict(type="tcp", port=listener), dict(type="tcp", port=free_port(), timeout_s=0.2),
            dict(type="http", port=hp, path="/ok"), dict(type="http", port=hp, path="/bad"),
            dict(type="script", command="/bin/true"), dict(type="script", command="/bin/false"),
        ]
        ref = [ref_health.evaluate_check(RefServiceCheck(**c)) for c in cases]
        port = [port_health.evaluate_check(ServiceCheck(**c)) for c in cases]
    finally:
        srv.shutdown()
        srv.server_close()
    assert port == ref == [True, False, True, False, True, False]


@dataclass
class _FakeState:
    state: str = "running"
    failed: bool = False
    restarts: int = 0


@dataclass
class _FakeRunner:
    alloc: object = None
    task_states: dict = field(default_factory=dict)


def _runner(mock, Service, check):
    job = mock.job()
    task = job.task_groups[0].tasks[0]
    task.services = [Service(name="web", checks=[check])]
    alloc = mock.alloc(job=job)
    alloc.deployment_id = "dep-1"
    alloc.task_group = job.task_groups[0].name
    return _FakeRunner(alloc=alloc, task_states={task.name: _FakeState()})


TRACKER_PACKAGES = (
    (ref_mock, RefService, RefServiceCheck, ref_health),
    (port_mock, Service, ServiceCheck, port_health),
)


def _verdicts(check_kw, window, deadline, join_s, prepare=None):
    """Each package's tracker over the same check, both at once; the
    verdicts each reported."""
    got, trackers, stop = [], [], threading.Event()
    for mock, Svc, Check, health in TRACKER_PACKAGES:
        runner = _runner(mock, Svc, Check(**check_kw))
        if prepare is not None:
            prepare(runner, stop)
        out = []
        got.append(out)
        t = health.AllocHealthTracker(
            runner, None, on_health=lambda aid, h, o=out: o.append(h),
            min_healthy_time_s=window, healthy_deadline_s=deadline,
        )
        t.start()
        trackers.append(t)
    try:
        for t in trackers:
            t.join(timeout=join_s)
    finally:
        stop.set()
    return got


def _flap(runner, stop):
    state = next(iter(runner.task_states.values()))

    def flap():
        while not stop.is_set():
            state.restarts += 1
            time.sleep(0.3)

    threading.Thread(target=flap, daemon=True).start()


def _dead(runner, stop):
    st = next(iter(runner.task_states.values()))
    st.state, st.failed = "dead", True


@pytest.mark.parametrize("case", ["healthy_window", "failing_check", "flapping", "dead_task"])
def test_tracker_verdicts(listener, case):
    ref, port = {
        "healthy_window": lambda: _verdicts(
            dict(type="tcp", port=listener, interval_s=0.1), 0.4, 5.0, 5),
        "failing_check": lambda: _verdicts(
            dict(type="tcp", port=free_port(), interval_s=0.1, timeout_s=0.2), 0.2, 1.0, 8),
        "flapping": lambda: _verdicts(
            dict(type="tcp", port=listener, interval_s=0.1), 1.0, 2.5, 10, _flap),
        "dead_task": lambda: _verdicts(
            dict(type="tcp", port=free_port()), 5.0, 30.0, 5, _dead),
    }[case]()
    assert port == ref == [case == "healthy_window"]


# -- tests/test_client.py::TestClientRestore / TestFsLogs ----------------------


SERVERS = (
    ("reference", RefServer, RefServerConfig, RefClient, RefHTTPAgent, RefNomadClient, ref_mock),
    ("port", Server, lambda **kw: ServerConfig(device="cpu", **kw), Client, HTTPAgent,
     NomadClient, None),
)


class _ServerClient:
    """A server and a client of one package, stopped in ``close``."""

    def __init__(self, pkg, data_dir, with_http=False):
        name, server_cls, config_cls, client_cls, http_cls, sdk_cls, _ = pkg
        self.name, self.client_cls = name, client_cls
        self.srv = server_cls(config_cls(num_workers=1))
        self.srv.establish_leadership()
        self.clients, self.http = [], None
        self.client = self.new_client(data_dir)
        if with_http:
            self.http = http_cls(self.srv, self.client, port=0)
            self.http.start()
            self.sdk = sdk_cls(self.http.address)

    def new_client(self, data_dir, node=None):
        c = self.client_cls(self.srv.client_rpc(), data_dir=data_dir, node=node,
                            heartbeat_interval=0.2)
        c.start()
        self.clients.append(c)
        return c

    def register(self, job):
        self.srv.register_job(copy.deepcopy(job) if self.name == "reference"
                              else port_of(job, Job))

    def wait_alloc(self, job, status):
        def got():
            al = self.srv.store.allocs_by_job("default", job.id)
            return al[0] if al and al[0].client_status == status else None

        assert wait_until(lambda: got() is not None, timeout=WAIT_S), (self.name, status)
        return got()

    def close(self):
        try:
            if self.http is not None:
                self.http.stop()
        finally:
            for c in self.clients:
                c.shutdown()
            self.srv.shutdown()


@pytest.fixture
def server_clients(tmp_path):
    """Build (package → _ServerClient) on demand; the reference's lives
    under the scoped monkeypatch; all stop in a ``finally``."""
    made = []

    def make(pkg, sub, **kw):
        sc = _ServerClient(pkg, str(tmp_path / pkg[0] / sub), **kw)
        made.append(sc)
        return sc

    with reference_runtime(pytest.MonkeyPatch()):
        try:
            yield make
        finally:
            for sc in made:
                sc.close()


def _pid_alive(pid):
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False


def test_restart_reattaches_to_live_process(server_clients, tmp_path):
    job = ref_mock.job()
    job.task_groups[0].count = 1
    t = job.task_groups[0].tasks[0]
    t.driver = "raw_exec"
    t.config = {"command": "/bin/sh", "args": ["-c", "sleep 60"]}
    outcomes = []
    for pkg in SERVERS:
        sc = server_clients(pkg, "c")
        sc.register(job)
        sc.wait_alloc(job, "running")
        runner = next(iter(sc.client.runners.values()))
        pid = runner.task_runners[t.name].handle.pid
        sc.client.shutdown(halt_tasks=False)  # a client restart that keeps its tasks
        survived = _pid_alive(pid)
        c2 = sc.new_client(sc.client.data_dir, node=sc.client.node)

        def handle():
            r2 = next(iter(c2.runners.values()), None)
            tr = r2.task_runners.get(t.name) if r2 is not None else None
            return tr.handle if tr is not None else None

        assert wait_until(lambda: handle() is not None, timeout=10), pkg[0]
        h2 = handle()
        outcomes.append((survived, h2.pid == pid, bool(h2.meta.get("recovered")),
                         _pid_alive(pid)))
        c2.shutdown()  # halt_tasks=True kills the sleep
        assert wait_until(lambda: not _pid_alive(pid), timeout=5), pkg[0]
    assert outcomes[1] == outcomes[0] == (True, True, True, True)


def test_completed_alloc_not_rerun_on_restore(server_clients, tmp_path):
    counts = []
    for pkg in SERVERS:
        marker = tmp_path / f"{pkg[0]}-ran-count"
        job = ref_mock.job(type="batch")
        job.task_groups[0].count = 1
        t = job.task_groups[0].tasks[0]
        t.driver = "raw_exec"
        t.config = {"command": "/bin/sh", "args": ["-c", f"echo run >> {marker}"]}
        sc = server_clients(pkg, "c")
        sc.register(job)
        sc.wait_alloc(job, "complete")
        first = marker.read_text().count("run")
        sc.client.shutdown(halt_tasks=False)
        sc.new_client(sc.client.data_dir)
        time.sleep(1.0)
        counts.append((first, marker.read_text().count("run")))
    assert counts[1] == counts[0] == (1, 1)  # not re-run


def test_logs_and_fs_through_http(server_clients):
    job = ref_mock.job(type="batch")
    job.task_groups[0].count = 1
    t = job.task_groups[0].tasks[0]
    t.driver = "raw_exec"
    t.config = {"command": "/bin/sh", "args": [
        "-c", "echo hello-stdout; echo hello-stderr 1>&2; echo data > out.txt"]}
    seen = []
    for pkg in SERVERS:
        sc = server_clients(pkg, "c", with_http=True)
        sc.register(job)
        alloc = sc.wait_alloc(job, "complete")
        base = sc.http.address

        def get(path):
            with urllib.request.urlopen(base + path, timeout=10) as r:
                return r.read()

        names = sorted(e["name"] for e in json.loads(
            get(f"/v1/client/fs/ls/{alloc.id}?path={t.name}")))
        cat = json.loads(get(f"/v1/client/fs/cat/{alloc.id}?path={t.name}/out.txt"))["data"]
        logs = {}
        for stream in ("stdout", "stderr"):
            frames = [json.loads(line) for line in get(
                f"/v1/client/fs/logs/{alloc.id}?task={t.name}&type={stream}").splitlines()
                if line]
            logs[stream] = "".join(f["data"] for f in frames)
        seen.append((names, cat, logs))
        if sc.name == "port":
            # a path escape: the port's RPC server answers with the error at
            # once; the reference's swallows it and its HTTP proxy answers
            # 500 only when its 10 s RPC timeout ends (ROADMAP C-R8)
            t0 = time.monotonic()
            with pytest.raises(urllib.error.HTTPError) as e:
                get(f"/v1/client/fs/cat/{alloc.id}?path=../../../etc/passwd")
            assert e.value.code == 500 and time.monotonic() - t0 < 5.0
            assert "path escapes alloc dir" in e.value.read().decode()
    assert seen[1] == seen[0]
    names, cat, logs = seen[1]
    assert "out.txt" in names and f"{t.name}.stdout" in names and cat == "data\n"
    assert logs == {"stdout": "hello-stdout\n", "stderr": "hello-stderr\n"}


def test_follow_streams_live_output(server_clients):
    job = ref_mock.job()
    job.task_groups[0].count = 1
    t = job.task_groups[0].tasks[0]
    t.driver = "raw_exec"
    t.config = {"command": "/bin/sh", "args": [
        "-c", "for i in 1 2 3; do echo tick-$i; sleep 0.3; done; sleep 30"]}
    seen = {}
    for pkg in SERVERS:
        sc = server_clients(pkg, "c", with_http=True)
        sc.register(job)
        alloc = sc.wait_alloc(job, "running")
        got = []

        def reader(sdk=sc.sdk, alloc_id=alloc.id, got=got):
            for frame in sdk.allocations.logs(alloc_id, t.name, follow=True):
                got.append(frame["data"])
                if "tick-3" in "".join(got):
                    return

        th = threading.Thread(target=reader, daemon=True)
        th.start()
        th.join(timeout=10)
        seen[pkg[0]] = "".join(got)
    assert seen["port"] == seen["reference"] == "tick-1\ntick-2\ntick-3\n"
