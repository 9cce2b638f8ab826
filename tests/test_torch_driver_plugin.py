"""The port's out-of-process driver plugins (``nomad_tpu_torch.client.plugin``)
against the JAX package's (``nomad_tpu.client.plugin``), on the CPU.

The 12 scenarios of the reference's ``tests/test_driver_plugin.py``, each
run on both packages: the handshake, start/wait and stop through a plugin
subprocess; the mock driver through it; reattach through a plugin
restart and the refusal of a dead pid; a client in plugin mode running a
batch job end to end; the exec driver's isolation (rlimits, a scrubbed
environment, its own session) and the native executor (exit codes,
durable across a restart, stop after reattach). The isolation and
executor scenarios run twice a package: on the driver in process, as the
reference's file runs them, and through the plugin, where a restart is a
new plugin process. Every outcome both packages give (exit codes, stdout,
liveness, recover verdicts, alloc statuses and counts) must be equal. The
two packages run each scenario at once, in two threads, but the client
end to end, whose reference side runs under the shim, one after the other.

Each package's plugin host is its own launcher (``python -m
<package>.client.plugin``). The reference's server schedules through its
``traced_jit`` kernels under the scoped ``reference_runtime`` shim
(ROADMAP C-R1); the port's runs on the CPU. Every task a scenario starts
in its own session is killed when the scenario ends, whatever its
outcome, so no ``sleep 60`` outlives the test. No numeric tolerance
applies: everything compared is exact.
"""

import os
import signal
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import pytest

from nomad_tpu import mock as ref_mock
from nomad_tpu.client import drivers as ref_drivers
from nomad_tpu.client import plugin as ref_plugin
from nomad_tpu.client.client import Client as RefClient
from nomad_tpu.server.server import Server as RefServer
from nomad_tpu.server.server import ServerConfig as RefServerConfig
from nomad_tpu.structs import Task as RefTask
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch.client import drivers as port_drivers
from nomad_tpu_torch.client import plugin as port_plugin
from nomad_tpu_torch.client.client import Client
from nomad_tpu_torch.server.server import Server, ServerConfig
from nomad_tpu_torch.structs import Task
from test_torch_api import wait_until
from test_torch_hetero import reference_runtime

REF = SimpleNamespace(
    name="reference", drivers=ref_drivers, plugin=ref_plugin, Task=RefTask,
    mock=ref_mock, Client=RefClient, Server=RefServer, ServerConfig=RefServerConfig,
    server_kw={},
)
PORT = SimpleNamespace(
    name="port", drivers=port_drivers, plugin=port_plugin, Task=Task,
    mock=port_mock, Client=Client, Server=Server, ServerConfig=ServerConfig,
    server_kw={"device": "cpu"},
)
ROUTES = ("inprocess", "plugin")


def both(fn):
    """``fn(package)`` on the reference and on the port, at once in two
    threads (each package's plugin processes start in parallel):
    (reference result, port result)."""
    with ThreadPoolExecutor(2) as pool:
        ref, port = pool.submit(fn, REF), pool.submit(fn, PORT)
        return ref.result(), port.result()


def sh_task(pkg, name, script, driver="raw_exec", **res):
    t = pkg.Task(name=name, driver=driver, config={"command": "/bin/sh", "args": ["-c", script]})
    for k, v in res.items():
        setattr(t.resources, k, v)
    return t


def alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except (ProcessLookupError, PermissionError):
        return False


def reap(pid: int) -> None:
    """Kill a task's whole session group (it was started with setsid)."""
    if pid and alive(pid):
        try:
            os.killpg(pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass


class Tasks:
    """The pids a scenario started, killed when it ends."""

    def __init__(self):
        self.pids = []

    def add(self, handle):
        self.pids.append(handle.pid)
        return handle

    def reap(self):
        for pid in self.pids:
            reap(pid)


@pytest.fixture
def tasks():
    t = Tasks()
    yield t
    t.reap()


def kill_plugin(d) -> None:
    """Hard-kill a plugin driver's process (not a graceful shutdown)."""
    d._proc.kill()
    d._proc.wait()


def test_launcher_is_the_packages_own():
    """Each package spawns its own plugin host: the port's names no
    module of the JAX package."""
    port_argv = port_plugin.PluginDriverClient("raw_exec").default_argv("raw_exec")
    assert port_argv[1:] == ["-m", "nomad_tpu_torch.client.plugin", "raw_exec"]
    assert port_plugin.HANDSHAKE_TIMEOUT_S == ref_plugin.HANDSHAKE_TIMEOUT_S == 10.0
    assert port_plugin.PLUGIN_MAGIC == ref_plugin.PLUGIN_MAGIC
    assert port_plugin.PROTO_VERSION == ref_plugin.PROTO_VERSION


# -- TestPluginProtocol --------------------------------------------------------


def test_start_wait_through_plugin(tmp_path, tasks):
    def run(pkg):
        work = tmp_path / pkg.name
        work.mkdir()
        d = pkg.plugin.PluginDriverClient("raw_exec")
        try:
            fp = d.fingerprint()
            h = tasks.add(d.start(sh_task(pkg, "t", "echo hi; exit 7"), {}, str(work)))
            assert h.pid > 0
            code = d.wait(h, timeout=10)
            return fp, code, h.state, (work / "t.stdout").read_bytes()
        finally:
            d.close()

    ref, port = both(run)
    assert port == ref == (True, 7, "dead", b"hi\n")


def test_stop_kills_task(tmp_path, tasks):
    def run(pkg):
        work = tmp_path / pkg.name
        work.mkdir()
        d = pkg.plugin.PluginDriverClient("raw_exec")
        try:
            h = tasks.add(d.start(sh_task(pkg, "t", "sleep 60"), {}, str(work)))
            was_alive = alive(h.pid)
            d.stop(h, kill_timeout=2.0)
            return was_alive, wait_until(lambda: not alive(h.pid), timeout=5)
        finally:
            d.close()

    ref, port = both(run)
    assert port == ref == (True, True)


def test_mock_driver_through_plugin(tmp_path):
    def run(pkg):
        d = pkg.plugin.PluginDriverClient("mock_driver")
        try:
            t = pkg.Task(name="m", driver="mock_driver", config={"run_for": 0.05, "exit_code": 3})
            h = d.start(t, {}, str(tmp_path))
            return d.wait(h, timeout=10)
        finally:
            d.close()

    ref, port = both(run)
    assert port == ref == 3


def test_reattach_through_plugin_restart(tmp_path, tasks):
    """The task (own session) survives its plugin's SIGKILL; a fresh
    plugin recovers the handle and can still stop the task."""

    def run(pkg):
        work = tmp_path / pkg.name
        work.mkdir()
        d1 = pkg.plugin.PluginDriverClient("raw_exec")
        h = tasks.add(d1.start(sh_task(pkg, "t", "sleep 60"), {}, str(work)))
        kill_plugin(d1)
        survived = alive(h.pid)
        d2 = pkg.plugin.PluginDriverClient("raw_exec")
        try:
            recovered = d2.recover(h)
            d2.stop(h, kill_timeout=2.0)
            return survived, recovered, wait_until(lambda: not alive(h.pid), timeout=5)
        finally:
            d2.close()

    ref, port = both(run)
    assert port == ref == (True, True, True)


def test_recover_rejects_dead_pid():
    def run(pkg):
        d = pkg.plugin.PluginDriverClient("raw_exec")
        try:
            ghost = pkg.drivers.TaskHandle(id="x", driver="raw_exec", pid=2**22 - 1)
            return d.recover(ghost)
        finally:
            d.close()

    ref, port = both(run)
    assert port is ref is False


# -- TestClientPluginMode ------------------------------------------------------


def _client_end_to_end(pkg, data_dir):
    srv = pkg.Server(pkg.ServerConfig(num_workers=1, **pkg.server_kw))
    srv.establish_leadership()
    client = None
    try:
        client = pkg.Client(
            srv.client_rpc(), data_dir=str(data_dir), heartbeat_interval=0.2,
            driver_mode="plugin",
        )
        assert all(isinstance(d, pkg.plugin.PluginDriverClient) for d in client.drivers.values())
        client.start()
        job = pkg.mock.batch_job()
        job.task_groups[0].count = 1
        t = job.task_groups[0].tasks[0]
        t.driver = "raw_exec"
        t.config = {"command": "/bin/sh", "args": ["-c", "echo done"]}
        srv.register_job(job)

        def allocs():
            return srv.store.allocs_by_job("default", job.id)

        done = wait_until(lambda: any(a.client_status == "complete" for a in allocs()), timeout=30)
        runner = client.runners[allocs()[0].id]
        out = os.path.join(runner.alloc_dir, t.name, f"{t.name}.stdout")
        return done, sorted(a.client_status for a in allocs()), open(out).read()
    finally:
        if client is not None:
            client.shutdown()
        srv.shutdown()


def test_end_to_end_with_plugin_drivers(tmp_path, monkeypatch):
    with reference_runtime(monkeypatch):
        ref = _client_end_to_end(REF, tmp_path / "ref")
    port = _client_end_to_end(PORT, tmp_path / "port")
    assert port == ref == (True, ["complete"], "done\n")


# -- TestExecIsolation, on the driver in process and through the plugin -------


def exec_driver(pkg, route):
    if route == "plugin":
        return pkg.plugin.PluginDriverClient("exec")
    return pkg.drivers.ExecDriver()


def close(d):
    if hasattr(d, "close"):
        d.close()


@pytest.mark.parametrize("route", ROUTES)
def test_rlimits_applied(tmp_path, tasks, route):
    def run(pkg):
        work = tmp_path / pkg.name
        work.mkdir()
        d = exec_driver(pkg, route)
        try:
            h = tasks.add(d.start(sh_task(pkg, "t", "ulimit -v", "exec", memory_mb=256), {},
                                  str(work)))
            return d.wait(h, timeout=10), int((work / "t.stdout").read_text().strip())
        finally:
            close(d)

    ref, port = both(run)
    assert port == ref == (0, (256 + 512) * 1024)  # RLIMIT_AS in KiB


@pytest.mark.parametrize("route", ROUTES)
def test_environment_scrubbed(tmp_path, tasks, monkeypatch, route):
    monkeypatch.setenv("NOMAD_TPU_LEAK_CANARY", "secret")

    def run(pkg):
        work = tmp_path / pkg.name
        work.mkdir()
        d = exec_driver(pkg, route)
        try:
            h = tasks.add(d.start(sh_task(pkg, "t", "env", "exec"), {"NOMAD_ALLOC_ID": "a1"},
                                  str(work)))
            code = d.wait(h, timeout=10)
            env_out = (work / "t.stdout").read_text()
            return code, "NOMAD_TPU_LEAK_CANARY" in env_out, "NOMAD_ALLOC_ID=a1" in env_out
        finally:
            close(d)

    ref, port = both(run)
    assert port == ref == (0, False, True)


@pytest.mark.parametrize("route", ROUTES)
def test_own_session(tmp_path, tasks, route):
    def run(pkg):
        work = tmp_path / pkg.name
        work.mkdir()
        d = exec_driver(pkg, route)
        try:
            h = tasks.add(d.start(sh_task(pkg, "t", "ps -o sid= -p $$", "exec"), {}, str(work)))
            code = d.wait(h, timeout=10)
            sid = int((work / "t.stdout").read_text().strip())
            return code, sid != os.getsid(0)  # not the agent's session
        finally:
            close(d)

    ref, port = both(run)
    assert port == ref == (0, True)


# -- TestNativeExecutor, on the driver in process and through the plugin -------


def restart(d, pkg, route):
    """The agent's restart: a fresh driver (in process), or the plugin
    SIGKILLed and a fresh plugin process."""
    if route == "plugin":
        kill_plugin(d)
    return exec_driver(pkg, route)


@pytest.mark.parametrize("route", ROUTES)
def test_supervised_start_and_exit_code(tmp_path, tasks, route):
    def run(pkg):
        work = tmp_path / pkg.name
        work.mkdir()
        assert pkg.drivers.native_executor(), "executor binary must build"
        d = exec_driver(pkg, route)
        try:
            h = tasks.add(d.start(sh_task(pkg, "t", "echo out; exit 9", "exec"), {}, str(work)))
            supervised = bool(h.meta.get("supervised"))
            code = d.wait(h, timeout=10)
            return (supervised, code, (work / "t.stdout").read_bytes(),
                    (work / "t.status").read_text().strip())
        finally:
            close(d)

    ref, port = both(run)
    assert port == ref == (True, 9, b"out\n", "exit 9")


@pytest.mark.parametrize("route", ROUTES)
def test_exit_code_durable_across_agent_restart(tmp_path, tasks, route):
    """The task ends while the agent is down: a fresh driver recovers the
    handle and still reads the real exit code from the supervisor's
    status record."""

    def run(pkg):
        work = tmp_path / pkg.name
        work.mkdir()
        d1 = exec_driver(pkg, route)
        h = tasks.add(d1.start(sh_task(pkg, "t", "exit 42", "exec"), {}, str(work)))
        status = work / "t.status"
        d2 = restart(d1, pkg, route)
        try:
            ended = wait_until(lambda: status.exists() and "exit" in status.read_text(),
                               timeout=10)
            return ended, d2.recover(h), d2.wait(h, timeout=5)
        finally:
            close(d2)
            close(d1)

    ref, port = both(run)
    assert port == ref == (True, True, 42)


@pytest.mark.parametrize("route", ROUTES)
def test_reattach_live_supervisor_and_stop(tmp_path, tasks, route):
    def run(pkg):
        work = tmp_path / pkg.name
        work.mkdir()
        d1 = exec_driver(pkg, route)
        h = tasks.add(d1.start(sh_task(pkg, "t", "sleep 60", "exec"), {}, str(work)))
        started = wait_until(lambda: (work / "t.status").exists(), timeout=10)
        d2 = restart(d1, pkg, route)
        try:
            recovered = d2.recover(h)
            d2.stop(h, kill_timeout=2.0)
            # in process the first driver's un-reaped Popen stays a
            # zombie, so the durable status record judges liveness
            code = d2.wait(h, timeout=10)
            status = (work / "t.status").read_text().strip()
            return started, recovered, code is not None and code >= 128, status == f"exit {code}"
        finally:
            close(d2)
            close(d1)

    ref, port = both(run)
    assert port == ref == (True, True, True, True)


# -- C-R11: a driver plugin's death under a running task -----------------------


def _plugin_death(pkg, data_dir, tasks):
    """A client in plugin mode runs a task that waits for a file; its
    driver plugin is SIGKILLed while the task runs. Once the client has
    either recovered the task or lost its task runner, the file appears
    and the task exits 0. Returns whether the task outlived the plugin,
    whether the client recovered it, the alloc's client status once the
    task has exited, the task's state and failed flag, and its last
    events."""
    srv = pkg.Server(pkg.ServerConfig(num_workers=1, **pkg.server_kw))
    srv.establish_leadership()
    client = None
    go = data_dir / "go"
    try:
        client = pkg.Client(srv.client_rpc(), data_dir=str(data_dir), heartbeat_interval=0.2,
                            driver_mode="plugin")
        client.start()
        job = pkg.mock.batch_job()
        job.task_groups[0].count = 1
        t = job.task_groups[0].tasks[0]
        t.driver = "raw_exec"
        t.config = {"command": "/bin/sh",
                    "args": ["-c", f"while [ ! -e {go} ]; do sleep 0.05; done"]}
        srv.register_job(job)

        def task_runner():
            allocs = srv.store.allocs_by_job("default", job.id)
            runner = client.runners.get(allocs[0].id) if allocs else None
            tr = runner.task_runners.get(t.name) if runner is not None else None
            return tr if tr is not None and tr.handle is not None else None

        assert wait_until(lambda: task_runner() is not None, timeout=30)
        tr = task_runner()
        pid = tasks.add(tr.handle).pid
        kill_plugin(client.drivers["raw_exec"])
        survived = alive(pid)
        assert wait_until(lambda: tr.handle.meta.get("recovered") or not tr._thread.is_alive(),
                          timeout=30)
        recovered = bool(tr.handle.meta.get("recovered"))
        go.touch()
        assert wait_until(lambda: not alive(pid), timeout=10)

        def status():
            return srv.store.allocs_by_job("default", job.id)[0].client_status

        wait_until(lambda: status() == "complete", timeout=2)
        events = [(e.type, e.exit_code) for e in tr.state.events[-2:]]
        return survived, recovered, status(), tr.state.state, tr.state.failed, events
    finally:
        if client is not None:
            client.shutdown()
        srv.shutdown()


# the reference's task-runner thread dies on the DriverError: that is the
# defect this test shows, not a failure of the test
@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_task_outlives_its_driver_plugin(tmp_path, tasks, monkeypatch):
    """The port's task runner recovers the task through a respawned
    plugin and records its end (exit 0); the JAX package's task runner
    thread dies on the plugin's DriverError and its alloc stays
    "running" after the task has exited (ROADMAP C-R11)."""
    with reference_runtime(monkeypatch):
        ref = _plugin_death(REF, tmp_path / "ref", tasks)
    port = _plugin_death(PORT, tmp_path / "port", tasks)
    assert port == (True, True, "complete", "dead", False,
                    [("Driver Failure", None), ("Terminated", 0)])
    assert ref[:4] == (True, False, "running", "running")


# -- C-R13: a task's requests after its driver plugin died ---------------------


def test_a_plugin_whose_output_ended_is_replaced(tmp_path, tasks, monkeypatch):
    """A killed plugin's output ends (its reader sees EOF) before the kernel
    reports the process exited. The next call spawns a fresh plugin; it is
    not written into the dying one's stdin, which a task it started still
    holds open, where it would wait unanswered for its timeout."""
    d = PORT.plugin.PluginDriverClient("raw_exec")
    try:
        h = tasks.add(d.start(sh_task(PORT, "t", "sleep 60"), {}, str(tmp_path)))
        old = d._proc
        old.kill()
        assert wait_until(lambda: old in d._ended, timeout=10)
        monkeypatch.setattr(old, "poll", lambda: None)  # its exit not visible yet
        assert d.recover(h)
        assert d._proc is not old and d._proc.poll() is None
    finally:
        d.close()


def test_wait_after_a_respawn_asks_for_recovery(tmp_path, tasks):
    """A wait issued after the task's plugin died goes to no other plugin:
    the respawned one does not hold the task, so the port's caller gets a
    DriverError, recovers the task through it and waits again (the task
    runner's path). The JAX package sends the wait to the new plugin,
    which answers at once with no exit code while the task still runs."""

    def run(pkg):
        work = tmp_path / pkg.name
        work.mkdir()
        d = pkg.plugin.PluginDriverClient("raw_exec")
        try:
            h = tasks.add(d.start(sh_task(pkg, "t", "sleep 1"), {}, str(work)))
            kill_plugin(d)
            try:
                first = ("returned", d.wait(h, timeout=10), alive(h.pid))
            except pkg.drivers.DriverError:
                first = ("raised", None, alive(h.pid))
            if first[0] == "returned":
                return first
            return first + (d.recover(h), d.wait(h, timeout=10), alive(h.pid))
        finally:
            d.close()

    ref, port = both(run)
    assert port == ("raised", None, True, True, 0, False)
    assert ref == ("returned", None, True)
