"""The port's CLI (``nomad_tpu_torch.cli``) against the JAX package's, on
the CPU.

``cli.main(argv)`` of each package runs every command of the reference's
``tests/test_api.py::TestCLI`` and ``tests/test_cli_breadth.py`` (and the
``alloc status`` / ``eval status`` / ``node status <id>`` reads), each
against its own package's agent of the pair from ``test_torch_api.py``
(an ACL-enabled server pair for the ``acl`` family). Exit codes must be
equal, and standard output equal after the same normalizer: output that
is JSON goes through ``test_torch_api.normalize``; a table's ids (the
evals, allocs, deployments, ACL tokens and dispatched child jobs of that
side's store, in full and as 8-character prefixes) and the agent's own
address and data dir are written as placeholders; ``operator metrics``
compares as ``/v1/metrics`` does in ``test_torch_api.py``. No tolerance
applies to text: it is exact.

Then ``python -m nomad_tpu_torch.cli agent -dev --device cpu`` runs as a
subprocess: it serves an HCL ``job run`` to ``complete`` and stops on
SIGINT. The command tree equals the reference's but for ``analyze
kernels`` (the jaxpr lint, ROADMAP A17), which the port names and
refuses; a command that only speaks HTTP starts without PyTorch.
"""

import argparse
import inspect
import json
import os
import re
import signal
import subprocess
import sys
import time

import pytest

from nomad_tpu import mock as ref_mock
from nomad_tpu.api.codec import encode as ref_encode
from nomad_tpu.api.http import HTTPAgent as RefHTTPAgent
from nomad_tpu.cli import main as ref_cli
from nomad_tpu.server.server import Server as RefServer
from nomad_tpu.server.server import ServerConfig as RefServerConfig
from nomad_tpu.structs.job import ParameterizedJobConfig
from nomad_tpu_torch.api.client import NomadClient
from nomad_tpu_torch.api.http import HTTPAgent
from nomad_tpu_torch.cli import main as port_cli
from nomad_tpu_torch.server.server import Server, ServerConfig
from test_torch_api import (
    AgentPair,
    assert_same,
    assert_same_metrics,
    complete,
    job_payload,
    normalize,
    wait_until,
)
from test_torch_hetero import reference_runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AGENT_READY_S = 60.0


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    with reference_runtime(pytest.MonkeyPatch()):
        p = AgentPair(tmp_path_factory)
        try:
            yield p
        finally:
            p.stop()


def _store_ids(store):
    ids = [a.id for a in store.allocs()] + [e.id for e in store.evals()]
    ids += [d.id for d in store.deployments()]
    ids += [j.id for j in store.jobs() if j.parent_id]  # dispatched children
    for t in store.acl_tokens():
        ids += [t.accessor_id, t.secret_id]
    return ids


def normalize_output(out, store, placeholders):
    """Standard output without ids, as a JSON value where it is one."""
    for k, v in placeholders.items():
        out = out.replace(k, v)
    try:
        return ("json", normalize(json.loads(out)))
    except ValueError:
        pass
    for full in sorted(set(_store_ids(store)), key=len, reverse=True):
        out = out.replace(full, "<id>").replace(full[:8], "<id>")
    return ("text", out)


class CliPair:
    """Runs one argv through both CLIs, each against its own agent."""

    def __init__(self, capsys, ref_side, port_side):
        self.capsys = capsys
        self.sides = ((ref_cli, ref_side), (port_cli, port_side))

    def run(self, *argv, token=None, expect=0):
        results = []
        for cli, side in self.sides:
            addr = ["--address", side.address] + (["--token", token[side.name]] if token else [])
            self.capsys.readouterr()
            rc = cli.main(addr + list(argv))
            out = self.capsys.readouterr().out
            results.append((rc, normalize_output(out, side.store, side.placeholders()), out))
        (ref_rc, ref_out, _), (port_rc, port_out, raw) = results
        assert (ref_rc, port_rc) == (expect, expect), (argv, ref_rc, port_rc)
        if ref_out[0] == "json":
            assert_same(ref_out[1], port_out[1], what=" ".join(argv))
        else:
            assert port_out == ref_out, argv
        return raw


@pytest.fixture
def cli(pair, capsys):
    return CliPair(capsys, pair.ref, pair.port)


def _write_job(tmp_path, payload):
    jf = tmp_path / "job.json"
    jf.write_text(json.dumps({"job": payload}))
    return str(jf)


# -- tests/test_api.py::TestCLI ------------------------------------------------


def test_cli_flow(pair, cli, tmp_path):
    payload = job_payload()
    jf = _write_job(tmp_path, payload)
    cli.run("job", "plan", jf)
    cli.run("job", "run", jf)
    for side in pair.sides:
        assert wait_until(lambda s=side: complete(s, payload["id"])), side.name
    out = cli.run("job", "status", payload["id"])
    assert payload["id"] in out
    cli.run("node", "status")
    node_id = pair.port.agent.client.node.id
    assert node_id == pair.ref.agent.client.node.id
    cli.run("node", "status", node_id)
    alloc = {s.name: s.client.jobs.allocations(payload["id"])[0]["id"] for s in pair.sides}
    evals = {s.name: s.client.jobs.evaluations(payload["id"])[0]["id"] for s in pair.sides}
    for verb, ids in (("alloc", alloc), ("eval", evals)):
        outs = []
        for cli_mod, side in cli.sides:
            cli.capsys.readouterr()
            assert cli_mod.main(["--address", side.address, verb, "status", ids[side.name]]) == 0
            outs.append(normalize_output(cli.capsys.readouterr().out, side.store,
                                         side.placeholders()))
        assert outs[0] == outs[1], verb
    cli.run("job", "stop", payload["id"])
    cli.run("operator", "scheduler")
    cli.run("server", "members")


# -- tests/test_cli_breadth.py -------------------------------------------------


def service_payload(job_id="cli-svc", run_for=600):
    j = ref_mock.job()
    j.id = job_id
    j.task_groups[0].count = 1
    j.task_groups[0].tasks[0].driver = "mock_driver"
    j.task_groups[0].tasks[0].config = {"run_for": run_for}
    j.task_groups[0].tasks[0].resources.cpu = 50
    j.task_groups[0].tasks[0].resources.memory_mb = 32
    return ref_encode(j)


def test_history_inspect_revert_eval(pair, cli):
    for run_for in (600, 601):  # versions 0 and 1
        payload = service_payload(run_for=run_for)
        pair.same(lambda s: s.client.jobs.register(payload), "register")
    out = cli.run("job", "history", "cli-svc")
    assert "Version" in out and "1" in out
    assert '"cli-svc"' in cli.run("job", "inspect", "cli-svc")
    cli.run("job", "revert", "cli-svc", "0")  # becomes version 2
    for side in pair.sides:
        cur = side.agent.store.job_by_id("default", "cli-svc")
        assert cur.version == 2 and cur.task_groups[0].tasks[0].config["run_for"] == 600
    assert "created evaluation" in cli.run("job", "eval", "cli-svc")
    for side in pair.sides:
        assert side.agent.server.wait_for_evals(timeout=20.0), side.name
    assert "cli-svc" in cli.run("eval", "list")


def children_allocs(side, parent):
    """The allocs of the jobs dispatched from ``parent``."""
    store = side.store
    return [a for j in store.jobs() if j.parent_id == parent
            for a in store.allocs_by_job(j.namespace, j.id)]


def test_dispatch_parameterized(pair, cli):
    j = ref_mock.job()
    j.id = "cli-param"
    j.task_groups[0].count = 1
    j.task_groups[0].tasks[0].driver = "mock_driver"
    j.task_groups[0].tasks[0].config = {"run_for": 0.05}
    j.parameterized = ParameterizedJobConfig(payload="optional")
    payload = ref_encode(j)
    pair.same(lambda s: s.client.jobs.register(payload), "register")
    assert "dispatched" in cli.run("job", "dispatch", "cli-param")
    # the child is a service whose task exits after 0.05 s, and its
    # restart policy then waits 15 s, so its alloc may be running or done
    # when the next test's sweep comes: stop it on both sides, so that
    # the sweep finds the same settled store on both
    for side in pair.sides:
        assert wait_until(lambda s=side: children_allocs(s, "cli-param")), side.name
        (kid,) = {a.job_id for a in children_allocs(side, "cli-param")}
        side.agent.server.deregister_job("default", kid)  # the id holds a "/"
    for side in pair.sides:
        assert wait_until(lambda s=side: all(
            a.terminal_status() for a in children_allocs(s, "cli-param"))), side.name


def settled(side):
    """Nothing in the side's store is still moving towards a terminal
    state: every eval terminal, every batch alloc terminal, every other
    alloc terminal or one the server wants running (pending or running).
    What a forced GC sweep reaps is then fixed."""
    store = side.store
    if not all(e.terminal_status() for e in store.evals()):
        return False
    for a in store.allocs():
        if a.terminal_status():
            continue
        job = store.job_by_id(a.namespace, a.job_id)
        if job is None or job.type == "batch":
            return False
        if a.desired_status != "run" or a.client_status not in ("pending", "running"):
            return False
    return True


def test_system_gc_snapshot_metrics_scaling_version(pair, cli, tmp_path):
    for side in pair.sides:
        assert wait_until(lambda s=side: settled(s)), side.name
    assert "gc:" in cli.run("system", "gc")
    paths = {}
    for cli_mod, side in cli.sides:
        paths[side.name] = str(tmp_path / f"{side.name}.snap")
        assert cli_mod.main(["--address", side.address, "operator", "snapshot", "save",
                             paths[side.name]]) == 0
    assert all(os.path.exists(p) for p in paths.values())
    metrics = []
    for cli_mod, side in cli.sides:
        cli.capsys.readouterr()
        assert cli_mod.main(["--address", side.address, "operator", "metrics"]) == 0
        metrics.append(json.loads(cli.capsys.readouterr().out))
    assert_same_metrics(*metrics)
    cli.run("scaling", "policies")
    assert "nomad-tpu v" in cli.run("version")


def test_acl_family_through_cli(tmp_path, capsys):
    servers = {}
    try:
        with reference_runtime(pytest.MonkeyPatch()):
            ref = RefServer(RefServerConfig(num_workers=0, acl_enabled=True))
            servers["reference"] = (ref, RefHTTPAgent(ref, port=0))
        port = Server(ServerConfig(num_workers=0, acl_enabled=True, device="cpu"))
        servers["port"] = (port, HTTPAgent(port, port=0))
        sides = []
        tokens = {}
        for name, (s, http) in servers.items():
            http.start()
            tokens[name] = s.acl.bootstrap().secret_id
            sides.append(_ServerSide(name, s, http))
        cli = CliPair(capsys, *sides)
        rules = tmp_path / "ro.hcl"
        rules.write_text('namespace "default" { policy = "read" }')
        cli.run("acl", "policy", "apply", "readonly", str(rules), token=tokens)
        assert "readonly" in cli.run("acl", "policy", "list", token=tokens)
        out = cli.run("acl", "token", "create", "--name", "ro", "--policy", "readonly",
                      token=tokens)
        assert "Secret ID" in out
        assert "ro" in cli.run("acl", "token", "list", token=tokens)
        cli.run("acl", "policy", "delete", "readonly", token=tokens)
        cli.run("acl", "policy", "list", token=tokens)
    finally:
        for s, http in servers.values():
            try:
                http.stop()
            finally:
                s.shutdown()


class _ServerSide:
    def __init__(self, name, server, http):
        self.name = name
        self.address = http.address
        self.store = server.store

    def placeholders(self):
        return {self.address: "<http>"}


# -- the command tree ----------------------------------------------------------


# the one reference command the port lacks (the jaxpr lint, ROADMAP A17):
# it parses as the reference's does, and refuses naming A17
LACKS = {("analyze", "kernels")}


def _commands(parser, prefix=()):
    """Every command path of a parser, with its handler."""
    out = {}
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            for name, sub in action.choices.items():
                out[prefix + (name,)] = sub.get_default("fn")
                out.update(_commands(sub, prefix + (name,)))
    return out


def test_the_port_lacks_only_analyze_kernels(capsys):
    ref = _commands(ref_cli.build_parser())
    port = _commands(port_cli.build_parser())
    assert port.keys() == ref.keys()
    refusing = {cmd for cmd, fn in port.items()
                if fn is not None and "not ported yet" in inspect.getsource(fn)}
    assert refusing == LACKS
    for cmd in LACKS:
        assert port_cli.main(list(cmd)) == 1
        assert "A17" in capsys.readouterr().err
    agent = port_cli.build_parser().parse_args(["agent", "-dev"])
    assert agent.device == "cuda"
    assert port_cli.build_parser().parse_args(["chaos", "run"]).device == "cuda"


def test_http_commands_start_without_torch():
    """A command that only speaks HTTP loads neither the server nor
    PyTorch; ``--algorithm`` still checks against the registry."""
    code = (
        "import sys\n"
        "from nomad_tpu_torch.cli.main import main\n"
        "assert main(['version']) == 0\n"
        "assert 'torch' not in sys.modules and 'nomad_tpu_torch.server' not in sys.modules\n"
        "try:\n"
        "    main(['operator', 'scheduler', '--algorithm', 'bogus'])\n"
        "except SystemExit as e:\n"
        "    assert e.code == 2\n"
    )
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=60)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "invalid choice: 'bogus' (choose from binpack, cp-gang" in run.stderr


# -- the agent as a user starts it ---------------------------------------------

WEB_HCL = """
job "web" {
  type = "batch"
  group "web" {
    count = 3
    task "web" {
      driver = "mock_driver"
      config {
        run_for = 0.05
      }
      resources {
        cpu    = 100
        memory = 64
      }
    }
  }
}
"""


def _cli(*argv, timeout=60.0):
    return subprocess.run(
        [sys.executable, "-m", "nomad_tpu_torch.cli", *argv],
        cwd=REPO, capture_output=True, text=True, timeout=timeout,
    )


def test_agent_dev_subprocess_serves_hcl_job_run(tmp_path):
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "nomad_tpu_torch.cli", "agent", "-dev",
         "--device", "cpu", "--bind", "127.0.0.1:0", "--data-dir", str(tmp_path / "data")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        addr = None
        deadline = time.time() + AGENT_READY_S
        lines = []
        while time.time() < deadline and addr is None:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            m = re.search(r"==> .* running at (\S+)", line)
            if m:
                addr = m.group(1)
        assert addr, "".join(lines)
        job = tmp_path / "web.hcl"
        job.write_text(WEB_HCL)
        run = _cli("--address", addr, "job", "run", str(job))
        assert run.returncode == 0, run.stdout + run.stderr
        assert "finished: complete" in run.stdout
        c = NomadClient(addr)
        assert wait_until(
            lambda: [a["client_status"] for a in c.jobs.allocations("web")] == ["complete"] * 3
        )
        status = _cli("--address", addr, "job", "status", "web")
        assert status.returncode == 0 and "web" in status.stdout
        trace = c.get("/v1/agent/trace")
        assert trace["kernels"]["place_closed_form_kernel"]["calls"] >= 1
        assert trace["kernel_fingerprints"] == {}
        proc.send_signal(signal.SIGINT)
        out, _ = proc.communicate(timeout=15)
        assert proc.returncode == 0 and "shutting down" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def test_agent_dev_refuses_cuda_where_there_is_none():
    """Asked for CUDA (the default) on a host without it, the agent
    raises and never serves."""
    run = _cli("agent", "-dev", "--bind", "127.0.0.1:0")
    assert run.returncode != 0
    assert "CUDA" in run.stderr and "running at" not in run.stdout
