"""The port's package boundary: nomad_tpu_torch imports with JAX blocked,
loads no module of the JAX package, and runs on the card unless the
caller asks for the CPU.

No numeric tolerance applies here: every check is exact (module sets,
import graphs, raised exceptions)."""

import ast
import pathlib
import re
import pkgutil
import subprocess
import sys

import pytest
import torch

import nomad_tpu_torch

PKG_DIR = pathlib.Path(nomad_tpu_torch.__file__).parent
REPO = PKG_DIR.parent


def _submodules():
    # ``cli/__main__.py`` is the ``python -m`` entry point: importing it
    # runs the CLI
    return sorted(
        m.name
        for m in pkgutil.walk_packages([str(PKG_DIR)], prefix="nomad_tpu_torch.")
        if not m.name.endswith(".__main__")
    )


def test_imports_with_jax_blocked():
    mods = _submodules()
    for m in (
        "nomad_tpu_torch.device.score",
        "nomad_tpu_torch.device.preempt",
        "nomad_tpu_torch.scheduler.preempt_host",
        "nomad_tpu_torch.scheduler.system",
        "nomad_tpu_torch.scheduler.hetero",
        "nomad_tpu_torch.scheduler.cp",
        "nomad_tpu_torch.device.cp",
        "nomad_tpu_torch.device.migrate",
        "nomad_tpu_torch.scheduler.migrate",
        "nomad_tpu_torch.device.cache",
        "nomad_tpu_torch.obs.calibrate",
        "nomad_tpu_torch.obs.recorder",
        "nomad_tpu_torch.chaos.plane",
        "nomad_tpu_torch.scheduler.annotate",
        "nomad_tpu_torch.state.snapshot",
        "nomad_tpu_torch.rpc.framing",
        "nomad_tpu_torch.resilience.errors",
        "nomad_tpu_torch.server.fsm",
        "nomad_tpu_torch.native.wal",
        "nomad_tpu_torch.raft.inline",
        "nomad_tpu_torch.broker.blocked",
        "nomad_tpu_torch.broker.eval_broker",
        "nomad_tpu_torch.broker.event_broker",
        "nomad_tpu_torch.broker.plan_apply",
        "nomad_tpu_torch.broker.plan_queue",
        "nomad_tpu_torch.server.overlay",
        "nomad_tpu_torch.server.lanes",
        "nomad_tpu_torch.server.worker",
        "nomad_tpu_torch.server.server",
        "nomad_tpu_torch.utils.cron",
        "nomad_tpu_torch.server.heartbeat",
        "nomad_tpu_torch.server.admission",
        "nomad_tpu_torch.server.drainer",
        "nomad_tpu_torch.server.deployment_watcher",
        "nomad_tpu_torch.server.periodic",
        "nomad_tpu_torch.server.core_gc",
        "nomad_tpu_torch.server.volume_watcher",
        "nomad_tpu_torch.server.defrag",
        "nomad_tpu_torch.utils.hcl",
        "nomad_tpu_torch.acl.tokens",
        "nomad_tpu_torch.acl.policy",
        "nomad_tpu_torch.acl.acl",
        "nomad_tpu_torch.acl",
        "nomad_tpu_torch.server.acl",
        "nomad_tpu_torch.chaos.invariants",
        "nomad_tpu_torch.chaos.runner",
        "nomad_tpu_torch.chaos",
        "nomad_tpu_torch.resilience.breaker",
        "nomad_tpu_torch.resilience.watchdog",
        "nomad_tpu_torch.resilience",
        "nomad_tpu_torch.obs.slo",
        "nomad_tpu_torch.obs.loadgen",
        "nomad_tpu_torch.obs",
        "nomad_tpu_torch.rpc.server",
        "nomad_tpu_torch.rpc.client",
        "nomad_tpu_torch.rpc",
        "nomad_tpu_torch.raft.node",
        "nomad_tpu_torch.api.codec",
        "nomad_tpu_torch.api.http",
        "nomad_tpu_torch.api.client",
        "nomad_tpu_torch.api",
        "nomad_tpu_torch.jobspec.parse",
        "nomad_tpu_torch.jobspec",
        "nomad_tpu_torch.utils.profile",
        "nomad_tpu_torch.client.drivers",
        "nomad_tpu_torch.client.container",
        "nomad_tpu_torch.client.task_runner",
        "nomad_tpu_torch.client.alloc_runner",
        "nomad_tpu_torch.client.state",
        "nomad_tpu_torch.client.allochealth",
        "nomad_tpu_torch.client.logmon",
        "nomad_tpu_torch.client.endpoints",
        "nomad_tpu_torch.client.fingerprint",
        "nomad_tpu_torch.client.stdio_plugin",
        "nomad_tpu_torch.client.plugin",
        "nomad_tpu_torch.client.device_plugin",
        "nomad_tpu_torch.client.csi_plugin",
        "nomad_tpu_torch.client.client",
        "nomad_tpu_torch.client",
        "nomad_tpu_torch.agent_config",
        "nomad_tpu_torch.agent",
        "nomad_tpu_torch.cli.main",
        "nomad_tpu_torch.cli",
    ):
        assert m in mods
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k == 'nomad_tpu' or k.startswith('nomad_tpu.')\n"
        "             or k == 'jax' and sys.modules[k] is not None)\n"
        "print(bad)\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "[]"


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize(
    "path",
    sorted(PKG_DIR.rglob("*.py")),
    ids=lambda p: str(p.relative_to(PKG_DIR)),
)
def test_no_jax_or_reference_import(path):
    for name in _imports(path):
        root = name.split(".")[0]
        assert root != "jax", f"{path} imports {name}"
        assert root != "nomad_tpu", f"{path} imports {name}"


def test_chip_smoke_imports_nothing_of_jax():
    names = set(_imports(REPO / "chip_smoke.py"))
    assert not any(n.split(".")[0] in ("jax", "nomad_tpu") for n in names)


PLUGIN_MODULES = (
    "nomad_tpu_torch.client.stdio_plugin",
    "nomad_tpu_torch.client.plugin",
    "nomad_tpu_torch.client.device_plugin",
    "nomad_tpu_torch.client.csi_plugin",
)


def _plugin_argvs():
    from nomad_tpu_torch.client.csi_plugin import BUILTIN_CSI_PLUGINS, CSIPluginClient
    from nomad_tpu_torch.client.device_plugin import (
        BUILTIN_DEVICE_PLUGINS,
        DevicePluginClient,
    )
    from nomad_tpu_torch.client.drivers import builtin_drivers
    from nomad_tpu_torch.client.plugin import plugin_drivers

    drivers = {**plugin_drivers(), **{n: None for n in builtin_drivers()}}
    clients = [
        *[(f"driver {n}", plugin_drivers((n,))[n], n) for n in sorted(drivers)],
        *[(f"device {n}", DevicePluginClient(n), n) for n in sorted(BUILTIN_DEVICE_PLUGINS)],
        *[(f"csi {n}", CSIPluginClient(n), n) for n in sorted(BUILTIN_CSI_PLUGINS)],
    ]
    return [(what, c.default_argv(n)) for what, c, n in clients]


def test_plugin_launchers_name_the_port():
    """Every builtin plugin's launcher starts this package's module: a
    copy that kept the JAX package's ``-m nomad_tpu.client.<module>``
    would start the reference as the plugin, and no import check would
    see it. Constructing a client spawns nothing."""
    argvs = _plugin_argvs()
    assert {w.split()[0] for w, _ in argvs} == {"driver", "device", "csi"}
    assert any(w == "device torch" for w, _ in argvs)
    for what, argv in argvs:
        assert argv[0] == sys.executable and argv[1] == "-m", (what, argv)
        assert argv[2] in PLUGIN_MODULES[1:], (what, argv)
        assert not any(a.startswith("nomad_tpu.") for a in argv), (what, argv)


def _strings(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            yield node.value


def test_no_string_names_a_module_of_the_jax_package():
    """No string of the port (nor of ``chip_smoke.py`` or
    ``bench_torch.py``) names a ``nomad_tpu.`` module: such a string
    reaches the JAX package through ``python -m`` or ``importlib``
    without an import statement."""
    paths = [*sorted(PKG_DIR.rglob("*.py")), REPO / "chip_smoke.py", REPO / "bench_torch.py"]
    bad = [
        (str(p.relative_to(REPO)), s) for p in paths for s in _strings(p)
        if re.search(r"\bnomad_tpu\.[A-Za-z_]", s)
    ]
    assert not bad, bad


def test_plugin_modules_import_neither_torch_nor_jax():
    """The plugin hosts start under the 10 s handshake: a fresh
    interpreter that imports the four plugin modules loads neither
    ``torch`` nor ``jax`` (the ``torch`` device plugin imports torch
    inside its calls)."""
    code = (
        "import importlib, sys\n"
        f"for m in {PLUGIN_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "print(sorted(k for k in ('torch', 'jax') if k in sys.modules))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "[]"


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from nomad_tpu_torch.device.cache import DeviceStateCache
    from nomad_tpu_torch.device.score import PlacementKernel
    from nomad_tpu_torch.scheduler import Harness, new_scheduler
    from nomad_tpu_torch.scheduler.algorithms import available, make_kernel
    from nomad_tpu_torch.scheduler.cp import run_cp_ab, run_gang_ab
    from nomad_tpu_torch.scheduler.hetero import run_hetero_ab
    from nomad_tpu_torch.obs.calibrate import run_calib_ab
    from nomad_tpu_torch.server import Server, ServerConfig

    _no_cuda(monkeypatch)
    for build in (
        Harness,
        DeviceStateCache,
        PlacementKernel,
        *[lambda name=name: make_kernel(name) for name in available()],
        lambda: new_scheduler("system", None, None),
        run_hetero_ab,
        run_cp_ab,
        run_gang_ab,
        run_calib_ab,
        ServerConfig,
        Server,
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()


def test_dev_agent_defaults_to_cuda_and_raises_without_it(monkeypatch):
    """``DevAgent()`` asks for CUDA; without it the agent raises before it
    makes its data dir, its server or its client."""
    import tempfile

    from nomad_tpu_torch.agent import DevAgent

    _no_cuda(monkeypatch)

    def no_dir(*a, **kw):
        raise AssertionError("data dir made before the device was resolved")

    monkeypatch.setattr(tempfile, "mkdtemp", no_dir)
    with pytest.raises(RuntimeError, match="CUDA"):
        DevAgent()
    with pytest.raises(RuntimeError, match="CUDA"):
        DevAgent(device="cuda", num_workers=1)


def test_score_group_raises_without_cuda(monkeypatch):
    import numpy as np

    from nomad_tpu_torch.device.flatten import ClusterTensors, GroupAsk
    from nomad_tpu_torch.scheduler.algorithms import score_group

    _no_cuda(monkeypatch)
    ct = ClusterTensors(
        node_ids=["a"], index=1, num_nodes=1,
        capacity=np.ones((8, 4), np.float32), used=np.zeros((8, 4), np.float32),
        ready=np.ones(8, bool), dc_ids=np.zeros(8, np.int32),
        class_ids=np.zeros(8, np.int32), dc_vocab={}, class_vocab={},
        class_rep=[0],
    )
    ga = GroupAsk(
        job_id="j", tg_name="t", count=1, desired_total=1,
        ask=np.zeros(4, np.float32), eligible=np.ones(8, bool),
        job_counts=np.zeros(8, np.int32), penalty_nodes=np.zeros(8, bool),
        affinity_scores=np.zeros(8, np.float32), has_affinities=False,
        distinct_hosts=False,
    )
    with pytest.raises(RuntimeError, match="CUDA"):
        score_group(ct, ga, 1)


def test_unported_paths_raise_not_implemented():
    """What is not ported raises naming its ROADMAP item: the mesh
    (A13), for every algorithm. Learned throughputs (A10's calibrate
    half) are ported and construct. Every registered algorithm builds its kernel on the device
    asked for, and the system and sysbatch schedulers construct there."""
    from nomad_tpu_torch.device.score import PlacementKernel
    from nomad_tpu_torch.scheduler import SystemScheduler, new_scheduler
    from nomad_tpu_torch.scheduler.algorithms import available, make_kernel
    from nomad_tpu_torch.scheduler.cp import CpGangPlacementKernel, CpPlacementKernel
    from nomad_tpu_torch.scheduler.hetero import HeteroPlacementKernel

    kinds = {
        "binpack": PlacementKernel, "spread": PlacementKernel,
        "hetero-maxmin": HeteroPlacementKernel,
        "hetero-makespan": HeteroPlacementKernel,
        "hetero-cost": HeteroPlacementKernel,
        "cp-pack": CpPlacementKernel, "cp-gang": CpGangPlacementKernel,
    }
    assert sorted(kinds) == available()
    for name, kind in kinds.items():
        kern = make_kernel(name, device="cpu")
        assert type(kern) is kind and kern.device == torch.device("cpu")
        with pytest.raises(NotImplementedError, match="A13"):
            make_kernel(name, mesh=object(), device="cpu")
    learned = HeteroPlacementKernel("cost", throughput_source="learned", device="cpu")
    assert learned.throughput_source == "learned"
    with pytest.raises(NotImplementedError, match="A13"):
        PlacementKernel(mesh=object(), device="cpu")
    for name in ("system", "sysbatch"):
        sched = new_scheduler(name, None, None, device="cpu")
        assert isinstance(sched, SystemScheduler)
        assert sched.device == torch.device("cpu")


def _fake_nvcc(tmp_path, body):
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + body)
    nvcc.chmod(0o755)
    return home


@pytest.fixture
def build_tree(tmp_path, monkeypatch):
    from nomad_tpu_torch import backend

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text("// a\n")
    (csrc / "b.cu").write_text("// b\n")
    monkeypatch.setattr(backend, "CSRC_DIR", csrc)
    monkeypatch.setattr(backend, "BUILD_DIR", tmp_path / "build")
    return backend


def test_build_all_runs_one_nvcc_per_source_and_reuses_builds(
    tmp_path, monkeypatch, build_tree
):
    """Every csrc/*.cu gets its own nvcc with the sm_90a flags; a second
    call finds the hashed libraries and runs nothing."""
    log = tmp_path / "calls"
    home = _fake_nvcc(
        tmp_path,
        f'echo "$@" >> {log}\n'
        'while [ "$1" != "-o" ]; do shift; done; touch "$2"\n',
    )
    monkeypatch.setenv("CUDA_HOME", str(home))
    out = build_tree.build_all()
    assert sorted(out) == ["a", "b"]
    assert all(p.exists() and p.parent == tmp_path / "build" for p in out.values())
    calls = log.read_text().splitlines()
    assert len(calls) == 2
    assert all("arch=compute_90a,code=sm_90a" in c and "-fmad=false" in c for c in calls)
    assert build_tree.build_all() == out
    assert len(log.read_text().splitlines()) == 2
    # an edited source hashes to a new library name and is rebuilt
    (tmp_path / "csrc" / "a.cu").write_text("// a, edited\n")
    assert build_tree.build_all()["a"] != out["a"]
    assert len(log.read_text().splitlines()) == 3


def test_build_all_rebuilds_every_source_when_a_shared_header_changes(
    tmp_path, monkeypatch, build_tree
):
    """A csrc/*.cuh header is part of every library's hash: editing it
    rebuilds each source, and a build that includes no edit is reused."""
    log = tmp_path / "calls"
    home = _fake_nvcc(
        tmp_path,
        f'echo "$@" >> {log}\n'
        'while [ "$1" != "-o" ]; do shift; done; touch "$2"\n',
    )
    monkeypatch.setenv("CUDA_HOME", str(home))
    header = tmp_path / "csrc" / "shared.cuh"
    header.write_text("// shared\n")
    out = build_tree.build_all()
    assert len(log.read_text().splitlines()) == 2
    assert build_tree.build_all() == out
    assert len(log.read_text().splitlines()) == 2
    header.write_text("// shared, edited\n")
    rebuilt = build_tree.build_all()
    assert all(rebuilt[n] != out[n] for n in ("a", "b"))
    assert all(p.exists() for p in rebuilt.values())
    assert len(log.read_text().splitlines()) == 4


def test_build_all_raises_with_the_compiler_output(tmp_path, monkeypatch, build_tree):
    home = _fake_nvcc(tmp_path, 'echo "error: expected a ;" ; exit 2\n')
    monkeypatch.setenv("CUDA_HOME", str(home))
    with pytest.raises(RuntimeError, match="expected a ;"):
        build_tree.build_all(["a"])
    assert not list((tmp_path / "build").glob("*.so"))
