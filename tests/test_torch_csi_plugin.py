"""The port's out-of-process CSI plugins (``nomad_tpu_torch.client.csi_plugin``)
against the JAX package's, on the CPU.

The 5 scenarios of the reference's ``tests/test_csi_plugin.py``, each on
both packages: probe, stage, publish and unpublish through the hostpath
plugin's subprocess; a publish of an unstaged volume refused; an unknown
plugin failing its probe; a volume whose data one alloc writes and a
later alloc reads back, staged and published around each task by the
alloc runner and unpublished when the client's GC tears the allocs down; and a job whose volume's
plugin no node runs, parked as a blocked eval with nothing placed. Every
outcome both packages give (probe verdicts, file contents, link states,
alloc statuses, eval statuses) must be equal. Each package's hostpath
plugin keeps its volumes under its own root (``NOMAD_CSI_HOSTPATH_ROOT``).

The reference's dev agent schedules through its ``traced_jit`` kernels
under the scoped ``reference_runtime`` shim (ROADMAP C-R1); the port's
runs on the CPU. No numeric tolerance applies: everything compared is
exact.
"""

import os
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import pytest

from nomad_tpu import mock as ref_mock
from nomad_tpu.agent import DevAgent as RefDevAgent
from nomad_tpu.client import csi_plugin as ref_csi
from nomad_tpu.structs import volumes as ref_volumes
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch.agent import DevAgent
from nomad_tpu_torch.client import csi_plugin as port_csi
from nomad_tpu_torch.structs import volumes as port_volumes
from test_torch_hetero import reference_runtime

WAIT_S = 30.0

REF = SimpleNamespace(name="reference", csi=ref_csi, mock=ref_mock, DevAgent=RefDevAgent,
                      volumes=ref_volumes, agent_kw={})
PORT = SimpleNamespace(name="port", csi=port_csi, mock=port_mock, DevAgent=DevAgent,
                       volumes=port_volumes, agent_kw={"device": "cpu"})


def both_plugins(fn, tmp_path):
    """``fn(package, work dir)`` on the reference and the port at once, in
    two threads. The hostpath root is read from the environment when the
    plugin process starts, so each package's plugin client is made with
    its own root by ``plugin(pkg, root)``."""
    with ThreadPoolExecutor(2) as pool:
        futs = [pool.submit(fn, pkg, tmp_path / pkg.name) for pkg in (REF, PORT)]
        return futs[0].result(), futs[1].result()


def plugin(pkg, root):
    """The package's hostpath CSI plugin client, its volumes under
    ``root``: the launcher's environment carries the root."""
    return pkg.csi.CSIPluginClient("hostpath", argv=[
        "/usr/bin/env", f"NOMAD_CSI_HOSTPATH_ROOT={root}",
        *pkg.csi.CSIPluginClient("hostpath").default_argv("hostpath"),
    ])


@pytest.fixture()
def csi_root(tmp_path, monkeypatch):
    root = tmp_path / "csi-root"
    monkeypatch.setenv("NOMAD_CSI_HOSTPATH_ROOT", str(root))
    return root


# -- TestCSIProtocol -----------------------------------------------------------


def test_probe_stage_publish_roundtrip(tmp_path):
    def run(pkg, work):
        root = work / "csi-root"
        cp = plugin(pkg, root)
        try:
            ready = cp.probe()
            target = str(work / "mnt" / "vol0")
            cp.node_stage("vol0", str(work / "staging"))
            cp.node_publish("vol0", target)
            # the published path is live: writes land in the volume backend
            with open(os.path.join(target, "data.txt"), "w") as f:
                f.write("hello-csi")
            backend = (root / "vol0" / "data.txt").read_text()
            cp.node_unpublish("vol0", target)
            gone = not os.path.lexists(target)
            cp.node_unstage("vol0")
            return ready, backend, gone
        finally:
            cp.close()

    ref, port = both_plugins(run, tmp_path)
    assert port == ref == (True, "hello-csi", True)


def test_publish_unstaged_volume_fails(tmp_path):
    def run(pkg, work):
        cp = plugin(pkg, work / "csi-root")
        try:
            with pytest.raises(RuntimeError) as e:
                cp.node_publish("ghost", str(work / "mnt" / "g"))
            return str(e.value), os.path.lexists(work / "mnt" / "g")
        finally:
            cp.close()

    ref, port = both_plugins(run, tmp_path)
    assert port == ref == ("volume ghost not staged", False)


def test_unknown_plugin_rejected(tmp_path):
    def run(pkg, _):
        return pkg.csi.CSIPluginClient("nonexistent").probe()

    ref, port = both_plugins(run, tmp_path)
    assert port is ref is False


def test_launcher_is_the_packages_own():
    argv = port_csi.CSIPluginClient("hostpath").default_argv("hostpath")
    assert argv[1:] == ["-m", "nomad_tpu_torch.client.csi_plugin", "hostpath"]
    assert port_csi.CSI_PLUGIN_MAGIC == ref_csi.CSI_PLUGIN_MAGIC


# -- TestCSIAllocLifecycle -----------------------------------------------------


def _vol_job(pkg, jid, script, volumes):
    job = pkg.mock.job()
    job.id = jid
    tg = job.task_groups[0]
    tg.count = 1
    tg.volumes = {"data": volumes.VolumeRequest(name="data", type="csi", source="shared-vol")}
    tg.tasks[0].driver = "raw_exec"
    tg.tasks[0].config = {"command": "/bin/sh", "args": ["-c", script]}
    tg.tasks[0].resources.cpu = 50
    tg.tasks[0].resources.memory_mb = 32
    return job


def _wait(cond):
    deadline = time.time() + WAIT_S
    while time.time() < deadline and not cond():
        time.sleep(0.1)
    return cond()


def published(agent, job_ids):
    """The jobs' alloc runners, and the jobs whose volume link is live."""
    runners = [r for a in agent.store.allocs() if a.job_id in job_ids
               for r in [agent.client.runners.get(a.id)] if r is not None]
    live = sorted(r.alloc.job_id for r in runners
                  if os.path.islink(os.path.join(r.alloc_dir, "volumes", "data")))
    return runners, live


def _persist(pkg, work, root):
    agent = pkg.DevAgent(data_dir=str(work / "agent"), num_workers=1, csi_plugins=["hostpath"],
                         **pkg.agent_kw)
    agent.start()
    try:
        attr = agent.client.node.attributes.get("csi.hostpath")
        infos = {k: (v.plugin_id, v.healthy) for k, v in agent.client.node.csi_node_plugins.items()}
        # multi-writer access, so that the reader need not wait for the
        # writer's claim to be reaped by the volume watcher
        agent.server.register_csi_volume(pkg.volumes.CSIVolume(
            id="shared-vol", name="shared-vol", plugin_id="hostpath",
            access_mode=pkg.volumes.ACCESS_MODE_MULTI_NODE_MULTI_WRITER,
        ))

        def done(jid):
            return any(a.client_status == "complete"
                       for a in agent.store.allocs_by_job("default", jid))

        agent.register_job(_vol_job(pkg, "writer", 'echo persisted > "$NOMAD_VOLUME_DATA/x"',
                                    pkg.volumes))
        wrote = _wait(lambda: done("writer"))
        backend = (root / "shared-vol" / "x").read_text().strip()
        agent.register_job(_vol_job(
            pkg, "reader", 'cat "$NOMAD_VOLUME_DATA/x" > "$NOMAD_ALLOC_DIR/copy"', pkg.volumes))
        read = _wait(lambda: done("reader"))
        r_alloc = next(a for a in agent.store.allocs_by_job("default", "reader")
                       if a.client_status == "complete")
        runner = agent.client.runners[r_alloc.id]
        copy = open(os.path.join(runner.alloc_dir, "shared", "copy")).read().strip()
        runners, live = published(agent, ("writer", "reader"))
        # teardown: the client's GC destroys the terminal allocs, and each
        # runner unpublishes and unstages its volume through the plugin
        agent.client.gc_max_terminal_allocs = 0
        torn_down = _wait(lambda: all(
            r._destroyed and not r._published_volumes
            and not os.path.lexists(os.path.join(r.alloc_dir, "volumes", "data"))
            for r in runners))
        statuses = sorted((a.job_id, a.client_status) for a in agent.store.allocs())
        kept = (root / "shared-vol" / "x").read_text().strip()
        return attr, infos, wrote, backend, read, copy, live, torn_down, statuses, kept
    finally:
        agent.shutdown()


def test_volume_data_persists_across_allocs(tmp_path, monkeypatch):
    """Alloc 1 writes into the volume, alloc 2 (a later, different alloc)
    reads it back: stage and publish through the out-of-process plugin,
    teardown unpublishes."""
    out = {}
    for pkg in (REF, PORT):
        root = tmp_path / pkg.name / "csi-root"
        monkeypatch.setenv("NOMAD_CSI_HOSTPATH_ROOT", str(root))
        if pkg is REF:
            with reference_runtime(monkeypatch):
                out[pkg.name] = _persist(pkg, tmp_path / pkg.name, root)
        else:
            out[pkg.name] = _persist(pkg, tmp_path / pkg.name, root)
    assert out["port"] == out["reference"]
    attr, infos, wrote, backend, read, copy, live, torn_down, statuses, kept = out["port"]
    assert (attr, infos) == ("1", {"hostpath": ("hostpath", True)})
    assert (wrote, backend, read, copy) == (True, "persisted", True, "persisted")
    assert live == ["reader", "writer"] and torn_down
    assert statuses == [("reader", "complete"), ("writer", "complete")]
    assert kept == "persisted"  # unpublishing keeps the volume's data


def _missing(pkg, work):
    agent = pkg.DevAgent(data_dir=str(work / "agent2"), num_workers=1, **pkg.agent_kw)
    agent.start()  # no CSI plugin configured
    try:
        job = pkg.mock.job()
        job.id = "no-plugin"
        tg = job.task_groups[0]
        tg.count = 1
        tg.volumes = {"data": pkg.volumes.VolumeRequest(name="data", type="csi",
                                                        source="shared-vol")}
        tg.tasks[0].driver = "raw_exec"
        tg.tasks[0].config = {"command": "/bin/true"}
        tg.tasks[0].resources.cpu = 50
        tg.tasks[0].resources.memory_mb = 32
        agent.server.register_csi_volume(pkg.volumes.CSIVolume(
            id="shared-vol", name="shared-vol", plugin_id="hostpath"))
        agent.register_job(job)
        # the node advertises no CSI plugin, so the scheduler filters it
        # and the job parks as a blocked eval
        blocked = _wait(lambda: any(e.status == "blocked" for e in agent.store.evals()
                                    if e.job_id == "no-plugin"))
        return blocked, len(agent.store.allocs_by_job("default", "no-plugin"))
    finally:
        agent.shutdown()


def test_missing_plugin_fails_alloc(tmp_path, csi_root, monkeypatch):
    with reference_runtime(monkeypatch):
        ref = _missing(REF, tmp_path / "ref")
    port = _missing(PORT, tmp_path / "port")
    assert port == ref == (True, 0)
