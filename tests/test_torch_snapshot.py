"""The port's snapshot restore (``state/snapshot.py``) and its restricted
unpickler (``rpc/framing.py``) against the JAX reference, on the CPU.

- The same records (nodes, service and batch jobs with a second version,
  allocs, evals, a namespace, the scheduler configuration) saved by each
  package and restored by each give stores that are equal as records
  (``dataclasses.asdict`` of every table, the job versions and the
  latest index).
- Each package restores its own files only: a snapshot of the other
  package names classes outside the allowlist and is refused with
  ``FramingError``.
- A restored port store schedules an eval to the same plan as the store
  before saving.
- The cases of ``tests/test_framing_security.py`` that apply to
  ``restricted_loads`` (plain types and framework dataclasses round-trip,
  a crafted global such as ``os.system`` or a framework function is
  refused, numpy arrays round-trip, a torn payload raises
  ``FramingError``, a failed write leaves the previous snapshot).

No numeric tolerance applies: every comparison is exact.
"""

import collections
import copy
import dataclasses
import os
import pickle

import numpy as np
import pytest

from nomad_tpu import mock as ref_mock
from nomad_tpu.rpc.framing import FramingError as RefFramingError
from nomad_tpu.state import SchedulerConfiguration as RefConfig
from nomad_tpu.state import StateStore as RefStore
from nomad_tpu.state.snapshot import restore_snapshot as ref_restore
from nomad_tpu.state.snapshot import save_snapshot as ref_save
from nomad_tpu.structs.job import Namespace as RefNamespace
from nomad_tpu_torch import interop
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch.rpc.framing import FramingError, restricted_loads
from nomad_tpu_torch.scheduler import Harness
from nomad_tpu_torch.state import SchedulerConfiguration as PortConfig
from nomad_tpu_torch.state import StateStore
from nomad_tpu_torch.state.snapshot import (
    SNAPSHOT_MAGIC,
    restore_snapshot,
    save_snapshot,
)
from nomad_tpu_torch.structs import Allocation, Evaluation, Job, Node
from nomad_tpu_torch.structs.job import Namespace


def _records():
    nodes = [ref_mock.node() for _ in range(6)]
    svc = ref_mock.job()
    svc.task_groups[0].count = 3
    batch = ref_mock.batch_job()
    allocs = [ref_mock.alloc(svc, nodes[i]) for i in range(3)]
    evals = [ref_mock.eval_for(svc, id="eval-a"), ref_mock.eval_for(batch, id="eval-b")]
    svc2 = copy.deepcopy(svc)
    svc2.task_groups[0].count = 4
    return nodes, [svc, batch], allocs, evals, svc2


def _ref_store(nodes, jobs, allocs, evals, svc2):
    s = RefStore()
    s.set_scheduler_config(1, RefConfig(preemption_service_enabled=True))
    for n in nodes:
        s.upsert_node(2, n)
    for j in jobs:
        s.upsert_job(3, j)
    s.upsert_allocs(4, allocs)
    s.upsert_evals(5, evals)
    s.upsert_job(6, svc2)
    s.upsert_namespace(7, RefNamespace(name="team-a", description="a"))
    return s


def _port_store(nodes, jobs, allocs, evals, svc2):
    s = StateStore()
    s.set_scheduler_config(1, PortConfig(preemption_service_enabled=True))
    for n in nodes:
        s.upsert_node(2, interop.from_record(Node, dataclasses.asdict(n)))
    for j in jobs:
        s.upsert_job(3, interop.from_record(Job, dataclasses.asdict(j)))
    s.upsert_allocs(
        4, [interop.from_record(Allocation, dataclasses.asdict(a)) for a in allocs]
    )
    s.upsert_evals(
        5, [interop.from_record(Evaluation, dataclasses.asdict(e)) for e in evals]
    )
    s.upsert_job(6, interop.from_record(Job, dataclasses.asdict(svc2)))
    s.upsert_namespace(7, Namespace(name="team-a", description="a"))
    return s


def _equal(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def _as_records(store):
    """Every table of a store as plain records, keyed by id."""
    snap = store.snapshot()
    t = snap._t

    def rec(table):
        return {k: dataclasses.asdict(v) for k, v in sorted(table.items(), key=str)}

    return {
        "index": snap.index,
        "nodes": rec(t.nodes),
        "jobs": rec(t.jobs),
        "job_versions": {
            str(k): [dataclasses.asdict(j) for j in v]
            for k, v in sorted(t.job_versions.items(), key=str)
        },
        "evals": rec(t.evals),
        "allocs": rec(t.allocs),
        "deployments": rec(t.deployments),
        "namespaces": rec(t.namespaces),
        "scheduler_config": dict(vars(t.scheduler_config)),
    }


def test_each_package_restores_the_same_records(tmp_path):
    recs = _records()
    ref_path, port_path = str(tmp_path / "ref.snap"), str(tmp_path / "port.snap")
    ref_idx = ref_save(_ref_store(*recs), ref_path)
    port_idx = save_snapshot(_port_store(*recs), port_path)
    assert ref_idx == port_idx == 7
    ref_restored = ref_restore(ref_path)
    port_restored = restore_snapshot(port_path)
    got, want = _as_records(port_restored), _as_records(ref_restored)
    _equal(got, want)
    assert len(got["allocs"]) == 3
    assert len(got["job_versions"]) == 2
    assert got["scheduler_config"]["preemption_service_enabled"] is True
    # the restored objects are the port's own classes
    node = next(iter(port_restored.nodes()))
    assert type(node) is Node


def test_each_package_refuses_the_others_file(tmp_path):
    recs = _records()
    ref_path, port_path = str(tmp_path / "ref.snap"), str(tmp_path / "port.snap")
    ref_save(_ref_store(*recs), ref_path)
    save_snapshot(_port_store(*recs), port_path)
    with pytest.raises(FramingError, match="disallowed global.*nomad_tpu\\."):
        restore_snapshot(ref_path)
    with pytest.raises(RefFramingError, match="disallowed global.*nomad_tpu_torch"):
        ref_restore(port_path)


def test_restored_store_schedules_the_same_plan(tmp_path):
    recs = _records()
    store = _port_store(*recs)
    path = str(tmp_path / "state.snap")
    save_snapshot(store, path)
    restored = restore_snapshot(path)

    def place(s):
        h = Harness(s, device="cpu")
        job = port_mock.job(id="fresh")
        job.task_groups[0].count = 5
        s.upsert_job(h.next_index(), job)
        ev = port_mock.eval_for(job, id="eval-fresh")
        s.upsert_evals(h.next_index(), [ev])
        h.process(ev)
        allocs = s.allocs_by_job(job.namespace, job.id)
        return (
            collections.Counter((a.name, a.node_id) for a in allocs),
            [(e.id, e.status) for e in h.evals],
        )

    before, after = place(store), place(restored)
    assert after == before
    assert sum(after[0].values()) == 5


def test_bad_magic_and_version_refused(tmp_path):
    path = str(tmp_path / "x.snap")
    with open(path, "wb") as f:
        f.write(b"NOT-A-SNAPSHOT" + pickle.dumps({}))
    with pytest.raises(ValueError, match="not a nomad-tpu snapshot"):
        restore_snapshot(path)
    with open(path, "wb") as f:
        f.write(SNAPSHOT_MAGIC + pickle.dumps({"version": 99}))
    with pytest.raises(ValueError, match="unsupported snapshot version"):
        restore_snapshot(path)


# -- restricted_loads (framing-security cases) ---------------------------------


def test_roundtrip_plain_types():
    msg = {"seq": 1, "method": "Node.register", "args": {"x": [1, 2.5, "s", None, True]}}
    assert restricted_loads(pickle.dumps(msg)) == msg
    more = {"s": {1, 2}, "f": frozenset({3}), "d": collections.OrderedDict(a=1)}
    assert restricted_loads(pickle.dumps(more)) == more


def test_roundtrip_framework_dataclass():
    node = port_mock.node()
    got = restricted_loads(pickle.dumps({"seq": 2, "args": node}))
    assert got["args"].id == node.id and type(got["args"]) is Node


def test_malicious_global_rejected():
    """A crafted payload resolving os.system is refused before any
    callable executes — the classic pickle RCE."""

    class Evil:
        def __reduce__(self):
            return (os.system, ("true",))

    with pytest.raises(FramingError, match="disallowed global"):
        restricted_loads(pickle.dumps({"seq": 3, "args": Evil()}))


def test_non_dataclass_framework_global_rejected():
    """A function of an allowed module, or of the port's own snapshot
    module, never resolves."""

    class Evil:
        def __reduce__(self):
            import nomad_tpu_torch.state.snapshot as s

            return (s.save_snapshot, (None, "/nonexistent/x"))

    with pytest.raises(FramingError, match="disallowed global"):
        restricted_loads(pickle.dumps({"args": Evil()}))

    class EvilStructFn:
        def __reduce__(self):
            from nomad_tpu_torch.structs import new_id

            return (new_id, ())

    with pytest.raises(FramingError, match="disallowed global"):
        restricted_loads(pickle.dumps({"args": EvilStructFn()}))


def test_reference_class_rejected():
    """A class of the JAX package is outside the port's allowlist."""
    with pytest.raises(FramingError, match="disallowed global in RPC frame: nomad_tpu\\.structs"):
        restricted_loads(pickle.dumps(ref_mock.node()))


def test_numpy_payload_roundtrip():
    got = restricted_loads(pickle.dumps({"a": np.arange(4, dtype=np.int32)}))
    assert got["a"].tolist() == [0, 1, 2, 3]


def test_torn_payload_is_a_framing_error():
    payload = pickle.dumps({"seq": 1, "args": list(range(100))})
    with pytest.raises(FramingError, match="malformed"):
        restricted_loads(payload[: len(payload) // 2])


def test_snapshot_write_is_atomic(tmp_path):
    """A failed snapshot write does not destroy the previous good one."""
    store = StateStore()
    store.upsert_node(1, port_mock.node())
    path = str(tmp_path / "state.snap")
    save_snapshot(store, path)
    good = open(path, "rb").read()
    with open(path + ".tmp", "wb") as f:
        f.write(good[: len(good) // 2])
    assert open(path, "rb").read() == good
    assert len(list(restore_snapshot(path).nodes())) == 1
