"""The port's system and sysbatch schedulers against the JAX reference, on
the CPU.

Each case builds one reference store (mock nodes, jobs, existing allocs,
a scheduler configuration), carries it to the port's store with the same
ids (``interop.store_from_records``), and processes the same evals
through the reference ``Harness`` and the port's ``Harness(device="cpu")``.
Per eval the plans must agree: the placed allocs (node, group, name and
the victims each preempts, by alloc id), the stopped and evicted allocs
by id, the follow-up evals, the eval statuses and the failed-group
metrics.

Tolerance: everything above is exact. Alloc scores and their score
metadata agree within ``rtol=1e-5, atol=1e-6`` — the score matrix's
``exp`` in XLA against PyTorch's, a few ulp (test_torch_score.py).

The reference's kernels run through ``traced_jit``, which needs a
monkeypatch on this jax (ROADMAP C-R1), scoped to the reference's block.
"""

import dataclasses

import jax
import jax._src.core
import numpy as np
import pytest

from nomad_tpu import mock as ref_mock
from nomad_tpu.scheduler import Harness as RefHarness
from nomad_tpu.state import SchedulerConfiguration as RefConfig
from nomad_tpu.state import StateStore as RefStore
from nomad_tpu.structs import Constraint, TaskGroup, Task
from nomad_tpu.structs.resources import Resources
from nomad_tpu.utils import backend as ref_backend
from nomad_tpu_torch import interop
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch.scheduler import Harness as PortHarness
from nomad_tpu_torch.state import SchedulerConfiguration as PortConfig

RTOL, ATOL = 1e-5, 1e-6


def _ballast_job(prio, cpu=1800, mem=3500, make=ref_mock.job):
    j = make(priority=prio)
    j.task_groups[0].tasks[0].resources.cpu = cpu
    j.task_groups[0].tasks[0].resources.memory_mb = mem
    return j


def _system_job(prio=50, cpu=500, mem=512, sysbatch=False):
    j = ref_mock.system_job(priority=prio)
    if sysbatch:
        j.type = "sysbatch"
    j.task_groups[0].tasks[0].resources.cpu = cpu
    j.task_groups[0].tasks[0].resources.memory_mb = mem
    return j


def _case(name):
    """(nodes, jobs to store, existing allocs, config kwargs, jobs to
    process in order)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    nodes = [ref_mock.node() for _ in range(40)]
    for i, n in enumerate(nodes):
        n.attributes["platform.rack"] = f"r{i % 4}"
        n.compute_class()
    jobs, allocs, config = [], [], {}
    if name == "fresh":
        sysj = _system_job()
        process = [sysj]
    elif name == "constrained_with_existing":
        sysj = _system_job()
        sysj.task_groups[0].constraints.append(
            Constraint(l_target="${attr.platform.rack}", r_target="r3", operand="!=")
        )
        # already running on five nodes, two of them in the rack the
        # constraint now excludes, which the plan stops
        for i in (0, 1, 2, 3, 7):
            a = ref_mock.alloc(sysj, nodes[i])
            allocs.append(a)
        process = [sysj]
    elif name == "two_groups":
        sysj = _system_job(cpu=1500, mem=2048)
        sysj.task_groups.append(TaskGroup(
            name="sidecar", count=1,
            tasks=[Task(name="side", driver="exec", resources=Resources(cpu=2000, memory_mb=1024))],
        ))
        # half the nodes hold 900 MHz of other work: the sidecar fits
        # only where the first group left room
        other = _ballast_job(80, cpu=900, mem=512)
        jobs.append(other)
        allocs += [ref_mock.alloc(other, n) for n in nodes[::2]]
        process = [sysj]
    elif name == "sysbatch_with_complete":
        sysj = _system_job(sysbatch=True)
        done = ref_mock.alloc(sysj, nodes[5])
        done.client_status = "complete"
        done.desired_status = "run"
        allocs.append(done)
        process = [sysj]
    elif name in ("preempts_by_default", "preemption_disabled", "mixed_priorities"):
        lows = [_ballast_job(p) for p in ((20, 40, 75) if name == "mixed_priorities" else (10,))]
        jobs += lows
        for i, n in enumerate(nodes):
            for k in range(2):
                a = ref_mock.alloc(lows[int(rng.integers(0, len(lows)))], n)
                a.name = f"{a.job_id}.web[{2 * i + k}]"
                allocs.append(a)
        sysj = _system_job(prio=90 if name != "mixed_priorities" else 50,
                           cpu=1000, mem=1024)
        if name == "preemption_disabled":
            config = dict(preemption_system_enabled=False)
        process = [sysj]
    else:
        raise KeyError(name)
    jobs.append(sysj)
    return nodes, jobs, allocs, config, process


def _plans(h, jobs):
    placed = sorted(
        (a.node_id, a.task_group, a.name, a.client_status,
         tuple(sorted(a.preempted_allocations)))
        for j in jobs for a in h.store.allocs_by_job(j.namespace, j.id)
        if a.eval_id and not a.terminal_status()
    )
    changed = sorted(
        (a.id, a.node_id, a.desired_status)
        for a in h.store.allocs() if a.desired_status != "run"
    )
    created = sorted((e.triggered_by, e.job_id, e.status) for e in h.created_evals)
    statuses = [(e.id, e.status) for e in h.evals]
    failed = [
        {tg: (m.nodes_evaluated, m.nodes_exhausted, m.coalesced_failures,
              dict(m.dimension_exhausted), dict(m.rejections))
         for tg, m in e.failed_tg_allocs.items()}
        for e in h.evals
    ]
    return placed, changed, created, statuses, failed


def _scores(h, jobs):
    return sorted(
        (a.node_id, a.task_group, k, float(v),
         tuple((s.node_id, s.norm_score) for s in a.metrics.score_meta))
        for j in jobs for a in h.store.allocs_by_job(j.namespace, j.id)
        if a.eval_id and not a.terminal_status()
        for k, v in a.metrics.scores.items()
    )


@pytest.mark.parametrize("name", [
    "fresh", "constrained_with_existing", "two_groups", "sysbatch_with_complete",
    "preempts_by_default", "preemption_disabled", "mixed_priorities",
])
def test_system_plans_match_reference(monkeypatch, name):
    nodes, jobs, allocs, config, process = _case(name)
    ref = RefHarness(RefStore())
    ref.store.set_scheduler_config(1, RefConfig(**config))
    for n in nodes:
        ref.store.upsert_node(2, n)
    for j in jobs:
        ref.store.upsert_job(3, j)
    if allocs:
        ref.store.upsert_allocs(4, allocs)
    records = (
        [dataclasses.asdict(n) for n in nodes],
        [dataclasses.asdict(j) for j in jobs],
        [dataclasses.asdict(a) for a in allocs],
    )
    port = PortHarness(interop.store_from_records(*records), device="cpu")
    port.store.set_scheduler_config(port.next_index(), PortConfig(**config))
    with monkeypatch.context() as mp:
        mp.setattr(
            jax.core, "trace_state_clean", jax._src.core.trace_state_clean,
            raising=False,
        )
        mp.setattr(ref_backend, "_mesh_config", ref_backend.MeshConfig(None, 1, 1, "test"))
        for i, j in enumerate(process):
            ref.process(ref_mock.eval_for(j, id=f"eval-{i}"))
    for i, j in enumerate(process):
        port.process(port_mock.eval_for(port.store.job_by_id(j.namespace, j.id), id=f"eval-{i}"))

    ref_plans, port_plans = _plans(ref, process), _plans(port, process)
    assert port_plans == ref_plans
    ref_scores, port_scores = _scores(ref, process), _scores(port, process)
    assert [s[:3] for s in port_scores] == [s[:3] for s in ref_scores]
    np.testing.assert_allclose(
        [s[3] for s in port_scores], [s[3] for s in ref_scores], rtol=RTOL, atol=ATOL
    )
    for p, r in zip(port_scores, ref_scores):
        assert [m[0] for m in p[4]] == [m[0] for m in r[4]]
        np.testing.assert_allclose(
            [m[1] for m in p[4]], [m[1] for m in r[4]], rtol=RTOL, atol=ATOL
        )

    placed, changed, created, statuses, failed = ref_plans
    assert statuses == [(f"eval-{i}", "complete") for i in range(len(process))]
    evicted = [c for c in changed if c[2] == "evict"]
    if name == "fresh":
        assert len(placed) == len(nodes)
    if name == "constrained_with_existing":
        # 30 eligible nodes, 3 already running; the two in r3 are stopped
        assert len(placed) == 30 - 3 and len(changed) == 2 and not evicted
    if name == "two_groups":
        assert {p[1] for p in placed} == {"sys", "sidecar"} and any(failed[0].values())
    if name == "sysbatch_with_complete":
        assert len(placed) == len(nodes) - 1
    if name == "preempts_by_default":
        assert len(placed) == len(nodes) and len(evicted) == len(nodes)
        assert {c[0] for c in created} == {"preemption"}
    if name == "preemption_disabled":
        assert placed == [] and not evicted and failed[0]["sys"][2] == len(nodes) - 1
    if name == "mixed_priorities":
        prio = {j.id: j.priority for j in jobs}
        victims = {ref.store.alloc_by_id(c[0]).job_id for c in evicted}
        assert evicted and all(prio[v] <= 40 for v in victims)
        assert 0 < len(placed) < len(nodes)  # nodes of two 75s cannot make room
