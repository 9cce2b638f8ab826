"""The whole slice: the same seeded cluster and jobs go through the
reference ``Harness`` and the port's ``Harness(device="cpu")``.

512 mock nodes; three service jobs; one batch job; one job with running
allocs already (so anti-affinity is live); one job that cannot fully
place. Per job the node multiset, the alloc scores, the eval statuses
and the failed task-group metrics must agree.

Tolerance: node multisets, statuses and failure counts are exact. Alloc
scores and explanation scores agree within ``rtol=1e-5, atol=1e-6``:
the runtimes evaluate ``exp`` with different polynomials (a few ulp on
scores in [-2, 1]; see test_torch_score.py).

The reference's ``traced_jit`` calls ``jax.core.trace_state_clean``,
which this jax no longer has (ROADMAP C-R1). The reference side runs
inside a monkeypatch that binds it to ``jax._src.core.trace_state_clean``
for that block alone, with the reference mesh held degenerate; nothing
is installed at import or session scope, so the reference's own tests
see jax as it is.
"""

import collections
import contextlib
import dataclasses

import jax
import jax._src.core
import numpy as np

from nomad_tpu import mock as ref_mock
from nomad_tpu.scheduler import Harness as RefHarness
from nomad_tpu.state import StateStore as RefStore
from nomad_tpu.utils import backend as ref_backend
from nomad_tpu_torch import interop
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch.scheduler import Harness as PortHarness

RTOL, ATOL = 1e-5, 1e-6
N_NODES = 512


def _scenario():
    """Reference records: nodes, jobs in processing order, existing allocs."""
    nodes = [ref_mock.node() for _ in range(N_NODES)]
    services = []
    for count in (120, 80, 60):
        j = ref_mock.job()
        j.task_groups[0].count = count
        services.append(j)
    batch = ref_mock.batch_job()
    batch.task_groups[0].count = 90
    anti = ref_mock.job()
    anti.task_groups[0].count = 40
    existing = []
    for i in range(12):
        a = ref_mock.alloc(anti, nodes[(i * 37) % N_NODES])
        a.name = f"{anti.id}.web[{i}]"
        existing.append(a)
    # 7 allocs of 500 MHz fit a 4000 MHz node after its 100 MHz reserve:
    # at most 3,584 on the cluster, fewer once the jobs above land
    huge = ref_mock.job()
    huge.task_groups[0].count = 4000
    return nodes, services + [batch, anti, huge], existing


def _alloc_view(store, job):
    allocs = [a for a in store.allocs_by_job(job.namespace, job.id) if a.eval_id]
    nodes = collections.Counter(a.node_id for a in allocs)
    scores = sorted(
        (a.node_id, float(v))
        for a in allocs
        for k, v in a.metrics.scores.items()
        if k.endswith(".score")
    )
    return nodes, scores


def _failed_view(ev):
    out = {}
    for tg, m in ev.failed_tg_allocs.items():
        out[tg] = dict(
            nodes_evaluated=m.nodes_evaluated,
            nodes_filtered=m.nodes_filtered,
            nodes_exhausted=m.nodes_exhausted,
            coalesced_failures=m.coalesced_failures,
            dimension_exhausted=dict(m.dimension_exhausted),
            constraint_filtered=dict(m.constraint_filtered),
            class_filtered=dict(m.class_filtered),
            nodes_available=dict(m.nodes_available),
            rejections=dict(m.rejections),
            score_meta=[(s.node_id, s.norm_score) for s in m.score_meta],
        )
    return out


def _drive(harness, eval_for, jobs, eval_ids):
    for job, eval_id in zip(jobs, eval_ids):
        ev = eval_for(job, id=eval_id)
        harness.store.upsert_evals(harness.next_index(), [ev])
        harness.process(ev)


@contextlib.contextmanager
def reference_runtime(monkeypatch):
    """The reference's traced_jit path on this jax, for one block only."""
    with monkeypatch.context() as mp:
        mp.setattr(
            jax.core, "trace_state_clean", jax._src.core.trace_state_clean,
            raising=False,
        )
        mp.setattr(ref_backend, "_mesh_config", ref_backend.MeshConfig(None, 1, 1, "test"))
        yield


def _run_reference(nodes, jobs, existing, eval_ids, monkeypatch):
    store = RefStore()
    for n in nodes:
        store.upsert_node(1, n)
    for j in jobs:
        store.upsert_job(2, j)
    store.upsert_allocs(3, existing)
    records = (
        [dataclasses.asdict(n) for n in nodes],
        [dataclasses.asdict(j) for j in jobs],
        [dataclasses.asdict(a) for a in existing],
    )
    h = RefHarness(store)
    with reference_runtime(monkeypatch):
        _drive(h, ref_mock.eval_for, jobs, eval_ids)
    return h, records


def test_slice_matches_reference_end_to_end(monkeypatch):
    nodes, jobs, existing = _scenario()
    eval_ids = [f"eval-{i}" for i in range(len(jobs))]
    ref, (node_recs, job_recs, alloc_recs) = _run_reference(
        nodes, jobs, existing, eval_ids, monkeypatch
    )
    # the scoped shim is gone once its block ends
    assert not hasattr(jax.core, "trace_state_clean")

    port_store = interop.store_from_records(node_recs, job_recs, alloc_recs)
    port = PortHarness(port_store, device="cpu")
    port_jobs = [port_store.job_by_id(j.namespace, j.id) for j in jobs]
    _drive(port, port_mock.eval_for, port_jobs, eval_ids)

    placed_total = 0
    for job, pjob in zip(jobs, port_jobs):
        ref_nodes, ref_scores = _alloc_view(ref.store, job)
        port_nodes, port_scores = _alloc_view(port.store, pjob)
        assert port_nodes == ref_nodes, job.id
        assert [n for n, _ in port_scores] == [n for n, _ in ref_scores]
        np.testing.assert_allclose(
            [s for _, s in port_scores], [s for _, s in ref_scores],
            rtol=RTOL, atol=ATOL,
        )
        placed_total += sum(ref_nodes.values())
    assert placed_total > 3000  # the huge job filled what was left

    def statuses(h):
        return [(e.id, e.status, e.status_description) for e in h.evals]

    assert statuses(port) == statuses(ref)
    ref_final = {e.id: e for e in ref.evals}
    port_final = {e.id: e for e in port.evals}
    assert ref_final.keys() == port_final.keys()
    for eid in ref_final:
        r, p = _failed_view(ref_final[eid]), _failed_view(port_final[eid])
        assert r.keys() == p.keys()
        for tg in r:
            rs, ps = r[tg].pop("score_meta"), p[tg].pop("score_meta")
            assert r[tg] == p[tg], (eid, tg)
            assert [n for n, _ in rs] == [n for n, _ in ps]
            np.testing.assert_allclose(
                [s for _, s in ps], [s for _, s in rs], rtol=RTOL, atol=ATOL
            )
        assert ref_final[eid].queued_allocations == port_final[eid].queued_allocations
    # the unplaceable job failed into a blocked eval on both sides
    assert any(_failed_view(e) for e in ref.evals)
    assert [e.status for e in port.created_evals] == [e.status for e in ref.created_evals]


def test_reference_sees_jax_unpatched():
    """No test module installs the trace_state_clean shim beyond its own
    block: at any other time the attribute is absent, as on this jax."""
    assert not hasattr(jax.core, "trace_state_clean")


def test_preemption_raises_not_implemented(monkeypatch):
    """Preemption is ported: on the same store (64 nodes full of ballast
    from jobs at priorities 20, 40 and 75), a priority-80 service job of
    24 allocs through both Harnesses evicts the same allocs, by id, for
    placements on the same nodes, and rolls the same follow-up evals."""
    from nomad_tpu.state import SchedulerConfiguration as RefConfig
    from nomad_tpu_torch.state import SchedulerConfiguration

    rng = np.random.default_rng(17)
    nodes = [ref_mock.node() for _ in range(64)]
    ballast = []
    for prio in (20, 40, 75):
        j = ref_mock.job(priority=prio)
        j.task_groups[0].tasks[0].resources.cpu = 1200
        j.task_groups[0].tasks[0].resources.memory_mb = 2048
        ballast.append(j)
    existing = []
    for i, n in enumerate(nodes):
        for k in range(3):
            a = ref_mock.alloc(ballast[int(rng.integers(0, 3))], n)
            a.name = f"{a.job_id}.web[{3 * i + k}]"
            existing.append(a)
    high = ref_mock.job(priority=80)
    high.task_groups[0].count = 24
    high.task_groups[0].tasks[0].resources.cpu = 1000
    high.task_groups[0].tasks[0].resources.memory_mb = 1024
    jobs = ballast + [high]

    records = (
        [dataclasses.asdict(n) for n in nodes],
        [dataclasses.asdict(j) for j in jobs],
        [dataclasses.asdict(a) for a in existing],
    )
    ref_store = RefStore()
    ref_store.set_scheduler_config(1, RefConfig(preemption_service_enabled=True))
    for n in nodes:
        ref_store.upsert_node(2, n)
    for j in jobs:
        ref_store.upsert_job(3, j)
    ref_store.upsert_allocs(4, existing)
    ref = RefHarness(ref_store)
    with reference_runtime(monkeypatch):
        _drive(ref, ref_mock.eval_for, [high], ["eval-high"])
    port_store = interop.store_from_records(*records)
    port_store.set_scheduler_config(2, SchedulerConfiguration(preemption_service_enabled=True))
    port = PortHarness(port_store, device="cpu")
    _drive(port, port_mock.eval_for, [port_store.job_by_id(high.namespace, high.id)],
           ["eval-high"])

    def plan(h):
        placed = sorted(
            (a.node_id, a.name, tuple(sorted(a.preempted_allocations)))
            for a in h.store.allocs_by_job(high.namespace, high.id)
        )
        evicted = sorted(
            (a.id, a.node_id) for a in h.store.allocs() if a.desired_status == "evict"
        )
        created = sorted((e.triggered_by, e.job_id) for e in h.created_evals)
        return placed, evicted, created

    assert plan(port) == plan(ref)
    placed, evicted, created = plan(ref)
    assert len(placed) == 24 and all(victims for _, _, victims in placed)
    prio_of = {j.id: j.priority for j in jobs}
    victim_jobs = {ref.store.alloc_by_id(aid).job_id for aid, _ in evicted}
    assert victim_jobs and all(prio_of[j] <= 70 for j in victim_jobs)
    assert sorted(j for t, j in created if t == "preemption") == sorted(victim_jobs)
