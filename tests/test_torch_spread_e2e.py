"""The spread slice end to end: jobs with spread stanzas and
distinct_property constraints go through the reference ``Harness`` and
the port's ``Harness(device="cpu")`` on the same seeded cluster.

512 mock nodes over 8 racks (``platform.rack``), every 4th with
``storage.type = ssd``, every 3rd twice as large. The jobs, processed in
order, take each coupled route of ``PlacementKernel.place``:

- an even rack spread + ssd affinity service job of 120 (one-per-value);
- a batch job of the same kind, 90 (one-per-value);
- a target rack spread over r0–r4 at 20 % each, 60 (chunked);
- a ``distinct_property`` rack cap of 6, 40 (exact value scan);
- an even rack spread of 20, at most EXACT_SCAN_MAX_COUNT (exact value
  scan).

Tolerance: per-job node multisets, eval statuses and failure counts are
exact; alloc scores agree within ``rtol=1e-5, atol=1e-6`` (the runtimes
evaluate ``exp`` with different polynomials; see test_torch_score.py).
The reference side runs inside the scoped ``trace_state_clean`` shim of
test_torch_e2e.py (ROADMAP C-R1).
"""

import collections
import dataclasses

import jax
import jax._src.core
import numpy as np

from nomad_tpu import mock as ref_mock
from nomad_tpu.scheduler import Harness as RefHarness
from nomad_tpu.state import StateStore as RefStore
from nomad_tpu.structs import Affinity, Constraint, Spread, SpreadTarget
from nomad_tpu.utils import backend as ref_backend
from nomad_tpu_torch import interop
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch.obs.trace import global_tracer
from nomad_tpu_torch.scheduler import Harness as PortHarness

RTOL, ATOL = 1e-5, 1e-6
N_NODES = 512
RACKS = 8
RACK = "${attr.platform.rack}"
DISTINCT_CAP = 6


def _nodes():
    nodes = []
    for i in range(N_NODES):
        n = ref_mock.node()
        n.attributes["platform.rack"] = f"r{i % RACKS}"
        n.attributes["storage.type"] = "ssd" if i % 4 == 0 else "hdd"
        if i % 3 == 1:
            n.node_resources.cpu = 8000
            n.node_resources.memory_mb = 16384
        n.compute_class()
        nodes.append(n)
    return nodes


def _job(count, batch=False, cpu=500, spreads=(), affinities=(), constraints=()):
    j = ref_mock.batch_job() if batch else ref_mock.job()
    tg = j.task_groups[0]
    tg.count = count
    tg.tasks[0].resources.cpu = cpu
    j.spreads = list(spreads)
    j.affinities = list(affinities)
    tg.constraints = list(tg.constraints) + list(constraints)
    return j


def _jobs():
    even = Spread(attribute=RACK, weight=50)
    ssd = Affinity(l_target="${attr.storage.type}", r_target="ssd", operand="=", weight=50)
    target = Spread(
        attribute=RACK, weight=50,
        targets=[SpreadTarget(value=f"r{r}", percent=20) for r in range(5)],
    )
    cap = Constraint(l_target=RACK, r_target=str(DISTINCT_CAP), operand="distinct_property")
    return [
        ("opv", _job(120, spreads=[even], affinities=[ssd])),
        ("opv", _job(90, batch=True, cpu=250, spreads=[even], affinities=[ssd])),
        ("chunked", _job(60, spreads=[target])),
        ("scan", _job(40, constraints=[cap])),
        ("scan", _job(20, spreads=[even])),
    ]


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


def _failures(h):
    return {
        e.id: {
            tg: (m.nodes_evaluated, m.nodes_filtered, m.nodes_exhausted,
                 m.coalesced_failures, dict(m.dimension_exhausted),
                 dict(m.constraint_filtered))
            for tg, m in e.failed_tg_allocs.items()
        }
        for e in h.evals
    }


def test_spread_slice_matches_reference_end_to_end(monkeypatch):
    nodes = _nodes()
    routed = _jobs()
    jobs = [j for _, j in routed]
    eval_ids = [f"eval-{i}" for i in range(len(jobs))]

    store = RefStore()
    for n in nodes:
        store.upsert_node(1, n)
    for j in jobs:
        store.upsert_job(2, j)
    records = (
        [dataclasses.asdict(n) for n in nodes],
        [dataclasses.asdict(j) for j in jobs],
        [],
    )
    ref = RefHarness(store)
    with monkeypatch.context() as mp:
        mp.setattr(
            jax.core, "trace_state_clean", jax._src.core.trace_state_clean,
            raising=False,
        )
        mp.setattr(ref_backend, "_mesh_config", ref_backend.MeshConfig(None, 1, 1, "test"))
        for job, eid in zip(jobs, eval_ids):
            ev = ref_mock.eval_for(job, id=eid)
            ref.store.upsert_evals(ref.next_index(), [ev])
            ref.process(ev)
    assert not hasattr(jax.core, "trace_state_clean")

    port_store = interop.store_from_records(*records)
    port = PortHarness(port_store, device="cpu")
    port_jobs = [port_store.job_by_id(j.namespace, j.id) for j in jobs]
    routes = []
    for (route, _), job, eid in zip(routed, port_jobs, eval_ids):
        ev = port_mock.eval_for(job, id=eid)
        port.store.upsert_evals(port.next_index(), [ev])
        global_tracer.begin(ev.id)
        with global_tracer.activate(ev.id):
            port.process(ev)
        spans = [
            sp["tags"] for sp in global_tracer.finish(ev.id)["spans"]
            if sp["name"] == "kernel.place"
        ]
        routes.append(
            {k for sp in spans for k in ("fast", "chunked", "opv", "scan") if sp[k]}
        )
    # every job took the route it was built for, and only that one
    assert routes == [{route} for route, _ in routed]

    rack_of = {n.id: n.attributes["platform.rack"] for n in nodes}
    for (route, job), pjob in zip(routed, port_jobs):
        ref_nodes, ref_scores = _alloc_view(ref.store, job)
        port_nodes, port_scores = _alloc_view(port.store, pjob)
        assert port_nodes == ref_nodes, (route, job.id)
        assert sum(port_nodes.values()) == job.task_groups[0].count
        assert [n for n, _ in port_scores] == [n for n, _ in ref_scores]
        np.testing.assert_allclose(
            [s for _, s in port_scores], [s for _, s in ref_scores],
            rtol=RTOL, atol=ATOL,
        )
    # the distinct_property job holds its cap on every rack
    per_rack = collections.Counter()
    for node_id, k in _alloc_view(port.store, port_jobs[3])[0].items():
        per_rack[rack_of[node_id]] += k
    assert max(per_rack.values()) <= DISTINCT_CAP

    def statuses(h):
        return [(e.id, e.status, e.status_description) for e in h.evals]

    assert statuses(port) == statuses(ref)
    assert {s for _, s, _ in statuses(port)} == {"complete"}
    assert _failures(port) == _failures(ref)

