"""The port's batched multi-eval methods and dry-run plan against the JAX
reference, on the CPU.

- Several service evals merged into ONE closed-form pass by
  ``Harness.process_merged`` (prepare each eval against one shared
  ClusterTensors, one ``kernel.place`` over the concatenated asks,
  ``repair_batch_conflicts`` with ``lane_groups``, ``build_batch_plan``
  on each eval's slice, submit, ``complete_merged_attempt``), against a
  mirror of that helper over the reference's ``GenericScheduler`` on the
  same snapshot: plans, eval statuses, failed groups, created evals and
  the ``complete_*`` return values are equal.
- An eval whose plan evicts (a destructive update) returns None from
  ``prepare_batch_attempt`` and takes the individual path, on both sides.
- ``plan_job`` (``scheduler/annotate.py``): annotations, failed groups
  and the inline explanations equal the reference's ``plan_job`` on the
  same store.

Tolerance: plans, statuses and counts exactly; the explanations' scores
within ``rtol=1e-5, atol=1e-6`` (``exp`` differs by an ulp between the
runtimes, see test_torch_score.py), everything else in them exactly.

The reference's ``traced_jit`` needs the scoped ``trace_state_clean``
monkeypatch of ``tests/test_torch_e2e.py`` (ROADMAP C-R1).
"""

import collections
import copy
import dataclasses

import numpy as np
import pytest

from nomad_tpu import mock as ref_mock
from nomad_tpu.device.score import repair_batch_conflicts as ref_repair
from nomad_tpu.scheduler import Harness as RefHarness
from nomad_tpu.scheduler import new_scheduler as ref_new_scheduler
from nomad_tpu.scheduler.annotate import plan_job as ref_plan_job
from nomad_tpu.state import StateStore as RefStore
from nomad_tpu_torch import interop
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch.scheduler import Harness as PortHarness
from nomad_tpu_torch.scheduler.annotate import plan_job
from test_torch_hetero import reference_runtime

RTOL, ATOL = 1e-5, 1e-6


def ref_process_merged(h, evaluations, overflow=32):
    """The reference side of ``Harness.process_merged``: the same steps
    over the reference's GenericScheduler and repair (the reference's
    server worker does them with lanes and an overlay on top)."""
    snapshot = h.store.snapshot()
    ct = h.device_cache.tensors(snapshot)
    prepared, all_asks, lane_groups, singles = [], [], [], []
    for ev in evaluations:
        if ev.type not in ("service", "batch"):
            singles.append(ev)
            continue
        sched = ref_new_scheduler(ev.type, snapshot, h, cache=h.device_cache)
        asks = sched.prepare_batch_attempt(ev, ct=ct)
        if asks is None:
            singles.append(ev)
            continue
        assert sched._batch_ctx[0] is ct
        lane_groups.extend([len(prepared)] * len(asks))
        prepared.append((ev, sched, len(asks)))
        all_asks.extend(asks)
    lane_ok, completed, merged = [], {}, []
    if all_asks:
        kernel = prepared[0][1].kernel
        results = kernel.place(ct, all_asks, overflow=overflow)
        lane_ok = ref_repair(
            ct, all_asks, results,
            algorithm_spread=kernel.algorithm_spread,
            lane_groups=lane_groups,
        )
        members, off = [], 0
        for ev, sched, n in prepared:
            span = results[off : off + n]
            span_ok = all(lane_ok[off : off + n])
            off += n
            if not span_ok:
                singles.append(ev)
                continue
            plan = sched.build_batch_plan(span)
            if plan is None:
                merged.append(ev.id)
            else:
                members.append((ev, sched, plan))
        for ev, sched, plan in members:
            result, new_snap = h.submit_plan(plan)
            ok = sched.complete_merged_attempt(result, new_snapshot=new_snap)
            completed[ev.id] = ok
            (merged if ok else singles).append(ev.id if ok else ev)
    for ev in singles:
        h.process(ev)
    return {
        "merged": merged,
        "individual": [ev.id for ev in singles],
        "completed": completed,
        "lanes": len(all_asks),
        "lane_groups": lane_groups,
        "lane_ok": list(lane_ok),
    }


def _stores(nodes, jobs, existing=()):
    records = (
        [dataclasses.asdict(n) for n in nodes],
        [dataclasses.asdict(j) for j in jobs],
        [dataclasses.asdict(a) for a in existing],
    )
    ref = RefStore()
    for n in nodes:
        ref.upsert_node(1, n)
    for j in jobs:
        ref.upsert_job(2, j)
    if existing:
        ref.upsert_allocs(3, list(existing))
    return ref, interop.store_from_records(*records)


def _evals(h, mock, store, jobs, ids):
    evs = []
    for j, eid in zip(jobs, ids):
        ev = mock.eval_for(store.job_by_id(j.namespace, j.id), id=eid)
        store.upsert_evals(h.next_index(), [ev])
        evs.append(ev)
    return evs


def _outcome(h, jobs):
    """Live allocs' (group, node) multiset per job, eval statuses with
    failed groups and queued counts, and the created evals."""
    allocs = {}
    for j in jobs:
        live = [
            a for a in h.store.allocs_by_job(j.namespace, j.id)
            if not a.terminal_status()
        ]
        allocs[j.id] = collections.Counter((a.name, a.node_id) for a in live)
    evals = sorted(
        (e.id, e.status, sorted(e.failed_tg_allocs),
         sorted(e.queued_allocations.items()))
        for e in h.evals
    )
    created = sorted(
        (e.job_id, e.status, e.triggered_by) for e in h.created_evals
    )
    return allocs, evals, created


def _run_both(monkeypatch, nodes, jobs, existing=(), extra=None):
    ref_store, port_store = _stores(nodes, jobs, existing)
    ids = [f"eval-{i}" for i in range(len(jobs))]
    if extra is not None:
        extra(ref_store, port_store)
    ref = RefHarness(ref_store)
    with reference_runtime(monkeypatch):
        ref_out = ref_process_merged(
            ref, _evals(ref, ref_mock, ref_store, jobs, ids)
        )
    port = PortHarness(port_store, device="cpu")
    port_out = port.process_merged(_evals(port, port_mock, port_store, jobs, ids))
    return (ref, ref_out), (port, port_out)


def _jobs(counts, cpu=500, seed_ids="job"):
    out = []
    for i, c in enumerate(counts):
        j = ref_mock.job()
        j.id = f"{seed_ids}-{i}"
        j.task_groups[0].count = c
        j.task_groups[0].tasks[0].resources.cpu = cpu
        out.append(j)
    return out


@pytest.mark.parametrize(
    "n_nodes,counts,cpu",
    [
        (40, (5, 8, 3, 10, 6), 500),  # roomy: every lane places
        (12, (10, 9, 8, 7), 1500),  # tight: lanes collide, repair moves them
        (6, (10, 10, 10), 1500),  # over-full: failed groups, blocked evals
    ],
    ids=["roomy", "tight", "overfull"],
)
def test_merged_pass_equals_reference(n_nodes, counts, cpu, monkeypatch):
    nodes = [ref_mock.node() for _ in range(n_nodes)]
    jobs = _jobs(counts, cpu)
    (ref, ref_out), (port, port_out) = _run_both(monkeypatch, nodes, jobs)
    assert port_out == ref_out
    assert port_out["lanes"] == len(jobs)
    assert _outcome(port, jobs) == _outcome(ref, jobs)


def test_merged_pass_places_like_one_eval_at_a_time_when_roomy(monkeypatch):
    """Where nothing collides, the merged pass commits every eval with
    one kernel call and places every alloc."""
    nodes = [ref_mock.node() for _ in range(40)]
    jobs = _jobs((4, 6, 5))
    (_ref, _), (port, out) = _run_both(monkeypatch, nodes, jobs)
    assert out["merged"] == ["eval-0", "eval-1", "eval-2"]
    assert out["completed"] == {"eval-0": True, "eval-1": True, "eval-2": True}
    assert out["individual"] == []
    assert all(out["lane_ok"])
    allocs, evals, _ = _outcome(port, jobs)
    assert [sum(allocs[j.id].values()) for j in jobs] == [4, 6, 5]
    assert all(status == "complete" for _, status, _, _ in evals)


def test_eviction_takes_the_individual_path(monkeypatch):
    """A destructive update stops the old allocs (``plan.node_update``):
    ``prepare_batch_attempt`` returns None and the eval runs alone, on
    both sides, while its siblings still merge."""
    nodes = [ref_mock.node() for _ in range(20)]
    jobs = _jobs((3, 4))
    old = copy.deepcopy(jobs[0])
    existing = [ref_mock.alloc(old, nodes[i]) for i in range(3)]
    for i, a in enumerate(existing):
        a.name = f"{old.id}.web[{i}]"
    jobs[0].task_groups[0].tasks[0].resources.cpu = 700  # destructive

    def bump(ref_store, port_store):
        ref_store.upsert_job(4, jobs[0])
        port_store.upsert_job(
            4, interop.from_record(type(port_store.job_by_id(jobs[0].namespace,
                                                            jobs[0].id)),
                                   dataclasses.asdict(jobs[0]))
        )

    (ref, ref_out), (port, port_out) = _run_both(
        monkeypatch, nodes, jobs, existing=existing, extra=bump
    )
    assert port_out == ref_out
    assert port_out["individual"] == ["eval-0"]
    assert port_out["merged"] == ["eval-1"]
    assert _outcome(port, jobs) == _outcome(ref, jobs)


def test_prepare_returns_none_without_placements(monkeypatch):
    """An eval with nothing to place (its allocs already run) is not a
    member of the pass."""
    from nomad_tpu_torch.scheduler import GenericScheduler

    nodes = [ref_mock.node() for _ in range(8)]
    jobs = _jobs((2,))
    _, port_store = _stores(nodes, jobs)
    h = PortHarness(port_store, device="cpu")
    ev = _evals(h, port_mock, port_store, jobs, ["e0"])[0]
    h.process(ev)
    ct = h.device_cache.tensors(port_store.snapshot())
    sched = GenericScheduler(port_store.snapshot(), h, cache=h.device_cache,
                             device="cpu")
    assert sched.prepare_batch_attempt(ev, ct=ct) is None


# -- dry-run plan ---------------------------------------------------------------


def _close(got, want, path=""):
    """Equal nested records, floats within RTOL/ATOL."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=path)
    else:
        assert got == want, path


@pytest.mark.parametrize("case", ["fits", "edit", "overfull"])
def test_plan_job_equals_reference(case, monkeypatch):
    nodes = [ref_mock.node() for _ in range(10)]
    existing_job = _jobs((3,), 500, "live")[0]
    ref_store, port_store = _stores(nodes, [existing_job])
    if case == "edit":
        job = copy.deepcopy(existing_job)
        job.task_groups[0].count = 6
    else:
        job = _jobs((4 if case == "fits" else 40,), 1500, "new")[0]
    with reference_runtime(monkeypatch):
        want = ref_plan_job(ref_store, job)
    port_job = interop.from_record(
        type(port_store.job_by_id(existing_job.namespace, existing_job.id)),
        dataclasses.asdict(job),
    )
    got = plan_job(port_store, port_job, device="cpu")
    _close(got, want)
    assert got["diff_type"] == ("edited" if case == "edit" else "added")
    if case == "overfull":
        assert got["failed_tg_allocs"]["web"]["coalesced_failures"] >= 1
    else:
        assert not got["failed_tg_allocs"]
    assert got["placement_explanations"]
    # the dry run committed nothing
    assert port_store.job_by_id(job.namespace, job.id) is None or case == "edit"
    assert len(port_store.allocs_by_job(job.namespace, job.id)) == 0


def test_plan_job_raises_without_cuda(monkeypatch):
    import torch

    from nomad_tpu_torch.state import StateStore

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        plan_job(StateStore(), port_mock.job())
