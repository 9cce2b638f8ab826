"""The port's gang auction (cp-gang) against the JAX reference, on the CPU.

Three layers, each with the same inputs on both sides:

- the device program: seeded numpy inputs through the reference's raw
  jitted program (``cp_gang_place_kernel.jitted``), its NumPy oracle
  (``oracle_cp_gang_place``) and the port's ``cp_gang_place`` on CPU
  tensors (the plain PyTorch version): colocate and spread weights on
  the rack/pod/ici levels, fractional weights, gang-less rows,
  coordinate-less nodes, a gang that cannot complete and is released,
  and a tie-heavy case; then the host release pass on those outputs;
- ``CpGangPlacementKernel.place`` with explanations, and ``run_gang_ab``;
- whole evaluations through both ``Harness``es under ``cp-gang``: gangs
  placed whole, a gang released whole into one blocked eval, a gang-less
  job; and a gang on a rack/pod/ici cluster.

Tolerance: the program's outputs (choices, choice_scores, used, rounds,
lam, waits) and the release pass bit for bit (uint32 views); placements,
gang provenance and the A/B report exactly. Where the score rows come
from the score matrix (the kernel object, the Harness), its ``exp``
differs between the runtimes by a few ulp (see test_torch_score.py):
slot and alloc scores and the solver's gap agree within ``rtol=1e-5,
atol=1e-6`` (the gap, a sum over slots, within 1e-4).

One fault of the reference is repaired in the port and pinned here: the
reference's device-state cache drops the topology columns on its
incremental refresh (ROADMAP C-R3), so after the first commit every node
reads as coordinate-less. Whole-eval comparisons with topology therefore
run one gang eval on a fresh store; the port's own test holds gangs
together across refreshes.
"""

import dataclasses

import numpy as np
import pytest
import torch

from nomad_tpu import mock as ref_mock
from nomad_tpu.device import cp as ref_cp
from nomad_tpu.scheduler import cp as ref_scp
from nomad_tpu.structs import Resources, Task, TaskGroup
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch import interop
from nomad_tpu_torch.device import cp as port_cp
from nomad_tpu_torch.scheduler import Harness as PortHarness
from nomad_tpu_torch.scheduler import cp as port_scp
from nomad_tpu_torch.state import SchedulerConfiguration as PortConfig
from nomad_tpu_torch.structs import Resources as PortResources
from nomad_tpu_torch.structs import Task as PortTask
from nomad_tpu_torch.structs import TaskGroup as PortTaskGroup
from test_torch_cp import count_auction_launches
from test_torch_hetero import (
    ATOL,
    RTOL,
    assert_bits_equal,
    assert_same_provenance,
    assert_same_plans,
    plans,
    reference_runtime,
    run_both,
)


def _gang_args(seed, ties=False, n_nodes=64):
    """The 18 inputs of the gang program on a seeded rack/pod/ici fleet:
    four gang jobs of three groups (even jobs colocate at rack and ici,
    odd jobs spread over pods), scores on a 1/16 grid; then fractional
    weights, two gang-less rows, coordinate-less nodes and one member
    that is eligible nowhere (its gang cannot complete)."""
    rng = np.random.default_rng(seed)
    ct = ref_scp.build_topo_fleet(n_nodes, seed=seed)
    asks = ref_scp.build_gang_asks(ct, 4, 3, seed=seed + 1)
    gi = ref_scp.build_gang_inputs(ct, asks)
    g, n = len(asks), ct.padded_n
    gang = gi.gang.copy()
    gang[[4, 9]] = 0  # gang-less rows in the batch
    w_rack, w_pod, w_ici = gi.w_rack.copy(), gi.w_pod.copy(), gi.w_ici.copy()
    w_rack[1], w_pod[2], w_ici[6] = 0.3, -0.7, 0.1015625
    rack_oh, pod_oh, ici_oh = gi.rack_oh.copy(), gi.pod_oh.copy(), gi.ici_oh.copy()
    rack_oh[5:9] = 0  # nodes without a rack coordinate
    eligible = np.stack([a.eligible for a in asks])
    eligible[11] = False  # gang 4's last member fits nowhere
    scores = (np.round(rng.random((g, n)) * 16) / 16).astype(np.float32)
    prio = rng.choice([50.0, 80.0], g).astype(np.float32)
    used = ct.used.copy()
    if ties:
        scores[:] = 0.0
        prio[:] = 50.0
        used[used == 0] = -0.0
    return [
        ct.capacity, used, np.stack([a.ask for a in asks]).astype(np.float32),
        np.full(g, 2, np.int32), eligible, scores, prio,
        np.zeros((g, n), np.int32), np.zeros(g, bool),
        (np.arange(g) // 3).astype(np.int32), gang, w_rack, w_pod, w_ici,
        rack_oh, pod_oh, ici_oh, np.zeros(n, np.float32),
    ]


@pytest.mark.parametrize("case", ["seed3", "seed4", "ties", "steps_cut"])
def test_cp_gang_place_matches_reference_bit_for_bit(case):
    args = _gang_args(4 if case == "seed4" else 3, ties=case == "ties")
    steps = 3 if case == "steps_cut" else 64
    ref = ref_cp.cp_gang_place_kernel.jitted(*args, steps=steps, max_c=2)
    oracle = ref_cp.oracle_cp_gang_place(*args, steps, 2)
    port = port_cp.cp_gang_place(
        *[torch.from_numpy(np.ascontiguousarray(a)) for a in args], steps, 2
    )
    assert_bits_equal(ref, oracle, "reference vs its oracle")
    assert_bits_equal(port, oracle, case)
    if case != "steps_cut":
        assert int(np.asarray(port[5]).sum()) > 0  # some member lost a round
    # the host release pass: gang 4 (one member eligible nowhere) goes
    asks, counts, gang = args[2], args[3], args[10]
    want = ref_cp.release_incomplete_gangs(*oracle[:3], asks, counts, gang)
    got = port_cp.release_incomplete_gangs(
        *[np.asarray(x) for x in port[:3]], asks, counts, gang
    )
    assert_bits_equal(got[:3], want[:3], "release")
    assert got[3] == want[3]
    if case != "steps_cut":
        assert 4 in got[3]
        assert (got[0][gang == 4] == -1).all()


def _ids_of(onehots):
    """(i32[3, N] per-node ids, widths) of three one-hots."""
    ids = np.stack([np.where(oh.any(axis=1), oh.argmax(axis=1), 0) for oh in onehots])
    return ids.astype(np.int32), tuple(oh.shape[1] for oh in onehots)


def _id_form(args):
    """The gang program's inputs with the one-hots as per-node ids: the
    18 inputs become ``cp_gang_place_ids``' 19."""
    ids, widths = _ids_of(args[14:17])
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    return [*t[:14], torch.from_numpy(ids), widths, t[17]]


@pytest.mark.parametrize("case", ["seed3", "ties", "steps_cut"])
def test_cp_gang_place_ids_matches_reference_bit_for_bit(case):
    """The id form (the kernel object's path) equals the reference's
    oracle on the one-hot inputs, every output."""
    args = _gang_args(3, ties=case == "ties")
    steps = 3 if case == "steps_cut" else 64
    oracle = ref_cp.oracle_cp_gang_place(*args, steps, 2)
    assert_bits_equal(port_cp.cp_gang_place_ids(*_id_form(args), steps, 2), oracle, case)


def test_gang_inputs_match_reference():
    """The port's GangInputs keep ids and widths; its one-hot tensors
    equal the reference's arrays, and the ids its one-hots."""
    ct = ref_scp.build_topo_fleet(64, seed=8)
    asks = ref_scp.build_gang_asks(ct, 3, 3, seed=9)
    want = ref_scp.build_gang_inputs(ct, asks)
    got = port_scp.build_gang_inputs(
        interop.cluster_from_numpy(dataclasses.asdict(ct)),
        interop.asks_from_numpy([dataclasses.asdict(a) for a in asks]),
    )
    ref_arrays = (want.gang, want.w_rack, want.w_pod, want.w_ici,
                  want.rack_oh, want.pod_oh, want.ici_oh)
    assert_bits_equal(got.tensors("cpu"), ref_arrays, "one-hot form")
    ids, widths = _ids_of(ref_arrays[4:])
    np.testing.assert_array_equal(got.level_ids, ids)
    assert got.widths == widths
    assert got.members == want.members and got.job_of == want.job_of


def test_level_ids_outside_their_width_raise():
    args = _id_form(_gang_args(3))
    args[14][1, 7] = args[15][1]
    with pytest.raises(ValueError, match="outside"):
        port_cp.cp_gang_place_ids(*args, 64, 2)


def test_gang_launcher_counts_only_launches(monkeypatch):
    """``cp_gang_place``'s count moves by one for each launch that
    succeeds, and by nothing for an empty group axis, zero steps or a
    refused launch; the launch takes the id form."""
    args = _id_form(_gang_args(3))
    common = [*args[:10], args[16]]
    count_auction_launches(monkeypatch, common, args[10:16], max_c=2)


def test_topology_mates_equal_the_reference_products():
    """The per-(gang, coordinate) count table equals the reference's
    three integer products, gang-less rows and coordinate-less nodes
    included."""
    args = _gang_args(5)
    rng = np.random.default_rng(5)
    assigned = rng.integers(0, 3, args[5].shape).astype(np.int32)
    gang = args[10]
    same = ref_cp._cp_gang_same(gang)
    for oh in args[14:17]:
        want = ref_cp._cp_topo_mates(same, assigned, oh)
        got = port_cp._cp_topo_mates(
            torch.from_numpy(gang), torch.from_numpy(assigned), torch.from_numpy(oh)
        )
        np.testing.assert_array_equal(got.numpy(), want)


def test_onehot_ids_reject_a_coordinate_zero_column():
    oh = np.zeros((4, 4), np.int32)
    oh[1, 0] = 1
    with pytest.raises(ValueError, match="one-hot"):
        port_cp._onehot_ids(torch.from_numpy(oh))


# -- the kernel object and the A/B harness --------------------------------------


def test_kernel_place_matches_reference(monkeypatch):
    ct = ref_scp.build_topo_fleet(64, seed=6)
    asks = ref_scp.build_gang_asks(ct, 4, 3, seed=7)
    asks[5].eligible = np.zeros_like(asks[5].eligible)  # gang 2 releases
    with reference_runtime(monkeypatch):
        ref = ref_scp.CpGangPlacementKernel().place(ct, asks, explain=True)
    port = port_scp.CpGangPlacementKernel(device="cpu").place(
        interop.cluster_from_numpy(dataclasses.asdict(ct)),
        interop.asks_from_numpy([dataclasses.asdict(a) for a in asks]),
        explain=True,
    )
    for r, p in zip(ref, port):
        np.testing.assert_array_equal(p.node_rows, r.node_rows)
        # the slot scores are the score matrix's (its exp differs by ulps)
        np.testing.assert_allclose(p.scores, r.scores, rtol=RTOL, atol=ATOL)
        assert p.explanation.algorithm == r.explanation.algorithm == "cp-gang"
        assert p.explanation.gang == r.explanation.gang
        assert_same_provenance(p.explanation.cp, r.explanation.cp)
    assert all((p.node_rows == -1).all() for p in port[3:6])


def test_run_gang_ab_matches_reference(monkeypatch):
    with reference_runtime(monkeypatch):
        ref = ref_scp.run_gang_ab()
    port = port_scp.run_gang_ab(device="cpu")
    assert port == ref
    assert port["ok"] and port["oracle_mismatches"] == 0


# -- whole evaluations -----------------------------------------------------------


def _gang_job(name, asks, stanza=None):
    """A gang job of one group per (count, cpu MHz) ask."""
    job = ref_mock.job(id=name, name=name)
    job.task_groups = [
        TaskGroup(name=f"g{k}", count=count, tasks=[
            Task(name=f"g{k}", driver="exec", resources=Resources(cpu=cpu, memory_mb=256))
        ])
        for k, (count, cpu) in enumerate(asks)
    ]
    job.gang = {"groups": [tg.name for tg in job.task_groups], **(stanza or {})}
    return job


def test_harness_cp_gang_matches_reference(monkeypatch):
    """On 12 mock nodes: two gangs placed whole, one gang whose second
    member fits nowhere (released whole into one blocked eval with
    gang-infeasible rejections) and a gang-less job — the same plans and
    evals on both sides."""
    nodes = [ref_mock.node() for _ in range(12)]
    plain = ref_mock.job(id="plain", name="plain")
    plain.task_groups[0].count = 5
    jobs = [
        _gang_job("gang-a", [(2, 500), (3, 700)]),
        _gang_job("gang-bad", [(2, 500), (2, 100_000)]),
        _gang_job("gang-b", [(2, 900), (2, 900), (1, 300)]),
        plain,
    ]
    ref, port = run_both(monkeypatch, nodes, jobs, "cp-gang")
    assert_same_plans(ref, port, jobs)
    placed, _, created = plans(port, jobs)
    assert sum(placed["gang-a"].values()) == 5 and sum(placed["gang-b"].values()) == 5
    assert not placed["gang-bad"]
    assert [c[1] for c in created if c[0] == "gang-bad"] == ["blocked"]
    blocked = [e for e in port.created_evals if e.job_id == "gang-bad"]
    assert set(blocked[-1].failed_tg_allocs) == {"g0", "g1"}
    for metric in blocked[-1].failed_tg_allocs.values():
        assert metric.rejections.get("gang-infeasible", 0) >= 1


def _topo_nodes(mock, n=48, rack=8):
    nodes = []
    for i in range(n):
        node = mock.node(topology={
            "rack": f"r{i // rack}", "pod": f"p{i // (3 * rack)}", "ici": f"i{i // (rack // 2)}",
        })
        nodes.append(node)
    return nodes


def test_harness_topology_gang_matches_reference(monkeypatch):
    """A rack-colocated gang on a rack/pod/ici cluster, one eval on a fresh
    store: the same plan, every member in one rack."""
    nodes = _topo_nodes(ref_mock)
    job = _gang_job("gang-topo", [(3, 1500), (3, 1500)],
                    {"colocate": {"level": "rack", "weight": 2.0}})
    ref, port = run_both(monkeypatch, nodes, [job], "cp-gang")
    assert_same_plans(ref, port, [job])
    placed, _, _ = plans(port, [job])
    racks = {port.store.node_by_id(node).topology["rack"] for (_, node) in placed[job.id]}
    assert len(racks) == 1


def test_topology_survives_the_cache_refresh():
    """Gang evals after the first commit still see every node's rack:
    each colocated gang lands in one rack, each pod-spread gang over
    several pods (the reference's cache refresh loses the columns,
    ROADMAP C-R3)."""
    h = PortHarness(device="cpu")
    h.store.set_scheduler_config(h.next_index(), PortConfig(scheduler_algorithm="cp-gang"))
    for node in _topo_nodes(port_mock, n=96):
        h.store.upsert_node(h.next_index(), node)
    jobs = []
    for j in range(4):
        stanza = ({"colocate": {"level": "rack", "weight": 2.0}} if j % 2 == 0
                  else {"spread": {"level": "pod", "weight": 1.0}})
        job = port_mock.job(id=f"gang-{j}", name=f"gang-{j}")
        job.task_groups = [
            PortTaskGroup(name=f"g{k}", count=3, tasks=[
                PortTask(name=f"g{k}", driver="exec",
                         resources=PortResources(cpu=1500, memory_mb=256))
            ])
            for k in range(2)
        ]
        job.gang = {"groups": ["g0", "g1"], **stanza}
        h.store.upsert_job(h.next_index(), job)
        ev = port_mock.eval_for(job)
        h.store.upsert_evals(h.next_index(), [ev])
        h.process(ev)
        jobs.append(job)
    assert h.device_cache.incremental_refreshes > 0
    for j, job in enumerate(jobs):
        nodes = [h.store.node_by_id(a.node_id) for a in h.store.allocs_by_job(job.namespace, job.id)]
        assert len(nodes) == 6
        if j % 2 == 0:
            assert len({n.topology["rack"] for n in nodes}) == 1, job.id
        else:
            assert len({n.topology["pod"] for n in nodes}) > 1, job.id
