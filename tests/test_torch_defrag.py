"""The port's defrag controller (``nomad_tpu_torch.server.defrag``) against
the JAX package's, on the CPU.

Both servers get the reference's fragmentation recipe (``_fragment`` of
``tests/test_defrag.py``) at 48 nodes: a filler job pins one 3,000 MHz
alloc per node, a thin job lands one 800 MHz alloc beside each, the
filler leaves, and a fake client brings every alloc up. Then defrag
cycles run by hand on both, cycle by cycle: the same moves, the same
``(job, name, node)`` after each cycle, the same packing efficiency.
The port's controller plans with ``migrate_plan`` on the server's device
(the plain version on the CPU); every call it makes is held against the
reference's NumPy ``oracle_migrate_plan`` on the same arrays, all six
outputs bit for bit. Also, under a fault plane installed in each
package (``migrate.kill_mid_move`` and ``migrate.move_drop`` scheduled): a
half-move (phase B lost) finished by ``recover()`` with invariant law 16
violated before and held after by both packages' checkers, a mid-move
source never replanned; and the candidates filter,
and an exception in the controller's loop counted as swallowed. A
``cuda``-marked test runs one cycle on the card and skips here.

Tolerance: none. Moves, placements, counters and efficiency exactly;
the planner's outputs as uint32 views of the f32 ones and equality of the
i32 ones.
"""

import contextlib
import copy

import numpy as np
import pytest
import torch

from nomad_tpu import mock as ref_mock
from nomad_tpu.chaos import plane as ref_plane
from nomad_tpu.chaos.invariants import check_cluster as ref_check_cluster
from nomad_tpu.device.migrate import oracle_migrate_plan
from nomad_tpu.server import defrag as ref_defrag
from nomad_tpu.structs import Resources
from nomad_tpu_torch.chaos import plane as port_plane
from nomad_tpu_torch.chaos.invariants import check_cluster as port_check_cluster
from nomad_tpu_torch.device import migrate as port_mig
from nomad_tpu_torch.server import defrag as port_defrag
from nomad_tpu_torch.structs.alloc import DesiredTransition
from nomad_tpu_torch.structs.resources import node_comparable_capacity
from nomad_tpu_torch.utils.metrics import global_metrics as port_metrics
from test_torch_hetero import assert_bits_equal
from test_torch_leader import counters_now, leaders, live
from test_torch_server import placements

N_NODES = 48
BUDGET = 8
CYCLES = 5
MIGRATE_COUNTERS = ("nomad.migrate.planned", "nomad.migrate.completed",
                    "nomad.migrate.aborted", "nomad.migrate.interrupted",
                    "nomad.migrate.recovered", "nomad.migrate.capacity_violations",
                    "nomad.migrate.budget_exhausted")


def _thin_job(job_id, count):
    j = ref_mock.job(id=job_id, name=job_id)
    j.task_groups[0].count = count
    j.task_groups[0].tasks[0].resources = Resources(cpu=800, memory_mb=512)
    return j


def _filler_job(count):
    j = ref_mock.job(id="filler", name="filler")
    j.task_groups[0].count = count
    # 3000 MHz: exactly one per node, so the fleet fragments
    # deterministically when the filler deregisters
    j.task_groups[0].tasks[0].resources = Resources(cpu=3000, memory_mb=1024)
    return j


def _fragment(p, n_nodes=N_NODES):
    p.job(_filler_job(n_nodes))
    p.settle()
    p.job(_thin_job("thin", n_nodes))
    p.settle()
    p.call("deregister_job", "default", "filler")
    p.settle()
    placed = p.same_placements("thin")
    assert len({n for _j, _a, n in placed}) == n_nodes


class PlanLog:
    """Stands in for the port's ``migrate_plan`` and keeps each call's
    host copies and outputs."""

    def __init__(self, real):
        self.real = real
        self.calls = []
        self.launches = 0

    def __call__(self, *args):
        out = self.real(*args)
        self.calls.append((
            [a.cpu().numpy().copy() if isinstance(a, torch.Tensor) else a for a in args],
            [o.cpu().numpy().copy() for o in out],
        ))
        return out


def _efficiency(p):
    return p.each(lambda s: s.defrag.last_efficiency)


@pytest.fixture
def plan_log(monkeypatch):
    log = PlanLog(port_mig.migrate_plan)
    monkeypatch.setattr(port_mig, "migrate_plan", log)
    return log


def test_cycles_match_reference_and_plan_with_migrate_plan(monkeypatch, plan_log):
    with leaders(monkeypatch, nodes=N_NODES, defrag_budget=BUDGET) as p:
        _fragment(p)
        before = counters_now(MIGRATE_COUNTERS)
        trail = []
        for _ in range(CYCLES):
            moved = [s.defrag.run_cycle() for s in p.servers]
            assert moved[0] == moved[1] <= BUDGET
            p.settle()
            placed = p.same_placements("thin")
            eff = _efficiency(p)
            assert eff[0] == eff[1]
            trail.append((moved[1], eff[1], len({n for _j, _a, n in placed})))
        assert sum(m for m, _e, _n in trail) > 0
        assert trail[-1][2] < N_NODES  # the thin job sits on fewer nodes
        assert [e for _m, e, _n in trail] == sorted(e for _m, e, _n in trail)
        assert len(live(p.port, "thin")) == N_NODES
        assert p.each(lambda s: s.defrag.cycles) == [CYCLES] * 2 or trail[-1][0] == 0
        want, got = p.counter_deltas(MIGRATE_COUNTERS, before)
        assert got == want and got["nomad.migrate.capacity_violations"] == 0
        assert got["nomad.migrate.completed"] == sum(m for m, _e, _n in trail)
    # every pass the controller planned, against the reference's oracle
    assert len(plan_log.calls) >= CYCLES
    for args, out in plan_log.calls:
        capacity = args[0]
        assert capacity.shape[1] == port_mig._D
        want = oracle_migrate_plan(*args[:8], np.int32(args[8]), args[9], args[10])
        assert_bits_equal(out, want, "the controller's migrate_plan call")


def test_capacity_vectors_have_the_kernels_width():
    from nomad_tpu_torch import mock

    vec = node_comparable_capacity(mock.node()).to_vector()
    assert vec.shape == (port_mig._D,) and vec.dtype == np.float32


def _half_moves(server):
    out = []
    for a in server.store.allocs():
        if a.terminal_status() or a.desired_description != port_defrag.DEFRAG_DESC:
            continue
        old = server.store.alloc_by_id(a.previous_allocation) if a.previous_allocation else None
        if old is not None and not old.terminal_status():
            out.append((a, old))
    return out


@contextlib.contextmanager
def _lose_first_phase_b():
    """On both servers, one fault plane installed in each package: the
    first move loses its phase B between the phases (the
    ``migrate.kill_mid_move`` site's "drop"), and the second move is
    dropped before anything commits (``migrate.move_drop``)."""
    planes = []
    for mod in (ref_plane, port_plane):
        planes.append(mod.install(mod.FaultPlane(schedule=[
            mod.FaultSpec("migrate.kill_mid_move", 0, "drop"),
            mod.FaultSpec("migrate.move_drop", 1, "drop"),
        ])))
    try:
        yield planes
    finally:
        for mod in (ref_plane, port_plane):
            mod.uninstall()
    for plane in planes:
        assert plane.triggered == [("migrate.kill_mid_move", 0, "drop"),
                                   ("migrate.move_drop", 1, "drop")]


def _law_16(p):
    """Invariant law 16 (``migration_conservation``) on both servers, by
    each package's own checker."""
    return [
        check(s).to_dict()["invariants"]["migration_conservation"]
        for check, s in zip((ref_check_cluster, port_check_cluster), p.servers)
    ]


def test_recover_finishes_a_half_move(monkeypatch):
    with leaders(monkeypatch, nodes=N_NODES, defrag_budget=BUDGET) as p:
        _fragment(p)
        before = counters_now(("nomad.migrate.interrupted", "nomad.migrate.recovered"))
        with _lose_first_phase_b():
            moved = [s.defrag.run_cycle() for s in p.servers]
        assert moved[0] == moved[1]
        assert _law_16(p) == ["violated", "violated"]  # the half-move is live
        pairs = p.each(_half_moves)
        assert [len(x) for x in pairs] == [1, 1]
        assert [(r.name, r.node_id, o.name, o.node_id) for r, o in pairs[0]] == [
            (r.name, r.node_id, o.name, o.node_id) for r, o in pairs[1]]
        for s in p.servers:
            s.defrag.recover()
        assert p.each(_half_moves) == [[], []]
        for s, ((_r, old),) in zip(p.servers, pairs):
            cur = s.store.alloc_by_id(old.id)
            assert cur.desired_status == "stop"
            assert cur.desired_description == port_defrag.DEFRAG_STOP_DESC
        deltas = p.counter_deltas(("nomad.migrate.interrupted", "nomad.migrate.recovered"),
                                  before)
        assert deltas[0] == deltas[1] == {
            "nomad.migrate.interrupted": 1, "nomad.migrate.recovered": 1}
        p.settle()
        p.same_placements("thin")
        assert _law_16(p) == ["ok", "ok"]


def test_mid_move_source_never_replanned(monkeypatch):
    with leaders(monkeypatch, nodes=N_NODES, defrag_budget=BUDGET) as p:
        _fragment(p)
        with _lose_first_phase_b():
            for s in p.servers:
                s.defrag.run_cycle()
        p.settle()  # the replacement comes up: both halves look healthy
        for s in p.servers:
            ((replacement, old),) = _half_moves(s)
            assert s.store.alloc_by_id(replacement.id).client_status == "running"
            snap = s.store.snapshot()
            node_row = {n.id: i for i, n in enumerate(snap.nodes())}
            ids = {a.id for a, _ in s.defrag._candidates(snap, node_row)}
            assert old.id not in ids and replacement.id not in ids
        # the next cycle recovers first, then converges: no slot ever
        # holds two live replacements
        moved = [s.defrag.run_cycle() for s in p.servers]
        assert moved[0] == moved[1]
        p.settle()
        assert p.each(_half_moves) == [[], []]
        p.same_placements("thin")
        for s in p.servers:
            prevs = [a.previous_allocation for a in live(s, "thin")
                     if a.desired_description == port_defrag.DEFRAG_DESC]
            assert len(prevs) == len(set(prevs))


def test_candidates_filter(monkeypatch):
    from nomad_tpu.structs.alloc import DesiredTransition as RefDT

    with leaders(monkeypatch, nodes=2) as p:
        p.job(ref_mock.system_job(id="sys", name="sys"))
        gang = _thin_job("gangjob", 2)
        gang.gang = {"groups": [gang.task_groups[0].name]}
        p.job(gang)
        p.job(_thin_job("plain", 2))
        p.settle()
        name = live(p.port, "plain")[0].name
        for s, dt in zip(p.servers, (RefDT, DesiredTransition)):
            (victim,) = [a for a in live(s, "plain") if a.name == name]
            marked = victim.copy_for_update()
            marked.desired_transition = dt(migrate=True)
            s.store.upsert_allocs(s.store.latest_index + 1, [marked])
        got = []
        for s in p.servers:
            snap = s.store.snapshot()
            node_row = {n.id: i for i, n in enumerate(snap.nodes())}
            got.append([(a.namespace, a.job_id, a.name, a.node_id)
                        for a, _job in s.defrag._candidates(snap, node_row)])
        assert got[0] == got[1]
        assert got[1] == sorted(got[1])
        assert {j for _ns, j, _n, _node in got[1]} == {"plain"}
        assert [n for _ns, _j, n, _node in got[1]] != [name]
        assert len(got[1]) == 1


def test_a_failing_cycle_is_counted_as_swallowed(monkeypatch):
    """The loop logs an exception from a cycle and carries on, as the
    reference's does, and counts it (``defrag.swallowed_errors``), so a
    kernel that fails to build or launch shows in the swallowed count."""
    import threading

    from nomad_tpu_torch.server import Server, ServerConfig

    s = Server(ServerConfig(num_workers=0, device="cpu"))
    s.establish_leadership()
    try:
        failed = threading.Event()

        def boom():
            failed.set()
            raise RuntimeError("migrate_plan: launch refused")

        monkeypatch.setattr(s.defrag, "_cycle_inner", boom)
        before = int(port_metrics.snapshot()["counters"].get("defrag.swallowed_errors", 0))
        s.defrag.trigger()
        assert failed.wait(30)
        s.defrag.stop()  # joins the thread: the handler has run
        after = int(port_metrics.snapshot()["counters"].get("defrag.swallowed_errors", 0))
        assert after == before + 1
        assert s.defrag.drained()
    finally:
        s.shutdown()


@pytest.mark.cuda
def test_cuda_server_cycle_launches_the_kernel():
    """On the card: a CUDA server's controller plans one cycle with the
    migration kernel (one launch), and its moves equal a CPU server's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.server import Server, ServerConfig

    results = []
    for device in ("cpu", "cuda"):
        s = Server(ServerConfig(num_workers=1, device=device, defrag_budget=BUDGET))
        s.establish_leadership()
        try:
            for i in range(16):
                s.register_node(mock.node(id=f"n{i:02d}", name=f"n{i:02d}"))
            for jid, cpu, count in (("filler", 3000, 16), ("thin", 800, 16)):
                j = mock.job(id=jid, name=jid)
                j.task_groups[0].count = count
                j.task_groups[0].tasks[0].resources = Resources(cpu=cpu, memory_mb=512)
                s.register_job(j)
                assert s.wait_for_evals(60)
            s.deregister_job("default", "filler")
            assert s.wait_for_evals(60)
            ups = []
            for a in s.store.allocs():
                if a.desired_status == "run" and a.client_status == "pending":
                    u = copy.copy(a)
                    u.client_status = "running"
                    ups.append(u)
            s.update_allocs_from_client(ups)
            launches = port_mig.migrate_plan.launches
            moved = s.defrag.run_cycle()
            results.append((moved, placements(s, "thin"),
                            port_mig.migrate_plan.launches - launches))
        finally:
            s.shutdown()
    (cpu_moved, cpu_placed, _), (cuda_moved, cuda_placed, cuda_launches) = results
    assert cuda_launches == 1 and cuda_moved == cpu_moved > 0
    assert sorted((j, n) for j, _a, n in cuda_placed) == sorted((j, n) for j, _a, n in cpu_placed)
