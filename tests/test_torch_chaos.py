"""The port's chaos plane, invariant laws and chaos runner
(``nomad_tpu_torch.chaos``) against the JAX package's, on the CPU.

- The tables: ``SITES`` (all 23 sites, in order, with their kinds),
  ``FAULT_KINDS``, ``_HORIZON`` and ``INVARIANTS`` equal the reference's,
  and ``build_schedule`` plans the reference's rows for seeds 1–20 under
  every single-kind fault tuple and the full mix.
- The plane: each kind's hit semantics, the thread kill escaping
  ``except Exception``, ``from_env``, the ``NOMAD_TPU_CHAOS``
  auto-install, the skewable clock.
- The invariant checker on the port's server: a lost placement, a double
  commit, a broker imbalance, a leaked overlay marker and a silent
  swallow are caught; an idle cluster is clean.
- The runner on the port's server (``device="cpu"``): seed 5's canonical
  report equal byte for byte to the reference's (run under the scoped
  ``reference_runtime``, ROADMAP C-R1), and the reference's explicit
  scenarios (a kill mid merged plan, a dropped delivery, a duplicate, a
  dropped move, a kill mid move, migration in the default mix) plus a
  ``gang.commit_drop`` run, each ``ok``.
- ``cp.round_perturb``: with the same perturbation scheduled in both
  packages, the port's CP dispatcher places as the reference's does.

Tolerance: exact (rows, verdicts, canonical JSON, node choices); the CP
slot scores come from the score matrix, whose ``exp`` differs between the
runtimes by a few ulp (``rtol=1e-5, atol=1e-6``, as test_torch_cp.py).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from nomad_tpu.chaos import invariants as ref_inv
from nomad_tpu.chaos import plane as ref_plane
from nomad_tpu.chaos import run_chaos as ref_run_chaos
from nomad_tpu.scheduler import cp as ref_scp
from nomad_tpu.scheduler import hetero as ref_hetero
from nomad_tpu.utils.metrics import global_metrics as ref_metrics
from nomad_tpu_torch import interop
from nomad_tpu_torch.chaos import (
    ChaosClock,
    ChaosFault,
    ChaosThreadKill,
    FaultPlane,
    FaultSpec,
    active_plane,
    chaos_site,
    check_cluster,
    install,
    run_chaos,
    uninstall,
)
from nomad_tpu_torch.chaos import invariants as port_inv
from nomad_tpu_torch.chaos import plane as port_plane
from nomad_tpu_torch.chaos.invariants import metrics_baseline
from nomad_tpu_torch.scheduler import cp as port_scp
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.utils.metrics import count_swallowed, global_metrics
from test_torch_hetero import ATOL, RTOL, reference_runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAULT_TUPLES = [(k,) for k in ref_plane.FAULT_KINDS] + [ref_plane.FAULT_KINDS]


@pytest.fixture(autouse=True)
def _no_leaked_plane():
    """A test that dies mid-install must not poison its neighbours."""
    yield
    uninstall()
    ref_plane.uninstall()


def _counter(name: str) -> float:
    return global_metrics.snapshot()["counters"].get(name, 0.0)


# -- the tables and the schedule ------------------------------------------------


def test_tables_equal_the_reference():
    assert list(port_plane.SITES.items()) == list(ref_plane.SITES.items())
    assert len(port_plane.SITES) == 23
    assert port_plane.FAULT_KINDS == ref_plane.FAULT_KINDS
    assert list(port_plane._HORIZON.items()) == list(ref_plane._HORIZON.items())
    assert port_inv.INVARIANTS == ref_inv.INVARIANTS
    assert port_plane.ENV_VAR == ref_plane.ENV_VAR == "NOMAD_TPU_CHAOS"


@pytest.mark.parametrize("faults", FAULT_TUPLES, ids=lambda f: "+".join(f))
def test_schedule_rows_equal_the_reference(faults):
    for seed in range(1, 21):
        for steps, rate in ((40, 0.04), (200, 0.04), (60, 0.10)):
            want = [s.row() for s in ref_plane.build_schedule(seed, steps, faults, rate=rate)]
            got = [s.row() for s in port_plane.build_schedule(seed, steps, faults, rate=rate)]
            assert got == want, (seed, steps, rate)
            plane = FaultPlane(seed=seed, steps=steps, faults=faults, rate=rate)
            assert plane.schedule_rows() == want


def test_schedule_is_pure_function_of_seed():
    a = port_plane.build_schedule(seed=42, steps=100, faults=("raise", "kill"))
    b = port_plane.build_schedule(seed=42, steps=100, faults=("raise", "kill"))
    assert [s.row() for s in a] == [s.row() for s in b]
    c = port_plane.build_schedule(seed=43, steps=100, faults=("raise", "kill"))
    assert [s.row() for s in a] != [s.row() for s in c]
    # a site subset plans each kept site's rows unchanged
    sub = port_plane.build_schedule(seed=42, steps=100, sites=("broker.ack",))
    full = port_plane.build_schedule(seed=42, steps=100)
    assert [s.row() for s in sub] == [s.row() for s in full if s.site == "broker.ack"]


# -- the plane ------------------------------------------------------------------


def test_off_by_default():
    assert active_plane() is None
    assert chaos_site("broker.ack") is None


def test_spec_rejects_out_of_contract_action():
    with pytest.raises(ValueError):
        FaultSpec("plan_apply.commit", 0, "drop")
    with pytest.raises(ValueError):
        FaultSpec("no.such.site", 0, "raise")
    with pytest.raises(ValueError):
        FaultSpec("kernel.execute", 0, "hang")


def test_hit_semantics_per_kind():
    slept = []
    plane = FaultPlane(schedule=[
        FaultSpec("broker.ack", 0, "raise"),
        FaultSpec("broker.ack", 1, "duplicate"),
        FaultSpec("broker.dequeue", 0, "drop"),
        FaultSpec("worker.commit", 0, "kill"),
        FaultSpec("broker.dequeue", 1, "skew", 0.5),
        FaultSpec("plan_apply.verify", 0, "delay", 0.01),
        FaultSpec("kernel.hang", 0, "hang", 0.3),
        FaultSpec("admission.flap", 0, "force"),
        FaultSpec("cp.round_perturb", 0, "perturb"),
    ], sleep=slept.append)
    install(plane)
    with pytest.raises(ChaosFault) as ei:
        chaos_site("broker.ack")
    assert (ei.value.site, ei.value.index) == ("broker.ack", 0)
    assert chaos_site("broker.ack") == "duplicate"
    assert chaos_site("broker.ack") is None  # past the schedule
    assert chaos_site("broker.dequeue") == "drop"
    with pytest.raises(ChaosThreadKill):
        chaos_site("worker.commit")
    before = plane.clock.offset
    assert chaos_site("broker.dequeue") == "skew"
    assert plane.clock.offset == pytest.approx(before + 0.5)
    assert chaos_site("plan_apply.verify") == "delay"
    assert chaos_site("kernel.hang") == "hang"
    assert slept == [0.01, 0.3]
    assert chaos_site("admission.flap") == "force"
    assert chaos_site("cp.round_perturb") == "perturb"
    assert plane.kills == 1
    assert plane.raised == [ei.value]
    assert [t[2] for t in plane.triggered] == [
        "raise", "duplicate", "drop", "kill", "skew", "delay", "hang", "force",
        "perturb",
    ]
    assert plane.site_counts()["broker.ack"] == 3


def test_thread_kill_escapes_except_exception():
    install(FaultPlane(schedule=[FaultSpec("worker.commit", 0, "kill")]))
    with pytest.raises(ChaosThreadKill):
        try:
            chaos_site("worker.commit")
        except Exception:  # the recovery handler a crash ignores
            pytest.fail("except Exception absorbed a thread kill")


def test_from_env_spec_roundtrip():
    spec = "seed=9,steps=50,rate=0.1,faults=raise+delay"
    plane = FaultPlane.from_env(spec)
    assert plane.seed == 9 and plane.steps == 50
    assert plane.schedule_rows() == FaultPlane(
        seed=9, steps=50, rate=0.1, faults=("raise", "delay")
    ).schedule_rows()
    assert plane.schedule_rows() == ref_plane.FaultPlane.from_env(spec).schedule_rows()
    sites = FaultPlane.from_env("on,seed=3,sites=broker.ack+fsm.apply")
    assert {s.site for s in sites.schedule} <= {"broker.ack", "fsm.apply"}
    with pytest.raises(ValueError):
        FaultPlane.from_env("seed=1,bogus=2")


def test_env_var_auto_installs_a_plane():
    spec = "seed=4,steps=80,faults=hang+drop"
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "from nomad_tpu_torch.chaos import plane\n"
        "p = plane.active_plane()\n"
        "print(p is not None and p.schedule_rows() == "
        "plane.FaultPlane.from_env(%r).schedule_rows())\n" % spec
    )
    env = dict(os.environ, NOMAD_TPU_CHAOS=spec)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "True", out.stderr


def test_chaos_clock_skews_both_readings():
    clock = ChaosClock()
    t0, m0 = clock.time(), clock.monotonic()
    clock.skew(10.0)
    assert clock.time() - t0 >= 9.9
    assert clock.monotonic() - m0 >= 9.9
    assert clock.offset == 10.0


def test_swallowed_chaos_fault_is_counted_and_ringed():
    from nomad_tpu_torch.obs.recorder import flight_recorder

    fault = ChaosFault("broker.ack", 3)
    before_faults = _counter("nomad.chaos.swallowed_faults")
    before_ring = flight_recorder.errors_total
    count_swallowed("worker", fault)
    assert fault.accounted is True
    assert _counter("nomad.chaos.swallowed_faults") == before_faults + 1
    assert flight_recorder.errors_total == before_ring + 1


# -- the invariant checker on the port's server ---------------------------------


@pytest.fixture
def server():
    s = Server(ServerConfig(device="cpu"))
    try:
        yield s
    finally:
        s.shutdown()


def _violations(report, law):
    return [v for v in report.violations if v.invariant == law]


def test_clean_idle_cluster_passes(server):
    report = check_cluster(server, baseline=metrics_baseline())
    assert report.ok, report.render()
    assert set(report.to_dict()["invariants"]) == set(port_inv.INVARIANTS)


def test_lost_placement_detected(server):
    plane = FaultPlane(schedule=[])
    plane.committed["ghost-alloc"] = 1  # reported, never stored
    report = check_cluster(server, plane=plane, baseline=metrics_baseline())
    assert any("ghost-alloc" in v.subject for v in _violations(report, "plan_ledger"))


def test_double_commit_detected(server):
    plane = FaultPlane(schedule=[])
    plane.committed["dup-alloc"] = 2
    report = check_cluster(server, plane=plane, baseline=metrics_baseline())
    assert any("2 times" in v.detail for v in _violations(report, "plan_ledger"))


def test_broker_imbalance_detected(server):
    server.eval_broker.counters["dequeues"] += 1  # unresolved
    report = check_cluster(server, baseline=metrics_baseline())
    assert _violations(report, "broker_conservation")
    assert report.to_dict()["invariants"]["broker_conservation"] == "violated"


def test_leaked_overlay_marker_detected(server):
    server.placement_overlay.commit_started()
    report = check_cluster(server, baseline=metrics_baseline())
    assert _violations(report, "overlay_drained")


def test_swallow_ring_invariant_catches_silent_swallow(server):
    baseline = metrics_baseline()
    # a swallow counter bump with no ring event = hidden swallow
    global_metrics.incr("worker.swallowed_errors")
    report = check_cluster(server, baseline=baseline)
    assert not report.ok and _violations(report, "swallow_ring")


# -- the runner on the port's server --------------------------------------------


def _small_run(seed, steps=40, **kw):
    kw.setdefault("quiesce_timeout", 60.0)
    return run_chaos(seed=seed, steps=steps, device="cpu", **kw)


@pytest.fixture(scope="module")
def seed5():
    return _small_run(5)


def test_canonical_report_equals_the_reference(seed5, monkeypatch):
    with reference_runtime(monkeypatch):
        ref = ref_run_chaos(seed=5, steps=40, quiesce_timeout=60.0)
    assert ref.ok, ref.render()
    assert seed5.ok, seed5.render()
    assert seed5.canonical_json() == ref.canonical_json()


def test_default_mix_lands_on_the_kernel_guard(seed5):
    """The seeded default mix at seed 5 fires both kernel-guard sites;
    every eval a refused or timed-out call nacked is accounted for, and
    no call finished on a fallback."""
    fired = {(site, action) for site, _n, action in seed5.triggered}
    assert ("kernel.execute", "raise") in fired and ("kernel.hang", "hang") in fired
    counters = seed5.report.info["counters"]
    assert counters.get("nomad.resilience.fallback_calls", 0) == 0
    refusals = seed5.report.info["kernel_refusals"]
    assert refusals["evals"] >= 1
    assert refusals["ended_placed"] + refusals["parked_failed"] == refusals["evals"]


def test_migration_exercised_in_default_mix():
    # no explicit schedule: the seeded default mix must still drive real
    # moves, and the law judges them at every quiesce point
    run = _small_run(11, steps=60)
    assert run.ok, run.render()
    assert run.report.info["counters"].get("nomad.migrate.planned", 0) >= 1
    assert run.report.checked["migration_conservation"]


def test_worker_thread_kill_mid_merged_plan():
    schedule = [
        FaultSpec("plan_queue.enqueue_merged", 0, "kill"),
        FaultSpec("worker.commit", 1, "kill"),
    ]
    run = _small_run(11, steps=60, schedule=schedule)
    assert run.ok, run.render()
    kills = [t for t in run.triggered if t[2] == "kill"]
    assert kills, "no kill fired: scenario did not exercise the seam"
    assert run.report.info["counters"].get("nomad.chaos.thread_kills", 0) >= len(kills) - 1


def test_dropped_delivery_redelivered_exactly_once():
    run = _small_run(13, steps=30, schedule=[FaultSpec("broker.dequeue", 0, "drop")])
    assert run.ok, run.render()
    c = run.report.info["broker"]
    assert c["chaos_dropped_deliveries"] == 1
    assert c["unack_timeouts"] == 1
    assert c["dequeues"] == c["acks"] + c["nacks"] + c["unack_timeouts"]


def test_duplicate_redelivery_converges():
    run = _small_run(17, steps=30, schedule=[FaultSpec("broker.ack", 0, "duplicate")])
    assert run.ok, run.render()
    c = run.report.info["broker"]
    assert c["chaos_dup_enqueues"] == 1
    assert c["dequeues"] == c["acks"] + c["nacks"] + c["unack_timeouts"]


def test_move_drop_commits_nothing():
    run = _small_run(7, steps=60, schedule=[FaultSpec("migrate.move_drop", 0, "drop")])
    assert run.ok, run.render()
    assert ("migrate.move_drop", 0, "drop") in run.triggered
    c = run.report.info["counters"]
    assert c.get("nomad.migrate.aborted", 0) >= 1
    assert run.report.checked["migration_conservation"]
    assert c.get("nomad.migrate.capacity_violations", 0) == 0


def test_kill_mid_move_recovered_never_doubled():
    run = _small_run(11, steps=60, schedule=[FaultSpec("migrate.kill_mid_move", 0, "drop")])
    assert run.ok, run.render()
    assert ("migrate.kill_mid_move", 0, "drop") in run.triggered
    c = run.report.info["counters"]
    assert c.get("nomad.migrate.interrupted", 0) >= 1
    assert c.get("nomad.migrate.recovered", 0) >= 1
    assert c.get("nomad.migrate.capacity_violations", 0) == 0
    assert run.report.checked["migration_conservation"]


def test_gang_commit_drop_releases_the_whole_gang():
    """A healthy gang's commit is dropped: every member releases and the
    gang rides one blocked eval, never a striped plan (law 15)."""
    before = _counter("nomad.gang.releases")
    run = _small_run(3, steps=30, schedule=[FaultSpec("gang.commit_drop", 0, "drop")])
    assert run.ok, run.render()
    assert ("gang.commit_drop", 0, "drop") in run.triggered
    assert _counter("nomad.gang.releases") > before
    assert run.report.checked["gang_atomicity"]


def test_uninstalls_plane_even_on_failure():
    with pytest.raises(TypeError):
        run_chaos(seed=1, steps="not-a-count", device="cpu")
    assert active_plane() is None


# -- cp.round_perturb -----------------------------------------------------------


def test_round_perturb_gives_the_reference_choices(monkeypatch):
    ct = ref_hetero.build_mixed_fleet(64, seed=8)
    asks = ref_scp.build_cp_asks(ct, 6, 5, seed=9)
    planes = [mod.install(mod.FaultPlane(schedule=[
        mod.FaultSpec("cp.round_perturb", 0, "perturb")])) for mod in (ref_plane, port_plane)]
    ref_before = ref_metrics.snapshot()["counters"].get("nomad.cp.chaos_perturbs", 0)
    port_before = _counter("nomad.cp.chaos_perturbs")
    with reference_runtime(monkeypatch):
        ref = ref_scp.CpPlacementKernel().place(ct, asks)
    port = port_scp.CpPlacementKernel(device="cpu").place(
        interop.cluster_from_numpy(dataclasses.asdict(ct)),
        interop.asks_from_numpy([dataclasses.asdict(a) for a in asks]),
    )
    for plane in planes:
        assert plane.triggered == [("cp.round_perturb", 0, "perturb")]
    assert ref_metrics.snapshot()["counters"]["nomad.cp.chaos_perturbs"] == ref_before + 1
    assert _counter("nomad.cp.chaos_perturbs") == port_before + 1
    for r, p in zip(ref, port):
        np.testing.assert_array_equal(p.node_rows, r.node_rows)
        np.testing.assert_allclose(p.scores, r.scores, rtol=RTOL, atol=ATOL)


# -- a move and its job's evals (ROADMAP C-R6, repaired in the port) -------------


@pytest.fixture
def moving():
    """A server on the CPU with the defrag loop off: four nodes and a
    three-alloc job, every alloc running. Yields (server, move), where
    ``move(name)`` plans a move of that alloc, as a cycle would from its
    snapshot, to a node that does not hold it; it runs when called."""
    from nomad_tpu_torch.chaos import runner as port_runner

    s = Server(ServerConfig(num_workers=1, num_batch_workers=1, heartbeat_ttl=3600.0,
                            device="cpu"))
    s.establish_leadership()
    try:
        for i in range(4):
            s.register_node(port_runner._build_node(i))
        s.register_job(port_runner._build_job(1, 3, 50))
        assert s.wait_for_evals(timeout=30)
        port_runner._flip_pending(s)

        def move(name):
            (old,) = [a for a in s.store.allocs() if a.name == f"chaos-job-0001.{name}"]
            job = s.store.job_by_id(old.namespace, old.job_id)
            dest = next(n.id for n in s.store.nodes() if n.id != old.node_id)
            return old, lambda: s.defrag._execute_move(old, job, dest)

        yield s, move
    finally:
        s.shutdown()


def _live(s):
    return sorted(a.name for a in s.store.allocs() if not a.terminal_status())


def _rescale(s, count):
    from nomad_tpu_torch.chaos import runner as port_runner

    s.register_job(port_runner._build_job(1, count, 50))
    assert s.wait_for_evals(timeout=30)


TWO = ["chaos-job-0001.web[0]", "chaos-job-0001.web[1]"]


def test_a_move_whose_source_the_job_stopped_commits_nothing_live(moving):
    """The job scales web[2] away after the defrag cycle took its
    snapshot: phase A still lands the replacement, which then goes too
    (the reference leaves it live: three allocs for a count of two)."""
    from nomad_tpu_torch.server.defrag import DEFRAG_ORPHAN_DESC

    s, move = moving
    old, run = move("web[2]")
    _rescale(s, 2)
    assert run() is False
    assert _live(s) == TWO
    (rep,) = [a for a in s.store.allocs() if a.previous_allocation == old.id]
    assert rep.desired_description == DEFRAG_ORPHAN_DESC
    assert check_cluster(s, baseline=metrics_baseline()).ok


@pytest.mark.parametrize("name", ["web[0]", "web[2]"])
def test_a_scale_down_during_a_half_move_sees_one_slot(moving, name):
    """Phase B of ``name``'s move is lost, then the job scales from three
    to two while both halves are live: the reconciler counts the pair as
    its source alone and stops web[2]; recovery then finishes web[0]'s
    move, or stops the replacement of the web[2] the job stopped. (The
    reference counts four allocs for web[0]'s move, keeps both halves of
    web[0] as the two, and recovery leaves one.)"""
    s, move = moving
    _old, run = move(name)
    install(FaultPlane(schedule=[FaultSpec("migrate.kill_mid_move", 0, "drop")]))
    try:
        assert run() is False
    finally:
        uninstall()
    assert len(_live(s)) == 4  # the half-move pair and two more
    _rescale(s, 2)
    s.defrag.recover()
    assert _live(s) == TWO
    assert check_cluster(s, baseline=metrics_baseline()).ok
