"""The port's circuit breakers, watchdog and kernel guard
(``nomad_tpu_torch.resilience``, ``backend.guarded_call``) against the JAX
package's, on the CPU.

- The breaker's state machine on a fake clock: scripted sequences of
  failures, successes, timeouts, probes and manual overrides give the
  reference's transitions, snapshots and seeded backoff jitter, step by
  step; the registry (forced open, ``degraded``, ``configure``) and the
  trip's counter, gauge and flight record.
- ``DeadlineExecutor``: results, poisoning, propagated errors, the
  compile extension, and ``abandoned()`` seen by a late thunk.
- The guard around the kernel wrappers (their plain versions on CPU
  tensors): a hang trips the breaker and raises
  ``KernelDeadlineExceeded`` with no plain version computed for the call
  (the abandoned thunk launches nothing); an open breaker raises
  ``KernelUnavailable``; a half-open probe closes it; a forced-open
  registry refuses every wrapper and the placement pass; a build started
  during a call buys the compile deadline; with ``cp_place_kernel``'s
  breaker open the CP pass goes to the base kernel, counted.
- At run level: the reference's kernel-hang scenarios on the port's
  server are ``ok`` with a trip and no fallback call.
- A ``cuda``-marked test runs the guard on the card and skips here.

Tolerance: exact (states, snapshots, counters, placements).
"""

import threading
import time

import numpy as np
import pytest
import torch

from nomad_tpu.resilience import breaker as ref_rbr
from nomad_tpu_torch import backend
from nomad_tpu_torch.chaos import FaultPlane, FaultSpec, install, run_chaos, uninstall
from nomad_tpu_torch.device import cp as port_dcp
from nomad_tpu_torch.device import migrate as port_mig
from nomad_tpu_torch.device import preempt as port_pre
from nomad_tpu_torch.device import score as port_score
from nomad_tpu_torch.resilience import breaker as rbr
from nomad_tpu_torch.resilience.breaker import CircuitBreaker, breaker_for, set_forced_open
from nomad_tpu_torch.resilience.errors import KernelDeadlineExceeded, KernelUnavailable
from nomad_tpu_torch.resilience.watchdog import DeadlineExecutor, abandoned
from nomad_tpu_torch.scheduler import hetero as port_het
from nomad_tpu_torch.utils.metrics import global_metrics

# every kernel wrapper of the port, by the breaker name its guard keys
WRAPPERS = {
    "score_matrix": (port_score, "score_matrix_kernel"),
    "place_closed_form": (port_score, "place_closed_form_kernel"),
    "place_value_scan": (port_score, "place_value_scan_kernel"),
    "place_spread_chunked": (port_score, "place_spread_chunked_kernel"),
    "place_spread_opv": (port_score, "place_spread_opv_kernel"),
    "find_preemption": (port_pre, "find_preemption_kernel"),
    "choose_preemption_node": (port_pre, "choose_preemption_node_kernel"),
    "hetero_place": (port_het, "hetero_place_kernel"),
    "cp_place": (port_dcp, "cp_place_kernel"),
    "cp_gang_place": (port_dcp, "cp_gang_place_kernel"),
    "cp_gang_place_ids": (port_dcp, "cp_gang_place_kernel"),
    "migrate_plan": (port_mig, "migrate_plan_kernel"),
}


@pytest.fixture(autouse=True)
def _clean_resilience_state():
    """Breakers, forced-open, tunable defaults and the chaos plane are
    process-global: every test starts and ends from a clean slate."""
    prev = rbr.configure()
    rbr.reset_all()
    yield
    uninstall()
    rbr.configure(**prev)
    rbr.reset_all()


def _counter(name: str) -> float:
    return global_metrics.snapshot()["counters"].get(name, 0.0)


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


# -- the breaker's state machine against the reference's -----------------------

SCRIPTS = {
    "threshold": ["fail", "allow", "fail", "allow", "fail", "allow", "allow"],
    "success_resets": ["fail", "fail", "success", "fail", "fail", "allow", "fail", "allow"],
    "timeout_trips": ["timeout", "allow", "timeout"],
    "half_open_one_probe": ["timeout", "allow", "backoff", "allow", "allow", "allow"],
    "probe_success_closes": ["timeout", "backoff", "allow", "success", "allow", "allow"],
    "probe_failure_doubles": [
        "timeout", "backoff", "allow", "fail", "allow", "backoff", "allow", "timeout",
        "backoff", "allow", "fail", "backoff", "allow", "success", "timeout",
    ],
    "cap_binds": ["timeout"] + ["backoff", "allow", "fail"] * 8,
    "manual": ["force_open", "allow", "advance", "allow", "force_closed", "allow",
               "fail", "force_open", "force_closed", "timeout"],
}


def _drive(cls, script):
    """Run ``script`` on a fresh breaker of ``cls``: each step's result
    and the snapshot after it (the trip's wall-clock stamp left out)."""
    clk = FakeClock()
    br = cls("test.kernel", clock=clk, failure_threshold=3, backoff_base=1.0,
             backoff_cap=8.0, execute_deadline=0.5, compile_deadline=4.0)
    trail = []
    for step in script:
        out = None
        if step == "fail":
            br.record_failure(RuntimeError("boom"))
        elif step == "success":
            br.record_success()
        elif step == "timeout":
            br.record_timeout(RuntimeError("hang"))
        elif step == "allow":
            out = br.allow()
        elif step == "backoff":
            clk.t += br.snapshot()["backoff_s"] + 0.001
        elif step == "advance":
            clk.t += 1e6
        elif step == "force_open":
            br.force_open()
        elif step == "force_closed":
            br.force_closed()
        snap = br.snapshot()
        snap.pop("last_trip_unix")
        trail.append((step, out, br.state, snap))
    return trail


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_breaker_transitions_equal_the_reference(script):
    port = _drive(CircuitBreaker, SCRIPTS[script])
    ref = _drive(ref_rbr.CircuitBreaker, SCRIPTS[script])
    assert port == ref
    assert any(state != "closed" for _s, _o, state, _snap in port)


def test_backoff_jitter_is_seeded_by_name_and_trip():
    for name in ("place_closed_form_kernel", "migrate_plan_kernel", "k"):
        got, want = [], []
        for cls, out in ((CircuitBreaker, got), (ref_rbr.CircuitBreaker, want)):
            clk = FakeClock()
            br = cls(name, clock=clk, backoff_base=0.05, backoff_cap=0.25)
            for _ in range(5):
                br.record_timeout(RuntimeError("x"))
                out.append(br.snapshot()["backoff_s"])
                clk.t += 10.0
                assert br.allow()
        assert got == want
        assert len(set(got)) > 1


def test_half_open_admits_one_probe_under_contention():
    """48 threads race one half-open breaker with a tiny switch interval:
    exactly one is admitted, the rest are refused (a lost update in the
    probe flag would admit two)."""
    import sys

    clk = FakeClock()
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(20):
            br = CircuitBreaker("race.kernel", clock=clk, backoff_base=1.0)
            br.record_timeout(RuntimeError("hang"))
            clk.t += br.snapshot()["backoff_s"] + 0.001
            start = threading.Barrier(48)
            admitted = []

            def probe():
                start.wait(5.0)
                admitted.append(br.allow())

            threads = [threading.Thread(target=probe) for _ in range(48)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(10.0)
            assert not any(t.is_alive() for t in threads)
            assert sorted(admitted) == [False] * 47 + [True]
            assert br.state == "half_open"
    finally:
        sys.setswitchinterval(prev)


def test_forced_open_overrides_every_breaker():
    br = breaker_for("some.kernel")
    assert br.allow() and not rbr.degraded()
    set_forced_open(True)
    assert not br.allow() and rbr.degraded() and rbr.forced_open()
    set_forced_open(False)
    assert br.allow()
    br.record_timeout(RuntimeError("hang"))
    assert rbr.degraded()


def test_trip_emits_counter_gauge_and_flight_record():
    from nomad_tpu_torch.obs.recorder import flight_recorder

    before = _counter("nomad.resilience.trips_total")
    breaker_for("obs.kernel").record_timeout(RuntimeError("hang"))
    assert _counter("nomad.resilience.trips_total") == before + 1
    assert global_metrics.snapshot()["gauges"]["nomad.resilience.breaker_state.obs.kernel"] == 2
    assert any(e["component"] == "resilience" and "obs.kernel" in e["error"]
               for e in flight_recorder.errors())


def test_configure_rejects_unknown_and_pushes_onto_live_breakers():
    with pytest.raises(TypeError):
        rbr.configure(not_a_knob=1)
    br = breaker_for("live.kernel")
    prev = rbr.configure(execute_deadline=0.123)
    try:
        assert br.execute_deadline == 0.123
    finally:
        rbr.configure(**prev)
    # unpinned deadlines come from the calibration table, as in the reference
    assert (breaker_for("fresh.kernel").execute_deadline,
            breaker_for("fresh.kernel").compile_deadline) == (
            ref_rbr.breaker_for("fresh.kernel").execute_deadline,
            ref_rbr.breaker_for("fresh.kernel").compile_deadline)


# -- the watchdog --------------------------------------------------------------


def test_executor_returns_result_and_reuses_worker():
    ex = DeadlineExecutor()
    for i in range(5):
        assert ex.run(lambda i=i: i * 2, name="k", deadline_s=5.0) == i * 2
    assert ex.spawned == 1


def test_executor_timeout_raises_and_poisons_the_worker():
    ex = DeadlineExecutor()
    release = threading.Event()
    seen = []

    def thunk():
        release.wait(5.0)
        seen.append(abandoned())

    with pytest.raises(KernelDeadlineExceeded) as ei:
        ex.run(thunk, name="k", deadline_s=0.05)
    assert ei.value.phase == "execute" and ex.poisoned == 1
    release.set()
    assert ex.run(lambda: "ok", name="k", deadline_s=5.0) == "ok"
    assert ex.spawned == 2
    # the abandoned thread appends on its own time: wait for it (5 s at most)
    waited = time.monotonic() + 5.0
    while not seen and time.monotonic() < waited:
        time.sleep(0.01)
    assert seen == [True]  # the late thunk saw its caller gone
    assert not abandoned()  # and the caller's own thread is no job


def test_executor_exceptions_propagate_to_the_caller():
    ex = DeadlineExecutor()
    with pytest.raises(ValueError, match="inner"):
        ex.run(lambda: (_ for _ in ()).throw(ValueError("inner")), name="k", deadline_s=5.0)


def test_executor_extend_probe_buys_the_compile_deadline():
    ex = DeadlineExecutor()
    out = ex.run(lambda: time.sleep(0.15) or "compiled", name="k", deadline_s=0.05,
                 extend_deadline_s=5.0, extend_probe=lambda: True)
    assert out == "compiled"
    release = threading.Event()
    with pytest.raises(KernelDeadlineExceeded) as ei:
        ex.run(lambda: release.wait(5.0), name="k", deadline_s=0.03,
               extend_deadline_s=0.1, extend_probe=lambda: True)
    assert ei.value.phase == "compile"
    release.set()


# -- the guard around the kernel wrappers ---------------------------------------


def _closed_form_args(seed=0, g=3, n=24):
    rng = np.random.default_rng(seed)
    t = torch.from_numpy
    cap = np.tile(np.array([4000, 8192, 102400, 1000], np.float32), (n, 1))
    used = np.floor(cap * rng.uniform(0, 0.5, (n, 1))).astype(np.float32)
    asks = np.tile(np.array([500, 256, 300, 0], np.float32), (g, 1))
    return (
        t(cap), t(used), t(asks), t(rng.random((g, n)) < 0.9),
        t(np.zeros((g, n), np.int32)), t(np.full(g, 5.0, np.float32)),
        t(np.zeros((g, n), bool)), t(np.zeros((g, n), np.float32)),
        t(np.zeros(g, bool)), t(np.zeros(g, bool)),
        t(np.full((g, n), np.inf, np.float32)), False, 4, 8,
    )


class PlainLog:
    """Stands in for a plain version and counts its calls."""

    def __init__(self, real):
        self.real, self.calls = real, 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.real(*args, **kwargs)


@pytest.fixture
def plain(monkeypatch):
    log = PlainLog(port_score.place_closed_form_plain)
    monkeypatch.setattr(port_score, "place_closed_form_plain", log)
    return log


def test_hang_trips_and_raises_with_no_plain_call(plain):
    rbr.configure(execute_deadline=0.05, backoff_base=60.0)
    args = _closed_form_args()
    want = port_score.place_closed_form(*args)
    assert plain.calls == 1
    trips = _counter("nomad.resilience.trips_total")
    skips = _counter("nomad.resilience.abandoned_skips")
    plane = install(FaultPlane(schedule=[FaultSpec("kernel.hang", 0, "hang", 0.3)]))
    with pytest.raises(KernelDeadlineExceeded) as ei:
        port_score.place_closed_form(*args)
    assert ei.value.kernel == "place_closed_form_kernel"
    assert _counter("nomad.resilience.trips_total") == trips + 1
    assert breaker_for("place_closed_form_kernel").state == "open"
    # the abandoned thunk wakes from its hang and launches nothing
    deadline = time.time() + 5.0
    while _counter("nomad.resilience.abandoned_skips") == skips and time.time() < deadline:
        time.sleep(0.01)
    assert _counter("nomad.resilience.abandoned_skips") == skips + 1
    assert plain.calls == 1
    assert plane.triggered == [("kernel.hang", 0, "hang")]
    assert _counter("nomad.resilience.fallback_calls") == 0
    # an open breaker refuses the next call outright
    refused = _counter("nomad.resilience.refused_calls")
    with pytest.raises(KernelUnavailable) as ei:
        port_score.place_closed_form(*args)
    assert (ei.value.kernel, ei.value.state) == ("place_closed_form_kernel", "open")
    assert ei.value.retry_in_s > 0
    assert _counter("nomad.resilience.refused_calls") == refused + 1
    assert plain.calls == 1
    uninstall()
    # the half-open probe, once the backoff has passed, closes it
    rbr.reset_all()
    rbr.configure(execute_deadline=0.05, backoff_base=0.02, backoff_cap=0.02)
    br = breaker_for("place_closed_form_kernel")
    br.record_timeout(RuntimeError("hang"))
    with pytest.raises(KernelUnavailable):
        port_score.place_closed_form(*args)
    time.sleep(0.05)
    got = port_score.place_closed_form(*args)
    assert br.state == "closed"
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_execute_fault_counts_as_a_failure(plain):
    from nomad_tpu_torch.chaos import ChaosFault

    install(FaultPlane(schedule=[FaultSpec("kernel.execute", i, "raise") for i in range(3)]))
    for _ in range(3):
        with pytest.raises(ChaosFault):
            port_score.place_closed_form(*_closed_form_args())
    assert plain.calls == 0
    assert breaker_for("place_closed_form_kernel").state == "open"


@pytest.mark.parametrize("wrapper", list(WRAPPERS))
def test_forced_open_refuses_every_wrapper(wrapper):
    """The guard refuses before the wrapper's body runs: nothing is
    checked, launched or computed."""
    module, name = WRAPPERS[wrapper]
    fn = getattr(module, wrapper)
    set_forced_open(True)
    with pytest.raises(KernelUnavailable) as ei:
        fn(torch.zeros(1))
    assert (ei.value.kernel, ei.value.state) == (name, "forced_open")
    with backend.direct_launches():  # timing bypass: the body runs (and checks)
        with pytest.raises(Exception) as ei:
            fn(torch.zeros(1))
    assert not isinstance(ei.value, KernelUnavailable)


def _cp_fleet(n=48, jobs=4, count=3):
    import dataclasses

    from nomad_tpu.scheduler import cp as ref_scp
    from nomad_tpu.scheduler import hetero as ref_hetero
    from nomad_tpu_torch import interop

    ct = ref_hetero.build_mixed_fleet(n, seed=8)
    asks = ref_scp.build_cp_asks(ct, jobs, count, seed=9)
    return (interop.cluster_from_numpy(dataclasses.asdict(ct)),
            interop.asks_from_numpy([dataclasses.asdict(a) for a in asks]))


def test_forced_open_refuses_the_placement_pass():
    ct, asks = _cp_fleet()
    kern = port_score.PlacementKernel(device="cpu")
    want = kern.place(ct, asks)
    set_forced_open(True)
    with pytest.raises(KernelUnavailable):
        kern.place(ct, asks)
    set_forced_open(False)
    got = kern.place(ct, asks)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.node_rows, w.node_rows)


def test_a_build_during_the_call_buys_the_compile_deadline():
    rbr.configure(execute_deadline=0.05, compile_deadline=5.0)

    def building():
        backend.note_compile()
        time.sleep(0.15)
        return "built"

    assert backend.guarded_call("build.kernel", torch.device("cpu"), building) == "built"
    with pytest.raises(KernelDeadlineExceeded):
        backend.guarded_call("slow.kernel", torch.device("cpu"), lambda: time.sleep(0.15))
    assert breaker_for("slow.kernel").state == "open"
    assert breaker_for("build.kernel").state == "closed"


def test_open_cp_breaker_sends_the_pass_to_the_base_kernel(monkeypatch):
    from nomad_tpu_torch.scheduler import cp as port_scp

    pct, pasks = _cp_fleet()
    cp_calls = PlainLog(port_dcp.cp_place)
    monkeypatch.setattr(port_dcp, "cp_place", cp_calls)
    kern = port_scp.CpPlacementKernel(device="cpu")
    kern.place(pct, pasks)
    assert cp_calls.calls == 1
    before = _counter("nomad.cp.fallback_passes")
    gang_failures = _counter("nomad.cp.gang_fallback_failures")
    breaker_for("cp_place_kernel").force_open()
    got = kern.place(pct, pasks)
    want = kern._base.place(pct, pasks)
    assert cp_calls.calls == 1  # the auction was not asked
    assert _counter("nomad.cp.fallback_passes") == before + 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.node_rows, w.node_rows)
    # cp-gang under the same open breaker: the gang asks fail whole, the
    # rest go to the base kernel
    for a in pasks[:2]:
        a.gang_member = True
    got = port_scp.CpGangPlacementKernel(device="cpu").place(pct, pasks)
    assert _counter("nomad.cp.fallback_passes") == before + 2
    assert _counter("nomad.cp.gang_fallback_failures") == gang_failures + 2
    assert all((r.node_rows == -1).all() for r in got[:2])
    for g, w in zip(got[2:], kern._base.place(pct, pasks[2:])):
        np.testing.assert_array_equal(g.node_rows, w.node_rows)


# -- at run level ---------------------------------------------------------------


def test_kernel_hang_trips_and_converges_clean():
    run = run_chaos(seed=23, steps=40, schedule=[FaultSpec("kernel.hang", 0, "hang", 0.3)],
                    quiesce_timeout=60.0, device="cpu")
    assert run.ok, run.render()
    assert [t for t in run.triggered if t[2] == "hang"], "the hang never fired"
    assert any(b["trips"] >= 1 for b in run.report.info["breakers"].values())
    assert run.report.info["counters"].get("nomad.resilience.trips_total", 0) >= 1
    assert run.report.info["counters"].get("nomad.resilience.fallback_calls", 0) == 0
    refusals = run.report.info["kernel_refusals"]
    assert refusals["evals"] >= 1
    assert refusals["ended_placed"] + refusals["parked_failed"] == refusals["evals"]


def test_hang_rate_run_places_everything():
    run = run_chaos(seed=31, steps=60, faults=("hang",), rate=0.10, device="cpu")
    assert run.ok, run.render()
    assert run.report.info["counters"].get("nomad.resilience.fallback_calls", 0) == 0


@pytest.mark.cuda
def test_cuda_guard_trips_refuses_and_probes_on_the_card():
    """On the card: a hang abandons the call before its launch (no
    launch counted), an open breaker refuses the next one, and the
    half-open probe launches the kernel and matches the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    dev = torch.device("cuda")
    args = [a.to(dev) if isinstance(a, torch.Tensor) else a for a in _closed_form_args()]
    want = port_score.place_closed_form_plain(*_closed_form_args())
    port_score.place_closed_form(*args)  # builds and loads the library
    rbr.configure(execute_deadline=0.05, backoff_base=0.02, backoff_cap=0.02)
    launches = port_score.place_closed_form.launches
    install(FaultPlane(schedule=[FaultSpec("kernel.hang", 0, "hang", 0.3)]))
    with pytest.raises(KernelDeadlineExceeded):
        port_score.place_closed_form(*args)
    with pytest.raises(KernelUnavailable):
        port_score.place_closed_form(*args)
    time.sleep(0.4)
    uninstall()
    assert port_score.place_closed_form.launches == launches
    got = port_score.place_closed_form(*args)
    assert port_score.place_closed_form.launches == launches + 1
    assert breaker_for("place_closed_form_kernel").state == "closed"
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
