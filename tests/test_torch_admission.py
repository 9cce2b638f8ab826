"""The port's admission controller (``nomad_tpu_torch.server.admission``)
against the JAX package's, on the CPU.

Both controllers get the same scripted inputs on fake clocks: broker
depths, ack counts and eval-latency samples (each fed to its own
package's ``Metrics`` registry through a ``HistWindow``). They must give
the same level and the same sampled signals at every step, the same
``check_intake`` decision for every (level, tier, trigger, cost) cell,
the same ``job_cost_demand``, and the same broker deferrals as the ready
depth climbs past each tier's watermark. The server wires the
controller into its broker as the reference's does.

Tolerance: none. Levels, decisions, counters, retry hints, costs and
signals are compared exactly (the signals are sums and EMAs of the same
float64 operations in the same order).
"""

import dataclasses
import inspect

import numpy as np
import pytest

from nomad_tpu import mock as ref_mock
from nomad_tpu.broker.eval_broker import EvalBroker as RefBroker
from nomad_tpu.server import admission as ref_adm
from nomad_tpu.utils.metrics import Metrics as RefMetrics
from nomad_tpu_torch import interop
from nomad_tpu_torch.broker.eval_broker import EvalBroker
from nomad_tpu_torch.server import admission as port_adm
from nomad_tpu_torch.structs import Evaluation, Job
from nomad_tpu_torch.utils.metrics import Metrics

TRIGGERS = ("job-register", "job-scaling", "periodic-job", "node-update",
            "job-deregister", "rolling-update")
PRIORITIES = (30, 50, 70)


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


class Feed:
    """One controller and the signals a script feeds it."""

    def __init__(self, mod, metrics_cls, **overrides):
        self.clock = FakeClock()
        self.depth = {"ready": 0, "unacked": 0}
        self.acks = 0
        self.metrics = metrics_cls()
        self.c = mod.AdmissionController(
            clock=self.clock,
            depth_fn=lambda: dict(self.depth),
            p99_window=mod.HistWindow(window_s=2.0, clock=self.clock,
                                      registry=self.metrics),
            completions_fn=lambda: self.acks,
            **overrides,
        )

    def step(self, dt, ready, unacked, acks, latencies, intakes):
        self.clock.t += dt
        self.depth = {"ready": ready, "unacked": unacked}
        self.acks += acks
        for s in latencies:
            self.metrics.measure("nomad.slo.eval_latency", s)
        for _ in range(intakes):
            self.c._note_intake()
        level = self.c.level(force=True)
        snap = self.c.snapshot()
        return level, snap["signals"], snap["level_changes"], snap["cooling"]


OVERRIDES = dict(
    brownout_backlog=40, shed_backlog=120, brownout_p99_ms=400.0,
    shed_p99_ms=2000.0, min_p99_samples=8, dwell_s=1.5, exit_fraction=0.5,
    imbalance_ratio=1.5, imbalance_min_backlog=16,
)


def _script(seed=11, steps=120):
    """Seeded depth / ack / latency samples that climb through brownout
    into shed, hold in the hysteresis band, then cool down in steps."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(steps):
        phase = i // 20
        base = (5, 45, 150, 70, 25, 3)[phase]
        ready = int(base + rng.integers(0, 10))
        unacked = int(rng.integers(0, 4))
        acks = int(rng.integers(0, 6))
        lat_scale = (0.05, 0.3, 2.5, 0.5, 0.1, 0.02)[phase]
        lat = [float(lat_scale * rng.uniform(0.5, 1.5)) for _ in range(rng.integers(0, 5))]
        out.append((0.25, ready, unacked, acks, lat, int(rng.integers(0, 8))))
    return out


def test_levels_and_signals_match_reference_on_a_scripted_sequence():
    ref = Feed(ref_adm, RefMetrics, **OVERRIDES)
    port = Feed(port_adm, Metrics, **OVERRIDES)
    levels = []
    for step in _script():
        want = ref.step(*step)
        got = port.step(*step)
        assert got == want
        levels.append(got[0])
    # the script visits every level and steps back down
    assert set(levels) == {"normal", "brownout", "shed"}
    assert levels[-1] == "normal"
    assert port.c.snapshot()["level_changes"] == ref.c.snapshot()["level_changes"] >= 4


def _intake_matrix(mod):
    out = {}
    for level in mod.LEVELS:
        c = mod.AdmissionController(clock=FakeClock(), retry_after_s=2.0)
        # warm the low tier's cost profile while NORMAL
        for demand in (1.0, 2.0, 50.0, 100.0):
            c.check_intake(30, cost_demand=demand)
        c.force_level(level, duration_s=3600.0)
        for prio in PRIORITIES:
            for trig in TRIGGERS:
                for cost in (None, 1.0, 100.0):
                    try:
                        c.check_intake(prio, trig, cost_demand=cost)
                        out[(level, prio, trig, cost)] = "admitted"
                    except mod.AdmissionRejected as e:
                        out[(level, prio, trig, cost)] = (e.decision, e.retry_after, e.tier)
        snap = c.snapshot()
        out[level] = (snap["counters"], snap["exempt_total"], snap["cost_profile"],
                      c.conserved())
    return out


def test_check_intake_shed_matrix_per_tier_matches_reference():
    got, want = _intake_matrix(port_adm), _intake_matrix(ref_adm)
    assert got == want
    assert got[("shed", 70, "job-register", None)] == "admitted"
    assert got[("shed", 50, "job-register", None)][0] == "deferred"
    assert got[("shed", 30, "job-register", 100.0)][0] == "shed"
    assert got[("shed", 30, "job-register", 1.0)][0] == "deferred"
    assert got[("shed", 30, "node-update", None)] == "admitted"


def _job(throughputs, counts=(4,), cpus=(500,)):
    job = ref_mock.job()
    job.throughputs = dict(throughputs)
    tg = job.task_groups[0]
    groups = []
    for count, cpu in zip(counts, cpus):
        g = dataclasses.replace(tg, name=f"g{len(groups)}", count=count)
        g.tasks = [dataclasses.replace(tg.tasks[0])]
        g.tasks[0].resources = dataclasses.replace(tg.tasks[0].resources, cpu=cpu)
        groups.append(g)
    job.task_groups = groups
    return job


@pytest.mark.parametrize("throughputs, counts, cpus", [
    ({}, (4,), (500,)),
    ({"tpu-v5p": 2.0}, (4,), (500,)),
    ({"cpu": 1.0, "gpu-h100": 3.0}, (3, 0), (250, 1000)),
    ({"fpga-x": 1.0}, (2, 5), (1500, 100)),
])
def test_job_cost_demand_matches_reference(throughputs, counts, cpus):
    ref_job = _job(throughputs, counts, cpus)
    port_job = interop.from_record(Job, dataclasses.asdict(ref_job))
    assert port_adm.job_cost_demand(port_job) == ref_adm.job_cost_demand(ref_job)
    assert [port_adm.tier_of(p) for p in range(0, 101)] == [
        ref_adm.tier_of(p) for p in range(0, 101)]


def _broker_run(broker_cls, adm_mod, evals, level):
    clock = FakeClock()
    adm = adm_mod.AdmissionController(clock=clock, shed_backlog=40, defer_delay_s=5.0)
    adm.force_level(level, duration_s=3600.0)
    broker = broker_cls(unack_timeout=None, clock=clock, admission=adm)
    broker.set_enabled(True)
    trail = []
    for ev in evals:
        broker.enqueue(ev)
        depths = broker.queue_depths()
        trail.append((broker.counters["admission_deferred"], depths["ready"],
                      depths["delayed"]))
    # the deferred evals fire after the delay and re-decide
    clock.t += 6.0
    with broker._lock:
        broker._drain_delayed_locked()
    depths = broker.queue_depths()
    trail.append((broker.counters["admission_deferred"], depths["ready"], depths["delayed"]))
    return trail, adm.counters(), adm.snapshot()["exempt_total"]


@pytest.mark.parametrize("level", ["normal", "brownout", "shed"])
def test_broker_deferrals_at_each_watermark_match_reference(level):
    evals = []
    for i in range(60):
        job = ref_mock.job(id=f"adm-{i:03d}", priority=PRIORITIES[i % 3])
        trig = ("job-register", "node-update", "rolling-update", "job-register")[i % 4]
        ev = ref_mock.eval_for(job, triggered_by=trig, priority=job.priority)
        ev.id = f"adm-eval-{i:03d}"
        evals.append(ev)
    want = _broker_run(RefBroker, ref_adm, evals, level)
    got = _broker_run(EvalBroker, port_adm,
                      [interop.from_record(Evaluation, dataclasses.asdict(e)) for e in evals],
                      level)
    assert got == want
    deferred = got[0][-1][0]
    assert (deferred > 0) == (level != "normal")


def test_server_wires_admission_as_the_reference_does():
    from nomad_tpu_torch.obs import recorder
    from nomad_tpu_torch.server import Server, ServerConfig

    s = Server(ServerConfig(num_workers=0, device="cpu",
                            admission_overrides={"shed_backlog": 77}))
    try:
        assert isinstance(s.admission, port_adm.AdmissionController)
        assert s.eval_broker.admission is s.admission
        assert s.admission.shed_backlog == 77
        # the flight recorder takes its high-tier cut from admission
        # instead of keeping a copy of it
        src = inspect.getsource(recorder)
        assert "from ..server.admission import TIER_HIGH, tier_of" in src
        assert not hasattr(recorder, "_is_high_tier")
    finally:
        s.shutdown()
