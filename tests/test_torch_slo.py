"""The port's SLO plane and load generator (``nomad_tpu_torch.obs.slo``,
``nomad_tpu_torch.obs.loadgen``) against the JAX package's, on the CPU.

- ``SLO_SCHEMA``, ``REPORT_COUNTERS`` and ``SloTargets``' fields and
  defaults equal the reference's; every report the port builds (a
  collector's, ``live_report``'s, a soak's) has exactly that schema.
- ``SloTargets.verdict`` gives the reference's verdict on the same
  measured blocks, and ``SloCollector`` windows the same trace feed (eval,
  high-tier and placement latencies, arrivals, completions, ring
  coverage) into the reference's numbers.
- The load generator's ``build_schedule`` plans the reference's rows for
  several seeds and knob sets (churn, node drains and flaps, a spike, a
  priority mix).
- A ~4 s smoke ``run_soak(device="cpu")`` on the port's server:
  invariants clean, the schema pinned, and its ``canonical_json()`` equal
  byte for byte to the reference's smoke soak at the same arguments (run
  under the scoped ``reference_runtime``, ROADMAP C-R1); and a small
  ``saturation_search`` that returns a rate inside its bracket.

Tolerance: exact.
"""

import pytest

from nomad_tpu.obs import loadgen as ref_loadgen
from nomad_tpu.obs import slo as ref_slo
from nomad_tpu.obs.recorder import FlightRecorder as RefRecorder
from nomad_tpu_torch.obs import loadgen as port_loadgen
from nomad_tpu_torch.obs import slo as port_slo
from nomad_tpu_torch.obs.recorder import FlightRecorder as PortRecorder
from test_torch_hetero import reference_runtime

SOAK = dict(seed=7, seconds=4.0, rate=10.0, nodes=50, batch_workers=1,
            drain_rate=0.25, flap_rate=0.25)


def test_schema_and_targets_equal_the_reference():
    assert port_slo.SLO_SCHEMA == ref_slo.SLO_SCHEMA
    assert port_slo.REPORT_COUNTERS == ref_slo.REPORT_COUNTERS
    assert port_slo.SloTargets.FIELDS == ref_slo.SloTargets.FIELDS
    assert port_slo.SloTargets().to_dict() == ref_slo.SloTargets().to_dict()
    report = port_slo.build_report(port_slo.SloCollector(), port_slo.SloTargets())
    assert port_slo.slo_schema_of(report) == port_slo.SLO_SCHEMA
    live = port_slo.live_report(None)
    assert port_slo.slo_schema_of(live["slo"]) == port_slo.SLO_SCHEMA
    assert live["schema"] == list(ref_slo.SLO_SCHEMA)
    # in the port nothing finishes on a fallback: those counters read 0
    assert live["slo"]["counters"]["fallback_activations"] == 0
    assert live["slo"]["counters"]["fallback_passes"] == 0


def _blank_slo():
    slo = ref_slo.SloCollector().measured()
    for block in ("counters", "gang", "defrag"):
        slo[block] = {k: 0.0 for k in slo[block]}
    return slo


VERDICT_CASES = {
    "clean": ({}, {}),
    "eval_breach": ({"eval_latency_ms": {"count": 10, "p99_ms": 9000.0}}, {}),
    "empty_window_not_judged": ({"eval_latency_ms": {"count": 0, "p99_ms": 9000.0}}, {}),
    "high_tier": ({"eval_latency_high_ms": {"count": 3, "p99_ms": 700.0}},
                  {"high_eval_p99_ms": 500.0}),
    "placement": ({"placement_latency_ms": {"count": 4, "p99_ms": 2600.0}}, {}),
    "queue": ({"queue_depth": {"max": 20000.0}}, {}),
    "counters": ({"counters": {"breaker_trips": 3, "fallback_activations": 1,
                               "lane_conflicts": 2, "unack_timeouts": 5,
                               "swallowed_errors": 1}},
                 {"max_unack_timeouts": 4, "max_swallowed_errors": 0}),
    "completion_ratio": ({"throughput": {"arrivals": 10, "completions": 7}},
                         {"min_completion_ratio": 0.8}),
    "unchecked": ({"counters": {"breaker_trips": 3}}, {"max_breaker_trips": None}),
}


@pytest.mark.parametrize("case", list(VERDICT_CASES))
def test_verdict_equals_the_reference(case):
    over, targets = VERDICT_CASES[case]
    slo = _blank_slo()
    for block, values in over.items():
        slo[block].update(values)
    got = port_slo.SloTargets(**targets).verdict(slo)
    want = ref_slo.SloTargets(**targets).verdict(slo)
    assert got == want
    assert got["pass"] == (case in ("clean", "empty_window_not_judged", "unchecked"))


def _trace(i):
    tags = {"priority": (30, 50, 70, 90)[i % 4]} if i % 5 else {}
    return {
        "eval_id": f"e{i}",
        "status": "acked",
        "duration_ms": 3.0 + (i * 7) % 41,
        "tags": tags,
        "spans": [
            {"name": "dequeue", "parent_id": 1, "tags": {"queue_wait_ms": float(i % 13)}},
            {"name": "invoke_scheduler", "parent_id": 1,
             "duration_ms": 1.0 + i % 5, "tags": {}},
            {"name": "submit_plan", "parent_id": 1, "duration_ms": 0.5 * (i % 3),
             "tags": {}},
        ],
    }


def test_collector_windows_equal_the_reference():
    out = []
    for recorder_cls, slo in ((PortRecorder, port_slo), (RefRecorder, ref_slo)):
        now = [100.0]
        rec = recorder_cls(capacity=16)
        c = slo.SloCollector(recorder=rec, clock=lambda now=now: now[0])
        c.attach()
        try:
            for i in range(300):
                now[0] += 0.05
                if i % 2:
                    c.note_arrival(1 + i % 3)
                rec.record(_trace(i))
        finally:
            c.detach()
        m = c.measured()
        out.append({k: m[k] for k in ("eval_latency_ms", "eval_latency_high_ms",
                                      "placement_latency_ms", "throughput",
                                      "queue_depth", "ring_coverage")})
    assert out[0] == out[1]
    assert out[0]["eval_latency_ms"]["count"] == 300
    assert 0 < out[0]["eval_latency_high_ms"]["count"] < 300
    assert out[0]["ring_coverage"]["traces_evicted"] == 300 - 16


SCHEDULES = [
    dict(seed=11, seconds=20.0, rate=15.0, nodes=100),
    dict(seed=12, seconds=20.0, rate=15.0, nodes=100),
    dict(seed=7, seconds=30.0, rate=25.0, nodes=10_000),
    dict(seed=9, seconds=60.0, rate=1.0, nodes=20, drain_rate=0.5, flap_rate=0.5),
    dict(seed=5, seconds=10.0, rate=20.0, nodes=50, update_frac=0.0, stop_frac=0.0,
         drain_rate=0.0, flap_rate=0.0),
    dict(seed=3, seconds=12.0, rate=8.0, nodes=40, spike_rate=60.0, spike_start=4.0,
         spike_seconds=3.0, priority_mix={"30": 1, "50": 2, "90": 1}),
]


@pytest.mark.parametrize("kw", SCHEDULES, ids=lambda kw: f"seed{kw['seed']}")
def test_loadgen_schedule_rows_equal_the_reference(kw):
    got = [e.row() for e in port_loadgen.build_schedule(**kw)]
    want = [e.row() for e in ref_loadgen.build_schedule(**kw)]
    assert got == want and len(got) > 10


@pytest.fixture(scope="module")
def smoke():
    return port_loadgen.run_soak(**SOAK, device="cpu")


def test_smoke_soak_is_clean_and_pinned(smoke):
    assert smoke.ok, smoke.render(verbose=True)
    assert port_slo.slo_schema_of(smoke.slo) == port_slo.SLO_SCHEMA
    t = smoke.slo["throughput"]
    assert t["arrivals"] > 0 and t["completions"] > 0
    assert smoke.slo["counters"]["fallback_activations"] == 0
    assert smoke.slo["counters"]["breaker_trips"] == 0
    assert smoke.admission["conserved"]


def test_smoke_soak_canonical_equals_the_reference(smoke, monkeypatch):
    with reference_runtime(monkeypatch):
        ref = ref_loadgen.run_soak(**SOAK)
    assert ref.ok, ref.render(verbose=True)
    assert smoke.canonical_json() == ref.canonical_json()
    assert smoke.workload["arrivals"] == ref.workload["arrivals"]


def test_saturation_search_returns_a_rate_in_its_bracket():
    lines = []
    rate = port_loadgen.saturation_search(
        seed=7, nodes=20, probe_seconds=0.5, lo=4.0, hi=8.0, iterations=1,
        log=lines.append, device="cpu",
    )
    assert 4.0 <= rate <= 8.0
    assert 2 <= len(lines) <= 3 and all(l.startswith("saturation probe") for l in lines)
