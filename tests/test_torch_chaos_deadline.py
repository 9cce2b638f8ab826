"""The CPU chaos run's kernel deadline holds on a slow host (ROADMAP C-P5).

A chaos run on the CPU computes every kernel call with its plain
version, which takes far longer than the card's kernel. With the card's
0.1 s execute deadline, a slow host refused legitimate calls: evals
parked and a gang could sit at its old counts. ``run_chaos`` now scales
the execute deadline and every injected kernel hang by
``CPU_DEADLINE_SCALE`` on the CPU, and keeps the schedule's rows (and so
the canonical report) as planned.

Here every kernel call is slowed by a fixed sleep longer than the old
deadline, inside the guard's watchdog thread where the deadline counts
it. The run at ``tests/test_torch_chaos.py``'s size must stay ``ok``
(law 15, gang atomicity, checked on its gang jobs), and the breaker may
trip only on the injected hang. Before the repair every slowed call
tripped it (19 trips for 1 hang at seed 1), and every eval parked.

Tolerance: exact (verdicts and counters).
"""

import time

from nomad_tpu_torch.chaos import plane as port_plane
from nomad_tpu_torch.chaos import run_chaos
from nomad_tpu_torch.chaos import runner as port_runner

# longer than the card's deadline, well inside the CPU run's
SLOW_CALL_S = 0.15


def test_slow_kernel_calls_trip_no_breaker_and_keep_gangs_whole(monkeypatch):
    assert SLOW_CALL_S > port_runner.RUN_EXECUTE_DEADLINE
    assert SLOW_CALL_S < port_runner.RUN_EXECUTE_DEADLINE * port_runner.CPU_DEADLINE_SCALE
    real_site = port_plane.chaos_site
    slowed = []

    def slow_site(site):
        # the guard's watchdog thread reaches this site before every launch
        if site == "kernel.hang":
            slowed.append(site)
            time.sleep(SLOW_CALL_S)
        return real_site(site)

    monkeypatch.setattr(port_plane, "chaos_site", slow_site)
    run = run_chaos(seed=1, steps=40, device="cpu", quiesce_timeout=60.0)
    assert run.ok, run.render()
    assert slowed, "no kernel call went through the guard"
    assert run.report.checked.get("gang_atomicity") is True
    assert run.report.info["gang_jobs"] >= 1
    hangs = [t for t in run.triggered if t[0] == "kernel.hang" and t[2] == "hang"]
    assert len(hangs) == 1, run.triggered
    counters = run.report.info["counters"]
    trips = [e["error"] for e in run.recorder_errors if "tripped" in str(e.get("error"))]
    assert counters.get("nomad.resilience.trips_total", 0) == len(hangs), (counters, trips)
    assert counters.get("nomad.resilience.fallback_calls", 0) == 0
    refusals = run.report.info["kernel_refusals"]
    assert refusals["parked_failed"] == 0, refusals
