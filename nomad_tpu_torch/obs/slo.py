"""SLO plane: windowed latency collection and per-run SLO reports.

The drain benches answer "how fast does a backlog empty"; the SLO plane
answers the production question — what are p99 eval and placement
latency *under sustained load*, is the queue stable, and did the
resilience machinery stay quiet. Three pieces:

* :class:`SloTargets` — declared service-level objectives. Every field
  set to ``None`` is unchecked; everything else feeds the pass/fail
  verdict.
* :class:`SloCollector` — a flight-recorder listener (sees every
  completed trace, even the ones the 256-trace ring evicts) feeding
  bounded log-bucketed histograms, plus a 1 Hz sampler thread filling
  per-second rings with broker queue depth. O(buckets + window) memory
  for an arbitrarily long soak.
* :func:`build_report` / :func:`live_report` — the canonical per-run
  SLO report: latency percentiles, queue-depth stats, throughput,
  resilience/lane counters, ring coverage, and the verdict. The report
  *schema* (key paths) is pinned by :data:`SLO_SCHEMA` so regressions
  in the report shape fail tests, while the measured values are
  timing-dependent diagnostics (same canonicalization discipline as
  chaos reports).

Latency definitions (one place, used by both the always-on metrics feed
in ``recorder.py`` and this collector, via ``trace_latencies``):

* eval latency    = broker queue wait (``queue_wait_ms`` on the dequeue
  span) + the trace's own duration (dequeue → ack/nack).
* placement latency = Σ durations of the ``invoke_scheduler`` and
  ``submit_plan`` spans — the schedule-and-commit core, excluding queue
  wait and bookkeeping.

The schema is the JAX package's, key for key. In the port a refused or
timed-out kernel call raises and its eval is redelivered, never finished
on the CPU, so ``counters.fallback_activations`` and
``counters.fallback_passes`` always read 0 (``backend.guarded_call``).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from ..utils.hist import LogHistogram, TimeSeriesRing
from ..utils.metrics import global_metrics
from .recorder import flight_recorder, trace_latencies

# counters surfaced in every SLO report, report key → metrics key;
# values are windowed deltas against the collector-start baseline
REPORT_COUNTERS = {
    "breaker_trips": "nomad.resilience.trips_total",
    "fallback_activations": "nomad.resilience.fallback_calls",
    "fallback_passes": "nomad.resilience.fallback_passes",
    "lane_conflicts": "nomad.plan.lane_conflicts",
    "cross_lane_handoffs": "nomad.plan.cross_lane_handoffs",
    "lane_handoff_fallbacks": "nomad.worker.lane_handoff_fallbacks",
    "stale_token_drops": "nomad.worker.stale_token_drops",
    "unack_timeouts": "nomad.broker.unack_timeouts",
    "deadline_nacks": "nomad.resilience.eval.deadline_nacks",
    "traces_evicted": "nomad.obs.traces_evicted",
    "admission_deferred": "nomad.admission.deferred_total",
    "admission_shed": "nomad.admission.shed_total",
}

_LATENCY_KEYS = (
    "count", "mean_ms", "p50_ms", "p95_ms", "p99_ms", "max_ms",
)

# the pinned report shape: every key path build_report() emits, in
# sorted order. Structural — a function of the code, never of a run —
# so it belongs in the canonical block of a soak report.
SLO_SCHEMA = tuple(sorted(
    [f"eval_latency_ms.{k}" for k in _LATENCY_KEYS]
    + [f"eval_latency_high_ms.{k}" for k in _LATENCY_KEYS]
    + [f"placement_latency_ms.{k}" for k in _LATENCY_KEYS]
    + [f"plan_apply_ms.{k}" for k in _LATENCY_KEYS]
    + [
        "queue_depth.mean", "queue_depth.max", "queue_depth.seconds",
        "throughput.arrivals", "throughput.arrival_rate_per_s",
        "throughput.completions", "throughput.completion_rate_per_s",
    ]
    + [f"counters.{k}" for k in sorted(REPORT_COUNTERS)]
    + ["counters.swallowed_errors"]
    + [
        "calibration.constants",
        "calibration.probe_sourced",
        "calibration.learned_cells",
        "calibration.estimator_samples",
    ]
    + [
        "device_cache.score_rows_rescored",
        "device_cache.score_rows_reused",
        "device_cache.pipeline_overlap_ms",
    ]
    + [
        "gang.atomic_releases",
        "gang.released_allocs",
        "gang.stopped_allocs",
        "gang.groups_in",
        "gang.commits",
        "gang.kernel_releases",
        "gang.fallback_failures",
    ]
    + [
        "defrag.moves_planned",
        "defrag.moves_completed",
        "defrag.moves_aborted",
        "defrag.moves_interrupted",
        "defrag.moves_recovered",
        "defrag.budget_exhausted_cycles",
        "defrag.capacity_violations",
        "defrag.packing_efficiency",
        "defrag.drain_migrated",
        "defrag.drain_force_stops",
    ]
    + [
        "ring_coverage.traces_recorded",
        "ring_coverage.traces_evicted",
        "ring_coverage.coverage",
        "verdict.pass", "verdict.failures",
    ]
))


def slo_schema_of(slo: dict) -> tuple[str, ...]:
    """Flattened sorted key paths of a measured ``slo`` block — compare
    against :data:`SLO_SCHEMA` to pin the report shape."""
    paths = []
    for k, v in slo.items():
        if isinstance(v, dict):
            paths.extend(f"{k}.{k2}" for k2 in v)
        else:
            paths.append(k)
    return tuple(sorted(paths))


class SloTargets:
    """Declared SLOs. ``None`` disables a check; everything else is
    compared against the measured window in :func:`verdict`."""

    FIELDS = (
        "eval_p99_ms", "high_eval_p99_ms", "placement_p99_ms",
        "queue_depth_max",
        "max_breaker_trips", "max_fallback_activations",
        "max_lane_conflicts", "max_unack_timeouts",
        "max_swallowed_errors", "min_completion_ratio",
    )

    def __init__(
        self,
        eval_p99_ms: Optional[float] = 5000.0,
        high_eval_p99_ms: Optional[float] = None,
        placement_p99_ms: Optional[float] = 2500.0,
        queue_depth_max: Optional[float] = 10000.0,
        max_breaker_trips: Optional[float] = 0.0,
        max_fallback_activations: Optional[float] = 0.0,
        max_lane_conflicts: Optional[float] = 0.0,
        max_unack_timeouts: Optional[float] = None,
        max_swallowed_errors: Optional[float] = None,
        min_completion_ratio: Optional[float] = None,
    ):
        self.eval_p99_ms = eval_p99_ms
        # the overload acceptance bar: high-tier eval latency must hold
        # even while lower tiers are being deferred/shed
        self.high_eval_p99_ms = high_eval_p99_ms
        self.placement_p99_ms = placement_p99_ms
        self.queue_depth_max = queue_depth_max
        self.max_breaker_trips = max_breaker_trips
        self.max_fallback_activations = max_fallback_activations
        self.max_lane_conflicts = max_lane_conflicts
        self.max_unack_timeouts = max_unack_timeouts
        self.max_swallowed_errors = max_swallowed_errors
        self.min_completion_ratio = min_completion_ratio

    def to_dict(self) -> dict:
        return {f: getattr(self, f) for f in self.FIELDS}

    @classmethod
    def from_dict(cls, d: dict) -> "SloTargets":
        return cls(**{f: d[f] for f in cls.FIELDS if f in d})

    def verdict(self, slo: dict) -> dict:
        """Compare a measured ``slo`` block against the targets. Each
        breach is one human-readable failure row; pass ⇔ no rows.
        Latency targets are only enforced once the window actually
        measured something (count > 0) — an empty window is a harness
        bug surfaced elsewhere, not an SLO pass."""
        failures: list[str] = []

        def _over(label: str, measured: float, bound: Optional[float]):
            if bound is not None and measured > bound:
                failures.append(f"{label} {measured:.3f} > {bound:.3f}")

        ev = slo["eval_latency_ms"]
        pl = slo["placement_latency_ms"]
        if ev["count"]:
            _over("eval_p99_ms", ev["p99_ms"], self.eval_p99_ms)
        hi = slo.get("eval_latency_high_ms")
        if hi and hi["count"]:
            _over("high_eval_p99_ms", hi["p99_ms"], self.high_eval_p99_ms)
        if pl["count"]:
            _over(
                "placement_p99_ms", pl["p99_ms"], self.placement_p99_ms
            )
        _over(
            "queue_depth_max", slo["queue_depth"]["max"],
            self.queue_depth_max,
        )
        c = slo["counters"]
        _over("breaker_trips", c["breaker_trips"], self.max_breaker_trips)
        _over(
            "fallback_activations", c["fallback_activations"],
            self.max_fallback_activations,
        )
        _over("lane_conflicts", c["lane_conflicts"], self.max_lane_conflicts)
        _over("unack_timeouts", c["unack_timeouts"], self.max_unack_timeouts)
        _over(
            "swallowed_errors", c["swallowed_errors"],
            self.max_swallowed_errors,
        )
        if self.min_completion_ratio is not None:
            t = slo["throughput"]
            if t["arrivals"]:
                ratio = t["completions"] / t["arrivals"]
                if ratio < self.min_completion_ratio:
                    failures.append(
                        f"completion_ratio {ratio:.3f} < "
                        f"{self.min_completion_ratio:.3f}"
                    )
        return {"pass": not failures, "failures": failures}


class SloCollector:
    """Windowed SLO measurement over a live server.

    ``attach()`` subscribes to the flight recorder (every completed
    trace feeds the latency histograms); ``start(server)`` additionally
    runs a sampler thread that polls broker queue depth once per
    ``period``. All state is bounded: two histograms + fixed rings.
    """

    def __init__(
        self,
        recorder=flight_recorder,
        metrics=global_metrics,
        clock=time.time,
        window_seconds: int = 900,
        period: float = 1.0,
    ):
        self._recorder = recorder
        self._metrics = metrics
        self._clock = clock
        self.period = period
        self._lock = threading.Lock()
        self.eval_hist = LogHistogram()
        # high-priority tier only (tier_of(priority) == "high", from the
        # worker's priority trace tag): the overload story promises this
        # histogram stays within SLO while lower tiers shed
        self.eval_high_hist = LogHistogram()
        self.placement_hist = LogHistogram()
        self.queue_ring = TimeSeriesRing(window_seconds)
        self.arrival_ring = TimeSeriesRing(window_seconds)
        self.completion_ring = TimeSeriesRing(window_seconds)
        self.arrivals = 0
        self.completions = 0
        self._counters_base = dict(metrics.snapshot()["counters"])
        self._hists_base = metrics.histograms()
        self._traces_base = (
            recorder.traces_total, recorder.traces_evicted,
        )
        self._started_at = clock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._server = None

    # -- trace feed --------------------------------------------------------
    def attach(self) -> None:
        self._recorder.add_listener(self._on_trace)

    def detach(self) -> None:
        self._recorder.remove_listener(self._on_trace)

    def _on_trace(self, trace: dict) -> None:
        eval_s, placement_s = trace_latencies(trace)
        now = self._clock()
        priority = (trace.get("tags") or {}).get("priority")
        is_high = False
        if priority is not None:
            from ..server.admission import TIER_HIGH, tier_of

            is_high = tier_of(int(priority)) == TIER_HIGH
        with self._lock:
            self.eval_hist.record(eval_s)
            if is_high:
                self.eval_high_hist.record(eval_s)
            if placement_s > 0.0:
                self.placement_hist.record(placement_s)
            self.completions += 1
            self.completion_ring.incr(now)

    def note_arrival(self, n: int = 1) -> None:
        """The load generator calls this per submitted job so arrival
        rate is measured at the same clock as everything else."""
        now = self._clock()
        with self._lock:
            self.arrivals += n
            self.arrival_ring.incr(now, n)

    # -- sampler -----------------------------------------------------------
    def start(self, server=None) -> None:
        self._server = server
        self.attach()
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._sample_loop, name="slo-sampler", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self.detach()
        self.sample_once()  # final depth sample so short windows aren't empty

    def _sample_loop(self) -> None:
        while not self._stop.wait(self.period):
            self.sample_once()

    def sample_once(self) -> None:
        server = self._server
        if server is None:
            return
        try:
            d = server.eval_broker.queue_depths()
            depth = (
                d["ready"] + d["unacked"] + d["delayed"] + d["deferred"]
            )
            plan_depth = server.plan_queue.depth()
        except Exception:
            global_metrics.incr("nomad.slo.sample_errors")
            return
        now = self._clock()
        with self._lock:
            self.queue_ring.observe(now, float(depth + plan_depth))

    def _calibration_block(self) -> dict:
        """Calibration-plane summary for the report: how many constants
        are probe-sourced and how much the throughput estimator has
        learned. Reads the attached server's table/estimator; a
        server-less collector reports the process globals (the shape —
        four scalars — is pinned either way)."""
        from .calibrate import calibration_overview

        return calibration_overview(
            table=getattr(self._server, "calibration", None),
            estimator=getattr(self._server, "throughput_estimator", None),
        )

    def _device_cache_block(self) -> dict:
        """Incremental-rescoring summary for the report: rows served
        from the resident score state vs re-uploaded, and how much
        commit wall time the pipelined loop hid under the next pass.
        Zeros from a server-less collector (the shape — three scalars
        — is pinned either way)."""
        cache = getattr(self._server, "device_cache", None)
        counters = cache.device_counters() if cache is not None else {}
        return {
            "score_rows_rescored": counters.get("score_rows_rescored", 0),
            "score_rows_reused": counters.get("score_rows_reused", 0),
            "pipeline_overlap_ms": counters.get("pipeline_overlap_ms", 0.0),
        }

    # -- report ------------------------------------------------------------
    def measured(self) -> dict:
        """The ``slo`` block: everything measured since the collector
        was constructed, as plain JSON-able data."""
        now = self._clock()
        counters = self._metrics.snapshot()["counters"]
        hists = self._metrics.histograms()
        with self._lock:
            eval_hist = self.eval_hist.copy()
            eval_high_hist = self.eval_high_hist.copy()
            placement_hist = self.placement_hist.copy()
            q = self.queue_ring.stats(now)
            arrivals = self.arrivals
            completions = self.completions
        span = max(now - self._started_at, 1e-9)

        def _delta(metric_key: str) -> float:
            return counters.get(metric_key, 0.0) - self._counters_base.get(
                metric_key, 0.0
            )

        ctr = {
            name: _delta(key) for name, key in REPORT_COUNTERS.items()
        }
        ctr["swallowed_errors"] = sum(
            _delta(k)
            for k in set(counters) | set(self._counters_base)
            if k.endswith(".swallowed_errors")
        )
        plan = hists.get("nomad.plan.apply")
        if plan is not None:
            base = self._hists_base.get("nomad.plan.apply")
            if base is not None:
                plan = plan.diff(base)
        recorded = self._recorder.traces_total - self._traces_base[0]
        evicted = self._recorder.traces_evicted - self._traces_base[1]
        return {
            "eval_latency_ms": eval_hist.snapshot(),
            "eval_latency_high_ms": eval_high_hist.snapshot(),
            "placement_latency_ms": placement_hist.snapshot(),
            "plan_apply_ms": (
                plan.snapshot() if plan is not None
                else LogHistogram().snapshot()
            ),
            "queue_depth": {
                "mean": round(q["mean"], 2),
                "max": q["max"],
                "seconds": q["seconds"],
            },
            "throughput": {
                "arrivals": arrivals,
                "arrival_rate_per_s": round(arrivals / span, 3),
                "completions": completions,
                "completion_rate_per_s": round(completions / span, 3),
            },
            "counters": ctr,
            # gang scheduling health: the atomic-commit seam (scheduler/
            # generic.py, law 15) plus the cp-gang kernel's own ledger —
            # windowed deltas like every other counter in the report
            "gang": {
                "atomic_releases": _delta("nomad.gang.releases"),
                "released_allocs": _delta("nomad.gang.released_allocs"),
                "stopped_allocs": _delta("nomad.gang.stopped_allocs"),
                "groups_in": _delta("nomad.cp.gang_groups_in"),
                "commits": _delta("nomad.cp.gang_commits"),
                "kernel_releases": _delta("nomad.cp.gang_releases"),
                "fallback_failures": _delta(
                    "nomad.cp.gang_fallback_failures"
                ),
            },
            # migration-plane health (server/defrag.py, law 16): the
            # move ledger as windowed deltas, the packing-efficiency
            # gauge as-is, and the drain split — graceful migrations vs
            # deadline force-stops — that the drainer reports
            "defrag": {
                "moves_planned": _delta("nomad.migrate.planned"),
                "moves_completed": _delta("nomad.migrate.completed"),
                "moves_aborted": _delta("nomad.migrate.aborted"),
                "moves_interrupted": _delta("nomad.migrate.interrupted"),
                "moves_recovered": _delta("nomad.migrate.recovered"),
                "budget_exhausted_cycles": _delta(
                    "nomad.migrate.budget_exhausted"
                ),
                "capacity_violations": _delta(
                    "nomad.migrate.capacity_violations"
                ),
                "packing_efficiency": round(
                    self._metrics.snapshot()["gauges"].get(
                        "nomad.migrate.packing_efficiency", 1.0
                    ), 6,
                ),
                "drain_migrated": _delta("nomad.drain.migrated"),
                "drain_force_stops": _delta("nomad.drain.force_stops"),
            },
            "calibration": self._calibration_block(),
            "device_cache": self._device_cache_block(),
            "ring_coverage": {
                "traces_recorded": recorded,
                "traces_evicted": evicted,
                "coverage": round(
                    (recorded - evicted) / recorded, 4
                ) if recorded else 1.0,
            },
        }


def build_report(collector: SloCollector, targets: SloTargets) -> dict:
    """Measured window + verdict: the ``slo`` block of a soak report
    and of ``/v1/agent/slo``."""
    slo = collector.measured()
    slo["verdict"] = targets.verdict(slo)
    return slo


def live_report(server, targets: Optional[SloTargets] = None) -> dict:
    """One-shot SLO report for a live agent (the HTTP endpoint): spin a
    collector against lifetime metrics, take a single queue-depth
    sample, and report the always-on ``nomad.slo.*`` latency series
    recorded by the flight recorder feed since process start."""
    targets = targets or SloTargets()
    collector = SloCollector()
    # lifetime window: zero the baselines so deltas cover process life
    collector._counters_base = {}
    collector._hists_base = {}
    collector._traces_base = (0, 0)
    collector._server = server
    collector.sample_once()
    hists = global_metrics.histograms()
    ev = hists.get("nomad.slo.eval_latency")
    hi = hists.get("nomad.slo.eval_latency_high")
    pl = hists.get("nomad.slo.placement_latency")
    if ev is not None:
        collector.eval_hist = ev
    if hi is not None:
        collector.eval_high_hist = hi
    if pl is not None:
        collector.placement_hist = pl
    collector.completions = collector.eval_hist.count
    slo = build_report(collector, targets)
    return {
        "targets": targets.to_dict(),
        "slo": slo,
        "schema": list(SLO_SCHEMA),
    }
