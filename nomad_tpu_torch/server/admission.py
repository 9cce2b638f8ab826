"""Admission control: overload levels and priority-tiered shedding.

The reference Nomad's eval broker is unbounded — past the saturation
arrival rate every priority tier degrades together, because priority is
only a heap-ordering hint (`eval_broker.go`), never a drop decision.
This module is the missing overload story: an :class:`AdmissionController`
derives a cluster overload level from windowed signals the repo already
produces and enforces it at every intake seam, so the cluster degrades
*by tier* instead of collapsing uniformly.

Levels (a seeded-clock-testable FSM like ``resilience/breaker.py``)::

    NORMAL ──enter──▶ BROWNOUT ──enter──▶ SHED
       ▲                 │  ▲                │
       └──── dwell ──────┘  └──── dwell ─────┘

- **Raising is immediate** the moment any signal crosses its *enter*
  threshold (backlog depth, eval-latency p99 over a sliding histogram
  window, or arrival rate outrunning completion rate with a real
  backlog behind it). A NORMAL→SHED jump is allowed.
- **Lowering is hysteretic**: signals must stay below the *exit*
  thresholds (``exit_fraction`` × enter, default 0.5×) continuously for
  ``dwell_s`` before the controller steps down ONE level. No flapping
  at a threshold boundary: between exit and enter the level holds.

Decisions are conservation-accounted per priority tier (invariant law
10: ``admitted + deferred + shed == submitted``) and placed so no law
can break:

- **Shed happens only before state commitment** — a rejected intake
  raises :class:`AdmissionRejected` (HTTP maps it to 429 +
  ``Retry-After``) and nothing is written. A committed job must keep a
  live evaluation (law 7, ``job_conservation``), so an eval that
  reached the broker is never dropped.
- **Deferral happens only after commitment** — the broker's enqueue
  gate parks over-watermark external evals on the existing delayed
  heap; they re-fire and re-decide. Each pass through the gate is one
  decision, so conservation holds through re-defers.
- Liveness traffic (node-update evals, deregisters that free capacity,
  ``_core`` housekeeping) is always exempt.

Everything is observable: ``nomad.admission.*`` counters feed the SLO
report and ``/v1/agent/resilience``; the chaos site ``admission.flap``
forces the level for a window to prove accounting survives abuse.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from ..chaos.plane import chaos_site
from ..structs.evaluation import (
    TRIGGER_JOB_DEREGISTER,
    TRIGGER_JOB_REGISTER,
    TRIGGER_JOB_SCALING,
    TRIGGER_NODE_UPDATE,
    TRIGGER_PERIODIC_JOB,
)
from ..utils.hist import LogHistogram
from ..utils.metrics import count_swallowed, global_metrics

# --------------------------------------------------------------------------
# levels and priority tiers

NORMAL = "normal"
BROWNOUT = "brownout"
SHED = "shed"
LEVELS = (NORMAL, BROWNOUT, SHED)
_RANK = {lvl: i for i, lvl in enumerate(LEVELS)}

TIER_HIGH = "high"
TIER_NORMAL = "normal"
TIER_LOW = "low"
TIERS = (TIER_HIGH, TIER_NORMAL, TIER_LOW)

DECISIONS = ("admitted", "deferred", "shed")

# Traffic the cluster must keep accepting even while shedding: node
# status evals keep placements correct, deregisters FREE capacity, and
# _core evals are internal housekeeping.
EXEMPT_TRIGGERS = frozenset({TRIGGER_NODE_UPDATE, TRIGGER_JOB_DEREGISTER})
EXEMPT_TYPES = frozenset({"_core"})

# Externally-submitted work — the only traffic admission decides on at
# the broker seam. Internal followups (rolling-update, queued-allocs,
# failed-follow-up, ...) were admitted at intake; deferring them would
# stall pipelines the cluster already committed to.
EXTERNAL_TRIGGERS = frozenset(
    {TRIGGER_JOB_REGISTER, TRIGGER_JOB_SCALING, TRIGGER_PERIODIC_JOB, "job-eval"}
)


def job_cost_demand(job, costs: Optional[dict] = None) -> float:
    """Device-class-cost-weighted demand of one job: Σ over task groups
    of ``count × cpu-cores``, scaled by the costliest device class the
    job targets (``throughputs`` keys) under scheduler/hetero.py's
    ``DEVICE_CLASS_COSTS`` — the same table ``class_cost_vector``
    reads, so admission's notion of "expensive" matches the scheduler's.
    A throughput-agnostic job runs on anything and is costed at the
    baseline 1.0."""
    if costs is None:
        from ..scheduler.hetero import DEVICE_CLASS_COSTS

        costs = DEVICE_CLASS_COSTS
    weight = 1.0
    for cls in getattr(job, "throughputs", {}) or {}:
        weight = max(weight, float(costs.get(cls, 1.0)))
    cores = 0.0
    for tg in getattr(job, "task_groups", []) or []:
        group_cpu = sum(t.resources.cpu for t in tg.tasks)
        cores += max(tg.count, 0) * group_cpu / 1000.0
    return weight * cores


def tier_of(priority: int) -> str:
    """Priority → tier. Matches the repo's conventional 30/50/70 split:
    >=70 high, 40–69 normal, <40 low."""
    if priority >= 70:
        return TIER_HIGH
    if priority >= 40:
        return TIER_NORMAL
    return TIER_LOW


class AdmissionRejected(Exception):
    """Raised at an intake seam when the controller refuses work.

    Carries ``retry_after`` (seconds) so the HTTP layer can emit a 429
    with a ``Retry-After`` header and the RPC layer can honor it in the
    client backoff."""

    def __init__(self, level: str, tier: str, decision: str, retry_after: float):
        super().__init__(
            f"admission {decision} (level={level}, tier={tier}); "
            f"retry after {retry_after:.1f}s"
        )
        self.level = level
        self.tier = tier
        self.decision = decision
        self.retry_after = float(retry_after)


class Signals:
    """One sampled view of the overload inputs."""

    __slots__ = ("backlog", "p99_ms", "p99_count", "arrival_rate", "completion_rate")

    def __init__(
        self,
        backlog: float = 0.0,
        p99_ms: float = 0.0,
        p99_count: int = 0,
        arrival_rate: float = 0.0,
        completion_rate: float = 0.0,
    ):
        self.backlog = float(backlog)
        self.p99_ms = float(p99_ms)
        self.p99_count = int(p99_count)
        self.arrival_rate = float(arrival_rate)
        self.completion_rate = float(completion_rate)

    def to_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}


class HistWindow:
    """Sliding-window p99 over an always-on metrics LogHistogram.

    Two-bucket scheme: the registry histogram is cumulative, so we keep
    a base snapshot rolled every ``window_s`` plus the previous full
    window, and answer percentiles from previous-window ∪ current-diff.
    The read therefore always covers the last ``window_s``..``2×window_s``
    of samples and never momentarily drops to zero at a roll boundary.
    """

    def __init__(
        self,
        metric: str = "nomad.slo.eval_latency",
        window_s: float = 5.0,
        clock: Optional[Callable[[], float]] = None,
        registry=None,
    ):
        self.metric = metric
        self.window_s = float(window_s)
        self._clock = clock if clock is not None else time.monotonic
        self._registry = registry if registry is not None else global_metrics
        self._base: Optional[LogHistogram] = None
        self._base_t = 0.0
        self._prev: Optional[LogHistogram] = None

    def sample(self) -> tuple[int, float]:
        """(sample count, p99 in ms) over the sliding window."""
        cur = self._registry.histograms().get(self.metric)
        if cur is None:
            return 0, 0.0
        now = self._clock()
        if self._base is None:
            self._base = cur
            self._base_t = now
            return 0, 0.0
        if now - self._base_t >= self.window_s:
            self._prev = cur.diff(self._base)
            self._base = cur
            self._base_t = now
        win = cur.diff(self._base)
        if self._prev is not None:
            win.merge(self._prev)
        if win.count <= 0:
            return 0, 0.0
        return win.count, win.percentile(0.99) * 1000.0


# The controller's tuned constants live in the calibration table
# (obs/calibrate.py, ``admission.*`` namespace) so every threshold
# carries provenance — shipped defaults are sized so NORMAL is
# byte-identical to the pre-admission repo at every existing test/soak
# scale, and a loaded saturation-probe artifact rewrites the backlog
# thresholds with ``source: probe``. This tuple only NAMES the override
# keys the controller accepts; NTA018 bans bare threshold literals here.
_CONFIG_KEYS = (
    "brownout_backlog",
    "shed_backlog",
    "brownout_p99_ms",
    "shed_p99_ms",
    "exit_fraction",
    "imbalance_ratio",
    "imbalance_min_backlog",
    "min_p99_samples",
    "dwell_s",
    "reeval_interval_s",
    "retry_after_s",
    "defer_delay_s",
    "flap_window_s",
    # per-tier ready-depth ceilings as fractions of shed_backlog; low
    # defers first, high only past the shed point itself
    "watermark_fractions",
    # brownout batch amortization: widen the dequeue window instead of
    # thrashing small kernel passes
    "brownout_batch_factor",
    "brownout_batch_timeout_s",
    # cost-aware shed ordering within the low tier: submissions at or
    # below this quantile of recently-seen cost demands defer instead of
    # shedding, so the expensive half of the tier sheds first
    "shed_cost_quantile",
)


def _default_config() -> dict:
    # lazy import: obs/__init__ transitively imports server modules, so
    # a module-level import here would cycle (same workaround as
    # obs/recorder.py's tier_of import)
    from ..obs.calibrate import global_table

    return global_table.admission_overrides()

_LEVEL_GAUGE = "nomad.admission.level"


class AdmissionController:
    """Overload FSM + per-tier admission decisions. Thread-safe.

    ``clock`` is monotonic-seconds (injectable for seeded tests and the
    chaos clock sweep, like the broker's ``clock=``). Signal callables
    are injected by the composition root:

    - ``depth_fn`` → the broker's ``queue_depths()`` dict (or a float)
    - ``p99_window`` → a :class:`HistWindow` over the always-on
      ``nomad.slo.eval_latency`` series
    - ``completions_fn`` → cumulative completion count (broker acks)
    """

    def __init__(
        self,
        *,
        clock: Optional[Callable[[], float]] = None,
        depth_fn: Optional[Callable[[], object]] = None,
        p99_window: Optional[HistWindow] = None,
        completions_fn: Optional[Callable[[], float]] = None,
        **overrides,
    ):
        unknown = set(overrides) - set(_CONFIG_KEYS)
        if unknown:
            raise TypeError(f"unknown admission overrides: {sorted(unknown)}")
        cfg = _default_config()
        cfg.update(overrides)
        for key, value in cfg.items():
            setattr(self, key, value)

        self._clock = clock if clock is not None else time.monotonic
        self._depth_fn = depth_fn
        self._p99_window = p99_window
        self._completions_fn = completions_fn

        self._lock = threading.Lock()
        now = self._clock()
        self._level = NORMAL
        self._changed_at = now
        self._cool_since: Optional[float] = None
        self._forced: Optional[tuple[str, float]] = None
        self._last_eval = now - self.reeval_interval_s  # first call samples
        self._level_changes = 0
        self._last_signals = Signals()

        # law-10 ledger: every decision bumps submitted + exactly one
        # outcome for its tier (fixed keys — bounded by construction)
        self._counters = {
            tier: {"submitted": 0, "admitted": 0, "deferred": 0, "shed": 0}
            for tier in TIERS
        }
        self._exempt = 0
        # cost profile of low-tier submissions (law-10-neutral: it only
        # reorders WHICH low-tier jobs shed, never how many decisions)
        self._cost_hist = LogHistogram()
        # arrival-vs-completion: cumulative intake count + EMA rates
        self._intake_total = 0
        self._rate_state: Optional[tuple[float, float, float]] = None
        self._arr_rate = 0.0
        self._comp_rate = 0.0
        global_metrics.set_gauge(_LEVEL_GAUGE, 0.0)

    # -- FSM ---------------------------------------------------------------

    def _now(self, now: Optional[float]) -> float:
        return self._clock() if now is None else now

    def _level_from(self, s: Signals, scale: float) -> str:
        """Map signals → level with thresholds scaled by ``scale``
        (1.0 = enter thresholds, ``exit_fraction`` = exit)."""
        level = NORMAL
        p99_votes = s.p99_count >= self.min_p99_samples
        if (
            s.backlog >= self.brownout_backlog * scale
            or (p99_votes and s.p99_ms >= self.brownout_p99_ms * scale)
            or (
                s.backlog >= self.imbalance_min_backlog
                and s.arrival_rate > self.imbalance_ratio * max(s.completion_rate, 1e-9)
            )
        ):
            level = BROWNOUT
        if s.backlog >= self.shed_backlog * scale or (
            p99_votes and s.p99_ms >= self.shed_p99_ms * scale
        ):
            level = SHED
        return level

    def _set_level_locked(self, level: str, now: float) -> None:
        if level == self._level:
            return
        self._level = level
        self._changed_at = now
        self._level_changes += 1
        global_metrics.set_gauge(_LEVEL_GAUGE, float(_RANK[level]))
        global_metrics.incr("nomad.admission.level_changes")
        global_metrics.incr(f"nomad.admission.level_enter.{level}")

    def evaluate(self, signals: Signals, now: Optional[float] = None) -> str:
        """One FSM step against ``signals``. Raise immediately past an
        enter threshold; lower one level at a time only after signals
        sit below the exit thresholds for a continuous ``dwell_s``."""
        with self._lock:
            now = self._now(now)
            self._last_signals = signals
            if self._forced is not None:
                level, until = self._forced
                if now < until:
                    self._set_level_locked(level, now)
                    return self._level
                self._forced = None
                self._cool_since = None
            enter = self._level_from(signals, 1.0)
            sustain = self._level_from(signals, self.exit_fraction)
            cur = self._level
            if _RANK[enter] > _RANK[cur]:
                self._set_level_locked(enter, now)
                self._cool_since = None
            elif _RANK[sustain] < _RANK[cur]:
                if self._cool_since is None:
                    self._cool_since = now
                elif now - self._cool_since >= self.dwell_s:
                    self._set_level_locked(LEVELS[_RANK[cur] - 1], now)
                    self._cool_since = None
            else:
                # between exit and enter: hold (the hysteresis band)
                self._cool_since = None
            return self._level

    def force_level(
        self,
        level: str,
        duration_s: Optional[float] = None,
        now: Optional[float] = None,
    ) -> None:
        """Pin the level for a window (chaos ``admission.flap``, drills).
        The FSM resumes control when the window expires."""
        if level not in _RANK:
            raise ValueError(f"unknown admission level: {level!r}")
        with self._lock:
            now = self._now(now)
            until = now + (self.flap_window_s if duration_s is None else duration_s)
            self._forced = (level, until)
            self._set_level_locked(level, now)
            self._cool_since = None
            global_metrics.incr("nomad.admission.forced")

    def level(self, now: Optional[float] = None, force: bool = False) -> str:
        """Current level, lazily re-evaluated from fresh signals at most
        once per ``reeval_interval_s`` (or always with ``force=True``)."""
        return self._maybe_reevaluate(now=now, force=force)

    def _maybe_reevaluate(
        self,
        now: Optional[float] = None,
        backlog_override: Optional[float] = None,
        force: bool = False,
    ) -> str:
        now = self._now(now)
        with self._lock:
            due = force or (now - self._last_eval >= self.reeval_interval_s)
            if due:
                self._last_eval = now
            current = self._level
        if not due:
            return current
        # chaos hook: a scheduled flap forces SHED for a bounded window;
        # decisions keep being counted, so law 10 holds through abuse
        if chaos_site("admission.flap") == "force":
            global_metrics.incr("nomad.admission.chaos_flaps")
            self.force_level(SHED, self.flap_window_s, now=now)
            return SHED
        # sample OUTSIDE the admission lock: depth_fn takes the broker
        # lock, and the broker's enqueue gate calls into us while
        # holding it — sampling under our lock would invert that order
        signals = self._sample(now, backlog_override)
        return self.evaluate(signals, now)

    def _sample(self, now: float, backlog_override: Optional[float]) -> Signals:
        backlog = 0.0
        if backlog_override is not None:
            backlog = float(backlog_override)
        elif self._depth_fn is not None:
            try:
                depths = self._depth_fn()
            except Exception as e:  # broker mid-shutdown
                count_swallowed("admission", e)
                depths = None
            if isinstance(depths, dict):
                backlog = float(depths.get("ready", 0) + depths.get("unacked", 0))
            elif depths is not None:
                backlog = float(depths)
        completions = 0.0
        if self._completions_fn is not None:
            try:
                completions = float(self._completions_fn())
            except Exception as e:
                count_swallowed("admission", e)
        p99_count, p99_ms = (0, 0.0)
        if self._p99_window is not None:
            p99_count, p99_ms = self._p99_window.sample()
        with self._lock:
            last = self._rate_state
            intake = float(self._intake_total)
            if last is not None and now > last[0]:
                dt = now - last[0]
                arr = max(0.0, (intake - last[1]) / dt)
                comp = max(0.0, (completions - last[2]) / dt)
                # EMA smoothing so one quiet/bursty interval can't flip
                # the imbalance vote on its own
                self._arr_rate = 0.5 * self._arr_rate + 0.5 * arr
                self._comp_rate = 0.5 * self._comp_rate + 0.5 * comp
            self._rate_state = (now, intake, completions)
            return Signals(
                backlog=backlog,
                p99_ms=p99_ms,
                p99_count=p99_count,
                arrival_rate=self._arr_rate,
                completion_rate=self._comp_rate,
            )

    # -- decisions ---------------------------------------------------------

    def _decide_locked(self, tier: str, decision: str) -> None:
        c = self._counters[tier]
        c["submitted"] += 1
        c[decision] += 1
        global_metrics.incr(f"nomad.admission.submitted.{tier}")
        global_metrics.incr(f"nomad.admission.{decision}.{tier}")
        global_metrics.incr("nomad.admission.submitted_total")
        global_metrics.incr(f"nomad.admission.{decision}_total")

    def _exempt_locked(self, tier: str) -> None:
        # exempt traffic is ADMITTED for conservation purposes, with a
        # separate counter proving the exemption fired
        self._decide_locked(tier, "admitted")
        self._exempt += 1
        global_metrics.incr("nomad.admission.exempt_total")

    def check_intake(
        self,
        priority: int,
        triggered_by: str = TRIGGER_JOB_REGISTER,
        now: Optional[float] = None,
        cost_demand: Optional[float] = None,
    ) -> None:
        """Gate an external submission BEFORE any state is committed.

        Under SHED: high admits, normal defers (429 + Retry-After — the
        client owns the retry), low sheds (longer Retry-After). Raises
        :class:`AdmissionRejected` for the latter two; nothing was
        written, so no conservation law is at risk.

        ``cost_demand`` (see :func:`job_cost_demand`) orders the shed
        WITHIN the low tier by class-cost-weighted demand: a low-tier
        submission at or below the ``shed_cost_quantile`` of recently
        seen demands defers like the normal tier instead of shedding —
        the expensive half of the tier gives back capacity first.
        Callers that pass no demand keep the legacy whole-tier shed."""
        self._note_intake()
        tier = tier_of(priority)
        if triggered_by in EXEMPT_TRIGGERS:
            with self._lock:
                self._exempt_locked(tier)
            return
        level = self._maybe_reevaluate(now=now)
        rejected: Optional[AdmissionRejected] = None
        with self._lock:
            if tier == TIER_LOW and cost_demand is not None:
                # profile continuously (not just under SHED) so the
                # quantile is warm the moment shedding starts
                self._cost_hist.record(max(float(cost_demand), 0.0))
            if level != SHED or tier == TIER_HIGH:
                self._decide_locked(tier, "admitted")
            elif tier == TIER_NORMAL:
                self._decide_locked(tier, "deferred")
                rejected = AdmissionRejected(level, tier, "deferred", self.retry_after_s)
            elif cost_demand is not None and float(cost_demand) <= (
                self._cost_hist.percentile(self.shed_cost_quantile)
            ):
                self._decide_locked(tier, "deferred")
                global_metrics.incr("nomad.admission.cost_spared_total")
                rejected = AdmissionRejected(level, tier, "deferred", self.retry_after_s)
            else:
                self._decide_locked(tier, "shed")
                rejected = AdmissionRejected(level, tier, "shed", 2.0 * self.retry_after_s)
        if rejected is not None:
            raise rejected

    def _note_intake(self) -> None:
        with self._lock:
            self._intake_total += 1

    def gate_enqueue(self, ev, ready_depth: float, now: Optional[float] = None):
        """Broker-seam gate, called under the broker lock with the ready
        depth it already holds (never re-samples the broker — the depth
        override keeps the lock order one-way).

        Returns ``None`` to admit or a delay in seconds to park the eval
        on the broker's delayed heap. Only externally-triggered evals are
        decided on; liveness traffic is exempt-counted; internal followup
        work passes through untouched (admitted at intake already)."""
        trig = getattr(ev, "triggered_by", None)
        tier = tier_of(getattr(ev, "priority", 50))
        if trig in EXEMPT_TRIGGERS or getattr(ev, "type", None) in EXEMPT_TYPES:
            with self._lock:
                self._exempt_locked(tier)
            return None
        if trig not in EXTERNAL_TRIGGERS:
            return None
        level = self._maybe_reevaluate(now=now, backlog_override=ready_depth)
        with self._lock:
            if level != NORMAL:
                watermark = self.watermark_fractions[tier] * self.shed_backlog
                if ready_depth > watermark:
                    self._decide_locked(tier, "deferred")
                    return self.defer_delay_s
            self._decide_locked(tier, "admitted")
            return None

    def batch_params(self, base_max: int, base_timeout: float) -> tuple[int, float]:
        """Brownout lever for the batch workers: widen the dequeue batch
        window to amortize kernel passes instead of thrashing."""
        if self._maybe_reevaluate() == NORMAL:
            return base_max, base_timeout
        return (
            int(base_max) * int(self.brownout_batch_factor),
            max(float(base_timeout), float(self.brownout_batch_timeout_s)),
        )

    # -- observability -----------------------------------------------------

    def counters(self) -> dict:
        """Per-tier decision ledger (law 10 reads this)."""
        with self._lock:
            return {tier: dict(c) for tier, c in self._counters.items()}

    def snapshot(self) -> dict:
        with self._lock:
            now = self._clock()
            forced = self._forced
            return {
                "level": self._level,
                "level_rank": _RANK[self._level],
                "since_s": max(0.0, now - self._changed_at),
                "level_changes": self._level_changes,
                "cooling": self._cool_since is not None,
                "forced": (
                    {"level": forced[0], "remaining_s": max(0.0, forced[1] - now)}
                    if forced is not None
                    else None
                ),
                "counters": {tier: dict(c) for tier, c in self._counters.items()},
                "exempt_total": self._exempt,
                "cost_profile": {
                    "count": self._cost_hist.count,
                    "split": self._cost_hist.percentile(self.shed_cost_quantile),
                },
                "signals": self._last_signals.to_dict(),
                "thresholds": {
                    "brownout_backlog": self.brownout_backlog,
                    "shed_backlog": self.shed_backlog,
                    "brownout_p99_ms": self.brownout_p99_ms,
                    "shed_p99_ms": self.shed_p99_ms,
                    "exit_fraction": self.exit_fraction,
                    "dwell_s": self.dwell_s,
                },
            }

    def conserved(self) -> bool:
        """True iff admitted + deferred + shed == submitted in every tier."""
        for c in self.counters().values():
            if c["admitted"] + c["deferred"] + c["shed"] != c["submitted"]:
                return False
        return True
