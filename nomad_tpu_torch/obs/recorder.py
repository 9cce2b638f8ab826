"""Flight recorder — fixed-size ring of recent completed traces.

The analog of an aircraft FDR for the scheduler: the last N eval traces
and the last N error events stay resident, cheap enough to leave on in
production, and are surfaced at ``/v1/agent/trace`` next to
``/v1/metrics``. ``render_trace`` turns one recorded tree into the
indented duration view the ``nomad-tpu trace`` CLI prints;
``phase_breakdown`` aggregates span durations by name for the BENCH
per-phase report.

Zero dependencies beyond the stdlib; traces arrive as plain dicts (see
``Tracer.finish``) so the recorder never holds live Span objects.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Callable, Optional

from ..utils.hist import pct_nearest_rank
from ..utils.metrics import global_metrics

DEFAULT_CAPACITY = 256
DEFAULT_ERROR_CAPACITY = 100


def _is_high_tier(priority: int) -> bool:
    """The admission plane's high tier (``server/admission.py``
    ``tier_of``: priority >= 70). The admission module is a leader
    service (ROADMAP A9b); until it lands the recorder keeps its own copy of
    the one cut it reads."""
    return priority >= 70


class FlightRecorder:
    def __init__(
        self,
        capacity: int = DEFAULT_CAPACITY,
        error_capacity: int = DEFAULT_ERROR_CAPACITY,
        clock=None,
    ):
        self.capacity = capacity
        # injectable wall clock for error-event stamps (NTA008)
        self._clock = clock if clock is not None else time.time
        self._lock = threading.Lock()
        # eval_id → trace dict, insertion-ordered: oldest first, evicted
        # first; a re-processed eval re-records and moves to the tail
        self._traces: "OrderedDict[str, dict]" = OrderedDict()
        self._errors: deque = deque(maxlen=error_capacity)
        # lifetime error-event count: the ring evicts, this doesn't, so
        # conservation checks (chaos invariant: every swallowed-error
        # counter bump has a ring event) survive ring wraparound
        self.errors_total = 0
        # lifetime trace counts: how much of a run the 256-trace ring
        # actually covered, so SLO reports can state coverage instead
        # of silently truncating to the newest 256
        self.traces_total = 0
        self.traces_evicted = 0
        # listeners see every completed trace even when the ring
        # wraps — the SLO collector windows latencies through this
        self._listeners: list[Callable[[dict], None]] = []
        # placement-explanation ring (obs/explain.py): eval_id → payload
        # dict, same capacity/eviction discipline as the trace ring so
        # `alloc why` / `/v1/evaluations/:id/placement` have a bounded,
        # always-on store; lifetime counters state coverage like traces
        self._explanations: "OrderedDict[str, dict]" = OrderedDict()
        self.explanations_total = 0
        self.explanations_evicted = 0

    # -- writes ------------------------------------------------------------
    def add_listener(self, fn: Callable[[dict], None]) -> None:
        with self._lock:
            if fn not in self._listeners:
                self._listeners.append(fn)

    def remove_listener(self, fn: Callable[[dict], None]) -> None:
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    def record(self, trace: dict) -> None:
        eval_id = trace.get("eval_id", "")
        evicted = 0
        with self._lock:
            if eval_id in self._traces:
                del self._traces[eval_id]
            self._traces[eval_id] = trace
            self.traces_total += 1
            while len(self._traces) > self.capacity:
                self._traces.popitem(last=False)
                evicted += 1
            self.traces_evicted += evicted
            listeners = list(self._listeners)
        # metrics bump + listener fan-out happen OUTSIDE the recorder
        # lock: listeners take their own locks, and the registry lock
        # must never nest under this one (same rule as Tracer.finish)
        if evicted:
            global_metrics.incr("nomad.obs.traces_evicted", evicted)
        eval_s, placement_s = trace_latencies(trace)
        global_metrics.measure("nomad.slo.eval_latency", eval_s)
        # high-priority tier gets its own always-on series: the
        # admission plane promises this one stays within SLO while
        # lower tiers are deferred/shed, so it must be observable
        # lifetime (live_report) not just per-collector
        priority = (trace.get("tags") or {}).get("priority")
        if priority is not None and _is_high_tier(int(priority)):
            global_metrics.measure("nomad.slo.eval_latency_high", eval_s)
        if placement_s > 0.0:
            global_metrics.measure("nomad.slo.placement_latency", placement_s)
        for fn in listeners:
            try:
                fn(trace)
            except Exception:
                global_metrics.incr("nomad.obs.listener_errors")

    def record_explanation(self, eval_id: str, payload: dict) -> None:
        """Ring one eval's placement explanation (dict of task group →
        explanation dict, plus eval metadata). Re-records move to the
        tail; evictions bump ``nomad.obs.explanations_evicted`` outside
        the lock, mirroring ``record``."""
        evicted = 0
        with self._lock:
            if eval_id in self._explanations:
                del self._explanations[eval_id]
            self._explanations[eval_id] = payload
            self.explanations_total += 1
            while len(self._explanations) > self.capacity:
                self._explanations.popitem(last=False)
                evicted += 1
            self.explanations_evicted += evicted
        if evicted:
            global_metrics.incr("nomad.obs.explanations_evicted", evicted)
        global_metrics.incr("nomad.obs.explanations_recorded")

    def explanation(self, eval_id: str) -> Optional[dict]:
        with self._lock:
            return self._explanations.get(eval_id)

    def explanations(self, n: int = 50) -> list[dict]:
        """Newest-first explanation payloads (bounded index view)."""
        with self._lock:
            items = list(reversed(self._explanations.values()))
        return items[: max(0, n)]

    def record_error(
        self, component: str, error: str, eval_id: str = ""
    ) -> None:
        with self._lock:
            self.errors_total += 1
            self._errors.append(
                {
                    "at_unix": self._clock(),
                    "component": component,
                    "error": error,
                    "eval_id": eval_id,
                }
            )

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()
            self._errors.clear()
            self._explanations.clear()

    # -- reads -------------------------------------------------------------
    def get(self, eval_id: str) -> Optional[dict]:
        with self._lock:
            return self._traces.get(eval_id)

    def traces(self) -> list[dict]:
        """Full trace dicts, newest first."""
        with self._lock:
            return list(reversed(self._traces.values()))

    def list(self, n: int = 50) -> list[dict]:
        """Newest-first summaries (the trace index endpoint)."""
        out = []
        for t in self.traces()[: max(0, n)]:
            out.append(
                {
                    "eval_id": t.get("eval_id", ""),
                    "status": t.get("status", ""),
                    "started_at": t.get("started_at", 0.0),
                    "duration_ms": t.get("duration_ms", 0.0),
                    "spans": len(t.get("spans", ())),
                    "tags": t.get("tags", {}),
                }
            )
        return out

    def errors(self) -> list[dict]:
        with self._lock:
            return list(reversed(self._errors))

    def __len__(self) -> int:
        with self._lock:
            return len(self._traces)


def trace_latencies(trace: dict) -> tuple[float, float]:
    """(eval_latency_s, placement_latency_s) for one completed trace —
    THE latency definitions every SLO surface shares.

    Eval latency is end-to-end from the user's side of the broker:
    ready-queue wait (the ``queue_wait_ms`` tag the worker stamps on
    the dequeue span) plus the trace's own dequeue→ack duration.
    Placement latency is the schedule-and-commit core: the summed
    durations of the ``invoke_scheduler`` and ``submit_plan`` spans.
    """
    queue_wait_ms = 0.0
    placement_ms = 0.0
    for s in trace.get("spans", ()):
        name = s.get("name", "")
        if name == "dequeue":
            try:
                queue_wait_ms += float(
                    s.get("tags", {}).get("queue_wait_ms", 0.0)
                )
            except (TypeError, ValueError):
                pass
        elif name in ("invoke_scheduler", "submit_plan"):
            placement_ms += float(s.get("duration_ms") or 0.0)
    eval_ms = queue_wait_ms + float(trace.get("duration_ms") or 0.0)
    return eval_ms / 1000.0, placement_ms / 1000.0


flight_recorder = FlightRecorder()


def render_trace(trace: dict) -> str:
    """Render one recorded trace as an indented duration tree::

        eval 4bb1…  acked  12.41ms  job_id=bench-3
          dequeue              0.31ms  queue_wait_ms=0.21
          wait_for_index       0.02ms
          ...
    """
    spans = trace.get("spans", [])
    children: dict = {}
    roots = []
    for s in spans:
        pid = s.get("parent_id")
        if pid is None:
            roots.append(s)
        else:
            children.setdefault(pid, []).append(s)

    def fmt_tags(tags: dict) -> str:
        return " ".join(f"{k}={v}" for k, v in sorted(tags.items()))

    header_tags = fmt_tags(trace.get("tags", {}))
    lines = [
        f"eval {trace.get('eval_id', '?')}  {trace.get('status', '?')}  "
        f"{trace.get('duration_ms', 0.0):.2f}ms"
        + (f"  {header_tags}" if header_tags else "")
    ]

    def walk(span: dict, depth: int) -> None:
        tags = fmt_tags(span.get("tags", {}))
        name = "  " * depth + span["name"]
        lines.append(
            f"{name:<40s} {span.get('duration_ms', 0.0):>10.2f}ms"
            + (f"  {tags}" if tags else "")
        )
        kids = children.get(span.get("span_id"), [])
        for kid in sorted(kids, key=lambda s: s.get("start_unix", 0.0)):
            walk(kid, depth + 1)

    for root in roots:
        for kid in sorted(
            children.get(root.get("span_id"), []),
            key=lambda s: s.get("start_unix", 0.0),
        ):
            walk(kid, 1)
    return "\n".join(lines)


def phase_breakdown(traces: list[dict]) -> dict:
    """Aggregate span durations by name across traces — the BENCH
    per-phase latency table. Root spans are excluded (the root is the
    whole eval; the phases are its children)."""
    by_name: dict[str, list[float]] = {}
    for t in traces:
        for s in t.get("spans", ()):
            if s.get("parent_id") is None:
                continue
            by_name.setdefault(s["name"], []).append(
                float(s.get("duration_ms") or 0.0)
            )
    out = {}
    for name in sorted(by_name):
        buf = sorted(by_name[name])
        n = len(buf)
        p95 = pct_nearest_rank(buf, 0.95)
        out[name] = {
            "count": n,
            "mean_ms": round(sum(buf) / n, 3),
            "p95_ms": round(p95, 3),
            "max_ms": round(buf[-1], 3),
        }
    return out
