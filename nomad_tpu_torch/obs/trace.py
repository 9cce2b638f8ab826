"""Span/Tracer — per-eval trace trees with cross-thread propagation.

The eval lifecycle crosses three threads (worker → plan-queue → applier,
plus the pipelined commit thread), so a thread-local "current span" alone
cannot carry a trace end to end. The model here:

- A *trace* is keyed by eval id and lives in the tracer's active table
  from ``begin(eval_id)`` (at dequeue) to ``finish(eval_id)`` (at
  ack/nack), whichever thread that happens on.
- ``span(name)`` opens a child of the calling thread's current span and
  times it with ``perf_counter``; ``timer=`` additionally feeds the
  legacy metrics sample of that name, so ``/v1/metrics`` keeps its
  ``nomad.worker.*`` / ``nomad.plan.*`` series while the same interval
  lands in the trace tree (this is what lets eval-lifecycle modules drop
  raw ``metrics.timer`` — lint rule NTA006).
- ``current_ctx()`` → ``attach(ctx)`` is the thread handoff: the worker
  stamps its submit-plan span's context onto the pending plan, the
  applier thread attaches it, and the plan-apply spans parent correctly.
- ``add_span`` records an interval *retroactively* — for phases measured
  before the trace existed (broker dequeue) or shared by a whole batch
  (one device pass scoring 16 evals is recorded into each member's
  trace, tagged ``shared``).

Disabled mode (``set_enabled(False)``) keeps every call a cheap no-op
but ``span(timer=...)`` still feeds the metrics sample — turning tracing
off never changes the metrics surface.

Thread-safety: the active-trace table is mutated only under the tracer
lock (begin/finish); per-trace span lists are appended via the
GIL-atomic ``list.append`` and snapshotted at finish, and completed
traces are handed to the recorder *outside* the lock so the tracer can
never participate in a lock-order cycle with metrics or recorder locks.
"""

from __future__ import annotations

import itertools
import threading
import time
from contextlib import contextmanager
from typing import Optional

from ..utils.metrics import global_metrics

_ids = itertools.count(1)


class SpanContext:
    """Immutable handoff token: enough to parent a span from another
    thread (the trace itself stays in the tracer's active table)."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: int):
        self.trace_id = trace_id
        self.span_id = span_id


class Span:
    __slots__ = (
        "trace_id",
        "span_id",
        "parent_id",
        "name",
        "tags",
        "start_unix",
        "duration_ms",
        "status",
        "_t0",
    )

    def __init__(
        self,
        trace_id: str,
        name: str,
        parent_id: Optional[int] = None,
        tags: Optional[dict] = None,
        clock=None,
    ):
        self.trace_id = trace_id
        self.span_id = next(_ids)
        self.parent_id = parent_id
        self.name = name
        self.tags = dict(tags) if tags else {}
        # injectable wall clock (NTA008): the tracer threads its own so
        # estimator/SLO windows over span streams replay under FakeClock
        wall = clock if clock is not None else time.time
        self.start_unix = wall()
        self.duration_ms: Optional[float] = None
        self.status = "ok"
        self._t0 = time.perf_counter()

    def finish(self, status: Optional[str] = None) -> None:
        if self.duration_ms is None:
            self.duration_ms = (time.perf_counter() - self._t0) * 1000.0
        if status is not None:
            self.status = status

    def ctx(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def to_dict(self) -> dict:
        return {
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start_unix": self.start_unix,
            "duration_ms": round(self.duration_ms or 0.0, 4),
            "status": self.status,
            "tags": self.tags,
        }


class _Trace:
    __slots__ = ("trace_id", "root", "spans")

    def __init__(self, trace_id: str, root: Span):
        self.trace_id = trace_id
        self.root = root
        self.spans: list[Span] = [root]


class Tracer:
    def __init__(self, recorder=None, clock=None):
        self._lock = threading.Lock()
        self._active: dict[str, _Trace] = {}
        self._tls = threading.local()
        self._enabled = True
        self._dropped = 0
        self.recorder = recorder
        # wall clock for span start stamps (injectable for FakeClock tests)
        self._clock = clock if clock is not None else time.time

    # -- enable switch -----------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled

    def set_enabled(self, on: bool) -> bool:
        """Flip tracing; disabling drops any in-flight traces (they could
        never finish coherently half-recorded). Returns the old value."""
        with self._lock:
            old = self._enabled
            self._enabled = on
            if not on:
                self._active.clear()
            return old

    def reset(self) -> None:
        with self._lock:
            self._active.clear()
            self._dropped = 0

    # -- trace lifecycle ---------------------------------------------------
    def begin(
        self, trace_id: str, name: str = "eval", tags: Optional[dict] = None
    ) -> Optional[Span]:
        """Open (or return the already-open) trace for ``trace_id``.
        Idempotent so retry paths — a batch-conflict eval re-entering the
        single path — keep appending to the same tree."""
        if not self._enabled:
            return None
        with self._lock:
            tr = self._active.get(trace_id)
            if tr is None:
                tr = _Trace(
                    trace_id,
                    Span(trace_id, name, tags=tags, clock=self._clock),
                )
                self._active[trace_id] = tr
            elif tags:
                tr.root.tags.update(tags)
            return tr.root

    def finish(
        self,
        trace_id: str,
        status: str = "ok",
        error: Optional[str] = None,
    ) -> Optional[dict]:
        """Close the trace and hand the completed tree to the recorder.
        No-op when the trace is unknown (already finished on another
        path, or tracing was off at dequeue)."""
        with self._lock:
            tr = self._active.pop(trace_id, None)
        if tr is None:
            return None
        tr.root.finish(status)
        if error is not None:
            tr.root.tags["error"] = error
        trace = {
            "eval_id": trace_id,
            "status": status,
            "started_at": tr.root.start_unix,
            "duration_ms": round(tr.root.duration_ms or 0.0, 4),
            "tags": tr.root.tags,
            "spans": [s.to_dict() for s in list(tr.spans)],
        }
        if self.recorder is not None:
            self.recorder.record(trace)
        return trace

    def active_count(self) -> int:
        with self._lock:
            return len(self._active)

    def dropped_spans(self) -> int:
        with self._lock:
            return self._dropped

    # -- thread-local current span ----------------------------------------
    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def current(self):
        """Top of this thread's span stack: a Span, or an attached
        SpanContext, or None."""
        st = self._stack()
        return st[-1] if st else None

    def current_ctx(self) -> Optional[SpanContext]:
        cur = self.current()
        if cur is None:
            return None
        if isinstance(cur, SpanContext):
            return cur
        return cur.ctx()

    @contextmanager
    def activate(self, trace_id: str):
        """Make ``trace_id``'s root this thread's current span — the
        commit/worker threads wrap per-eval work in this so spans opened
        downstream (submit_plan, plan_apply) parent into the right tree."""
        tr = self._active.get(trace_id)
        if tr is None:
            yield None
            return
        st = self._stack()
        st.append(tr.root)
        try:
            yield tr.root
        finally:
            self._pop(tr.root)

    @contextmanager
    def attach(self, ctx: Optional[SpanContext]):
        """Adopt a SpanContext from another thread as the current span
        (the applier thread attaches the worker's submit-plan context)."""
        if ctx is None or not self._enabled:
            yield None
            return
        st = self._stack()
        st.append(ctx)
        try:
            yield ctx
        finally:
            self._pop(ctx)

    def _pop(self, item) -> None:
        st = self._stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i] is item:
                del st[i]
                return

    # -- spans -------------------------------------------------------------
    @contextmanager
    def span(
        self,
        name: str,
        *,
        parent=None,
        tags: Optional[dict] = None,
        timer: Optional[str] = None,
    ):
        """Time a block as a child span of ``parent`` (default: this
        thread's current span). Yields the Span, or None when no trace is
        active — callers never branch on tracing state. ``timer`` names a
        legacy metrics sample fed unconditionally, tracing on or off."""
        t0 = time.perf_counter()
        sp = self._open(name, parent, tags)
        try:
            yield sp
        except BaseException:
            if sp is not None:
                sp.status = "error"
            raise
        finally:
            dt = time.perf_counter() - t0
            if timer is not None:
                global_metrics.measure(timer, dt)
            if sp is not None:
                sp.duration_ms = dt * 1000.0
                self._pop(sp)

    def _open(self, name, parent, tags) -> Optional[Span]:
        if not self._enabled:
            return None
        if parent is None:
            parent = self.current()
        if parent is None:
            return None
        tr = self._active.get(parent.trace_id)
        if tr is None:
            # trace already finished (late span after ack) — account it
            with self._lock:
                self._dropped += 1
            return None
        sp = Span(
            tr.trace_id, name, parent_id=parent.span_id, tags=tags,
            clock=self._clock,
        )
        tr.spans.append(sp)
        self._stack().append(sp)
        return sp

    def add_span(
        self,
        trace_id: str,
        name: str,
        duration_s: float,
        *,
        parent=None,
        tags: Optional[dict] = None,
    ) -> Optional[Span]:
        """Record an already-measured interval into a trace: the broker
        dequeue (measured before any eval id existed) and batch-shared
        phases (one device pass recorded into each member's tree)."""
        if not self._enabled:
            return None
        tr = self._active.get(trace_id)
        if tr is None:
            with self._lock:
                self._dropped += 1
            return None
        pid = parent.span_id if parent is not None else tr.root.span_id
        sp = Span(trace_id, name, parent_id=pid, tags=tags, clock=self._clock)
        sp.start_unix -= duration_s
        sp.duration_ms = duration_s * 1000.0
        tr.spans.append(sp)
        return sp

    def record_kernel(
        self,
        name: str,
        seconds: float,
        *,
        traced: bool = False,
        shape: Optional[str] = None,
    ) -> Optional[Span]:
        """Attach one jit-kernel call as a child of the calling thread's
        current span (utils/backend hands every traced_jit call here)."""
        cur = self.current()
        if cur is None:
            return None
        tags: dict = {"traced": traced}
        if shape:
            tags["shape"] = shape
        return self.add_span(
            cur.trace_id,
            f"kernel:{name}",
            seconds,
            parent=cur,
            tags=tags,
        )


global_tracer = Tracer()
