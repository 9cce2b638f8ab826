"""PlanQueue — priority-ordered pending plans with result futures.

Reference: nomad/plan_queue.go (:29-60) and the planApply loop
(nomad/plan_apply.go:71-178), which pipelines: while plan N's Raft commit
is in flight, plan N+1 is already being evaluated against the optimistic
post-N snapshot — worth keeping because evaluation (fit re-check) and
commit (log write) use different resources. Here the applier thread
evaluates the next plan while the store upsert of the previous one
completes asynchronously is a no-op (in-memory store), but the structure
is retained so a durable log can slot in.
"""

from __future__ import annotations

import heapq
import itertools
import logging
import threading
import time
from concurrent.futures import Future
from typing import Optional

from ..chaos.plane import chaos_site
from ..obs.trace import global_tracer as tracer
from ..structs import MergedPlan, Plan, PlanResult
from ..utils.metrics import global_metrics as metrics
from .plan_apply import PlanApplier

log = logging.getLogger(__name__)


class PendingPlan:
    __slots__ = ("plan", "future", "trace_ctx", "enqueued_at")

    def __init__(self, plan: Plan, trace_ctx=None):
        self.plan = plan
        self.future: Future[PlanResult] = Future()
        # the submitting worker's span context rides the queue so the
        # applier thread parents its spans into the right eval trace
        self.trace_ctx = trace_ctx
        self.enqueued_at = time.perf_counter()

    def cancel(self) -> None:
        self.future.cancel()


class PendingMergedPlan:
    """One queue entry for a whole batched pass: B member plans, B result
    futures — the coalesced commit unit the merged-apply path consumes."""

    __slots__ = ("mplan", "futures", "trace_ctxs", "enqueued_at")

    def __init__(self, mplan: MergedPlan, trace_ctxs=None):
        self.mplan = mplan
        self.futures: list[Future] = [Future() for _ in mplan.plans]
        # one span context per member, so the applier thread records the
        # shared merged-apply phases into every member's trace
        self.trace_ctxs = list(trace_ctxs or [None] * len(mplan.plans))
        self.enqueued_at = time.perf_counter()

    def cancel(self) -> None:
        for f in self.futures:
            f.cancel()


class PlanQueue:
    def __init__(self):
        self._lock = threading.Condition()
        self._heap: list[tuple] = []
        self._c = itertools.count()
        self.enabled = False

    def set_enabled(self, enabled: bool) -> None:
        with self._lock:
            self.enabled = enabled
            if not enabled:
                for _, _, pending in self._heap:
                    pending.cancel()
                self._heap.clear()
            self._lock.notify_all()

    def enqueue(self, plan: Plan) -> Future:
        # raise faults here surface on the submitting worker, which
        # must nack the eval back to the broker for redelivery
        chaos_site("plan_queue.enqueue")
        with self._lock:
            if not self.enabled:
                f: Future = Future()
                f.set_exception(RuntimeError("plan queue is disabled"))
                return f
            pending = PendingPlan(plan, trace_ctx=tracer.current_ctx())
            heapq.heappush(self._heap, (-plan.priority, next(self._c), pending))
            metrics.set_gauge("nomad.plan.queue_depth", len(self._heap))
            self._lock.notify_all()
            return pending.future

    def enqueue_merged(
        self, mplan: MergedPlan, trace_ctxs=None
    ) -> list[Future]:
        """Submit a whole batched pass as ONE pending entry; returns one
        result future per member plan, resolved together when the merged
        apply lands."""
        # the caller is the worker's commit thread: a kill fault here is
        # the "crash mid merged-plan submit" scenario — nothing enqueued,
        # the batch's evals stay unacked, the deadline sweep redelivers
        chaos_site("plan_queue.enqueue_merged")
        with self._lock:
            if not self.enabled:
                futures: list[Future] = []
                for _ in mplan.plans:
                    f: Future = Future()
                    f.set_exception(RuntimeError("plan queue is disabled"))
                    futures.append(f)
                return futures
            pending = PendingMergedPlan(mplan, trace_ctxs=trace_ctxs)
            heapq.heappush(
                self._heap, (-mplan.priority, next(self._c), pending)
            )
            metrics.set_gauge("nomad.plan.queue_depth", len(self._heap))
            self._lock.notify_all()
            return pending.futures

    def pop(self, timeout: float = 1.0) -> Optional[PendingPlan]:
        with self._lock:
            if not self._heap:
                self._lock.wait(timeout)
            if not self._heap:
                return None
            return heapq.heappop(self._heap)[2]

    def depth(self) -> int:
        with self._lock:
            return len(self._heap)


class PlanApplyLoop:
    """The leader's serialized applier thread (plan_apply.go:71-178)."""

    def __init__(self, store, queue: PlanQueue, on_evals_created=None,
                 commit=None, commit_merged=None, lanes=None,
                 token_check=None):
        self.applier = PlanApplier(
            store, on_evals_created=on_evals_created, commit=commit,
            commit_merged=commit_merged, lanes=lanes,
            token_check=token_check,
        )
        self.queue = queue
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="plan-apply", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)

    def _run(self) -> None:
        while not self._stop.is_set():
            pending = self.queue.pop(timeout=0.2)
            if pending is None:
                continue
            if isinstance(pending, PendingMergedPlan):
                self._apply_merged(pending)
                continue
            ctx = pending.trace_ctx
            if ctx is not None:
                tracer.add_span(
                    ctx.trace_id,
                    "plan_queue.wait",
                    time.perf_counter() - pending.enqueued_at,
                    parent=ctx,
                )
            try:
                # cross-thread adoption: plan_apply spans below parent
                # under the worker's submit_plan span
                with tracer.attach(ctx):
                    result = self.applier.apply(pending.plan)
                pending.future.set_result(result)
            except Exception as e:  # noqa: BLE001 — propagate to waiter
                pending.future.set_exception(e)

    def _apply_merged(self, pending: PendingMergedPlan) -> None:
        """Apply one merged batch and resolve every member future; the
        shared queue-wait and apply phases are recorded into each
        member's trace (the batch-wide ``shared`` span convention)."""
        wait_s = time.perf_counter() - pending.enqueued_at
        mplan = pending.mplan
        try:
            results, timings = self.applier.apply_merged(mplan)
        except Exception as e:  # noqa: BLE001 — propagate to waiters
            log.exception("merged plan apply failed (%d members)",
                          len(mplan.plans))
            for f in pending.futures:
                if not f.done():
                    f.set_exception(e)
            return
        n = len(mplan.plans)
        for mp, res, fut, ctx in zip(
            mplan.plans, results, pending.futures, pending.trace_ctxs
        ):
            if ctx is not None:
                eid = mp.eval_id
                tracer.add_span(
                    eid, "plan_queue.wait", wait_s,
                    parent=ctx, tags={"shared": True},
                )
                sp = tracer.add_span(
                    eid, "plan_apply", timings["apply_s"], parent=ctx,
                    tags={
                        "shared": True,
                        "members": n,
                        "rejected_nodes": len(res.rejected_nodes),
                    },
                )
                if sp is not None:
                    tracer.add_span(
                        eid, "plan_apply.evaluate", timings["evaluate_s"],
                        parent=sp, tags={"shared": True},
                    )
                    tracer.add_span(
                        eid, "plan_apply.commit", timings["commit_s"],
                        parent=sp, tags={"shared": True},
                    )
            fut.set_result(res)
