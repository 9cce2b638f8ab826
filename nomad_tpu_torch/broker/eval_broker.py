"""EvalBroker — leader-side at-least-once priority queue of evaluations.

Reference: nomad/eval_broker.go (:47-105 EvalBroker, :182 Enqueue, blocking
Dequeue with per-scheduler-type ready queues, Ack/Nack with unack tracking,
nack redelivery with delay, DeliveryLimit → _failed queue, delayheap for
WaitUntil evals, per-job serialization: at most one eval per job in flight,
later ones deferred until the outstanding one is acked).
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
import uuid
import zlib
from typing import Optional

from ..chaos.plane import chaos_site
from ..structs import Evaluation
from ..structs.evaluation import EVAL_DELIVERY_LIMIT

FAILED_QUEUE = "_failed"
DEFAULT_NACK_DELAY = 5.0
DEFAULT_INITIAL_NACK_DELAY = 1.0
# redelivery deadline for dequeued-but-unacked evals: a worker that dies
# mid-eval (crash, hung commit) would otherwise strand its evals — and,
# through per-job serialization, every later eval of the same jobs —
# forever. Sized well past the worker's longest internal wait (the 30 s
# plan future timeout) so slow-but-alive workers don't double-deliver.
DEFAULT_UNACK_TIMEOUT = 60.0


class _PQ:
    """Priority queue: higher eval priority first, FIFO within priority."""

    def __init__(self):
        self._h: list[tuple] = []
        self._c = itertools.count()

    def push(self, ev: Evaluation) -> None:
        heapq.heappush(self._h, (-ev.priority, next(self._c), ev))

    def pop(self) -> Optional[Evaluation]:
        if not self._h:
            return None
        return heapq.heappop(self._h)[2]

    def peek(self) -> Optional[Evaluation]:
        return self._h[0][2] if self._h else None

    def __len__(self):
        return len(self._h)


class EvalBroker:
    def __init__(
        self,
        nack_delay: float = DEFAULT_NACK_DELAY,
        initial_nack_delay: float = DEFAULT_INITIAL_NACK_DELAY,
        delivery_limit: int = EVAL_DELIVERY_LIMIT,
        n_partitions: int = 1,
        unack_timeout: Optional[float] = DEFAULT_UNACK_TIMEOUT,
        clock=None,
        admission=None,
    ):
        self._lock = threading.Condition()
        self.enabled = False
        # overload gate (server/admission.py AdmissionController, set by
        # the composition root): consulted on every enqueue with the
        # backlog depth the broker already holds, so over-watermark
        # external evals park on the delayed heap instead of piling
        # into ready. None (unit tests, standalone brokers) = no gate.
        self.admission = admission
        # injectable wall clock (the GenericScheduler clock= pattern,
        # NTA008): delay-heap firing times and unack redelivery
        # deadlines all read it, so chaos clock-skew faults reach the
        # broker's time-based behavior
        self._clock = clock if clock is not None else time.time
        self.nack_delay = nack_delay
        self.initial_nack_delay = initial_nack_delay
        self.delivery_limit = delivery_limit
        # None disables the redelivery deadline (tests that hold evals
        # outstanding across arbitrary debugger pauses)
        self.unack_timeout = unack_timeout
        # Eval-stream partitioning for CONCURRENT batching workers: each
        # eval's job hashes onto one of n_partitions sub-queues, and a
        # batching worker dequeues only its own partition — two batched
        # passes therefore never carry evals of the same job set, and
        # with per-worker lane striping (decorrelate_salt) they rarely
        # share hot nodes. n_partitions=1 keeps the original single
        # ready-queue-per-type behavior.
        self.n_partitions = max(1, n_partitions)
        # scheduler type (or "type#pN" when partitioned) → ready queue
        self._ready: dict[str, _PQ] = {}
        # eval id → (eval, token, redelivery deadline) while unacked
        self._unack: dict[str, tuple[Evaluation, str, float]] = {}
        # (ns, job id) → deferred evals waiting for the in-flight one
        self._pending_by_job: dict[tuple[str, str], _PQ] = {}
        self._in_flight_jobs: set[tuple[str, str]] = set()
        # delayed: (fire_time, seq, eval, type) heap for WaitUntil + nacks
        self._delayed: list[tuple] = []
        self._seq = itertools.count()
        self._delivery_count: dict[str, int] = {}
        # queue-wait attribution for the trace layer: eval id → wall clock
        # of first readiness, converted at dequeue into a wait the worker
        # collects via take_queue_wait() for the dequeue span's tags
        self._enqueued_at: dict[str, float] = {}
        self._queue_waits: dict[str, float] = {}
        self.stats = {
            "total_ready": 0,
            "total_unacked": 0,
            "total_blocked_on_job": 0,
            "total_waiting": 0,
            "total_failed": 0,
        }
        # at-least-once conservation ledger (chaos invariant: every
        # dequeue resolves as exactly one ack, nack, or unack timeout)
        self.counters = {
            "enqueues": 0,
            "dequeues": 0,
            "acks": 0,
            "nacks": 0,
            "unack_timeouts": 0,
            "admission_deferred": 0,
            "chaos_dup_enqueues": 0,
            "chaos_dropped_deliveries": 0,
        }

    # -- lifecycle ---------------------------------------------------------
    def set_enabled(self, enabled: bool) -> None:
        with self._lock:
            self.enabled = enabled
            if not enabled:
                self._ready.clear()
                self._unack.clear()
                self._pending_by_job.clear()
                self._in_flight_jobs.clear()
                self._delayed.clear()
                self._delivery_count.clear()
                self._enqueued_at.clear()
                self._queue_waits.clear()
            self._lock.notify_all()

    # -- enqueue -----------------------------------------------------------
    def enqueue(self, ev: Evaluation) -> None:
        with self._lock:
            self._enqueue_locked(ev)
            self._lock.notify_all()

    def enqueue_all(self, evals: list[Evaluation]) -> None:
        with self._lock:
            for ev in evals:
                self._enqueue_locked(ev)
            self._lock.notify_all()

    def _enqueue_locked(self, ev: Evaluation, ignore_job_gate: bool = False) -> None:
        if not self.enabled:
            return
        self.counters["enqueues"] += 1
        now = self._clock()
        if ev.wait_until_unix and ev.wait_until_unix > now:
            heapq.heappush(
                self._delayed, (ev.wait_until_unix, next(self._seq), ev)
            )
            return
        # stamp first readiness (delayed evals stamp when they fire; the
        # job-gate defer still counts — that IS queue wait for the job)
        self._enqueued_at.setdefault(ev.id, now)
        # per-priority admission watermarks: past the brownout point,
        # externally-submitted evals whose tier watermark is below the
        # active backlog park on the delayed heap and re-decide when
        # they fire (each pass is one conservation-counted decision).
        # Liveness traffic is exempt inside the gate; a committed eval
        # is only ever DEFERRED here, never dropped (law 7).
        adm = self.admission
        if adm is not None:
            backlog = len(self._unack) + sum(
                len(q) for t, q in self._ready.items() if t != FAILED_QUEUE
            )
            delay = adm.gate_enqueue(ev, backlog)
            if delay is not None:
                self.counters["admission_deferred"] += 1
                heapq.heappush(self._delayed, (now + delay, next(self._seq), ev))
                return
        job_key = (ev.namespace, ev.job_id)
        if not ignore_job_gate and job_key in self._in_flight_jobs:
            self._pending_by_job.setdefault(job_key, _PQ()).push(ev)
            return
        self._ready.setdefault(self._queue_key(ev), _PQ()).push(ev)
        from ..utils.metrics import global_metrics

        global_metrics.set_gauge(
            "nomad.broker.total_ready",
            sum(len(q) for t, q in self._ready.items() if t != FAILED_QUEUE),
        )

    def _drain_delayed_locked(self) -> float:
        """Move due delayed evals to ready; return seconds to next firing."""
        now = self._clock()
        wait = 3600.0
        while self._delayed:
            fire, _, ev = self._delayed[0]
            if fire <= now:
                heapq.heappop(self._delayed)
                ev2 = ev
                ev2.wait_until_unix = 0.0
                self._enqueue_locked(ev2)
            else:
                wait = fire - now
                break
        # redelivery deadline sweep: evals whose dequeuing worker never
        # acked or nacked within unack_timeout go back through the normal
        # nack path (backoff redelivery, _failed past the delivery limit)
        if self.unack_timeout is not None:
            expired = [
                eid
                for eid, (_ev, _tok, deadline) in self._unack.items()
                if deadline <= now
            ]
            for eid in expired:
                ev, _tok, _deadline = self._unack.pop(eid)
                self._queue_waits.pop(eid, None)
                from ..utils.metrics import global_metrics

                global_metrics.incr("nomad.broker.unack_timeouts")
                self.counters["unack_timeouts"] += 1
                self._redeliver_locked(ev)
            for _ev, _tok, deadline in self._unack.values():
                wait = min(wait, max(deadline - now, 0.001))
        return wait

    # -- dequeue -----------------------------------------------------------
    def _queue_key(self, ev: Evaluation) -> str:
        if self.n_partitions == 1:
            return ev.type
        part = zlib.crc32(
            f"{ev.namespace}/{ev.job_id}".encode()
        ) % self.n_partitions
        return f"{ev.type}#p{part}"

    def _scan_keys(
        self, schedulers: list[str], partition
    ) -> list[str]:
        """``partition`` may be None (scan everything), a single int, or
        a tuple/list of ints — lane mode hands each batching worker its
        owned lane SET so dequeue is lane-affine by construction."""
        if self.n_partitions == 1:
            return list(schedulers)
        if isinstance(partition, int):
            partition = (partition,)
        keys = []
        for t in schedulers:
            if t == FAILED_QUEUE:
                keys.append(t)  # the failed queue is never partitioned
            elif partition is None:
                keys.extend(
                    f"{t}#p{p}" for p in range(self.n_partitions)
                )
            else:
                keys.extend(
                    f"{t}#p{p % self.n_partitions}" for p in partition
                )
        return keys

    def dequeue(
        self,
        schedulers: list[str],
        timeout: Optional[float] = None,
        partition: Optional[int | tuple[int, ...]] = None,
    ) -> tuple[Optional[Evaluation], str]:
        """Blocking dequeue for the given scheduler types. Returns
        (eval, token) or (None, "") on timeout/disable. ``timeout=None``
        blocks until an eval arrives (the reference's blocking
        Eval.Dequeue RPC, nomad/eval_broker.go); ``timeout=0`` is an
        explicit non-blocking poll. ``partition`` restricts the scan to
        one job-hash partition, or a lane set when given a tuple
        (deterministic lane ownership); None scans every partition."""
        deadline = None if timeout is None else self._clock() + timeout
        keys = self._scan_keys(schedulers, partition)
        with self._lock:
            while True:
                if not self.enabled:
                    return None, ""
                next_delay = self._drain_delayed_locked()
                best: Optional[_PQ] = None
                for t in keys:
                    q = self._ready.get(t)
                    if not q:
                        continue
                    # defer ready evals whose job already has one in flight
                    # (per-job serialization also applies to evals enqueued
                    # before the first one was dequeued)
                    while len(q):
                        cand = q.peek()
                        job_key = (cand.namespace, cand.job_id)
                        if job_key in self._in_flight_jobs:
                            q.pop()
                            self._pending_by_job.setdefault(job_key, _PQ()).push(
                                cand
                            )
                            continue
                        break
                    if len(q):
                        cand = q.peek()
                        if best is None or cand.priority > best.peek().priority:
                            best = q
                if best is not None:
                    ev = best.pop()
                    token = str(uuid.uuid4())
                    deadline = (
                        self._clock() + self.unack_timeout
                        if self.unack_timeout is not None
                        else float("inf")
                    )
                    self._unack[ev.id] = (ev, token, deadline)
                    self._in_flight_jobs.add((ev.namespace, ev.job_id))
                    self._delivery_count[ev.id] = (
                        self._delivery_count.get(ev.id, 0) + 1
                    )
                    self.counters["dequeues"] += 1
                    t_ready = self._enqueued_at.pop(ev.id, None)
                    if t_ready is not None:
                        self._queue_waits[ev.id] = self._clock() - t_ready
                    if chaos_site("broker.dequeue") == "drop":
                        # delivered-but-lost: the eval is charged as a
                        # dequeue and sits unacked, so the redelivery
                        # deadline sweep must hand it out exactly once
                        # more — the caller sees an empty poll
                        self.counters["chaos_dropped_deliveries"] += 1
                        self._queue_waits.pop(ev.id, None)
                        return None, ""
                    return ev, token
                if deadline is None:
                    self._lock.wait(min(next_delay, 1.0))
                    continue
                remaining = deadline - self._clock()
                if remaining <= 0:
                    return None, ""
                self._lock.wait(min(remaining, next_delay, 1.0))

    def dequeue_many(
        self,
        schedulers: list[str],
        max_n: int,
        timeout: Optional[float] = None,
        partition: Optional[int | tuple[int, ...]] = None,
    ) -> list[tuple[Evaluation, str]]:
        """Dequeue up to ``max_n`` ready evals in one call — the intake of
        the batched multi-eval device pass (SURVEY.md §7 step 5). The
        first eval blocks up to ``timeout``; the rest are taken only if
        immediately ready. Per-job serialization holds: two evals of one
        job can never be in the same batch (or in flight at all)."""
        first = self.dequeue(schedulers, timeout=timeout, partition=partition)
        if first[0] is None:
            return []
        out = [first]
        while len(out) < max_n:
            nxt = self.dequeue(schedulers, timeout=0.0, partition=partition)
            if nxt[0] is None:
                break
            out.append(nxt)
        return out

    # -- ack / nack --------------------------------------------------------
    def _validate(self, eval_id: str, token: str) -> Evaluation:
        entry = self._unack.get(eval_id)
        if entry is None:
            raise ValueError(f"eval {eval_id} not outstanding")
        ev, tok, _deadline = entry
        if tok != token:
            raise ValueError("token mismatch")
        return ev

    def _promote_pending_locked(self, job_key: tuple[str, str]) -> None:
        """Release the next deferred eval for a job whose gate opened."""
        pq = self._pending_by_job.get(job_key)
        if pq is not None and len(pq):
            nxt = pq.pop()
            if not len(pq):
                del self._pending_by_job[job_key]
            self._enqueue_locked(nxt)

    def take_queue_wait(self, eval_id: str) -> float:
        """Pop the ready→dequeue wait recorded for an eval (seconds);
        0.0 when unknown. The dequeuing worker calls this exactly once to
        tag the trace's dequeue span, so the table never accumulates."""
        with self._lock:
            return self._queue_waits.pop(eval_id, 0.0)

    def ack(self, eval_id: str, token: str) -> None:
        # consulted outside the lock: a "delay" here models a *late*
        # ack, which may lose the race against the unack-deadline sweep
        # (the worker then sees ValueError, a swallow site it accounts)
        action = chaos_site("broker.ack")
        if action == "drop":
            # lost ack: the eval stays unacked and the deadline sweep
            # redelivers it — reprocessing must converge to a no-op
            return
        with self._lock:
            ev = self._validate(eval_id, token)
            del self._unack[eval_id]
            self.counters["acks"] += 1
            self._delivery_count.pop(eval_id, None)
            self._queue_waits.pop(eval_id, None)
            job_key = (ev.namespace, ev.job_id)
            self._in_flight_jobs.discard(job_key)
            self._promote_pending_locked(job_key)
            if action == "duplicate":
                # at-least-once duplicate delivery: the acked eval is
                # re-enqueued once (behind the job gate, like any real
                # duplicate) and must reprocess to a no-op
                self.counters["chaos_dup_enqueues"] += 1
                self._enqueue_locked(ev)
            self._lock.notify_all()

    def nack(self, eval_id: str, token: str) -> None:
        """Failed processing: redeliver after a backoff, unless the
        delivery limit is reached — then route to the _failed queue."""
        with self._lock:
            ev = self._validate(eval_id, token)
            del self._unack[eval_id]
            self.counters["nacks"] += 1
            self._queue_waits.pop(eval_id, None)
            self._redeliver_locked(ev)
            self._lock.notify_all()

    def _redeliver_locked(self, ev: Evaluation) -> None:
        """Shared tail of an explicit nack and an unack-deadline expiry:
        release the job gate, then backoff-redeliver or fail out."""
        job_key = (ev.namespace, ev.job_id)
        self._in_flight_jobs.discard(job_key)
        count = self._delivery_count.get(ev.id, 0)
        if count >= self.delivery_limit:
            self._ready.setdefault(FAILED_QUEUE, _PQ()).push(ev)
            # the job's gate is permanently released for this eval —
            # deferred evals must not be stranded behind it
            self._promote_pending_locked(job_key)
        else:
            # attempt-indexed escalation: first redelivery waits
            # initial_nack_delay, each further one doubles, capped at
            # nack_delay — a hot-looping eval (processing-deadline
            # expiry, flapping device) cannot spin dequeue/nack at full
            # broker speed (eval_broker.go computes the same
            # per-attempt wait before re-enqueueing)
            delay = min(
                self.nack_delay,
                self.initial_nack_delay * (2.0 ** max(0, count - 1)),
            )
            from ..utils.metrics import global_metrics

            global_metrics.incr("nomad.broker.nack_redelivery_delayed")
            heapq.heappush(
                self._delayed,
                (self._clock() + delay, next(self._seq), ev),
            )

    # -- introspection -----------------------------------------------------
    def outstanding(self, eval_id: str) -> bool:
        with self._lock:
            return eval_id in self._unack

    def outstanding_token(self, eval_id: str) -> str:
        with self._lock:
            entry = self._unack.get(eval_id)
            return entry[1] if entry else ""

    def ready_count(self) -> int:
        with self._lock:
            return sum(len(q) for t, q in self._ready.items() if t != FAILED_QUEUE)

    def failed_count(self) -> int:
        with self._lock:
            q = self._ready.get(FAILED_QUEUE)
            return len(q) if q else 0

    def failed_eval_ids(self) -> list[str]:
        """Evals parked past the delivery limit (chaos accounting: a
        failed eval explains a job stuck short of its desired count)."""
        with self._lock:
            q = self._ready.get(FAILED_QUEUE)
            return [entry[2].id for entry in q._h] if q else []

    def tracked_eval_ids(self) -> set[str]:
        """Every eval id the broker still holds anywhere — ready
        queues, unacked, delayed heap, or deferred behind a job gate.
        The chaos invariant checker uses this to prove no non-terminal
        eval in the store has been stranded."""
        with self._lock:
            ids: set[str] = set()
            for q in self._ready.values():
                ids.update(entry[2].id for entry in q._h)
            ids.update(self._unack.keys())
            ids.update(entry[2].id for entry in self._delayed)
            for q in self._pending_by_job.values():
                ids.update(entry[2].id for entry in q._h)
            return ids

    def queue_depths(self) -> dict[str, int]:
        """One consistent snapshot of every queue depth (the chaos
        runner's quiesce predicate: all zeros except _failed)."""
        with self._lock:
            return {
                "ready": sum(
                    len(q) for t, q in self._ready.items() if t != FAILED_QUEUE
                ),
                "unacked": len(self._unack),
                "delayed": len(self._delayed),
                "deferred": sum(len(q) for q in self._pending_by_job.values()),
                "failed": len(self._ready.get(FAILED_QUEUE, ())),
            }
