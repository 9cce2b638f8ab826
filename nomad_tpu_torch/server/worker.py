"""Worker — the scheduling worker loop.

Reference: nomad/worker.go — run (:385-432): dequeue an eval, wait for the
state store to catch up to the eval's index (snapshotMinIndex :536-549),
invoke the scheduler on a snapshot (:552-581), ack on success / nack on
failure (:818-838). The worker is also the scheduler's Planner: SubmitPlan
(:585-652) attaches the eval token + snapshot index, submits to the plan
queue, waits the future, and on a RefreshIndex result hands the scheduler
a fresher snapshot.

The accelerator twist (SURVEY.md §2.7): one worker drives a *batched* device pass,
so a single worker replaces N CPU-bound Go workers for placement; multiple
workers still make sense to overlap host-side reconcile/flatten work.

Pipelining (the plan_apply.go:49-69 analog): the device pass for batch
k+1 overlaps the host-side COMMIT of batch k. The worker hands each
finished pass to a commit thread and immediately dequeues + prepares the
next one; the next pass scores against an OPTIMISTIC usage overlay (the
previous pass's placements, not yet committed), exactly how the
reference's applier evaluates plan N+1 against the optimistic post-N
snapshot. The serialized plan applier remains the authority — an overlay
mis-guess surfaces as a partial commit and an individual retry.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

import numpy as np

from ..broker.plan_apply import PlanTokenMismatch
from ..chaos.plane import ChaosThreadKill, chaos_site
from ..obs.trace import global_tracer as tracer
from ..resilience.errors import EvalDeadlineExceeded
from ..scheduler import new_scheduler
from ..structs import Evaluation, MergedPlan, Plan
from ..structs.evaluation import EVAL_STATUS_FAILED
from ..utils.metrics import count_swallowed
from ..utils.metrics import global_metrics as metrics

log = logging.getLogger("nomad_tpu_torch.worker")

# the core GC scheduler ("_core") comes with core_gc.py (ROADMAP A9b)
SCHEDULER_TYPES = ["service", "batch", "system", "sysbatch"]

# evals packed into one batched device pass (SURVEY.md §7 step 5): the
# batch dimension of the placement kernel replaces the reference's
# worker-per-core concurrency (nomad/config.go:468). Each eval still
# submits its own plan; the serialized applier resolves conflicts exactly
# as it does for the reference's parallel workers. Sized so a burst of
# registrations drains in a handful of passes — each pass costs ~2 host↔device
# round trips regardless of depth, and lane decorrelation + host repair
# keep wide batches conflict-free.
#
# Workers 0..num_batch_workers-1 run batched passes, each on a disjoint
# JOB-HASH PARTITION of the eval stream (broker n_partitions), a disjoint
# hashed NODE UNIVERSE, and its own lane-stripe salt — r3 measured a
# 0.46 conflict rate with two batching workers sharing one stream;
# partitioning removes the shared hot set (measured 6.8× single-worker
# eval throughput with conflict 0 at the 8-deep repro shape). Remaining
# workers drain solo evals through the same shared optimistic overlay.
#
# Concurrency caveat, measured honestly: on a SINGLE-core host at the
# 10k-node config-3 shape, any second worker (solo or batching) races
# the pipelined commits under CPU starvation and conflict rates swing
# run-to-run (0.0–0.96); one pipelined batching worker is bit-stable
# there (conflict 0.0 across every instrumented run). The bench pins
# num_workers=1 for reproducibility; multi-worker batching is for
# multi-core servers.
#
# Depth 16 beats 64 on BOTH axes with the single pipelined worker at
# the config-3 shape (true-CPU A/B: 5.5 vs 4.7 evals/s and invoke p99
# 2.7 s vs 9.0 s, conflict 0.0 in every run): the pipeline hides the
# extra pass dispatches while smaller passes commit sooner and cap the
# p99 at one-quarter the device time.
EVAL_BATCH_SIZE = 16


class _EvalBuffer:
    """Deferred eval writes for one batch commit. Every member's
    finalize-time status update (and followup/blocked eval creates)
    coalesces into ONE raft apply per flush instead of one per eval —
    the eval-side analog of the merged plan commit."""

    def __init__(self, server):
        self._server = server
        self.updates: list[Evaluation] = []
        self.creates: list[Evaluation] = []

    def flush(self) -> None:
        creates, self.creates = self.creates, []
        if creates:
            self._server.apply_eval_create(creates)
        updates, self.updates = self.updates, []
        if updates:
            self._server.apply_eval_update(updates)


class _TokenPlanner:
    """Planner bound to ONE eval's broker token. Batch completion runs on
    the commit thread concurrently with the next pass's prepare, so the
    token cannot live as mutable worker state (worker.go keeps it as
    per-worker state because its workers are strictly serial)."""

    def __init__(self, worker: "Worker", token: str):
        self._worker = worker
        self.token = token
        # when the commit thread sets this, eval writes buffer for a
        # batch-wide flush instead of raft-applying one at a time
        self.buffer: Optional[_EvalBuffer] = None
        # absolute processing deadline (worker clock) set at dequeue by
        # Worker._planner; None = no deadline (direct callers)
        self.deadline: Optional[float] = None

    def check_deadline(self, eval_id: str = "") -> None:
        """Raise EvalDeadlineExceeded once this eval's processing pass
        has outlived the server's eval_deadline — checked at the plan
        submission boundary and before each commit-thread build, the
        two places a pass commits to more expensive work."""
        if self.deadline is not None and self._worker._clock() > self.deadline:
            raise EvalDeadlineExceeded(
                eval_id, self._worker._eval_deadline or 0.0
            )

    def submit_plan(self, plan: Plan):
        self.check_deadline(plan.eval_id)
        plan.eval_token = self.token
        plan.normalize()
        server = self._worker.server
        # the enqueue captures this span's context onto the pending plan,
        # so the applier thread's plan_apply spans parent under it
        with tracer.span(
            "submit_plan", timer="nomad.worker.submit_plan"
        ) as sp:
            future = server.plan_queue.enqueue(plan)
            result = future.result(timeout=30)
            if sp is not None:
                sp.tags["rejected_nodes"] = len(result.rejected_nodes)
        new_snapshot = None
        if result.refresh_index:
            with tracer.span(
                "refresh_snapshot",
                tags={"refresh_index": result.refresh_index},
            ):
                server.store.wait_for_index(result.refresh_index, timeout=5.0)
                new_snapshot = server.store.snapshot()
        return result, new_snapshot

    def update_eval(self, ev: Evaluation) -> None:
        if self.buffer is not None:
            self.buffer.updates.append(ev)
            return
        self._worker.server.apply_eval_update([ev])

    def create_eval(self, ev: Evaluation) -> None:
        if self.buffer is not None:
            self.buffer.creates.append(ev)
            return
        self._worker.server.apply_eval_create([ev])

    def reblock_eval(self, ev: Evaluation) -> None:
        self._worker.server.eval_broker.enqueue(ev)


class Worker:
    # class-level defaults so partially-constructed workers (tests build
    # them via __new__) still plan without an eval deadline
    _eval_deadline: Optional[float] = None
    _eval_attempt_limit: int = 3
    _clock = staticmethod(time.time)

    def __init__(self, server, worker_id: int = 0, schedulers=None):
        self.server = server
        self.id = worker_id
        self.schedulers = schedulers or SCHEDULER_TYPES
        self._stop = threading.Event()
        self._paused = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # the commit thread and the worker thread both account evals —
        # bare dict increments would lose counts across the interleave
        self.stats = {"processed": 0, "acked": 0, "nacked": 0}
        self._stats_lock = threading.Lock()
        # Pipelining state (batch worker only): this worker's in-flight
        # commit thread. Optimistic usage accounting lives in the
        # SERVER-SHARED overlay (server/overlay.py) so concurrent
        # batching workers see each other's in-flight placements too.
        self._commit_thread: Optional[threading.Thread] = None
        # perf_counter stamp the commit thread writes in its finally;
        # the next pass's join site reads it to account how much of the
        # commit's wall time genuinely overlapped device work
        self._commit_done_at: float = 0.0
        # eval-lifecycle deadlines (resilience layer): the injectable
        # cluster clock when configured, else wall time
        cfg = getattr(server, "config", None)
        clock = getattr(cfg, "clock", None)
        self._clock = clock.time if clock is not None else time.time
        deadline = getattr(cfg, "eval_deadline", 0.0) or 0.0
        self._eval_deadline: Optional[float] = (
            deadline if deadline > 0 else None
        )
        self._eval_attempt_limit: int = getattr(cfg, "eval_attempt_limit", 3)

    def _planner(self, token: str) -> _TokenPlanner:
        p = _TokenPlanner(self, token)
        if self._eval_deadline is not None:
            p.deadline = self._clock() + self._eval_deadline
        return p

    # -- lane plumbing -----------------------------------------------------
    def _lane_mode(self) -> bool:
        """Deterministic lane ownership is active only with >1 batching
        worker; at 1 every path below reduces to the legacy behavior."""
        return getattr(self.server, "lane_mode", False)

    def _my_overlay(self):
        """This worker's epoch overlay. In lane mode each batching
        worker scores against (and writes deltas into) its OWN overlay;
        solo workers — and everything at num_batch_workers=1 — use the
        legacy shared view (LaneOverlays delegates it to worker 0)."""
        ov = self.server.placement_overlay
        for_worker = getattr(ov, "for_worker", None)
        n_batchers = getattr(self.server.config, "num_batch_workers", 1)
        if for_worker is not None and n_batchers > 1 and self.id < n_batchers:
            return for_worker(self.id)
        return ov

    def _rebase_lanes(self, overlay) -> None:
        """An overlay epoch reset (or a fresh epoch) means this worker's
        next snapshot includes every committed cross-lane handoff onto
        its nodes — unblock them."""
        claims = getattr(self.server, "lane_claims", None)
        if claims is not None and self._lane_mode():
            if overlay.is_fresh():
                claims.clear_settled(self.id)

    def _lane_node_filter(self, ct) -> np.ndarray:
        """Eligibility mask for a batch worker's SOLO fallback in lane
        mode: own lanes only, minus claim-blocked nodes. The batched
        path scores the full cluster and hands off cross-lane winners;
        the solo fallback has no handoff step, so it stays home — a
        shortfall becomes a blocked eval, never a foreign-node write."""
        claims = self.server.lane_claims
        blocked = claims.blocked_node_ids()
        lanes = self.server.lanes
        mask = np.zeros(ct.padded_n, dtype=bool)
        for i, node in enumerate(ct.nodes):
            mask[i] = (
                lanes.owner_of_node(node.id) == self.id
                and node.id not in blocked
            )
        return mask

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(
            target=self.run, name=f"worker-{self.id}", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
        self._join_commit(timeout=5)

    def pause(self) -> None:
        """Leader pauses half its workers (nomad/leader.go:231-233)."""
        self._paused.set()

    def resume(self) -> None:
        self._paused.clear()

    def _bump(self, *keys: str) -> None:
        with self._stats_lock:
            for k in keys:
                self.stats[k] += 1

    def _join_commit(self, timeout: float = 60.0) -> None:
        t = self._commit_thread
        if t is not None:
            t.join(timeout=timeout)
            self._commit_thread = None

    # -- main loop ---------------------------------------------------------
    def run(self) -> None:
        while not self._stop.is_set():
            if self._paused.is_set():
                self._join_commit()
                self._stop.wait(0.1)
                continue
            n_batchers = getattr(self.server.config, "num_batch_workers", 1)
            batching = self.id < n_batchers
            lane_mode = batching and self._lane_mode()
            # Lane-affine dequeue: a batching worker scans exactly the
            # lane set it owns (the broker partitions by the SAME job
            # hash LaneMap uses, so partition keys ARE lanes); solo
            # workers scan everything, but in lane mode they must not
            # steal service/batch evals from their lane owners — they
            # drain only the solo-native types.
            scan_types = self.schedulers
            if self._lane_mode() and not batching:
                scan_types = [
                    t for t in self.schedulers
                    if t not in ("service", "batch")
                ]
            # pre-trace interval: no eval (hence no trace) exists until the
            # dequeue returns — the sample feeds /v1/metrics directly and
            # the span is attached retroactively per dequeued eval below
            # brownout lever: past the brownout point the batch worker
            # widens its dequeue window (bigger batch, longer wait) so
            # each device pass amortizes more evals instead of
            # thrashing small kernel invocations; NORMAL keeps the
            # baseline 16/0.2 exactly.
            max_n, deq_timeout = EVAL_BATCH_SIZE if batching else 1, 0.2
            adm = getattr(self.server, "admission", None)
            if adm is not None and batching:
                max_n, deq_timeout = adm.batch_params(max_n, deq_timeout)
            t0 = time.perf_counter()
            batch = self.server.eval_broker.dequeue_many(
                scan_types,
                max_n,
                timeout=deq_timeout,
                partition=(
                    self.server.lanes.lanes_of_worker(self.id)
                    if lane_mode
                    else None
                ),
            )
            dequeue_s = time.perf_counter() - t0
            metrics.measure("nomad.worker.dequeue_eval", dequeue_s)
            if not batch:
                self._join_commit()
                if lane_mode:
                    # idle is the rebase point: drop a drained epoch and
                    # unblock any handoff-settled nodes (the next
                    # snapshot includes those committed placements)
                    ov = self._my_overlay()
                    if ov.maybe_reset():
                        metrics.incr("nomad.worker.pipeline_epoch_resets")
                    self._rebase_lanes(ov)
                continue
            for ev, _token in batch:
                queue_wait = self.server.eval_broker.take_queue_wait(ev.id)
                root = tracer.begin(
                    ev.id,
                    tags={
                        "job_id": ev.job_id,
                        "namespace": ev.namespace,
                        "type": ev.type,
                        "triggered_by": ev.triggered_by,
                        "priority": ev.priority,
                        "worker": self.id,
                        "batch_size": len(batch),
                    },
                )
                if root is not None:
                    tracer.add_span(
                        ev.id,
                        "dequeue",
                        dequeue_s,
                        tags={
                            "queue_wait_ms": round(queue_wait * 1000.0, 3),
                            "shared": len(batch) > 1,
                        },
                    )
            try:
                if len(batch) == 1 and not lane_mode:
                    # batch accounting reconciliation: evals dequeued solo
                    # never enter a batched pass at all
                    metrics.incr("nomad.worker.solo_evals")
                    self._run_one(*batch[0])
                else:
                    # in lane mode even a batch of one goes through the
                    # batched pass: byte-identity with the 1-worker
                    # reference requires every service/batch eval to
                    # take the SAME code path (same salt, same overlay,
                    # same merged-commit route) regardless of load
                    self._run_batch(batch)
            except Exception as e:
                # a worker thread must never die silently: dequeued evals
                # would stay unacked forever and per-job serialization
                # would wedge those jobs (the broker has no redelivery
                # deadline). Nack everything still outstanding.
                log.exception("worker %d: batch failed", self.id)
                count_swallowed("worker", e)
                for ev, token in batch:
                    try:
                        self.server.eval_broker.nack(ev.id, token)
                        self._bump("nacked")
                    except ValueError as e2:
                        count_swallowed("worker", e2)  # already acked/nacked
                    tracer.finish(ev.id, status="nacked", error=repr(e))
        self._join_commit()

    def _run_one(self, ev: Evaluation, token: str) -> None:
        planner = self._planner(token)
        # idempotent: run() already opened the trace for dequeued evals;
        # this covers direct callers (tests, batch single-path fallbacks
        # keep appending to the tree they started in)
        tracer.begin(ev.id, tags={"job_id": ev.job_id, "type": ev.type})
        try:
            with tracer.activate(ev.id):
                self.process_eval(ev, planner)
            self.server.eval_broker.ack(ev.id, token)
            self._bump("acked")
            tracer.finish(ev.id, status="acked")
        except EvalDeadlineExceeded as e:
            self._deadline_nack(ev, token, e)
            return  # _deadline_nack did all the accounting
        except PlanTokenMismatch:
            # the unack deadline redelivered this eval mid-flight: the
            # redelivered copy owns it now. Drop — no ack/nack (our token
            # is already dead at the broker) and no retry (retrying would
            # race the new owner into exactly the double-commit the token
            # guard exists to prevent).
            metrics.incr("nomad.worker.stale_token_drops")
            self._bump("processed")
            tracer.finish(ev.id, status="stale_token")
            return
        except Exception as e:
            log.exception("worker %d: eval %s failed", self.id, ev.id)
            count_swallowed("worker", e)
            try:
                self.server.eval_broker.nack(ev.id, token)
            except ValueError as e2:
                count_swallowed("worker", e2)
            self._bump("nacked", "processed")
            tracer.finish(ev.id, status="nacked", error=repr(e))
        # per-eval counter: the invoke_scheduler TIMER emits one sample per
        # batched pass, so throughput accounting reads this counter instead
        metrics.incr("nomad.worker.evals_processed")

    def _run_batch(self, batch: list[tuple[Evaluation, str]]) -> None:
        """Run a batch of evals through one combined device pass, then
        hand the commit to the pipeline thread and return — the NEXT
        pass's prepare + device time overlaps this pass's commit."""
        # Reap a finished commit thread and (only when NOTHING is in
        # flight anywhere) reset the shared overlay epoch — strictly
        # BEFORE the snapshot, so the snapshot taken next is guaranteed
        # to include everything the dropped overlay was predicting
        # (resetting from the commit thread let the next pass freeze a
        # pre-commit base and cascade into applier rejections).
        commit_alive_at_start = (
            self._commit_thread is not None
            and self._commit_thread.is_alive()
        )
        t_pass0 = time.perf_counter()
        if self._commit_thread is not None and (
            not self._commit_thread.is_alive()
        ):
            self._join_commit()
        overlay = self._my_overlay()
        if overlay.maybe_reset():
            metrics.incr("nomad.worker.pipeline_epoch_resets")
        lane_mode = self._lane_mode()
        if lane_mode:
            # a fresh epoch rebases this worker onto the committed
            # store — any nodes settled by peers' handoffs unblock now
            self._rebase_lanes(overlay)
        t0 = time.perf_counter()
        self.server.store.wait_for_index(
            max(ev.modify_index for ev, _ in batch), timeout=5.0
        )
        wfi_s = time.perf_counter() - t0
        metrics.measure("nomad.worker.wait_for_index", wfi_s)
        t0 = time.perf_counter()
        snapshot = self.server.store.snapshot()
        # One ClusterTensors for the WHOLE batch: if each scheduler fetched
        # its own, a concurrent worker advancing the cache generation
        # mid-batch would hand later schedulers a transient build whose row
        # order differs (sorted-by-id vs incremental append) — their masks
        # would silently misalign with the capacity/used arrays in the
        # combined kernel call.
        ct = self.server.device_cache.tensors(snapshot)
        snap_s = time.perf_counter() - t0
        # shared phases happen once for the whole batch; record the same
        # interval into every member's trace, tagged shared
        for ev, _tok in batch:
            tracer.add_span(ev.id, "wait_for_index", wfi_s, tags={"shared": True})
            tracer.add_span(ev.id, "snapshot", snap_s, tags={"shared": True})

        prepared = []  # (ev, token, sched, n_asks)
        all_asks: list = []
        lane_groups: list[int] = []  # lane -> eval ordinal (for repair)
        singles: list[tuple[Evaluation, str]] = []
        for ev, token in batch:
            if ev.type not in ("service", "batch"):
                singles.append((ev, token))
                continue
            sched = new_scheduler(
                ev.type,
                snapshot,
                self._planner(token),
                cache=self.server.device_cache,
                overlay=overlay,
            )
            t0 = time.perf_counter()
            try:
                asks = sched.prepare_batch_attempt(ev, ct=ct)
            except Exception as e:
                log.exception("worker %d: batch prepare %s", self.id, ev.id)
                count_swallowed("worker", e)
                asks = None
                singles.append((ev, token))
                continue
            tracer.add_span(ev.id, "prepare", time.perf_counter() - t0)
            if asks is None:
                singles.append((ev, token))
            else:
                assert sched._batch_ctx[0] is ct
                lane_groups.extend([len(prepared)] * len(asks))
                prepared.append((ev, token, sched, len(asks)))
                all_asks.extend(asks)

        results = None
        lane_ok: list[bool] = []
        if all_asks:
            if lane_mode:
                # mask out claim-blocked nodes: a peer's handoff is in
                # flight on them (or their owner has not yet rebased a
                # committed one) — scoring them would race the claim.
                # Everything ELSE stays scorable: lane mode scores the
                # FULL cluster and hands off foreign winners, because
                # restricting each worker to its own lanes would change
                # placements vs the 1-worker reference.
                blocked = self.server.lane_claims.blocked_node_ids()
                if blocked:
                    rows = [
                        ct.node_row[n] for n in blocked if n in ct.node_row
                    ]
                    if rows:
                        for a in all_asks:
                            a.eligible[rows] = False
            # Optimistic overlay: in-flight passes of THIS worker's
            # pipeline are not committed yet, but the applier WILL land
            # most of them — scoring against bare ct.used would
            # double-book those nodes (server/overlay.py). In lane mode
            # this overlay is the worker's own; peers' in-flight state
            # is irrelevant by construction (disjoint lanes + claims).
            used_override = overlay.begin_pass(ct)
            if used_override is not None:
                metrics.incr("nomad.worker.pipeline_override_passes")
            try:
                kernel = prepared[0][2].kernel
                # all scheds in a batch share one scheduler config, so
                # the first lane's explain gate speaks for the pass
                explain = bool(getattr(prepared[0][2], "_explain", False))
                t0 = time.perf_counter()
                # decorrelate: each lane scores a disjoint node stripe
                # (the vector analog of per-worker shuffle sampling,
                # stack.go:74-90) so concurrent lanes stop argmaxing
                # onto the same nodes; repair re-scores any remainder.
                # The tie-break salt must be a function of the WORK, not
                # the worker: lane mode derives it from the first eval's
                # job lane so an N-worker run reproduces the 1-worker
                # reference byte for byte, and the legacy cross-worker
                # node-universe carving (decorrelate_workers) is retired
                # — structural claims replace it.
                results = kernel.place(
                    ct,
                    all_asks,
                    decorrelate=True,
                    decorrelate_salt=(
                        self.server.lanes.lane_of_job(
                            prepared[0][0].namespace, prepared[0][0].job_id
                        )
                        if lane_mode
                        else self.id
                    ),
                    decorrelate_workers=(
                        1
                        if lane_mode
                        else getattr(
                            self.server.config, "num_batch_workers", 1
                        )
                    ),
                    overflow=32,
                    used_override=used_override,
                    explain=explain,
                )
                from ..device.score import repair_batch_conflicts

                lane_ok = repair_batch_conflicts(
                    ct,
                    all_asks,
                    results,
                    algorithm_spread=kernel.algorithm_spread,
                    # multi-TG evals span lanes; a failed lane
                    # discards the WHOLE eval, so repair must release
                    # (and stop reserving for) every sibling lane too
                    lane_groups=lane_groups,
                    used_override=used_override,
                )
                if explain:
                    # post-repair: stamp the committed rows into each
                    # lane's explanation (obs/explain.py)
                    from ..obs.explain import finalize_explanations

                    finalize_explanations(
                        ct, all_asks, results, used_override=used_override
                    )
                invoke_s = time.perf_counter() - t0
                metrics.measure("nomad.worker.invoke_scheduler", invoke_s)
                for ev, _tok, _sched, _n in prepared:
                    tracer.add_span(
                        ev.id,
                        "invoke_scheduler",
                        invoke_s,
                        tags={
                            "shared": True,
                            "evals": len(prepared),
                            "lanes": len(all_asks),
                            "explain": explain,
                        },
                    )
            except Exception as e:
                # shared pass failed — every prepared eval falls back to
                # the individual path rather than dying unacked
                log.exception("worker %d: combined kernel pass", self.id)
                count_swallowed("worker", e)
                metrics.incr("nomad.worker.batch_kernel_errors")
                singles.extend((ev, token) for ev, token, _, _ in prepared)
                prepared = []
                results = None
            finally:
                # Reserve THIS pass's submitted placements in the shared
                # overlay, take the COMMIT marker, and only then release
                # the pass marker: a gap between the two markers would
                # let another worker's maybe_reset() drop the overlay
                # while these placements are neither "in a pass" nor "in
                # a commit" — exactly the dropped-reservation cascade the
                # reset discipline exists to prevent. The commit thread
                # below runs unconditionally, releasing the marker.
                try:
                    if results is not None and prepared:
                        off = 0
                        for _ev, _tok, _sched, n in prepared:
                            span_ok = all(lane_ok[off : off + n])
                            for lane in range(off, off + n):
                                if not span_ok:
                                    continue
                                a = all_asks[lane]
                                rows = results[lane].node_rows
                                rows = rows[rows >= 0]
                                if rows.size:
                                    overlay.add_delta(
                                        ct, rows, a.ask, writer=self.id
                                    )
                            off += n
                finally:
                    overlay.commit_started()
                    overlay.pass_finished()

        # pipeline: the previous commit must finish before this pass's
        # commit starts (plan order per job; one in-flight commit bounds
        # memory), but the NEXT device pass overlaps THIS commit.
        self._join_commit()
        if commit_alive_at_start:
            # the previous commit ran concurrently with this pass's
            # prepare/flatten/device phases from t_pass0 until it
            # finished (or until the join, whichever came first) —
            # that interval is wall time the pipeline genuinely hid
            t_join_end = time.perf_counter()
            overlap_s = max(
                0.0, min(self._commit_done_at, t_join_end) - t_pass0
            )
            metrics.measure("nomad.worker.pipeline_overlap", overlap_s)
            self.server.device_cache.note_overlap(overlap_s * 1000.0)
        if not all_asks:
            # the marker is taken in the device-pass block; a batch with
            # no kernel work (all singles) still needs it for the commit
            # thread's finally to balance
            overlay.commit_started()
        args = (prepared, all_asks, results, lane_ok, singles)
        self._commit_thread = threading.Thread(
            target=self._commit_batch, args=args,
            name=f"worker-{self.id}-commit", daemon=True,
        )
        self._commit_thread.start()

    def _commit_batch(
        self, prepared, all_asks, results, lane_ok, singles
    ) -> None:
        """Commit one finished pass: per-eval plan submission + ack/nack.
        Runs on the commit thread while the worker's next device pass is
        in flight."""
        try:
            self._commit_batch_inner(
                prepared, all_asks, results, lane_ok, singles
            )
        except ChaosThreadKill as e:
            # injected cooperative crash: die exactly like a killed
            # commit thread — whatever was not yet acked stays unacked
            # and the broker's redelivery deadline must recover it.
            # BaseException, so no recovery handler above could absorb
            # it; accounted here at the thread boundary, never silent.
            metrics.incr("nomad.chaos.thread_kills")
            count_swallowed("chaos", e)
        finally:
            # Promote the pass's staged score generation (device/cache.py):
            # the swap carries the ONE transfer fence of the pipeline, so
            # it lands here at the merge point — after the commit's store
            # writes, before the overlay releases. Runs on the kill path
            # too: the staged buffer is still an exact mirror of the used
            # matrix it was built from, and any store rows the killed
            # commit never landed show up as dirty bytes next pass.
            self.server.device_cache.score_commit()
            self._commit_done_at = time.perf_counter()
            # must release the SAME overlay whose commit_started marker
            # the device pass took (the worker's own in lane mode)
            self._my_overlay().commit_finished()

    def _nack_member(self, ev, token, e, what: str) -> None:
        if isinstance(e, EvalDeadlineExceeded):
            self._deadline_nack(ev, token, e)
            return
        log.exception("worker %d: %s %s", self.id, what, ev.id)
        count_swallowed("worker", e)
        try:
            self.server.eval_broker.nack(ev.id, token)
        except ValueError as e2:
            count_swallowed("worker", e2)
        self._bump("nacked", "processed")
        metrics.incr("nomad.worker.evals_processed")
        tracer.finish(ev.id, status="nacked", error=repr(e))

    def _deadline_nack(self, ev, token, e) -> None:
        """Escalation path for a processing-deadline expiry. Below the
        attempt cap: nack — the broker re-enqueues with attempt-indexed
        delay. At the cap: mark the eval failed with a structured
        reason (durable BEFORE the ack releases the per-job gate) and
        ack — terminal parking, not another spin of the hot loop."""
        ev.attempts += 1
        limit = self._eval_attempt_limit
        log.warning(
            "worker %d: eval %s blew its %ss processing deadline "
            "(attempt %d/%d)",
            self.id, ev.id, self._eval_deadline, ev.attempts, limit,
        )
        metrics.incr("nomad.resilience.eval.deadline_nacks")
        count_swallowed("worker", e)
        if ev.attempts >= limit:
            ev.status = EVAL_STATUS_FAILED
            ev.status_description = (
                f"eval-deadline-exceeded: attempts={ev.attempts} "
                f"limit={limit} deadline_s={self._eval_deadline}"
            )
            try:
                self.server.apply_eval_update([ev])
            except Exception as e2:
                count_swallowed("worker", e2)
            try:
                self.server.eval_broker.ack(ev.id, token)
            except ValueError as e2:
                count_swallowed("worker", e2)
            self._bump("processed")
            metrics.incr("nomad.worker.evals_processed")
            metrics.incr("nomad.resilience.eval.deadline_failed")
            tracer.finish(ev.id, status="failed", error=repr(e))
        else:
            try:
                self.server.eval_broker.nack(ev.id, token)
            except ValueError as e2:
                count_swallowed("worker", e2)
            self._bump("nacked", "processed")
            metrics.incr("nomad.worker.evals_processed")
            tracer.finish(ev.id, status="nacked", error=repr(e))

    def _commit_batch_inner(
        self, prepared, all_asks, results, lane_ok, singles
    ) -> None:
        """Coalesced commit: build every member's plan from its result
        slice, then submit the WHOLE pass as one MergedPlan — one plan
        queue entry, one vectorized applier verify, one raft apply — and
        resolve each member from its own result future. A stale member
        falls back to the individual path without failing its siblings."""
        # cooperative crash flag, checked where a real commit thread
        # spends its life: once on entry, and again mid merged-plan
        # commit (below) after the submit is in flight
        chaos_site("worker.commit")
        server = self.server
        buf = _EvalBuffer(server)
        members: list[tuple] = []  # (ev, token, sched, member plan)
        done: list[tuple] = []  # acked after the status flush below
        claims: list = []  # confirmed cross-lane claims riding this commit
        try:
            # 1. build: turn each member's lane slice into a plan. A lane
            # conflict with no usable overflow candidate drops the member
            # to the individual path before any submit.
            off = 0
            for ev, token, sched, n in prepared:
                span = results[off : off + n]
                span_ok = all(lane_ok[off : off + n])
                off += n
                if not span_ok:
                    metrics.incr("nomad.worker.batch_conflict_fallbacks")
                    metrics.incr("nomad.worker.batch_repair_fallbacks")
                    singles.append((ev, token))
                    continue
                sched.planner.buffer = buf
                try:
                    # adopt this eval's trace on the commit thread so the
                    # spans recorded below parent into it
                    with tracer.activate(ev.id):
                        # a member whose pass outlived the eval deadline
                        # escalates (nack w/ delay, then failed) instead
                        # of committing stale work
                        sched.planner.check_deadline(ev.id)
                        member = sched.build_batch_plan(span)
                except Exception as e:  # nta: allow=NTA003 — _nack_member logs+counts
                    self._nack_member(ev, token, e, "batch build")
                    continue
                if member is None:
                    # no-op eval: finalized already (status buffered)
                    done.append((ev, token))
                    metrics.incr("nomad.worker.batch_evals_completed")
                else:
                    members.append((ev, token, sched, member))

            # 1b. cross-lane handoff (lane mode): a member placing on a
            # peer's nodes must hold a confirmed claim on them before
            # riding the merged commit — reserve (refused if any node is
            # already claimed/settled), then confirm (peer quiesced, no
            # peer in-flight delta, fresh-snapshot capacity re-check).
            # Either phase failing drops the member to the solo fallback
            # in its own lanes; the reservation is released either way.
            if self._lane_mode() and members:
                kept: list[tuple] = []
                for ev, token, sched, member in members:
                    foreign = {
                        node_id: list(allocs)
                        for node_id, allocs in member.node_allocation.items()
                        if server.lanes.owner_of_node(node_id) != self.id
                    }
                    if not foreign:
                        kept.append((ev, token, sched, member))
                        continue
                    claim = server.lane_claims.reserve(
                        self.id, ev.id, foreign
                    )
                    if claim is not None:
                        # register with the finally BEFORE confirm: a
                        # thread kill inside confirm must not leak the
                        # reservation (release is idempotent, so the
                        # immediate release below stays safe)
                        claims.append(claim)
                        if server.lane_claims.confirm(claim):
                            kept.append((ev, token, sched, member))
                            continue
                        server.lane_claims.release(claim, committed=False)
                    metrics.incr("nomad.worker.lane_handoff_fallbacks")
                    singles.append((ev, token))
                members = kept

            # 2. followup evals must exist BEFORE the plans that reference
            # them commit; one raft apply covers the whole batch's creates
            buf.flush()

            # 3. submit: ONE merged entry for the whole pass
            mresults: list = [None] * len(members)
            if members:
                ctxs = []
                for ev, token, _sched, member in members:
                    member.eval_token = token
                    member.normalize()
                    with tracer.activate(ev.id):
                        ctxs.append(tracer.current_ctx())
                t0 = time.perf_counter()
                # past this point the applier may land the claimed
                # placements even if this thread dies — the finally
                # below must settle (not just drop) the claimed nodes
                for claim in claims:
                    claim.submitted = True
                futures = server.plan_queue.enqueue_merged(
                    MergedPlan(
                        plans=[m[3] for m in members],
                        owner_worker=self.id if self._lane_mode() else -1,
                        claims=list(claims),
                    ),
                    trace_ctxs=ctxs,
                )
                # a kill here crashes the thread AFTER the merged plan
                # is in flight: the applier still commits it, nobody
                # acks, and redelivered members must converge to no-ops
                # (never lose or double-commit a member)
                chaos_site("worker.commit")
                for i, (ev, token, _sched, _member) in enumerate(members):
                    try:
                        mresults[i] = futures[i].result(timeout=30)
                    except Exception as e:  # nta: allow=NTA003 — _nack_member logs+counts
                        self._nack_member(ev, token, e, "merged submit")
                submit_s = time.perf_counter() - t0
                metrics.measure("nomad.worker.submit_plan", submit_s)
                for i, (ev, _t, _s, _m) in enumerate(members):
                    if mresults[i] is None:
                        continue
                    tracer.add_span(
                        ev.id, "submit_plan", submit_s,
                        tags={
                            "shared": True,
                            "rejected_nodes": len(mresults[i].rejected_nodes),
                        },
                    )

                # 4. one shared refresh barrier for every partially
                # committed member (each previously waited on its own)
                refresh = max(
                    (r.refresh_index for r in mresults if r is not None),
                    default=0,
                )
                if refresh:
                    t0 = time.perf_counter()
                    server.store.wait_for_index(refresh, timeout=5.0)
                    refresh_s = time.perf_counter() - t0
                    for i, (ev, _t, _s, _m) in enumerate(members):
                        if mresults[i] is not None and mresults[i].refresh_index:
                            tracer.add_span(
                                ev.id, "refresh_snapshot", refresh_s,
                                tags={"shared": True, "refresh_index": refresh},
                            )

                # 5. complete: full commits finalize (status buffered);
                # stale members retry individually on fresh state (the
                # trace stays open; _run_one below appends the retry)
                for i, (ev, token, sched, _member) in enumerate(members):
                    if mresults[i] is None:
                        continue  # nacked above
                    if mresults[i].token_stale:
                        # the applier dropped this member: the broker
                        # redelivered the eval mid-pass and another
                        # worker owns it now — no ack/nack (our token is
                        # dead) and no singles retry (that would race
                        # the new owner into a double commit)
                        metrics.incr("nomad.worker.stale_token_drops")
                        self._bump("processed")
                        tracer.finish(ev.id, status="stale_token")
                        continue
                    try:
                        with tracer.activate(ev.id):
                            completed = sched.complete_merged_attempt(
                                mresults[i]
                            )
                    except Exception as e:  # nta: allow=NTA003 — _nack_member logs+counts
                        self._nack_member(ev, token, e, "batch complete")
                        continue
                    if completed:
                        done.append((ev, token))
                        metrics.incr("nomad.worker.batch_evals_completed")
                    else:
                        metrics.incr("nomad.worker.batch_conflict_fallbacks")
                        metrics.incr("nomad.worker.batch_commit_fallbacks")
                        singles.append((ev, token))

            # 6. land every member's finalize-time status (and blocked
            # eval creates) in one raft apply, then ack — status must be
            # durable before the ack releases the per-job gate
            buf.flush()
            for ev, token in done:
                try:
                    server.eval_broker.ack(ev.id, token)
                except ValueError as e:
                    count_swallowed("worker", e)
                self._bump("acked", "processed")
                metrics.incr("nomad.worker.evals_processed")
                tracer.finish(ev.id, status="acked")

            for ev, token in singles:
                metrics.incr("nomad.worker.batch_single_fallbacks")
                self._run_one(ev, token)
        except Exception as e:
            # the commit thread must never die with evals unacked —
            # including the singles that accumulated from fallbacks
            log.exception("worker %d: commit thread failed", self.id)
            count_swallowed("worker", e)
            outstanding = [
                (ev, token) for ev, token, _s, _n in prepared
            ] + list(singles)
            for ev, token in outstanding:
                try:
                    self.server.eval_broker.nack(ev.id, token)
                except Exception as e2:  # best-effort cleanup
                    count_swallowed("worker", e2)
                # finish() no-ops for evals already acked/finished above
                tracer.finish(ev.id, status="nacked", error=repr(e))
        finally:
            # no leaked claims, EVER: release is idempotent and this
            # finally runs even on ChaosThreadKill (a BaseException). A
            # claim that made it to enqueue_merged settles its nodes (the
            # applier may land it regardless of this thread's fate); one
            # that did not is simply dropped.
            for claim in claims:
                server.lane_claims.release(
                    claim, committed=claim.submitted
                )

    def process_eval(self, ev: Evaluation, planner=None) -> None:
        # solo evals score against the shared overlay too (an overlay-
        # blind pass would seed the very conflicts it predicts), so they
        # must also retire its epoch before snapshotting — a long solo-
        # only stretch otherwise accumulates every past ask against a
        # frozen base until placements fail on a near-empty cluster.
        # Safe from the commit thread's singles fallback: the commit
        # marker is still held there, so maybe_reset() is a no-op.
        overlay = self._my_overlay()
        if overlay.maybe_reset():
            metrics.incr("nomad.worker.pipeline_epoch_resets")
        lane_mode = self._lane_mode()
        if lane_mode:
            self._rebase_lanes(overlay)
        # raft catch-up barrier (worker.go:536-549)
        with tracer.span(
            "wait_for_index", timer="nomad.worker.wait_for_index"
        ):
            self.server.store.wait_for_index(ev.modify_index, timeout=5.0)
        with tracer.span("snapshot"):
            snapshot = self.server.store.snapshot()
        # all workers share the server's resident device-state cache —
        # tensors refresh incrementally by state index, not per eval
        kw = {}
        if lane_mode and ev.type in ("service", "batch") and (
            self.id < getattr(self.server.config, "num_batch_workers", 1)
        ):
            # a batch worker's SOLO fallback stays in its own lanes:
            # the solo path has no cross-lane handoff, so foreign nodes
            # are off the table (a shortfall blocks the eval, it never
            # writes a peer's node). system/sysbatch/_core evals stay
            # unrestricted — they are single-plan optimistic commits
            # outside the merged-plan lane contract.
            kw["node_filter"] = self._lane_node_filter
        sched = new_scheduler(
            ev.type,
            snapshot,
            planner if planner is not None else _TokenPlanner(self, ""),
            cache=self.server.device_cache,
            overlay=overlay,
            **kw,
        )
        with tracer.span(
            "invoke_scheduler", timer="nomad.worker.invoke_scheduler"
        ):
            sched.process(ev)

    # -- Planner interface kept for direct (non-batch) callers -------------
    def submit_plan(self, plan: Plan):
        return _TokenPlanner(self, getattr(plan, "eval_token", "")).submit_plan(
            plan
        )

    def update_eval(self, ev: Evaluation) -> None:
        self.server.apply_eval_update([ev])

    def create_eval(self, ev: Evaluation) -> None:
        self.server.apply_eval_create([ev])

    def reblock_eval(self, ev: Evaluation) -> None:
        self.server.eval_broker.enqueue(ev)
