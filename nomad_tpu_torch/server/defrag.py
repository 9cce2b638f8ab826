"""DefragController — live migration with capacity-conserved two-phase
move sequencing.

A long-lived cluster fragments: churn leaves load smeared thinly across
many nodes, so gang asks and large allocs block even though the total
free capacity is ample. This controller continuously repacks the fleet
by *live-migrating* allocs — bounded moves per cycle, chosen by the
migration auction (``device/migrate.py`` via ``scheduler/migrate.py``'s
batch assembler). Each cycle plans with ``migrate_plan`` on the server's
device (``ServerConfig.device``): the hand-written kernel of
``csrc/migrate.cu`` on a CUDA device, its plain version on the CPU. The
two agree bit for bit, and the plain version agrees with the JAX
package's NumPy oracle, so the moves are the reference's.

The safety contract is the whole point (invariant law 16,
``migration_conservation``):

**Two-phase, place-first.** Every move is (A) place the replacement
alloc on the destination — through the lane-claim protocol and the
serialized plan applier, exactly like any scheduler placement — then
(B) stop the old alloc with a separate stop-only plan. Free capacity
never goes negative mid-flight: between A and B both halves exist and
both are counted (the auction's used-only-increases pricing model is
this exact invariant, priced on device). A killed controller thread
leaves a *completed pair*, never a torn one — phase A either fully
committed through the applier or not at all, and phase B is a pure
capacity release. Orphaned half-moves (replacement placed, stop never
submitted) are finished by the recovery scan at the top of the next
cycle.

**Everything through the commit path.** Replacements ride a
``MergedPlan`` with a confirmed cross-lane claim (claimant −1: the
controller owns no lanes, so every destination is foreign and must be
reserved → confirmed → released, ``finally``-guaranteed). Stops go
through ``Plan.append_stopped_alloc`` — the applier's stops-always-
commit rule makes phase B unconditional.

**Preemption-aware sequencing.** Candidates are filtered, not fought
over: allocs the drainer already marked (``desired_transition.migrate``),
gang-job members (law 15 owns their atomicity), system jobs, jobs with
an active deployment, and non-running allocs are all skipped, so the
controller never races another subsystem for the same alloc.

Chaos sites: ``migrate.move_drop`` (a planned move is dropped before
phase A — nothing committed, conservation trivial) and
``migrate.kill_mid_move`` (thread kill or lost phase B between the
phases — the half-move must be recovered, never doubled).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

import numpy as np

from ..chaos.plane import ChaosThreadKill, chaos_site
from ..structs import MergedPlan, Plan, allocs_fit, new_id
from ..structs.alloc import (
    ALLOC_CLIENT_PENDING,
    ALLOC_DESIRED_RUN,
    DesiredTransition,
)
from ..structs.resources import node_comparable_capacity
from ..utils.metrics import count_swallowed, global_metrics as metrics

log = logging.getLogger("nomad_tpu_torch.defrag")

#: desired_description marker on a defrag replacement alloc. Law 16 uses
#: it to recognize the legitimate mid-move pair (old + replacement, same
#: group slot, linked by previous_allocation) at a quiesce point.
DEFRAG_DESC = "alloc migrated by defrag"

#: desired_description on the old alloc's phase-B stop.
DEFRAG_STOP_DESC = "alloc stopped after defrag migration"

#: desired_description on a replacement whose source the job stopped
#: (scaled away, updated) between the cycle's snapshot and phase A.
DEFRAG_ORPHAN_DESC = "alloc stopped: its source left the job mid-move"


def orphaned(old) -> bool:
    """True when a move's source was stopped by its job (scaled away,
    updated, rescheduled), not by the move's phase B: the job no longer
    wants that slot there, so the replacement goes too (ROADMAP C-R6). A
    failed or evicted source leaves its slot to the replacement."""
    return old.desired_status == "stop" and old.desired_description != DEFRAG_STOP_DESC


#: the controller's synthetic worker id on MergedPlans: it owns no
#: lanes, so every destination node rides a confirmed cross-lane claim.
DEFRAG_CLAIMANT = -1


class DefragController:
    """Periodic + event-triggered defragmentation bound to a Server.

    ``interval <= 0`` disables the periodic scan (the production-safe
    default): the thread still runs and serves explicit ``trigger()``
    calls (operator API), but nothing moves unasked. Drain-completion
    nudges (``notify_drain_complete``) only fire when periodic mode is
    enabled — a freed node is prime repacking space, but only clusters
    that opted into continuous defrag want it acted on."""

    def __init__(
        self,
        server,
        interval: float = 0.0,
        budget: int = 4,
        min_gain_moves: int = 1,
    ):
        self.server = server
        self.interval = float(interval)
        self.budget = int(budget)
        self.min_gain_moves = int(min_gain_moves)
        self.paused = False
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._busy = False
        self._lock = threading.Lock()
        self.cycles = 0
        self.last_efficiency = 1.0

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="defrag", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread:
            self._thread.join(timeout=2)
            self._thread = None

    def trigger(self) -> None:
        """Run a cycle soon regardless of the periodic interval (the
        operator endpoint's knob)."""
        self._wake.set()

    def notify_drain_complete(self) -> None:
        """A node finished draining: its freed capacity makes this the
        cheapest moment to repack — but only in continuous mode."""
        if self.interval > 0:
            self._wake.set()

    def drained(self) -> bool:
        """No cycle in flight — the chaos runner's quiesce predicate."""
        with self._lock:
            return not self._busy

    def recover(self) -> None:
        """Synchronously finish any outstanding half-moves (phase B
        only — no new moves are planned). The chaos runner calls this
        after quiesce so a ``kill_mid_move`` landing on the *last* cycle
        still resolves before law 16 judges the cluster."""
        self._recover_half_moves(self.server.store.snapshot())

    def status(self) -> dict:
        snap = metrics.snapshot()["counters"]
        return {
            "enabled": self.interval > 0,
            "paused": self.paused,
            "interval": self.interval,
            "budget": self.budget,
            "cycles": self.cycles,
            "packing_efficiency": round(self.last_efficiency, 6),
            "counters": {
                k: v for k, v in sorted(snap.items())
                if k.startswith("nomad.migrate.")
            },
        }

    # -- the loop ----------------------------------------------------------
    def _run(self) -> None:
        while not self._stop.is_set():
            timeout = self.interval if self.interval > 0 else None
            fired = self._wake.wait(timeout)
            if self._stop.is_set():
                return
            if fired:
                self._wake.clear()
            self.supervised_cycle()

    def supervised_cycle(self) -> None:
        """One ``run_cycle`` as the loop runs it: a failure is counted,
        never raised. The chaos runner steps cycles through this."""
        try:
            self.run_cycle()
        except ChaosThreadKill as e:
            # injected crash mid-move: the cycle dies exactly like a
            # killed controller thread — phase A either committed
            # whole or not at all, the lane claim released via its
            # finally — and the loop supervises a fresh cycle, whose
            # recovery scan finishes any half-move left behind.
            metrics.incr("nomad.chaos.thread_kills")
            count_swallowed("chaos", e)
            with self._lock:
                self._busy = False
        except Exception as e:  # noqa: BLE001
            # counted like the worker's own swallows: a kernel that
            # fails to build or launch shows in the swallowed count
            count_swallowed("defrag", e)
            log.exception("defrag cycle failed")

    # -- one cycle ---------------------------------------------------------
    def run_cycle(self) -> int:
        """One bounded defrag pass. Returns the number of moves fully
        completed (phase B landed)."""
        if self.paused or not self.server._leader:
            return 0
        with self._lock:
            self._busy = True
        try:
            return self._cycle_inner()
        finally:
            with self._lock:
                self._busy = False

    def _cycle_inner(self) -> int:
        import torch

        # the kernel wrapper is called through the module, so that a
        # stand-in (chip_smoke.py's recorder) sees every call
        from ..device import migrate as device_migrate
        from ..device.migrate import packing_efficiency
        from ..scheduler.migrate import _on, _steps_for, build_defrag_batch

        snap = self.server.store.snapshot()
        if self._recover_half_moves(snap):
            # recovery stopped allocs the snapshot still shows live —
            # replan from the post-recovery state, or a stopped source
            # could be re-migrated (a double-committed move, law 16)
            snap = self.server.store.snapshot()

        nodes = [n for n in snap.nodes() if n.ready()]
        if len(nodes) < 2:
            return 0
        node_row = {n.id: i for i, n in enumerate(nodes)}
        capacity = np.stack(
            [node_comparable_capacity(n).to_vector() for n in nodes]
        ).astype(np.float32)
        used = np.zeros_like(capacity)
        for n in nodes:
            for a in snap.allocs_by_node(n.id):
                if not a.terminal_status():
                    used[node_row[n.id]] += (
                        a.comparable_resources().to_vector()
                    )

        ready = np.ones(len(nodes), dtype=bool)
        eff = packing_efficiency(capacity, used, ready)
        self.last_efficiency = eff
        metrics.set_gauge("nomad.migrate.packing_efficiency", eff)

        movable = self._candidates(snap, node_row)
        if not movable:
            return 0
        sizes = np.stack(
            [a.comparable_resources().to_vector() for a, _ in movable]
        ).astype(np.float32)
        cur = np.array(
            [node_row[a.node_id] for a, _ in movable], dtype=np.int32
        )
        dev = self.server.config.device
        args = _on(build_defrag_batch(capacity, used, sizes, cur), dev)
        lam0 = torch.zeros(len(nodes), dtype=torch.float32, device=dev)
        out = device_migrate.migrate_plan(
            *args, self.budget, lam0, _steps_for(len(movable))
        )
        dest = out[0].cpu().numpy()
        moves = int(out[3])
        # the [A, N] grids and the pass's outputs go before the moves run
        del args, lam0, out
        if moves == 0:
            return 0
        if moves >= self.budget:
            metrics.incr("nomad.migrate.budget_exhausted")

        completed = 0
        for i in np.flatnonzero(dest >= 0):
            old, job = movable[int(i)]
            if self._stop.is_set():
                break
            if self._execute_move(old, job, nodes[int(dest[i])].id):
                completed += 1
        self.cycles += 1
        return completed

    # -- candidate selection ----------------------------------------------
    def _candidates(self, snap, node_row) -> list:
        """(alloc, job) pairs the controller may move. Everything another
        subsystem owns — or whose atomicity law is stricter than a
        per-alloc move — is excluded up front."""
        out = []
        # sources of in-flight moves: any live defrag replacement's
        # previous_allocation is mid-move — planning a SECOND move of
        # that source would double-commit the slot (law 16's first
        # violation class), so both halves of a pair are off the table
        in_flight_sources = {
            a.previous_allocation
            for a in snap.allocs()
            if not a.terminal_status()
            and a.desired_description == DEFRAG_DESC
            and a.previous_allocation
        }
        for a in snap.allocs():
            if a.terminal_status() or a.client_status != "running":
                continue
            if a.id in in_flight_sources:
                continue  # mid-move source: phase B owns its exit
            if a.desired_transition.migrate:
                continue  # drainer owns this alloc's exit
            if a.desired_description == DEFRAG_DESC and a.previous_allocation:
                prev = snap.alloc_by_id(a.previous_allocation)
                if prev is not None and not prev.terminal_status():
                    continue  # mid-move: the recovery scan owns it
            if a.node_id not in node_row:
                continue
            job = snap.job_by_id(a.namespace, a.job_id)
            if job is None or job.stopped():
                continue
            if job.type in ("system", "sysbatch"):
                continue  # pinned per-node by definition
            if job.gang:
                continue  # law 15 (gang atomicity) owns these
            dep = snap.latest_deployment_by_job(a.namespace, a.job_id)
            if dep is not None and dep.active():
                continue  # deployment watcher owns placement churn
            out.append((a, job))
        # deterministic order: by (namespace, job, name) so a seeded run
        # builds the identical batch every time
        out.sort(key=lambda p: (p[0].namespace, p[0].job_id, p[0].name))
        return out

    # -- the two-phase move ------------------------------------------------
    def _execute_move(self, old, job, dest_node_id: str) -> bool:
        """Phase A (place replacement, verified commit) then phase B
        (stop old). Returns True when both phases landed."""
        metrics.incr("nomad.migrate.planned")
        if chaos_site("migrate.move_drop") == "drop":
            # the planned move was lost before anything committed —
            # conservation holds trivially, the next cycle replans it
            metrics.incr("nomad.migrate.aborted")
            return False

        replacement = self._replacement_for(old, job, dest_node_id)
        plan_a = Plan(
            eval_id=new_id(), priority=job.priority, job=job
        )
        plan_a.append_alloc(replacement)

        claim = self.server.lane_claims.reserve(
            DEFRAG_CLAIMANT, plan_a.eval_id, {dest_node_id: [replacement]}
        )
        if claim is None:
            metrics.incr("nomad.migrate.aborted")
            return False
        placed = False
        try:
            if not self.server.lane_claims.confirm(claim):
                metrics.incr("nomad.migrate.aborted")
                return False
            # past this point the applier may land the placement even if
            # this thread dies — release must settle the node either way
            claim.submitted = True
            futures = self.server.plan_queue.enqueue_merged(
                MergedPlan(
                    plans=[plan_a],
                    owner_worker=DEFRAG_CLAIMANT,
                    claims=[claim],
                )
            )
            result = futures[0].result(timeout=5.0)
            placed, _, _ = result.full_commit(plan_a)
        except ChaosThreadKill:
            raise  # thread boundary accounts it; finally releases
        except Exception:  # noqa: BLE001
            log.exception("defrag phase A failed for %s", old.id)
        finally:
            # settling exists to cover a lane owner's frozen overlay
            # base predating this commit. Outside lane mode the single
            # applier's re-verify already bounces stale optimism, so
            # settling would only wedge idle clusters (nobody rebases).
            committed = claim.submitted and self.server.lane_mode
            self.server.lane_claims.release(claim, committed=committed)
            if committed:
                # mirror the worker's rebase idiom: a fresh owner
                # overlay has no stale base, so its settled nodes are
                # immediately schedulable again — without this an idle
                # owner never rebases and the node stays blocked
                owner = self.server.lanes.owner_of_node(dest_node_id)
                ov = self.server.placement_overlay.for_worker(owner)
                if ov.is_fresh():
                    self.server.lane_claims.clear_settled(owner)
        if not placed:
            metrics.incr("nomad.migrate.aborted")
            return False

        # mid-move capacity audit: with both halves live the destination
        # must still fit — the applier's verify guarantees it, law 16
        # pins the counter at zero
        self._audit_capacity(dest_node_id)

        # the job may have stopped the source since the cycle's snapshot
        snap = self.server.store.snapshot()
        cur = snap.alloc_by_id(old.id)
        if cur is not None and orphaned(cur):
            self._stop_old(snap.alloc_by_id(replacement.id), DEFRAG_ORPHAN_DESC)
            metrics.incr("nomad.migrate.aborted")
            return False

        # the seam chaos rehearses: a kill here leaves the committed
        # pair for the recovery scan; a drop loses phase B the same way
        if chaos_site("migrate.kill_mid_move") == "drop":
            metrics.incr("nomad.migrate.interrupted")
            return False

        self._stop_old(old)
        metrics.incr("nomad.migrate.completed")
        return True

    def _replacement_for(self, old, job, dest_node_id: str):
        a = old.copy_for_update()
        a.id = new_id()
        a.node_id = dest_node_id
        a.previous_allocation = old.id
        a.next_allocation = ""
        a.eval_id = ""
        a.job = job
        a.desired_status = ALLOC_DESIRED_RUN
        a.desired_description = DEFRAG_DESC
        a.desired_transition = DesiredTransition()
        a.client_status = ALLOC_CLIENT_PENDING
        a.client_description = ""
        a.deployment_id = ""
        a.deployment_status = None
        a.create_index = 0
        a.modify_index = 0
        return a

    def _stop_old(self, old, desc: str = DEFRAG_STOP_DESC) -> None:
        """Phase B: a stop-only plan through the same serialized commit
        path (stops always commit — they only free capacity)."""
        plan_b = Plan(eval_id=new_id())
        plan_b.append_stopped_alloc(old, desc)
        futures = self.server.plan_queue.enqueue_merged(
            MergedPlan(plans=[plan_b], owner_worker=DEFRAG_CLAIMANT)
        )
        futures[0].result(timeout=5.0)

    def _audit_capacity(self, node_id: str) -> None:
        snap = self.server.store.snapshot()
        node = snap.node_by_id(node_id)
        if node is None:
            return
        live = [
            a for a in snap.allocs_by_node(node_id)
            if not a.terminal_status()
        ]
        ok, _dim, _used = allocs_fit(node, live, check_devices=True)
        if not ok:
            metrics.incr("nomad.migrate.capacity_violations")

    # -- recovery ----------------------------------------------------------
    def _recover_half_moves(self, snap) -> int:
        """Finish moves a dead controller left half-done: a live defrag
        replacement whose source alloc is still live means phase A
        committed but phase B never ran — complete it (stop the old
        half). The pair is exactly what law 16 tolerates mid-move; this
        scan is what bounds 'mid-move' to one cycle. A live replacement
        whose source its job stopped meanwhile is stopped instead (C-R6).
        Returns the number of half-moves completed."""
        recovered = 0
        for a in snap.allocs():
            if a.desired_description != DEFRAG_DESC or a.terminal_status():
                continue
            if not a.previous_allocation:
                continue
            old = snap.alloc_by_id(a.previous_allocation)
            if old is not None and orphaned(old):
                try:
                    self._stop_old(a, DEFRAG_ORPHAN_DESC)
                    metrics.incr("nomad.migrate.aborted")
                except Exception:  # noqa: BLE001
                    log.exception("defrag recovery failed for %s", a.id)
                continue
            if old is None or old.terminal_status():
                continue
            try:
                self._stop_old(old)
                metrics.incr("nomad.migrate.recovered")
                metrics.incr("nomad.migrate.completed")
                recovered += 1
            except Exception:  # noqa: BLE001
                log.exception("defrag recovery failed for %s", old.id)
        return recovered
