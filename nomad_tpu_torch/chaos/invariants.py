"""Cluster conservation laws, checked over a live quiesced cluster.

The checks encode what the eval→plan→apply pipeline promises to keep
true no matter which faults fired:

``node_capacity``
    no node's committed non-terminal allocations exceed its
    reserved-adjusted capacity (the plan applier's verify step is the
    only writer of placements, so an overcommit means verify lied).
``plan_ledger``
    every *fresh* placement the applier reported committed landed in
    the store exactly once — no loss after a reported commit, no
    double-commit of a merged-plan member. In-place updates of an
    existing alloc (job scaled / re-registered) are not placements and
    are excluded (requires an installed FaultPlane ledger).
``index_monotonic``
    the change journal's raft indexes never go backwards and the
    store's latest index bounds every journaled write.
``overlay_drained``
    the SharedOverlay's pass/commit markers drain to zero once the
    cluster quiesces — a leaked marker wedges ``maybe_reset`` forever.
``broker_conservation``
    every dequeue is resolved by exactly one of ack, nack, or
    unack-deadline redelivery (at-least-once bookkeeping balances).
``swallow_ring``
    no swallowed-error counter increments without a matching flight-
    recorder error-ring event (swallows can't hide from the obs plane).
``job_conservation``
    after quiesce every service job runs exactly its desired count of
    allocations, or a live eval (pending/blocked in the store, or
    parked in the broker's failed queue) accounts for the difference;
    an unexplained surplus is the double-commit smoking gun.
``eval_terminal``
    no eval is stranded: every non-terminal eval in the store is still
    tracked somewhere (broker queues, delayed heap, job gate, failed
    queue, or the blocked-evals tracker).
``lane_isolation``
    with deterministic lane ownership active, structural disjointness
    held: zero lane conflicts (``nomad.plan.lane_conflicts`` — a merged
    plan touching a foreign node without a confirmed claim, or bounced
    on one), zero cross-lane overlay writes
    (``nomad.overlay.cross_lane_writes``), and the claim table drained
    (no leaked reservations after quiesce). Handoffs themselves are
    fine and counted separately (``nomad.plan.cross_lane_handoffs``).
``admission_conservation``
    the admission controller's per-tier decision ledger balances:
    ``admitted + deferred + shed == submitted`` for every priority
    tier — no decision is lost or double-counted, even through
    ``admission.flap`` forced-level windows (server/admission.py).
``class_capacity``
    per-device-class conservation: within every device class (including
    the class-less ""), summed live-allocation usage never exceeds the
    class's summed reserved-adjusted capacity on non-terminal nodes. A
    per-node overcommit is already ``node_capacity``; this catches the
    heterogeneity-specific failure where a policy pass (or its cache's
    class column going stale) books work against a class that doesn't
    hold it (scheduler/hetero.py, device/cache.py).
``shard_consistency``
    with a multi-chip mesh active, the DeviceStateCache's sharded
    device-resident capacity, re-gathered to host per shard, equals the
    store-derived reference tensors *exactly* (bitwise) — per-shard
    incremental refresh (dirty-region tracking) and the
    ``mesh.shard_refresh_drop`` chaos recovery path never leave a stale
    slice on any device (device/cache.py). The capacity half runs
    whenever the cache holds a sharded capacity view (a node-axis mesh,
    its shards on one card or several) and is skipped, as the
    reference skips it, with a degenerate mesh; the score half
    (``verify_score_view``) runs whenever a score view exists.
    ``report.info["shard_consistency"]`` says which halves ran.
``cp_assignment_conservation``
    every group that entered a CP joint pass (scheduler/cp.py) ended
    exactly one of placed / deferred / failed — the ``nomad.cp.*``
    pass ledger balances — and no pass ever committed usage beyond a
    node's capacity (``nomad.cp.capacity_violations`` stays 0), even
    through ``cp.round_perturb`` price-perturbation windows.
``calibration_sanity``
    the calibration plane (obs/calibrate.py) degrades to declared,
    never to garbage: every throughput-estimator cell is finite and
    positive, a cell below the sample floor reports ``source: default``
    (and only then), a learned read stays inside the clamp band of its
    anchor, and every calibration-table constant is finite with a known
    provenance source — including through ``calib.telemetry_drop``
    starvation windows.
``gang_atomicity``
    after quiesce every gang job (structs/job.py ``gang`` stanza) is
    fully placed or fully absent: its member task groups all run
    exactly their desired counts, or all run zero — never a striped
    partial gang. Holds through ``gang.commit_drop`` dropped/killed
    commits and cp-gang in-pass releases (scheduler/generic.py
    ``_enforce_gang_atomicity``, invariant law 15).
``migration_conservation``
    live migration conserves identity and capacity (server/defrag.py).
    After quiesce every migrated alloc serves exactly once: no group
    slot holds two live defrag replacements (a double-committed move),
    and no replacement's source alloc is still live (an unrecovered
    half-move — the recovery scan bounds mid-move to one cycle). The
    controller's mid-move capacity audit never fired
    (``nomad.migrate.capacity_violations`` stays 0): free capacity was
    conserved at every point between phase A and phase B, including
    through ``migrate.move_drop`` and ``migrate.kill_mid_move`` faults.
"""

from __future__ import annotations

from typing import Optional

from ..structs import allocs_fit
from ..structs.evaluation import (
    EVAL_STATUS_BLOCKED,
    EVAL_STATUS_FAILED,
    EVAL_STATUS_PENDING,
)

INVARIANTS = (
    "node_capacity",
    "plan_ledger",
    "index_monotonic",
    "overlay_drained",
    "broker_conservation",
    "swallow_ring",
    "job_conservation",
    "eval_terminal",
    "lane_isolation",
    "admission_conservation",
    "class_capacity",
    "shard_consistency",
    "cp_assignment_conservation",
    "calibration_sanity",
    "gang_atomicity",
    "migration_conservation",
)


class Violation:
    __slots__ = ("invariant", "subject", "detail")

    def __init__(self, invariant: str, subject: str, detail: str):
        self.invariant = invariant
        self.subject = subject
        self.detail = detail

    def row(self) -> str:
        return f"{self.invariant}: {self.subject}: {self.detail}"

    def __repr__(self):
        return f"Violation({self.row()})"


class InvariantReport:
    def __init__(self):
        self.checked: dict[str, bool] = {}
        self.violations: list[Violation] = []
        # free-form run stats for human rendering; excluded from the
        # canonical dict because some (queue depths, retry counts) are
        # timing-dependent while the verdicts are not
        self.info: dict[str, object] = {}

    @property
    def ok(self) -> bool:
        return not self.violations

    def _fail(self, invariant: str, subject: str, detail: str) -> None:
        self.checked[invariant] = False
        self.violations.append(Violation(invariant, subject, detail))

    def to_dict(self) -> dict:
        """Canonical form: deterministic for a deterministic workload."""
        return {
            "ok": self.ok,
            "invariants": {
                name: ("ok" if self.checked.get(name, True) else "violated")
                for name in INVARIANTS
            },
            "violations": sorted(v.row() for v in self.violations),
        }

    def render(self) -> str:
        lines = []
        for name in INVARIANTS:
            state = "ok" if self.checked.get(name, True) else "VIOLATED"
            if name not in self.checked:
                state = "skipped"
            lines.append(f"  {name:<20s} {state}")
        for v in self.violations:
            lines.append(f"  !! {v.row()}")
        return "\n".join(lines)


def metrics_baseline() -> dict:
    """Snapshot the swallow counters + error-ring total before a run so
    the swallow_ring check measures only the run's own deltas."""
    from ..obs.recorder import flight_recorder
    from ..utils.metrics import global_metrics

    counters = global_metrics.snapshot()["counters"]
    swallowed = sum(
        v for k, v in counters.items() if k.endswith(".swallowed_errors")
    )
    return {
        "swallowed": swallowed,
        "ring": flight_recorder.errors_total,
        "lane_conflicts": counters.get("nomad.plan.lane_conflicts", 0),
        "cross_lane_writes": counters.get(
            "nomad.overlay.cross_lane_writes", 0
        ),
    }


def check_cluster(
    server,
    plane=None,
    baseline: Optional[dict] = None,
) -> InvariantReport:
    """Run every conservation check against a (quiesced) live Server."""
    from ..obs.recorder import flight_recorder
    from ..utils.metrics import global_metrics

    report = InvariantReport()
    store = server.store
    snap = store.snapshot()
    broker = server.eval_broker

    # -- node_capacity + class_capacity ------------------------------------
    from ..structs.resources import node_comparable_capacity

    report.checked["node_capacity"] = True
    report.checked["class_capacity"] = True
    n_nodes = 0
    class_cap: dict[str, object] = {}
    class_used: dict[str, object] = {}
    for node in snap.nodes():
        if node.terminal_status():
            continue
        n_nodes += 1
        live = [
            a for a in snap.allocs_by_node(node.id) if not a.terminal_status()
        ]
        fits, dim, used = allocs_fit(node, live, check_devices=True)
        if not fits:
            report._fail(
                "node_capacity",
                node.id,
                f"{len(live)} live allocs overcommit {dim} (used {used})",
            )
        dc = getattr(node, "device_class", "")
        cap_vec = node_comparable_capacity(node).to_vector()
        if dc in class_cap:
            class_cap[dc] = class_cap[dc] + cap_vec
        else:
            class_cap[dc] = cap_vec
        for a in live:
            use_vec = a.comparable_resources().to_vector()
            if dc in class_used:
                class_used[dc] = class_used[dc] + use_vec
            else:
                class_used[dc] = use_vec
    for dc, used_vec in sorted(class_used.items()):
        cap_vec = class_cap.get(dc)
        if cap_vec is None or (used_vec > cap_vec).any():
            report._fail(
                "class_capacity",
                dc or "(class-less)",
                f"summed live usage {used_vec} exceeds class capacity "
                f"{cap_vec}",
            )
    report.info["nodes"] = n_nodes
    report.info["device_classes"] = len(class_cap)

    # -- plan_ledger -------------------------------------------------------
    if plane is not None:
        report.checked["plan_ledger"] = True
        for alloc_id, count in sorted(plane.committed.items()):
            if count != 1:
                report._fail(
                    "plan_ledger",
                    alloc_id,
                    f"placement committed {count} times (expected exactly 1)",
                )
            elif snap.alloc_by_id(alloc_id) is None:
                report._fail(
                    "plan_ledger",
                    alloc_id,
                    "committed placement missing from the state store",
                )
        report.info["ledger_commits"] = len(plane.committed)

    # -- index_monotonic ---------------------------------------------------
    report.checked["index_monotonic"] = True
    journal = store.journal
    with journal._lock:
        entries = list(journal._entries)
    prev = 0
    for idx, table, key in entries:
        if idx < prev:
            report._fail(
                "index_monotonic",
                f"{table}/{key}",
                f"journal index went backwards ({prev} -> {idx})",
            )
            break
        prev = idx
    if entries and entries[-1][0] > store.latest_index:
        report._fail(
            "index_monotonic",
            "latest_index",
            f"journal head {entries[-1][0]} > store latest "
            f"{store.latest_index}",
        )

    # -- overlay_drained ---------------------------------------------------
    overlay = getattr(server, "placement_overlay", None)
    if overlay is not None:
        report.checked["overlay_drained"] = True
        if hasattr(overlay, "snapshot_markers"):
            # LaneOverlays: every per-worker overlay must drain
            markers = overlay.snapshot_markers()
            if not isinstance(markers, list):
                markers = [markers]
        else:
            with overlay._lock:
                markers = [(overlay._passes, overlay._commits)]
        for w, (passes, commits) in enumerate(markers):
            if passes or commits:
                report._fail(
                    "overlay_drained",
                    f"placement_overlay[{w}]",
                    f"markers leaked after quiesce: passes={passes} "
                    f"commits={commits}",
                )

    # -- broker_conservation -----------------------------------------------
    report.checked["broker_conservation"] = True
    c = broker.counters
    with broker._lock:
        outstanding = len(broker._unack)
    resolved = c["acks"] + c["nacks"] + c["unack_timeouts"]
    if c["dequeues"] != resolved + outstanding:
        report._fail(
            "broker_conservation",
            "eval_broker",
            f"dequeues={c['dequeues']} != acks={c['acks']} + "
            f"nacks={c['nacks']} + unack_timeouts={c['unack_timeouts']} "
            f"+ outstanding={outstanding}",
        )
    if outstanding:
        report._fail(
            "broker_conservation",
            "eval_broker",
            f"{outstanding} evals still unacked after quiesce",
        )
    report.info["broker"] = dict(c)

    # -- swallow_ring ------------------------------------------------------
    report.checked["swallow_ring"] = True
    now = metrics_baseline()
    base = baseline or {"swallowed": 0, "ring": 0}
    d_swallowed = now["swallowed"] - base["swallowed"]
    d_ring = now["ring"] - base["ring"]
    if d_swallowed > d_ring:
        report._fail(
            "swallow_ring",
            "count_swallowed",
            f"{d_swallowed} swallow counter bumps but only {d_ring} "
            "error-ring events",
        )
    report.info["swallowed"] = d_swallowed

    # -- job_conservation --------------------------------------------------
    report.checked["job_conservation"] = True
    failed_ids = set(broker.failed_eval_ids())
    jobs_seen: set[tuple[str, str]] = set()
    for job in snap.jobs():
        jobs_seen.add((job.namespace, job.id))
    # jobs that were deregistered but still have allocs on the books
    for alloc in snap.allocs():
        jobs_seen.add((alloc.namespace, alloc.job_id))
    blocked = server.blocked_evals
    for namespace, job_id in sorted(jobs_seen):
        job = snap.job_by_id(namespace, job_id)
        if job is not None and job.type != "service":
            continue
        desired = 0
        if job is not None:
            desired = sum(job.required_allocs().values())
        live = [
            a
            for a in snap.allocs_by_job(namespace, job_id)
            if not a.terminal_status()
        ]
        if len(live) == desired:
            continue
        # failed is terminal parking like the broker's failed queue: a
        # deadline-capped eval explains its job's shortfall the same way
        # a delivery-limit-capped one does
        accounted = any(
            ev.status
            in (EVAL_STATUS_PENDING, EVAL_STATUS_BLOCKED, EVAL_STATUS_FAILED)
            or ev.id in failed_ids
            for ev in snap.evals_by_job(namespace, job_id)
        ) or blocked.get_blocked(namespace, job_id) is not None
        if accounted:
            continue
        kind = "surplus" if len(live) > desired else "shortfall"
        report._fail(
            "job_conservation",
            f"{namespace}/{job_id}",
            f"unaccounted {kind}: {len(live)} live allocs vs desired "
            f"{desired} with no outstanding eval",
        )
    report.info["jobs"] = len(jobs_seen)

    # -- eval_terminal -----------------------------------------------------
    report.checked["eval_terminal"] = True
    tracked = broker.tracked_eval_ids()
    tracked |= {ev.id for ev in server.blocked_evals.captured()}
    for ev in snap.evals():
        if ev.terminal_status() or ev.status == EVAL_STATUS_BLOCKED:
            continue
        if ev.id not in tracked:
            report._fail(
                "eval_terminal",
                ev.id,
                f"eval for {ev.namespace}/{ev.job_id} is {ev.status} but "
                "tracked by no queue",
            )

    # -- lane_isolation ----------------------------------------------------
    # Checked whenever the lane machinery exists (it is structural, so
    # the counters must stay zero even at one worker); the claim-table
    # drain additionally proves no reservation leaked past quiesce —
    # including through handoff_drop faults and kill-mid-handoff.
    claims = getattr(server, "lane_claims", None)
    if claims is not None:
        report.checked["lane_isolation"] = True
        base = baseline or {}
        d_conflicts = now["lane_conflicts"] - base.get("lane_conflicts", 0)
        d_xwrites = now["cross_lane_writes"] - base.get(
            "cross_lane_writes", 0
        )
        if d_conflicts:
            report._fail(
                "lane_isolation",
                "plan_applier",
                f"{d_conflicts} lane conflicts (merged plans escaped "
                "ownership or bounced on foreign nodes)",
            )
        if d_xwrites:
            report._fail(
                "lane_isolation",
                "placement_overlay",
                f"{d_xwrites} cross-lane overlay writes refused (a worker "
                "wrote into a peer's epoch)",
            )
        if not claims.drained():
            report._fail(
                "lane_isolation",
                "lane_claims",
                f"{claims.active_count()} claims still active after "
                f"quiesce (nodes {sorted(claims.blocked_node_ids())})",
            )
        report.info["lanes"] = claims.snapshot()

    # -- admission_conservation --------------------------------------------
    # Law 10: the admission controller's per-tier decision ledger must
    # balance — every submitted decision resolved as exactly one of
    # admitted, deferred, or shed. Per-server counters, so no baseline
    # is needed; checked whenever the controller exists, including
    # through admission.flap forced-level windows.
    adm = getattr(server, "admission", None)
    if adm is not None:
        report.checked["admission_conservation"] = True
        adm_counters = adm.counters()
        for tier in sorted(adm_counters):
            c2 = adm_counters[tier]
            resolved = c2["admitted"] + c2["deferred"] + c2["shed"]
            if resolved != c2["submitted"]:
                report._fail(
                    "admission_conservation",
                    f"tier:{tier}",
                    f"submitted={c2['submitted']} != "
                    f"admitted={c2['admitted']} + deferred={c2['deferred']} "
                    f"+ shed={c2['shed']}",
                )
        report.info["admission"] = adm.snapshot()

    # -- cp_assignment_conservation ----------------------------------------
    # Law 13: the CP dispatcher's pass ledger must balance — every group
    # submitted to a joint pass resolved as exactly one of placed,
    # deferred, or failed — and no pass may ever have committed usage
    # beyond capacity. Checked whenever any CP pass ran this process
    # (counter-based, like law 10; perturbation windows included).
    cp_counters = global_metrics.snapshot()["counters"]
    cp_groups = cp_counters.get("nomad.cp.groups_in", 0)
    if cp_groups:
        report.checked["cp_assignment_conservation"] = True
        resolved = (
            cp_counters.get("nomad.cp.placed_groups", 0)
            + cp_counters.get("nomad.cp.deferred_groups", 0)
            + cp_counters.get("nomad.cp.failed_groups", 0)
        )
        if resolved != cp_groups:
            report._fail(
                "cp_assignment_conservation",
                "cp_pass_ledger",
                f"groups_in={cp_groups} != placed+deferred+failed="
                f"{resolved}",
            )
        cp_viol = cp_counters.get("nomad.cp.capacity_violations", 0)
        if cp_viol:
            report._fail(
                "cp_assignment_conservation",
                "cp_capacity",
                f"{cp_viol} node-rounds committed usage beyond capacity",
            )

    # -- shard_consistency -------------------------------------------------
    # Law 12: with a multi-chip mesh active, the device-resident capacity
    # shards (per-shard incremental refresh, device/cache.py) re-gathered
    # to host must equal the store-derived reference bitwise — including
    # after mesh.shard_refresh_drop recovery. Skipped when no sharded
    # device view ever materialized (a degenerate mesh: the cache keeps
    # the capacity as one tensor).
    cache = getattr(server, "device_cache", None)
    halves = {"capacity": "skipped", "score": "skipped"}
    verify_device_view = getattr(cache, "verify_device_view", None)
    if verify_device_view is not None:
        mismatches = verify_device_view()
        if mismatches is not None:
            report.checked["shard_consistency"] = True
            halves["capacity"] = "checked"
            for detail in mismatches:
                report._fail("shard_consistency", "device_cache", detail)
            report.info["device_cache"] = cache.device_counters()
    # Score half of law 12: the persisted score-state shards (incremental
    # rescoring, device/cache.py) re-gathered to host must equal their
    # generation mirror bitwise — including after cache.score_refresh_drop
    # recovery and killed commits. Checked whenever a score view ever
    # materialized; unlike the capacity half it also exists with the mesh
    # off (the degenerate path persists a whole-tensor buffer).
    if cache is not None:
        score_mismatches = cache.verify_score_view()
        if score_mismatches is not None:
            report.checked["shard_consistency"] = True
            halves["score"] = "checked"
            for detail in score_mismatches:
                report._fail("shard_consistency", "score_view", detail)
            report.info["device_cache"] = cache.device_counters()
    report.info["shard_consistency"] = halves

    # -- calibration_sanity ------------------------------------------------
    # Law 14: estimation degrades to declared, never to garbage. Checked
    # whenever the server carries a calibration plane (estimator/table);
    # telemetry-drop starvation must leave every cell honest.
    import math as _math

    est = getattr(server, "throughput_estimator", None)
    table = getattr(server, "calibration", None)
    if est is not None or table is not None:
        report.checked["calibration_sanity"] = True
    if est is not None:
        esnap = est.snapshot()
        floor = esnap["sample_floor"]
        band = esnap["clamp_band"]
        for key, cell in esnap["cells"].items():
            ema = cell["ema"]
            if not (_math.isfinite(ema) and ema > 0):
                report._fail(
                    "calibration_sanity",
                    f"cell:{key}",
                    f"non-finite/non-positive ema {ema!r}",
                )
            want = "default" if cell["samples"] < floor else "learned"
            if cell["source"] != want:
                report._fail(
                    "calibration_sanity",
                    f"cell:{key}",
                    f"samples={cell['samples']} (floor {floor}) but "
                    f"source={cell['source']!r}, want {want!r}",
                )
            value, source = est.value(
                cell["device_class"], cell["profile"], declared=1.0
            )
            if source == "learned" and not (
                1.0 / band <= value <= band
            ):
                report._fail(
                    "calibration_sanity",
                    f"cell:{key}",
                    f"learned value {value} outside clamp band "
                    f"[{1.0 / band}, {band}] of unit anchor",
                )
        report.info["calibration_estimator"] = {
            k: esnap[k]
            for k in ("cell_count", "learned_cells", "samples", "dropped")
        }
    if table is not None:
        tsnap = table.snapshot()
        for name, entry in tsnap["constants"].items():
            if not _math.isfinite(entry["value"]):
                report._fail(
                    "calibration_sanity",
                    f"constant:{name}",
                    f"non-finite value {entry['value']!r}",
                )
            if entry["source"] not in ("default", "probe", "learned"):
                report._fail(
                    "calibration_sanity",
                    f"constant:{name}",
                    f"unknown provenance source {entry['source']!r}",
                )
        report.info["calibration_by_source"] = tsnap["by_source"]

    # -- gang_atomicity ----------------------------------------------------
    # Law 15: a gang is fully placed or fully absent. For every live gang
    # job, each member group runs exactly its desired count or every
    # member runs zero — a mixed state means a release path (scheduler/
    # generic.py _enforce_gang_atomicity, or the cp-gang kernel's
    # release_incomplete_gangs) let a fragment stripe through, including
    # under gang.commit_drop dropped/killed commits.
    gang_jobs = 0
    for job in snap.jobs():
        gang = getattr(job, "gang", None) or {}
        members = [m for m in (gang.get("groups") or ())]
        if not members or job.stopped():
            continue
        gang_jobs += 1
        report.checked["gang_atomicity"] = True
        desired = job.required_allocs()
        counts = {}
        for m in members:
            counts[m] = sum(
                1
                for a in snap.allocs_by_job(job.namespace, job.id)
                if a.task_group == m and not a.terminal_status()
            )
        full = all(counts[m] == desired.get(m, 0) for m in members)
        absent = all(counts[m] == 0 for m in members)
        if not (full or absent):
            report._fail(
                "gang_atomicity",
                f"{job.namespace}/{job.id}",
                "gang striped: member live counts "
                f"{sorted(counts.items())} vs desired "
                f"{sorted((m, desired.get(m, 0)) for m in members)} "
                "(want all-full or all-zero)",
            )
    report.info["gang_jobs"] = gang_jobs

    # -- migration_conservation --------------------------------------------
    # Law 16: every migrated alloc serves exactly once after quiesce.
    # The two-phase protocol (server/defrag.py) may hold both halves of
    # a move live BETWEEN phases, but quiesce includes the recovery
    # scan, so a surviving pair means phase B was lost AND never
    # recovered; two live replacements for one slot means one planned
    # move committed twice. The controller's own mid-move audits
    # (capacity with both halves counted) must never have fired.
    from ..server.defrag import DEFRAG_DESC

    counters_now = global_metrics.snapshot()["counters"]
    migrate_active = any(
        k.startswith("nomad.migrate.") for k in counters_now
    )
    reps_by_slot: dict[tuple, int] = {}
    for a in snap.allocs():
        if a.terminal_status() or a.desired_description != DEFRAG_DESC:
            continue
        migrate_active = True
        report.checked.setdefault("migration_conservation", True)
        slot = (a.namespace, a.job_id, a.task_group, a.name)
        reps_by_slot[slot] = reps_by_slot.get(slot, 0) + 1
        if reps_by_slot[slot] > 1:
            report._fail(
                "migration_conservation",
                "/".join(slot),
                f"{reps_by_slot[slot]} live defrag replacements for one "
                "group slot (a move double-committed)",
            )
        if a.previous_allocation:
            old = snap.alloc_by_id(a.previous_allocation)
            if old is not None and not old.terminal_status():
                report._fail(
                    "migration_conservation",
                    a.id,
                    f"half-move unresolved at quiesce: source alloc "
                    f"{old.id} still live beside its replacement",
                )
    if migrate_active:
        report.checked.setdefault("migration_conservation", True)
        cap_viol = counters_now.get("nomad.migrate.capacity_violations", 0)
        if cap_viol:
            report._fail(
                "migration_conservation",
                "capacity",
                f"mid-move capacity audit fired {cap_viol} times "
                "(free capacity went negative between phases)",
            )

    # context for the human-facing dump
    from ..resilience.breaker import snapshot_all

    report.info["breakers"] = snapshot_all()
    report.info["ring_errors"] = len(flight_recorder.errors())
    report.info["counters"] = {
        k: v
        for k, v in global_metrics.snapshot()["counters"].items()
        if k.startswith((
            "nomad.chaos.", "nomad.resilience.", "nomad.lane.",
            "nomad.overlay.", "nomad.plan.lane", "nomad.plan.cross_lane",
            "nomad.admission.", "nomad.cp.", "nomad.gang.",
            "nomad.migrate.", "nomad.drain.",
        ))
        or k == "nomad.broker.nack_redelivery_delayed"
        or k.endswith(".swallowed_errors")
    }
    return report
