"""Chaos runner — a seeded in-process cluster under a fault schedule.

``run_chaos(seed, steps, device=...)`` boots a single-server cluster on
``device`` (default ``"cuda"``, as every entry point; one pipelined
batching worker, the chaos clock threaded into broker + heartbeater,
short redelivery deadlines so recovery paths actually run), installs a
:class:`FaultPlane`, drives a seeded job workload (register / scale /
deregister), quiesces, and checks every cluster invariant.

Determinism contract: the *canonical* output — seed, fault schedule,
invariant verdicts — is a pure function of the arguments, so two runs
with the same seed emit byte-identical reports. Runtime detail (which
faults fired, retry counts, the kernel refusals, the defrag moves) is
reported separately as diagnostics. The port's runner also makes the
fault order a function of the seed: each op is drained before the next,
the defrag cycles are stepped between ops (``_drive_workload``) and
admission reads op time (``_RunClock``), so two runs of one seed fire
the same faults on the same calls and make the same moves.

On the card no kernel call is finished on the CPU: a breaker that
refuses, or a deadline that fires, raises out of the kernel guard and the
worker nacks the eval for redelivery (``backend.guarded_call``). The
diagnostics count those evals (``report.info["kernel_refusals"]``): how
many were refused, how many ended placed, how many parked failed.

On a violation, ``shrink_schedule`` greedily re-runs with ever-smaller
fault subsets until no single fault can be removed without the failure
disappearing — the minimal failing schedule to attach to a bug report.
"""

from __future__ import annotations

import json
import random
import time
from typing import Optional

from .invariants import InvariantReport, check_cluster, metrics_baseline
from .plane import FAULT_KINDS, FaultPlane, FaultSpec, install, uninstall

DEFAULT_NODES = 6
# recovery latencies scaled for a test run: redelivery must happen in
# milliseconds-to-seconds, not the production 60 s deadline
RUN_UNACK_TIMEOUT = 1.5
RUN_NACK_DELAY = 0.1
RUN_INITIAL_NACK_DELAY = 0.05
# workload ops between two settle points (``_drive_workload``)
SETTLE_EVERY = 8
# the drain check's poll: it runs after every op (three calm polls in a
# row make a drained cluster), within SETTLE_TIMEOUT_S
QUIESCE_POLL_S = 0.005
SETTLE_TIMEOUT_S = 10.0
# op time: how far the run's monotonic clock moves per workload op
# (``_RunClock``); one admission re-evaluation interval
RUN_OP_SECONDS = 0.25
# the kernel guard's execute deadline in a run on the card, and the factor
# a run on the CPU scales it and every injected kernel hang by: the plain
# versions a CPU run computes take far longer than the card's kernels,
# and on a slow host more than 0.1 s, so an unscaled deadline refuses
# legitimate calls there (an injected hang, 0.2-0.5 s, is still at least
# twice the deadline either way and trips the breaker the first time)
RUN_EXECUTE_DEADLINE = 0.1
CPU_DEADLINE_SCALE = 10.0


class _RunClock:
    """The run's server clock. ``time()`` is the chaos clock, real time
    plus the injected skew, which broker and worker deadlines read.
    ``monotonic()`` is op time, ``RUN_OP_SECONDS`` a workload op plus
    the same skew, which admission and the heartbeat TTLs read: so that
    admission's re-evaluations, the ``admission.flap`` hits and the
    windows they force fall on the same ops in every run, however fast
    the host runs them."""

    def __init__(self, chaos_clock):
        self._chaos = chaos_clock
        self.ops = 0

    def time(self) -> float:
        return self._chaos.time()

    def monotonic(self) -> float:
        return self.ops * RUN_OP_SECONDS + self._chaos.offset

    def tick(self) -> None:
        self.ops += 1


class ChaosRun:
    """Result of one chaos run: canonical report + diagnostics."""

    def __init__(
        self,
        seed: int,
        steps: int,
        faults: tuple[str, ...],
        schedule_rows: list[str],
        report: InvariantReport,
        workload: dict,
        triggered: list,
        duration_s: float,
        recorder_errors: list,
    ):
        self.seed = seed
        self.steps = steps
        self.faults = faults
        self.schedule_rows = schedule_rows
        self.report = report
        self.workload = workload
        self.triggered = triggered
        self.duration_s = duration_s
        self.recorder_errors = recorder_errors

    @property
    def ok(self) -> bool:
        return self.report.ok

    def canonical(self) -> dict:
        """The bit-reproducible part: pure function of (seed, steps,
        faults) plus the invariant verdicts. ``rejected`` is excluded
        from the workload — whether an injected raft drop lands on a
        workload RPC or on an applier commit depends on which call
        reaches the site Nth, i.e. on thread interleaving."""
        return {
            "seed": self.seed,
            "steps": self.steps,
            "faults": sorted(self.faults),
            "schedule": list(self.schedule_rows),
            "workload": {
                k: v for k, v in self.workload.items() if k != "rejected"
            },
            "invariants": self.report.to_dict(),
        }

    def canonical_json(self) -> str:
        return json.dumps(self.canonical(), sort_keys=True, indent=2)

    def render(self, verbose: bool = False) -> str:
        lines = [
            f"chaos run: seed={self.seed} steps={self.steps} "
            f"faults={'+'.join(sorted(self.faults))}",
            f"fault schedule ({len(self.schedule_rows)} planned):",
        ]
        lines += [f"  {row}" for row in self.schedule_rows]
        lines.append(
            "workload: "
            + " ".join(f"{k}={v}" for k, v in sorted(self.workload.items()))
        )
        lines.append("invariants:")
        lines.append(self.report.render())
        lines.append("PASS" if self.ok else "FAIL")
        if verbose or not self.ok:
            lines.append(
                f"-- diagnostics (timing-dependent; {self.duration_s:.2f}s) --"
            )
            lines.append(f"triggered ({len(self.triggered)}):")
            lines += [
                f"  {site}[{n}] {action}" for site, n, action in self.triggered
            ]
            for k, v in sorted(self.report.info.items()):
                lines.append(f"  {k}: {v}")
        if not self.ok and self.recorder_errors:
            lines.append("-- flight recorder error ring (newest first) --")
            for e in self.recorder_errors[:25]:
                lines.append(f"  [{e.get('component')}] {e.get('error')}")
        return "\n".join(lines)


def _build_node(i: int):
    from .. import mock

    return mock.node(id=f"chaos-node-{i:02d}", name=f"chaos-node-{i:02d}")


def _build_job(seq: int, count: int, priority: int):
    from .. import mock
    from ..structs import Resources, Task, TaskGroup

    j = mock.job(id=f"chaos-job-{seq:04d}", name=f"chaos-job-{seq:04d}")
    j.priority = priority

    def _tg(name: str) -> TaskGroup:
        return TaskGroup(
            name=name,
            count=count,
            tasks=[
                Task(
                    name=name,
                    driver="exec",
                    # sized so the seeded workload fills well under the
                    # fleet: deregister churn leaves holes AND headroom,
                    # which is what live migration needs to act on — a
                    # saturated fleet has no destination for any move
                    resources=Resources(cpu=128, memory_mb=64),
                )
            ],
        )

    if seq % 5 == 4:
        # every fifth job is a two-group gang: the atomic-commit seam
        # (law 15, scheduler/generic.py) only gets exercised if gangs
        # flow through the ordinary op stream — registers, scales, and
        # deregisters alike — under the same faults as everything else.
        # Keyed off seq (not an rng draw) so the workload's draw count
        # per step is unchanged and canonical reports stay comparable.
        j.task_groups = [_tg("a"), _tg("b")]
        j.gang = {
            "groups": ["a", "b"],
            "colocate": {"level": "rack", "weight": 1.0},
        }
    else:
        j.task_groups = [_tg("web")]
    return j


def _flip_pending(server) -> None:
    """The run's stand-in for a client plane: pending allocs come up
    ``running`` through the ordinary client-update path. Without it the
    fleet never serves — drainer health checks and the defrag candidate
    filter (server/defrag.py: only running allocs migrate) would see
    nothing to act on. Failures are a client's problem — it retries."""
    import copy

    updates = []
    for a in server.store.allocs():
        if a.desired_status == "run" and a.client_status == "pending":
            u = copy.copy(a)
            u.client_status = "running"
            updates.append(u)
    if updates:
        try:
            server.update_allocs_from_client(updates)
        except Exception:
            pass  # injected raft drop: a real client retries next poll


def _settle(server, defrag: bool) -> None:
    """One of the run's settle points: placed allocs come up, the
    cluster drains, and, with ``defrag``, one defrag cycle runs on the
    drained cluster and is drained in turn."""
    _flip_pending(server)
    _quiesce(server, SETTLE_TIMEOUT_S)
    if defrag:
        server.defrag.supervised_cycle()
        _quiesce(server, SETTLE_TIMEOUT_S)


def _drive_workload(
    server, seed: int, steps: int, defrag: bool, touch_nodes: int = 0
) -> dict:
    """Seeded register/scale/deregister stream. The generator's state
    depends ONLY on its rng — a register the cluster rejected (injected
    raft drop) is still remembered as attempted, so the op sequence and
    draw count per step are identical across runs no matter which
    faults fired.

    Each op is drained before the next is submitted, and every
    ``SETTLE_EVERY`` ops a settle point flips placed allocs to running
    and steps one defrag cycle on the drained cluster (``_settle``). So
    the worker's batches, its kernel calls, the defrag controller's and
    the fault sites they hit come in an order that the seed alone
    decides: ops streamed into a busy worker are batched as they happen
    to arrive, and a free defrag thread beside the worker made the
    order follow the threads' timing.

    With ``touch_nodes`` (the fleet's size), each settle point first
    re-registers one node of the fleet, in turn: no rng draw, so the op
    stream is the same."""
    rng = random.Random(f"{seed}:workload")
    attempted: list[str] = []
    seq = 0
    counts = {
        "registers": 0,
        "gang_registers": 0,
        "scales": 0,
        "deregisters": 0,
        "rejected": 0,
    }
    if touch_nodes:
        counts["node_touches"] = 0

    def _submit(fn):
        try:
            fn()
            return True
        except Exception:
            # injected raft drop / plan-time fault surfaced on the
            # endpoint: a real client would retry; the workload moves on
            counts["rejected"] += 1
            return False

    for _step in range(steps):
        server.config.clock.tick()  # a _RunClock: admission's op time
        r = rng.random()
        if r < 0.55 or len(attempted) < 3:
            count = rng.randint(1, 3)
            priority = rng.choice((30, 50, 70))
            job_id = f"chaos-job-{seq:04d}"
            _submit(
                lambda: server.register_job(_build_job(seq, count, priority))
            )
            attempted.append(job_id)
            if seq % 5 == 4:
                counts["gang_registers"] += 1
            seq += 1
            counts["registers"] += 1
        elif r < 0.85:
            target = rng.choice(attempted)
            count = rng.randint(1, 4)
            target_seq = int(target.rsplit("-", 1)[1])
            _submit(
                lambda: server.register_job(_build_job(target_seq, count, 50))
            )
            counts["scales"] += 1
        else:
            target = rng.choice(attempted)
            _submit(
                lambda: server.deregister_job("default", target)
            )
            counts["deregisters"] += 1
        _quiesce(server, SETTLE_TIMEOUT_S)
        if _step % SETTLE_EVERY == SETTLE_EVERY - 1 or _step == steps - 1:
            if touch_nodes:
                node = _build_node(counts["node_touches"] % touch_nodes)
                _submit(lambda: server.register_node(node))
                counts["node_touches"] += 1
            _settle(server, defrag)
    return counts


class _RefusalLog:
    """Flight-recorder listener: the evals a kernel refusal or a missed
    kernel deadline nacked (the worker closes their traces with the
    error's repr). ``outcome`` says what became of them."""

    _ERRORS = ("KernelUnavailable(", "KernelDeadlineExceeded(")

    def __init__(self):
        self.eval_ids: set[str] = set()

    def __call__(self, trace: dict) -> None:
        error = str((trace.get("tags") or {}).get("error", ""))
        if error.startswith(self._ERRORS):
            self.eval_ids.add(trace.get("eval_id", ""))

    def outcome(self, server) -> dict:
        """The counts, and ``jobs``: each refused eval's job and how it
        ended, sorted (eval ids are random; job ids come from the seed)."""
        failed = set(server.eval_broker.failed_eval_ids())
        snap = server.store.snapshot()
        placed = parked = 0
        jobs = []
        for eval_id in self.eval_ids:
            ev = snap.eval_by_id(eval_id)
            if eval_id in failed or (ev is not None and ev.status == "failed"):
                parked += 1
                end = "parked_failed"
            elif ev is not None and ev.status == "complete":
                placed += 1
                end = "ended_placed"
            else:
                end = ev.status if ev is not None else "unknown"
            jobs.append(f"{ev.job_id if ev is not None else '?'} {end}")
        return {"evals": len(self.eval_ids), "ended_placed": placed,
                "parked_failed": parked, "jobs": sorted(jobs)}


def defrag_moves(server) -> list[str]:
    """Every live-migration move the run committed, as ``job name
    from-node -> to-node`` rows, sorted: the replacement allocs the
    controller placed (server/defrag.py ``DEFRAG_DESC``) against the
    allocs they replace."""
    from ..server.defrag import DEFRAG_DESC

    snap = server.store.snapshot()
    rows = []
    for a in snap.allocs():
        if a.desired_description != DEFRAG_DESC or not a.previous_allocation:
            continue
        old = snap.alloc_by_id(a.previous_allocation)
        src = old.node_id if old is not None else "?"
        rows.append(f"{a.job_id} {a.name} {src} -> {a.node_id}")
    return sorted(rows)


def _quiesce(server, timeout: float) -> bool:
    """Wait until the broker (ready/unacked/delayed/deferred), the plan
    queue, and the workers' commit threads are all drained. The failed
    queue and blocked evals are terminal parking, not work."""
    deadline = time.time() + timeout
    calm = 0
    while time.time() < deadline:
        d = server.eval_broker.queue_depths()
        busy = d["ready"] + d["unacked"] + d["delayed"] + d["deferred"]
        threads_busy = any(
            w._commit_thread is not None and w._commit_thread.is_alive()
            for w in server.workers
        )
        defrag_busy = not server.defrag.drained()
        if (
            busy == 0
            and server.plan_queue.depth() == 0
            and not threads_busy
            and not defrag_busy
        ):
            calm += 1
            if calm >= 3:  # stable across three polls, not a gap between ops
                return True
        else:
            calm = 0
        time.sleep(QUIESCE_POLL_S)
    return False


def run_chaos(
    seed: int = 7,
    steps: int = 200,
    faults: tuple[str, ...] = FAULT_KINDS,
    nodes: int = DEFAULT_NODES,
    rate: float = 0.04,
    schedule: Optional[list[FaultSpec]] = None,
    quiesce_timeout: float = 60.0,
    num_batch_workers: int = 1,
    incremental: Optional[bool] = None,
    defrag_interval: float = 0.05,
    device="cuda",
    node_touches: bool = False,
) -> ChaosRun:
    """One full chaos cycle: boot, inject, quiesce, check, tear down.

    ``incremental`` pins the score-state cache (device/cache.py) on or
    off for the run; None inherits the ambient NOMAD_TPU_INCREMENTAL
    resolution. Chaos runs with it on exercise cache.score_refresh_drop
    and the score half of invariant law 12.

    ``defrag_interval > 0`` enables defragmentation for the run
    (server/defrag.py): the runner steps one cycle at each settle point
    of the workload (every ``SETTLE_EVERY`` ops), so live migration
    churns between the op groups and the ``migrate.*`` fault sites land
    on real two-phase moves; ``<= 0`` runs no cycle. The controller's
    thread gets no period either way (it waits for an operator trigger
    that never comes), so that no cycle races the worker.

    ``device`` is the server's (``ServerConfig(device=...)``): every
    worker's kernels and the defrag controller's run there.

    ``node_touches`` re-registers one node at every settle point, so the
    device cache refreshes node rows during the run: under a node-axis
    mesh that is the per-shard capacity refresh and its
    ``mesh.shard_refresh_drop`` site. Off by default: the workload has no
    node op, and its canonical reports stay as they were."""
    import os

    from .. import backend as _backend
    from ..obs.recorder import flight_recorder
    from ..server.server import Server, ServerConfig

    _incr_prev: Optional[str] = None
    if incremental is not None:
        _incr_prev = os.environ.get("NOMAD_TPU_INCREMENTAL")
        os.environ["NOMAD_TPU_INCREMENTAL"] = "on" if incremental else "off"
        _backend.reset_incremental()

    faults = tuple(faults)
    import torch

    scale = CPU_DEADLINE_SCALE if torch.device(device).type == "cpu" else 1.0
    plane = FaultPlane(
        seed=seed, steps=steps, faults=faults, rate=rate, schedule=schedule,
        hang_scale=scale,
    )
    baseline = metrics_baseline()
    # breaker deadlines scaled like the broker deadlines above: injected
    # kernel hangs run 0.2-0.5 s, so a 0.1 s execute deadline trips on
    # the first hang (≤3-consecutive-failures acceptance bound) while
    # legitimate executes at this cluster size stay sub-millisecond on
    # the card; on the CPU both are scaled by CPU_DEADLINE_SCALE (the
    # schedule's rows, and so the canonical report, keep the unscaled
    # hang lengths); compile still gets the full production allowance
    # via the trace-started probe
    from ..resilience import breaker as _breaker

    _breaker.reset_all()
    _prev_breaker = _breaker.configure(
        execute_deadline=RUN_EXECUTE_DEADLINE * scale,
        backoff_base=0.05,
        backoff_cap=0.25,
    )
    t_start = time.perf_counter()
    server = Server(
        ServerConfig(
            # every worker batches: the chaos workload is service-only,
            # and system/_core evals ride the batch workers' singles
            # path, so solo workers would only add nondeterminism
            num_workers=num_batch_workers,
            num_batch_workers=num_batch_workers,
            # heartbeats come from no client here; a real TTL would mark
            # every node down mid-run (heartbeat expiry has its own
            # deterministic unit test — see tests/test_chaos.py)
            heartbeat_ttl=3600.0,
            clock=_RunClock(plane.clock),
            # admission's latency votes read eval latency, which follows
            # the host's load, not the seed: out of reach for the run
            # (its flap site and backlog votes stay)
            admission_overrides={
                "brownout_p99_ms": float("inf"),
                "shed_p99_ms": float("inf"),
            },
            # bounded live migration — and the migrate.* fault sites —
            # between the op groups (law 16, migration_conservation):
            # the runner steps the cycles, the controller's thread
            # stays idle
            defrag_interval=0.0,
            defrag_budget=2,
            device=device,
        )
    )
    broker = server.eval_broker
    broker.unack_timeout = RUN_UNACK_TIMEOUT
    broker.nack_delay = RUN_NACK_DELAY
    broker.initial_nack_delay = RUN_INITIAL_NACK_DELAY
    report: InvariantReport
    refusals = _RefusalLog()
    try:
        server.establish_leadership()
        for i in range(nodes):
            server.register_node(_build_node(i))
        # faults start with the workload: setup above is the fixture
        flight_recorder.add_listener(refusals)
        install(plane)
        try:
            workload = _drive_workload(
                server, seed, steps, defrag=defrag_interval > 0,
                touch_nodes=nodes if node_touches else 0,
            )
            quiesced = _quiesce(server, quiesce_timeout)
        finally:
            uninstall()
        # one fault-free settling pass: anything the faults parked on
        # the delayed heap drains at normal speed now
        if not quiesced:
            quiesced = _quiesce(server, 10.0)
        # no new moves past this point; a kill_mid_move that landed on
        # the *last* defrag cycle left a committed half-move with no
        # next cycle to recover it — finish phase B synchronously so
        # law 16 judges a settled cluster, not a mid-flight one
        server.defrag.stop()
        server.defrag.recover()
        report = check_cluster(server, plane=plane, baseline=baseline)
        report.info["quiesced"] = quiesced
        report.info["batch_workers"] = num_batch_workers
        report.info["kernel_refusals"] = refusals.outcome(server)
        report.info["defrag_moves"] = defrag_moves(server)
        if not quiesced:
            report._fail(
                "eval_terminal",
                "quiesce",
                f"cluster failed to quiesce within {quiesce_timeout}s",
            )
    finally:
        flight_recorder.remove_listener(refusals)
        try:
            server.shutdown()
        except Exception:
            from ..utils.metrics import count_swallowed

            count_swallowed("chaos", None)
        _breaker.configure(**_prev_breaker)
        _breaker.reset_all()
        if incremental is not None:
            if _incr_prev is None:
                os.environ.pop("NOMAD_TPU_INCREMENTAL", None)
            else:
                os.environ["NOMAD_TPU_INCREMENTAL"] = _incr_prev
            _backend.reset_incremental()
    return ChaosRun(
        seed=seed,
        steps=steps,
        faults=faults,
        schedule_rows=plane.schedule_rows(),
        report=report,
        workload=workload,
        triggered=list(plane.triggered),
        duration_s=time.perf_counter() - t_start,
        recorder_errors=flight_recorder.errors(),
    )


def shrink_schedule(
    seed: int,
    steps: int,
    faults: tuple[str, ...] = FAULT_KINDS,
    nodes: int = DEFAULT_NODES,
    rate: float = 0.04,
    schedule: Optional[list[FaultSpec]] = None,
    num_batch_workers: int = 1,
    log=None,
    device="cuda",
) -> tuple[list[FaultSpec], Optional[ChaosRun]]:
    """Greedy 1-minimal shrink of a failing schedule: drop one planned
    fault at a time, keep the drop whenever the run still violates an
    invariant. Returns (minimal schedule, last failing run) — or the
    original schedule and None if the failure did not reproduce."""
    if schedule is None:
        plane = FaultPlane(seed=seed, steps=steps, faults=faults, rate=rate)
        schedule = list(plane.schedule)
    base = run_chaos(
        seed=seed, steps=steps, faults=faults, nodes=nodes,
        schedule=schedule, num_batch_workers=num_batch_workers,
        device=device,
    )
    if base.ok:
        return schedule, None
    current = list(schedule)
    last_fail = base
    i = 0
    while i < len(current):
        trial = current[:i] + current[i + 1 :]
        if log:
            log(
                f"shrink: retry without {current[i].row()} "
                f"({len(trial)} faults)"
            )
        run = run_chaos(
            seed=seed, steps=steps, faults=faults, nodes=nodes,
            schedule=trial, num_batch_workers=num_batch_workers,
            device=device,
        )
        if not run.ok:
            current = trial  # still fails without it: drop for good
            last_fail = run
        else:
            i += 1  # load-bearing fault: keep it, try the next
    return current, last_fail
