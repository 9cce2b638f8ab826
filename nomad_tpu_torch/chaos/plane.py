"""FaultPlane — seeded, deterministic fault injection at named sites.

The production seams call :func:`chaos_site` with a site name; when no
plane is installed that is one module-global load and an ``is None``
branch (the ``NOMAD_TPU_RACECHECK`` zero-overhead-when-off contract).
When a plane is installed, each site keeps a monotone *effective-call*
counter, and the plane's precomputed schedule — a pure function of
``(seed, site)`` — decides whether the Nth effective call at that site
injects a fault:

``raise``
    raise :class:`ChaosFault` (an ``Exception``: ordinary recovery
    paths — nack/redeliver, singles fallback — must absorb it, and any
    swallow site that does must go through ``count_swallowed``).
``delay``
    sleep a small deterministic duration at the site (lock-holding
    sites stall their peers, exactly the hazard being rehearsed).
``duplicate``
    duplicate delivery (broker ack: the eval is re-enqueued once after
    the ack, the classic at-least-once duplicate).
``drop``
    site-specific loss: a dequeue that never reaches the worker (unack
    deadline must redeliver), a lost ack, a rejected raft apply, a
    skipped heartbeat-expiry sweep.
``kill``
    cooperative thread crash: raises :class:`ChaosThreadKill` (a
    ``BaseException`` so ``except Exception`` recovery code cannot
    hide it); the worker commit thread catches it only at its thread
    boundary and simply dies, leaving its evals unacked.
``skew``
    step the shared :class:`ChaosClock` offset; components that took
    the injectable clock (broker unack sweep, heartbeat TTLs) see time
    jump.
``hang``
    block the site for ``arg`` seconds — a wedged PJRT call or a stuck
    connection. Unlike ``delay`` (a stall the caller rides out), a hang
    is scheduled only at sites guarded by a deadline (the kernel
    watchdog), which must get the caller's thread back.
``force`` / ``perturb``
    site-specific: the admission controller forces its overload level
    for a window; the CP dispatcher perturbs the auction's initial
    prices for one pass.

Schedules are deterministic per (seed, site, call-index), so a re-run
with the same seed plans — and, for a deterministic workload, fires —
the identical faults.

The port's table, kinds, horizons and schedules are the JAX package's,
site for site in the same order, so one seed plans the same rows in both.
``mesh.shard_refresh_drop`` and ``rpc.conn_drop`` stay in the table with
no seam in the port yet (node-axis sharding and the RPC client come with
later items): a single-card, single-server run never reaches them, just
as the reference's never does with no mesh. ``kernel.execute`` and
``kernel.hang`` sit in the kernel guard (``backend.guarded_call``) that
every kernel wrapper launches through.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Optional

ENV_VAR = "NOMAD_TPU_CHAOS"

#: site name → fault kinds that stay inside the system's recovery
#: contract at that seam. Kinds outside the tuple are never scheduled
#: there (e.g. silently dropping a plan commit the caller was told
#: succeeded is a loss *injected below the contract*, not a test).
SITES: dict[str, tuple[str, ...]] = {
    "broker.dequeue": ("delay", "drop", "skew"),
    "broker.ack": ("raise", "delay", "drop", "duplicate", "skew"),
    "plan_queue.enqueue": ("raise", "delay"),
    "plan_queue.enqueue_merged": ("raise", "delay", "kill"),
    "plan_apply.verify": ("raise", "delay"),
    "plan_apply.commit": ("raise", "delay"),
    "fsm.apply": ("delay", "drop"),
    "worker.commit": ("kill", "delay"),
    "heartbeat.expiry": ("drop", "delay", "skew"),
    "store.snapshot": ("raise", "delay"),
    "kernel.execute": ("raise", "delay"),
    "kernel.hang": ("hang",),
    "rpc.conn_drop": ("drop",),
    # cross-lane handoff protocol (server/lanes.py): a dropped confirm
    # must release the reservation (no leaked claims), a kill mid-
    # handoff must still settle/release via the worker's finally
    "lane.handoff_drop": ("drop", "kill"),
    "lane.handoff_delay": ("delay",),
    # admission controller (server/admission.py): force the overload
    # level to SHED for a bounded window mid-run — shed accounting
    # (invariant law 10) and NORMAL recovery must survive the flapping
    "admission.flap": ("force",),
    # mesh sharding (device/cache.py): drop a per-shard incremental
    # capacity upload — recovery must be a whole-tensor re-upload on
    # the same access, never a stale device shard (invariant law 12)
    "mesh.shard_refresh_drop": ("drop",),
    # CP dispatcher (scheduler/cp.py): perturb the solver's initial
    # prices for one joint pass — the assignment may legitimately shift,
    # but conservation (invariant law 13) must hold: every group ends
    # exactly one of placed/deferred/failed and capacity is never
    # exceeded post-round
    "cp.round_perturb": ("perturb",),
    # incremental score state (device/cache.py): drop one per-shard
    # score patch — recovery must be a full score rebuild on the same
    # access, never a stale device row; the staged/committed mirrors
    # stay bitwise-exact either way (invariant law 12, score half)
    "cache.score_refresh_drop": ("drop",),
    # calibration plane (obs/calibrate.py): drop estimator input samples
    # before they reach their cell — starved cells must keep reporting
    # source: default and answer the declared anchor, never a garbage
    # estimate (invariant law 14)
    "calib.telemetry_drop": ("drop",),
    # gang atomic commit (scheduler/generic.py): drop a healthy gang's
    # commit — every member must release and the whole gang ride one
    # blocked eval, never a striped partial plan; a kill mid-commit
    # leaves the plan unsubmitted (trivially atomic). Invariant law 15:
    # after quiesce a gang job is fully placed or fully absent.
    "gang.commit_drop": ("drop", "kill"),
    # defrag two-phase moves (server/defrag.py): a dropped move commits
    # nothing (conservation trivial); a kill or drop BETWEEN phase A
    # (replacement placed) and phase B (old stopped) leaves a committed
    # half-move that the recovery scan must finish, never double.
    # Invariant law 16: after quiesce every migrating alloc serves
    # exactly once, and capacity was conserved at every mid-move point.
    "migrate.move_drop": ("drop",),
    "migrate.kill_mid_move": ("kill", "drop"),
}

FAULT_KINDS = (
    "raise", "delay", "duplicate", "drop", "kill", "skew", "hang", "force",
    "perturb",
)

# Expected effective-call budget per site for a `steps`-op workload,
# as a fraction of steps (with a floor). Fault indices are sampled
# inside this horizon so a quiesced run has consumed them all.
_HORIZON = {
    "broker.dequeue": (1.0, 8),
    "broker.ack": (1.0, 8),
    "plan_queue.enqueue": (0.125, 2),
    "plan_queue.enqueue_merged": (0.125, 2),
    "plan_apply.verify": (0.125, 2),
    "plan_apply.commit": (0.125, 2),
    "fsm.apply": (1.0, 8),
    "worker.commit": (0.25, 2),
    "heartbeat.expiry": (0.0, 2),
    "store.snapshot": (0.25, 4),
    "kernel.execute": (0.125, 2),
    "kernel.hang": (0.125, 2),
    "rpc.conn_drop": (0.25, 2),
    "lane.handoff_drop": (0.25, 2),
    "lane.handoff_delay": (0.25, 2),
    # hit once per controller re-eval tick, not per workload op
    "admission.flap": (0.5, 4),
    # hit per cache device-view access with dirty regions pending
    "mesh.shard_refresh_drop": (0.125, 2),
    # hit once per joint CP placement pass, not per workload op
    "cp.round_perturb": (0.125, 2),
    # hit per score-view access with dirty rows pending (incremental on)
    "cache.score_refresh_drop": (0.125, 2),
    # hit once per gang-job scheduling pass, not per workload op
    "gang.commit_drop": (0.125, 2),
    # hit once per estimator input sample (span fan-out rate)
    "calib.telemetry_drop": (1.0, 8),
    # hit once per planned defrag move, a few moves per cycle
    "migrate.move_drop": (0.125, 2),
    "migrate.kill_mid_move": (0.125, 2),
}


class ChaosFault(RuntimeError):
    """Injected failure. An ``Exception`` on purpose: the same recovery
    paths that absorb infrastructure errors must absorb it, and
    ``count_swallowed`` tags it (``nomad.chaos.swallowed_faults``) so a
    swallow site can never absorb one silently."""

    nta_chaos_fault = True

    def __init__(self, site: str, index: int):
        super().__init__(f"chaos: injected fault at {site}[{index}]")
        self.site = site
        self.index = index
        self.accounted = False


class ChaosThreadKill(BaseException):
    """Cooperative thread crash. Derives from ``BaseException`` so the
    ``except Exception`` recovery handlers between the site and the
    thread boundary cannot absorb it — the thread dies with its work
    half done (``finally`` blocks still run; Python cannot skip them)."""

    nta_chaos_fault = True

    def __init__(self, site: str, index: int):
        super().__init__(f"chaos: thread kill at {site}[{index}]")
        self.site = site
        self.index = index


class ChaosClock:
    """Skewable clock: real time plus a plane-controlled offset. Both
    faces move together, so broker deadlines (``time``-like) and
    heartbeat TTLs (``monotonic``-like) observe the same jumps."""

    def __init__(self):
        self._offset = 0.0
        self._lock = threading.Lock()

    def time(self) -> float:
        return time.time() + self._offset

    def monotonic(self) -> float:
        return time.monotonic() + self._offset

    def skew(self, delta: float) -> float:
        with self._lock:
            self._offset += delta
            return self._offset

    @property
    def offset(self) -> float:
        return self._offset


class FaultSpec:
    """One planned injection: the Nth effective call at ``site`` runs
    ``action`` (arg = sleep seconds for delay, offset delta for skew)."""

    __slots__ = ("site", "index", "action", "arg")

    def __init__(self, site: str, index: int, action: str, arg: float = 0.0):
        if site not in SITES:
            raise ValueError(f"unknown chaos site {site!r}")
        if action not in SITES[site]:
            raise ValueError(f"action {action!r} not allowed at {site}")
        self.site = site
        self.index = index
        self.action = action
        self.arg = arg

    def row(self) -> str:
        return f"{self.site}[{self.index}] {self.action} {self.arg:.6f}"

    def __repr__(self):
        return f"FaultSpec({self.row()})"


def build_schedule(
    seed: int,
    steps: int,
    faults: tuple[str, ...] = FAULT_KINDS,
    sites: Optional[tuple[str, ...]] = None,
    rate: float = 0.04,
) -> list[FaultSpec]:
    """Deterministic schedule: a pure function of the arguments. Each
    site gets its own ``random.Random(f"{seed}:{site}")`` stream, so
    adding or removing one site never perturbs another's plan."""
    specs: list[FaultSpec] = []
    for site in sorted(sites if sites is not None else SITES):
        allowed = tuple(a for a in SITES[site] if a in faults)
        if not allowed:
            continue
        frac, floor = _HORIZON[site]
        horizon = max(floor, int(steps * frac))
        k = min(horizon, max(1, int(horizon * rate)))
        rng = random.Random(f"{seed}:{site}")
        for index in sorted(rng.sample(range(horizon), k)):
            action = rng.choice(allowed)
            arg = 0.0
            if action == "delay":
                arg = rng.uniform(0.001, 0.025)
            elif action == "hang":
                # long enough that any sane kernel deadline fires, short
                # enough that an abandoned watchdog thread drains fast
                arg = rng.uniform(0.2, 0.5)
            elif action == "skew":
                arg = rng.choice((-1.0, 1.0)) * rng.uniform(0.25, 1.5)
            specs.append(FaultSpec(site, index, action, arg))
    return specs


class FaultPlane:
    def __init__(
        self,
        seed: int = 0,
        steps: int = 200,
        faults: tuple[str, ...] = FAULT_KINDS,
        sites: Optional[tuple[str, ...]] = None,
        rate: float = 0.04,
        schedule: Optional[list[FaultSpec]] = None,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.seed = seed
        self.steps = steps
        self.faults = tuple(faults)
        self.clock = ChaosClock()
        self._sleep = sleep
        if schedule is None:
            schedule = build_schedule(seed, steps, self.faults, sites, rate)
        self.schedule = schedule
        self._by_site: dict[str, dict[int, FaultSpec]] = {}
        for spec in schedule:
            self._by_site.setdefault(spec.site, {})[spec.index] = spec
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}
        # runtime log: (site, effective index, action) actually fired
        self.triggered: list[tuple[str, int, str]] = []
        # every ChaosFault object this plane raised (swallow accounting)
        self.raised: list[ChaosFault] = []
        self.kills = 0
        # plan-commit ledger: alloc id → times committed. The plan
        # applier reports every committed placement through
        # note_committed(); the invariant checker demands each id lands
        # exactly once (no loss after a reported commit, no
        # double-commit of a merged-plan member).
        self.committed: dict[str, int] = {}

    # -- the hot path ------------------------------------------------------
    def hit(self, site: str) -> Optional[str]:
        """Consult the schedule for one effective call at ``site``.
        Returns the action name for caller-interpreted kinds
        ("drop"/"duplicate"), performs delay/skew inline, raises for
        raise/kill, and returns None when nothing is scheduled."""
        with self._lock:
            n = self._counts.get(site, 0)
            self._counts[site] = n + 1
            per_site = self._by_site.get(site)
            spec = per_site.get(n) if per_site else None
            if spec is None:
                return None
            self.triggered.append((site, n, spec.action))
        action = spec.action
        if action == "delay":
            self._sleep(spec.arg)
            return "delay"
        if action == "hang":
            self._sleep(spec.arg)
            return "hang"
        if action == "skew":
            self.clock.skew(spec.arg)
            return "skew"
        if action == "raise":
            fault = ChaosFault(site, n)
            with self._lock:
                self.raised.append(fault)
            raise fault
        if action == "kill":
            with self._lock:
                self.kills += 1
            raise ChaosThreadKill(site, n)
        # "drop" / "duplicate" / "force" / "perturb": the site decides
        # what it means
        return action

    def ledger_commit(self, alloc_ids) -> None:
        with self._lock:
            for aid in alloc_ids:
                self.committed[aid] = self.committed.get(aid, 0) + 1

    # -- reporting ---------------------------------------------------------
    def schedule_rows(self) -> list[str]:
        """Canonical planned schedule — deterministic for a seed."""
        return [s.row() for s in self.schedule]

    def site_counts(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counts)

    # -- construction ------------------------------------------------------
    @classmethod
    def from_env(cls, spec: str) -> "FaultPlane":
        """Parse ``seed=7,steps=200,rate=0.05,faults=raise+delay``."""
        kw: dict = {}
        for part in spec.split(","):
            part = part.strip()
            if not part or part in ("1", "on", "true"):
                continue
            key, _, val = part.partition("=")
            key = key.strip()
            if key == "seed":
                kw["seed"] = int(val)
            elif key == "steps":
                kw["steps"] = int(val)
            elif key == "rate":
                kw["rate"] = float(val)
            elif key == "faults":
                kw["faults"] = tuple(v for v in val.split("+") if v)
            elif key == "sites":
                kw["sites"] = tuple(v for v in val.split("+") if v)
            else:
                raise ValueError(f"unknown {ENV_VAR} key {key!r}")
        return cls(**kw)


# -- global install point (the zero-overhead-when-off seam) ----------------
_ACTIVE: Optional[FaultPlane] = None


def active_plane() -> Optional[FaultPlane]:
    return _ACTIVE


def install(plane: FaultPlane) -> FaultPlane:
    global _ACTIVE
    if _ACTIVE is not None and _ACTIVE is not plane:
        raise RuntimeError("a FaultPlane is already installed")
    _ACTIVE = plane
    return plane


def uninstall() -> None:
    global _ACTIVE
    _ACTIVE = None


def chaos_site(site: str) -> Optional[str]:
    """The hook compiled into production seams. One global load and an
    ``is None`` branch when chaos is off."""
    p = _ACTIVE
    if p is None:
        return None
    return p.hit(site)


def make_fault(site: str) -> ChaosFault:
    """For sites where a caller-interpreted action ("drop") surfaces as
    an error: builds the fault AND registers it with the active plane so
    swallow accounting still sees it."""
    fault = ChaosFault(site, -1)
    p = _ACTIVE
    if p is not None:
        with p._lock:
            p.raised.append(fault)
    return fault


def note_committed(alloc_ids) -> None:
    """Plan applier → ledger: these placements were committed."""
    p = _ACTIVE
    if p is None:
        return
    p.ledger_commit(alloc_ids)


def _maybe_autoinstall() -> None:
    import os

    spec = os.environ.get(ENV_VAR, "")
    if spec not in ("", "0"):
        install(FaultPlane.from_env(spec))


_maybe_autoinstall()
