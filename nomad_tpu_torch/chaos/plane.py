"""FaultPlane — deterministic fault injection at named sites.

The production seams call :func:`chaos_site` with a site name; when no
plane is installed that is one module-global load and an ``is None``
branch. When a plane is installed, each site keeps a monotone
*effective-call* counter, and the plane's schedule decides whether the
Nth effective call at that site injects a fault. The one kind carried
here is ``drop``, whose meaning the site decides.

The port carries what its seams need: the one schedulable site, the
calibration estimator's ``calib.telemetry_drop``; the server's sites
(broker, plan queue, applier, raft, lanes, worker), which call
:func:`chaos_site` and find nothing scheduled; the fault types they
raise or catch (:class:`ChaosFault` through :func:`make_fault`,
:class:`ChaosThreadKill`); and the commit ledger the applier reports to
(:func:`note_committed`). Scheduling faults at the server's sites, the
other fault kinds, seeded schedules and the skewable clock come with
ROADMAP A14.
"""

from __future__ import annotations

import threading
from typing import Optional

#: site name → fault kinds that stay inside the system's recovery
#: contract at that seam
SITES: dict[str, tuple[str, ...]] = {
    # calibration plane (obs/calibrate.py): drop estimator input samples
    # before they reach their cell — starved cells must keep reporting
    # source: default and answer the declared anchor, never a garbage
    # estimate (invariant law 14)
    "calib.telemetry_drop": ("drop",),
}


class FaultSpec:
    """One planned injection: the Nth effective call at ``site`` runs
    ``action``."""

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


class FaultPlane:
    def __init__(self, schedule: list[FaultSpec]):
        self.schedule = list(schedule)
        self._by_site: dict[str, dict[int, FaultSpec]] = {}
        for spec in self.schedule:
            self._by_site.setdefault(spec.site, {})[spec.index] = spec
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}
        # runtime log: (site, effective index, action) actually fired
        self.triggered: list[tuple[str, int, str]] = []
        # every ChaosFault object made at a site (swallow accounting)
        self.raised: list[ChaosFault] = []
        # plan-commit ledger: alloc id → times committed. The plan
        # applier reports every committed placement through
        # note_committed(); each id must land exactly once.
        self.committed: dict[str, int] = {}

    def hit(self, site: str) -> Optional[str]:
        """Consult the schedule for one effective call at ``site``:
        the scheduled action's name, or None when nothing is scheduled."""
        with self._lock:
            n = self._counts.get(site, 0)
            self._counts[site] = n + 1
            per_site = self._by_site.get(site)
            spec = per_site.get(n) if per_site else None
            if spec is None:
                return None
            self.triggered.append((site, n, spec.action))
        return spec.action

    def ledger_commit(self, alloc_ids) -> None:
        with self._lock:
            for aid in alloc_ids:
                self.committed[aid] = self.committed.get(aid, 0) + 1

    def site_counts(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counts)


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
