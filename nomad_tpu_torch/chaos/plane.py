"""FaultPlane — deterministic fault injection at named sites.

The production seams call :func:`chaos_site` with a site name; when no
plane is installed that is one module-global load and an ``is None``
branch. When a plane is installed, each site keeps a monotone
*effective-call* counter, and the plane's schedule decides whether the
Nth effective call at that site injects a fault. The one kind carried
here is ``drop``, whose meaning the site decides.

The port carries only what its one seam needs: the calibration
estimator's ``calib.telemetry_drop``. The other sites and fault kinds,
seeded schedules, the skewable clock and the commit ledger come with the
seams that use them (ROADMAP A14).
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
