"""nomad_tpu_torch.chaos — deterministic fault injection.

A :class:`FaultPlane` injects faults at named *sites* compiled into the
production seams. The plane is off by default: every site is a single
global load + ``is None`` branch when no plane is installed.

The port carries the part of the JAX package's plane that its seams
need (``plane.py``): the calibration estimator's schedulable
``calib.telemetry_drop``; ``ChaosFault`` / ``ChaosThreadKill``,
``make_fault`` and the commit ledger (``note_committed``) for the
server's sites, where nothing can be scheduled yet. The sites that
the earlier copies left out, the other fault kinds, the invariant checks
(``invariants.py``) and the seeded cluster runner (``runner.py``) are not
ported yet (ROADMAP A14).
"""

from .plane import (  # noqa: F401
    SITES,
    ChaosFault,
    ChaosThreadKill,
    FaultPlane,
    FaultSpec,
    active_plane,
    chaos_site,
    install,
    make_fault,
    note_committed,
    uninstall,
)
