"""nomad_tpu_torch.chaos — deterministic fault injection + cluster invariants.

A seeded :class:`FaultPlane` injects faults (raise, delay, duplicate
delivery, drop, cooperative thread-kill, clock skew, kernel hang) at
named *sites* compiled into the production seams (broker dequeue/ack,
plan queue, plan apply verify/commit, raft apply, worker commit thread,
heartbeat expiry, store snapshot, the kernel guard, lanes, admission,
the CP dispatcher, the score-state cache, gang commits, defrag moves,
the calibration estimator). The plane is off by default: every site is a
single global load + ``is None`` branch when no plane is installed. Set
``NOMAD_TPU_CHAOS`` to a spec (``seed=7,steps=200,faults=raise+delay``)
to auto-install one.

:mod:`.invariants` checks the cluster's conservation laws after a run;
:mod:`.runner` drives a seeded in-process cluster on ``device`` through a
randomized workload and re-runs bit-identically from the same seed.
"""

from .plane import (  # noqa: F401
    ENV_VAR,
    FAULT_KINDS,
    SITES,
    ChaosClock,
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
from .invariants import InvariantReport, Violation, check_cluster  # noqa: F401
from .runner import ChaosRun, run_chaos, shrink_schedule  # noqa: F401
