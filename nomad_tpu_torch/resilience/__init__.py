"""nomad_tpu_torch.resilience — unified degradation layer.

Three surfaces keep the scheduler placing allocations when the device,
the transport, or a single pass misbehaves:

- :mod:`breaker` — per-kernel circuit breakers with watchdog deadlines;
  a tripped kernel's calls are refused (``KernelUnavailable``) until a
  half-open probe launches it again. The port never finishes a call on
  a plain version: the worker nacks the eval and the broker redelivers
  it.
- :mod:`watchdog` — the deadline executor behind the breaker (poisoned
  worker threads, build-aware two-stage deadlines; an abandoned thunk
  launches nothing).
- eval-lifecycle deadlines live at their call site (``server/worker.py``)
  and share the exception types in :mod:`errors`.

The guard that puts a breaker and the watchdog in front of every kernel
launch is ``backend.guarded_call``. Obs surface:
``nomad.resilience.breaker_state.<kernel>`` gauges, ``trips_total``,
``refused_calls``, ``abandoned_skips``, ``eval.deadline_nacks``
counters; ``fallback_calls`` and ``fallback_passes`` stay in the SLO
schema and read 0. Breaker trips land in the flight recorder.
"""

from .breaker import (
    CircuitBreaker,
    all_breakers,
    breaker_for,
    configure,
    degraded,
    forced_open,
    reset_all,
    set_forced_open,
    snapshot_all,
)
from .errors import EvalDeadlineExceeded, KernelDeadlineExceeded, KernelUnavailable
from .watchdog import DeadlineExecutor, global_executor

__all__ = [
    "CircuitBreaker",
    "DeadlineExecutor",
    "EvalDeadlineExceeded",
    "KernelDeadlineExceeded",
    "KernelUnavailable",
    "all_breakers",
    "breaker_for",
    "configure",
    "degraded",
    "forced_open",
    "global_executor",
    "reset_all",
    "set_forced_open",
    "snapshot_all",
]
