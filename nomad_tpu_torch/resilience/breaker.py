"""Per-kernel circuit breaker: closed → open → half-open.

Every kernel wrapper owns one breaker, keyed by the JAX package's
kernel name (``place_closed_form_kernel``, …, ``migrate_plan_kernel``).
Repeated exceptions (``failure_threshold`` consecutive) or a single
watchdog timeout trip it; while open, the kernel guard
(``backend.guarded_call``) refuses the call with ``KernelUnavailable``
and launches nothing — the port never finishes a call on a plain
version, so the worker nacks the eval and the broker redelivers it.
After a seeded-jitter exponential backoff one probe call is let through
half-open: success closes the breaker, failure re-opens it with doubled
backoff.

The jitter is deterministic — ``random.Random(f"{name}:{trips}")`` — so
a chaos run's recovery timing is a function of the seed-driven fault
order, not of process entropy. Registry-level ``set_forced_open`` is
the bench/degraded-mode override: it makes every ``allow()`` return
False without touching per-breaker state.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Callable, Dict, Optional

from ..utils.metrics import global_metrics

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"
_STATE_GAUGE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


class CircuitBreaker:
    """One kernel's degradation state. All transitions hold ``_lock``;
    ``allow``/``record_*`` are called from the kernel hot path, so the
    closed-state fast path is one lock acquire and two reads."""

    def __init__(
        self,
        name: str,
        *,
        failure_threshold: int = 3,
        execute_deadline: float = 5.0,
        compile_deadline: float = 60.0,
        backoff_base: float = 1.0,
        backoff_cap: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.name = name
        self.failure_threshold = failure_threshold
        self.execute_deadline = execute_deadline
        self.compile_deadline = compile_deadline
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._trips = 0
        self._reopens = 0  # trips without an intervening close
        self._probe_at = 0.0
        self._probing = False
        self._backoff_s = 0.0
        self.last_error = ""
        self.last_trip_unix = 0.0

    # -- hot path ------------------------------------------------------------

    def allow(self) -> bool:
        """True = run the device kernel; False = refuse the call.
        While open, exactly one caller is admitted half-open once the
        probe backoff elapses; concurrent callers stay refused."""
        if _FORCED_OPEN.is_set():
            return False
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN and self._clock() >= self._probe_at:
                self._set_state(HALF_OPEN)
            if self._state == HALF_OPEN and not self._probing:
                self._probing = True
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
            self._probing = False
            if self._state != CLOSED:
                self._reopens = 0
                self._set_state(CLOSED)

    def record_failure(self, error: Optional[BaseException] = None) -> None:
        with self._lock:
            self._consecutive_failures += 1
            if error is not None:
                self.last_error = repr(error)
            if self._state == HALF_OPEN:
                self._trip_locked("probe failure")
            elif (
                self._state == CLOSED
                and self._consecutive_failures >= self.failure_threshold
            ):
                self._trip_locked(
                    f"{self._consecutive_failures} consecutive failures"
                )

    def record_timeout(self, error: Optional[BaseException] = None) -> None:
        """A deadline blow-out trips immediately — a hung device does
        not get ``failure_threshold`` more chances to hang siblings."""
        with self._lock:
            if error is not None:
                self.last_error = repr(error)
            if self._state != OPEN:
                self._trip_locked("watchdog timeout")

    # -- manual overrides ----------------------------------------------------

    def force_open(self) -> None:
        with self._lock:
            if self._state != OPEN:
                self._trip_locked("forced open")
            # never probe out of a manual open on its own
            self._probe_at = float("inf")

    def force_closed(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
            self._probing = False
            self._reopens = 0
            if self._state != CLOSED:
                self._set_state(CLOSED)

    # -- internals -----------------------------------------------------------

    def _trip_locked(self, reason: str) -> None:
        self._trips += 1
        self._reopens += 1
        self._probing = False
        self._consecutive_failures = 0
        raw = min(
            self.backoff_cap,
            self.backoff_base * (2.0 ** (self._reopens - 1)),
        )
        jitter = random.Random(f"{self.name}:{self._trips}").uniform(0.5, 1.5)
        self._backoff_s = raw * jitter
        self._probe_at = self._clock() + self._backoff_s
        self.last_trip_unix = time.time()
        self._set_state(OPEN)
        global_metrics.incr("nomad.resilience.trips_total")
        try:
            from ..obs.recorder import flight_recorder

            flight_recorder.record_error(
                "resilience",
                f"breaker {self.name} tripped ({reason}); "
                f"probe in {self._backoff_s:.2f}s; "
                f"last_error={self.last_error or 'n/a'}",
            )
        except Exception:
            pass

    def _set_state(self, state: str) -> None:
        self._state = state
        global_metrics.set_gauge(
            f"nomad.resilience.breaker_state.{self.name}",
            _STATE_GAUGE[state],
        )

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "state": self._state,
                "trips": self._trips,
                "consecutive_failures": self._consecutive_failures,
                "backoff_s": round(self._backoff_s, 4),
                "probe_in_s": (
                    round(max(0.0, self._probe_at - self._clock()), 4)
                    if self._state == OPEN and self._probe_at != float("inf")
                    else 0.0
                ),
                "execute_deadline_s": self.execute_deadline,
                "compile_deadline_s": self.compile_deadline,
                "failure_threshold": self.failure_threshold,
                "last_error": self.last_error,
                "last_trip_unix": self.last_trip_unix,
            }


# -- registry ----------------------------------------------------------------

_REG_LOCK = threading.Lock()
_BREAKERS: Dict[str, CircuitBreaker] = {}
_FORCED_OPEN = threading.Event()
_TUNABLES = (
    "failure_threshold",
    "execute_deadline",
    "compile_deadline",
    "backoff_base",
    "backoff_cap",
)
# None = "no env pin": the deadline defaults then come from the
# calibration table (obs/calibrate.py, resilience.execute_deadline_s /
# compile_deadline_s) so they carry provenance. Env vars keep
# precedence, and configure() overrides both.
_DEFAULTS: dict = {
    "failure_threshold": _env_int("NOMAD_TPU_BREAKER_THRESHOLD", 3),
    "execute_deadline": _env_float("NOMAD_TPU_KERNEL_EXECUTE_DEADLINE", None),
    "compile_deadline": _env_float("NOMAD_TPU_KERNEL_COMPILE_DEADLINE", None),
    "backoff_base": _env_float("NOMAD_TPU_BREAKER_BACKOFF", 1.0),
    "backoff_cap": _env_float("NOMAD_TPU_BREAKER_BACKOFF_CAP", 30.0),
}


def _resolved_defaults() -> dict:
    """Concrete constructor kwargs: env-pinned / configure()d values win;
    an unpinned deadline reads the calibration table at construction
    time (lazy import — same cycle workaround as server/admission.py)."""
    out = dict(_DEFAULTS)
    if out["execute_deadline"] is None or out["compile_deadline"] is None:
        from ..obs.calibrate import global_table

        tbl = global_table.breaker_defaults()
        if out["execute_deadline"] is None:
            out["execute_deadline"] = tbl["execute_deadline"]
        if out["compile_deadline"] is None:
            out["compile_deadline"] = tbl["compile_deadline"]
    return out


def breaker_for(name: str) -> CircuitBreaker:
    with _REG_LOCK:
        br = _BREAKERS.get(name)
        if br is None:
            br = CircuitBreaker(name, **_resolved_defaults())
            _BREAKERS[name] = br
        return br


def all_breakers() -> Dict[str, CircuitBreaker]:
    with _REG_LOCK:
        return dict(_BREAKERS)


def snapshot_all() -> Dict[str, dict]:
    return {name: br.snapshot() for name, br in all_breakers().items()}


def configure(**overrides) -> dict:
    """Override registry defaults (and push tunables onto live breakers
    — the chaos runner shortens deadlines for kernels that already
    traced). Returns the previous defaults so callers can restore:
    ``prev = configure(execute_deadline=0.1); ...; configure(**prev)``.
    """
    with _REG_LOCK:
        prev = dict(_DEFAULTS)
        for key, value in overrides.items():
            if key not in _DEFAULTS:
                raise TypeError(f"unknown breaker tunable: {key}")
            _DEFAULTS[key] = value
        resolved = _resolved_defaults()
        for br in _BREAKERS.values():
            for key in _TUNABLES:
                setattr(br, key, resolved[key])
        return prev


def reset_all() -> None:
    """Drop every breaker (fresh closed state on next ``breaker_for``)
    and clear the forced-open override. Test/chaos-run hygiene."""
    with _REG_LOCK:
        _BREAKERS.clear()
    _FORCED_OPEN.clear()


def set_forced_open(flag: bool) -> None:
    """Registry-wide degraded-mode switch: every ``allow()`` returns
    False while set, so every guarded kernel call is refused."""
    if flag:
        _FORCED_OPEN.set()
    else:
        _FORCED_OPEN.clear()


def forced_open() -> bool:
    return _FORCED_OPEN.is_set()


def degraded() -> bool:
    """True when any kernel is off the device path — forced open, or at
    least one breaker not closed. Cheap enough for once-per-pass use."""
    if _FORCED_OPEN.is_set():
        return True
    with _REG_LOCK:
        return any(br._state != CLOSED for br in _BREAKERS.values())
