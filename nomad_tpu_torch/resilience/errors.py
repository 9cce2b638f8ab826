"""Deadline exceptions shared across the resilience layer.

Both are plain ``Exception`` subclasses on purpose: they must be
catchable by the worker's generic recovery handlers (unlike
``ChaosThreadKill``, which models a crash and derives from
``BaseException`` so those handlers can NOT absorb it).
"""

from __future__ import annotations


class KernelDeadlineExceeded(RuntimeError):
    """A device kernel blew through its watchdog deadline. The call may
    still be running on an abandoned worker thread — the result, if it
    ever arrives, is discarded."""

    def __init__(self, name: str, deadline_s: float, phase: str = "execute"):
        self.kernel = name
        self.deadline_s = deadline_s
        self.phase = phase
        super().__init__(
            f"kernel {name} exceeded {deadline_s:.3f}s {phase} deadline"
        )


class EvalDeadlineExceeded(RuntimeError):
    """An evaluation's per-processing-pass deadline expired in the
    worker. The eval is nacked with escalating delay (attempt count
    carried on the eval) rather than held forever."""

    def __init__(self, eval_id: str, deadline_s: float, attempts: int = 0):
        self.eval_id = eval_id
        self.deadline_s = deadline_s
        self.attempts = attempts
        super().__init__(
            f"eval {eval_id} exceeded {deadline_s:.3f}s processing deadline "
            f"(attempts={attempts})"
        )
