"""Deadline executor: run a thunk on a reusable watchdog thread and
abandon it if it blows its deadline.

Python cannot kill a thread stuck inside a C extension (a hung PJRT
call never re-enters the interpreter), so on timeout the worker thread
is *poisoned*: the caller marks the job abandoned under its lock and
raises; when (if) the stuck call ever returns, the worker sees the
abandoned flag, discards the result, and exits instead of rejoining
the pool. A fresh worker is spawned for the next call. The happy path
reuses one idle thread per concurrency level — a queue hand-off and an
Event wait per kernel call, well under the ≤1% bench overhead budget.

The two-stage deadline mirrors compile-vs-execute reality: the caller
waits ``deadline_s`` first; if the job is still running but
``extend_probe()`` says a build actually started (an ``nvcc`` build or
a Triton specialization compiling, legitimately slow), the wait extends
to ``extend_deadline_s`` total before declaring a timeout.

A thunk can ask :func:`abandoned` whether its caller already gave up on
it: the kernel guard asks after its ``kernel.hang`` site and then
launches nothing, because a late launch on the card could write scratch
that the next call of the same kernel is using.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Optional

from .errors import KernelDeadlineExceeded

_MAX_IDLE = 8

# the job a watchdog thread is running, for abandoned()
_current = threading.local()


def abandoned() -> bool:
    """True when called from a watchdog thread whose job's caller has
    timed out and moved on. False on any other thread."""
    job = getattr(_current, "job", None)
    if job is None:
        return False
    with job.lock:
        return job.abandoned


class _Job:
    __slots__ = ("thunk", "done", "lock", "abandoned", "result", "error")

    def __init__(self, thunk: Callable[[], Any]):
        self.thunk = thunk
        self.done = threading.Event()
        self.lock = threading.Lock()
        self.abandoned = False
        self.result: Any = None
        self.error: Optional[BaseException] = None


class _Worker(threading.Thread):
    def __init__(self, pool: "DeadlineExecutor", n: int):
        super().__init__(name=f"kernel-watchdog-{n}", daemon=True)
        self.pool = pool
        self.inbox: "queue.Queue[Optional[_Job]]" = queue.Queue(maxsize=1)

    def run(self) -> None:
        while True:
            job = self.inbox.get()
            if job is None:
                return
            _current.job = job
            try:
                result = job.thunk()
                error: Optional[BaseException] = None
            except BaseException as e:  # re-raised in the caller thread
                result, error = None, e
            finally:
                _current.job = None
            with job.lock:
                if job.abandoned:
                    # timed out: the caller already raised and moved
                    # on — discard and die poisoned
                    return
                job.result, job.error = result, error
                job.done.set()
            self.pool._release(self)


class DeadlineExecutor:
    """Pool of watchdog threads, one in flight per concurrent caller."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._free: list[_Worker] = []
        self._spawned = 0
        self.poisoned = 0

    @property
    def spawned(self) -> int:
        with self._lock:
            return self._spawned

    def _acquire(self) -> _Worker:
        with self._lock:
            if self._free:
                return self._free.pop()
            self._spawned += 1
            w = _Worker(self, self._spawned)
        w.start()
        return w

    def _release(self, w: _Worker) -> None:
        with self._lock:
            if len(self._free) < _MAX_IDLE:
                self._free.append(w)
                return
        w.inbox.put(None)  # surplus: let the thread exit

    def run(
        self,
        thunk: Callable[[], Any],
        *,
        name: str,
        deadline_s: float,
        extend_deadline_s: Optional[float] = None,
        extend_probe: Optional[Callable[[], bool]] = None,
    ) -> Any:
        w = self._acquire()
        job = _Job(thunk)
        w.inbox.put(job)
        phase = "execute"
        finished = job.done.wait(deadline_s)
        if (
            not finished
            and extend_probe is not None
            and extend_deadline_s is not None
            and extend_deadline_s > deadline_s
            and extend_probe()
        ):
            phase = "compile"
            finished = job.done.wait(extend_deadline_s - deadline_s)
        if not finished:
            with job.lock:
                if not job.done.is_set():
                    job.abandoned = True
            if job.abandoned:
                with self._lock:
                    self.poisoned += 1
                deadline = (
                    extend_deadline_s if phase == "compile" else deadline_s
                )
                raise KernelDeadlineExceeded(name, deadline, phase)
        if job.error is not None:
            raise job.error
        return job.result


global_executor = DeadlineExecutor()
