"""Runtime lock-graph race detector (the lockdep analog).

Env-gated via ``NOMAD_TPU_RACECHECK=1``: ``install()`` replaces
``threading.Lock``/``RLock``/``Condition`` with instrumented wrappers for
locks *created from nomad_tpu_torch or test code* (stdlib internals keep real
locks — the creation-site filter keeps the blast radius at zero for
logging/queue/concurrent.futures machinery). Each wrapper records, per
thread, the stack of held locks; acquiring B while holding A adds the
edge A→B to a global lock graph keyed by creation site (two instances
born on the same line are the same graph node, exactly how lockdep
classes locks). A cycle in that graph is a deadlock that merely hasn't
fired yet.

Guarded fields: ``guarded_by("_lock")`` is a class-level descriptor that,
while a detector is installed, verifies the instance's named lock is held
by the accessing thread and records a violation otherwise — the runtime
twin of the static NTA005 rule.

Usage (tests/test_torch_analysis.py):

    with race.racecheck() as graph:
        ...construct brokers/stores/workers and hammer them...
    # racecheck() raises RaceError on cycles or guarded-field violations

or, env-gated for a whole test module, via the conftest fixture.
"""

from __future__ import annotations

import os
import sys
import threading
from contextlib import contextmanager

ENV_VAR = "NOMAD_TPU_RACECHECK"

_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock
_REAL_CONDITION = threading.Condition


def enabled() -> bool:
    return os.environ.get(ENV_VAR, "") not in ("", "0")


class RaceError(AssertionError):
    """Lock-order cycle or guarded-field violation."""


class LockGraph:
    """Global acquisition-order graph + guarded-field violation log."""

    def __init__(self):
        # the graph's own lock must be a REAL lock: it is taken inside
        # every instrumented acquire and must never recurse into itself
        self._mu = _REAL_LOCK()
        # (held_site, acquired_site) -> example "thread: held -> acquired"
        self._edges: dict[tuple[str, str], str] = {}
        self._tls = threading.local()
        self._field_violations: list[str] = []

    # -- per-thread held stack ---------------------------------------------
    def _held(self) -> list:
        h = getattr(self._tls, "held", None)
        if h is None:
            h = self._tls.held = []
        return h

    def note_acquire(self, lock: "_InstrumentedBase") -> None:
        held = self._held()
        new_edges = []
        for other in held:
            if other is lock or other.nta_name == lock.nta_name:
                continue  # reentrancy / same lock class: not an ordering
            new_edges.append((other.nta_name, lock.nta_name))
        held.append(lock)
        if new_edges:
            tname = threading.current_thread().name
            with self._mu:
                for e in new_edges:
                    self._edges.setdefault(e, f"{tname}: {e[0]} -> {e[1]}")

    def note_release(self, lock: "_InstrumentedBase") -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is lock:
                del held[i]
                return

    def holds(self, lock: "_InstrumentedBase") -> bool:
        return any(h is lock for h in self._held())

    def held_count(self, lock: "_InstrumentedBase") -> int:
        return sum(1 for h in self._held() if h is lock)

    # -- guarded fields ----------------------------------------------------
    def note_unguarded(self, desc: str) -> None:
        with self._mu:
            self._field_violations.append(desc)

    # -- reporting ---------------------------------------------------------
    def edges(self) -> dict[tuple[str, str], str]:
        with self._mu:
            return dict(self._edges)

    def field_violations(self) -> list[str]:
        with self._mu:
            return list(self._field_violations)

    def cycles(self) -> list[list[str]]:
        """Enumerate simple cycles in the acquired-before graph (each
        reported once, from its lexicographically smallest node)."""
        edges = self.edges()
        adj: dict[str, set[str]] = {}
        for a, b in edges:
            adj.setdefault(a, set()).add(b)
        cycles: list[list[str]] = []
        seen_cycles: set[tuple[str, ...]] = set()

        def dfs(start: str, node: str, path: list[str]) -> None:
            for nxt in sorted(adj.get(node, ())):
                if nxt == start:
                    # canonicalize: rotate so min node leads
                    cyc = path[:]
                    m = cyc.index(min(cyc))
                    key = tuple(cyc[m:] + cyc[:m])
                    if key not in seen_cycles:
                        seen_cycles.add(key)
                        cycles.append(list(key))
                elif nxt > start and nxt not in path:
                    dfs(start, nxt, path + [nxt])

        for start in sorted(adj):
            dfs(start, start, [start])
        return cycles

    def report(self) -> dict:
        return {
            "edges": {f"{a} -> {b}": ex for (a, b), ex in self.edges().items()},
            "cycles": self.cycles(),
            "field_violations": self.field_violations(),
        }

    def assert_clean(self) -> None:
        cycles = self.cycles()
        fields = self.field_violations()
        if cycles or fields:
            lines = []
            for c in cycles:
                lines.append("lock-order cycle: " + " -> ".join(c + [c[0]]))
            lines.extend(fields)
            raise RaceError("; ".join(lines))


class _InstrumentedBase:
    """Shared bookkeeping for Lock/RLock wrappers. Implements the private
    hooks ``threading.Condition`` probes (``_is_owned``, ``_release_save``,
    ``_acquire_restore``) so instrumented locks nest under Conditions."""

    def __init__(self, graph: LockGraph, name: str, inner):
        self._inner = inner
        self.nta_graph = graph
        self.nta_name = name

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self.nta_graph.note_acquire(self)
        return ok

    def release(self) -> None:
        self._inner.release()
        self.nta_graph.note_release(self)

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def _is_owned(self) -> bool:  # Condition support
        return self.nta_graph.holds(self)

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.nta_name} of {self._inner!r}>"


class _InstrumentedLock(_InstrumentedBase):
    def _release_save(self):  # Condition.wait on a plain Lock
        self.release()

    def _acquire_restore(self, _state) -> None:
        self.acquire()


class _InstrumentedRLock(_InstrumentedBase):
    def locked(self) -> bool:
        # RLock.locked() exists on 3.12+; emulate via ownership otherwise
        try:
            return self._inner.locked()
        except AttributeError:
            return self.nta_graph.held_count(self) > 0

    def _release_save(self):
        # Condition.wait must drop ALL recursive holds
        count = self.nta_graph.held_count(self)
        state = self._inner._release_save()
        for _ in range(count):
            self.nta_graph.note_release(self)
        return (state, count)

    def _acquire_restore(self, state) -> None:
        inner_state, count = state
        self._inner._acquire_restore(inner_state)
        for _ in range(count):
            self.nta_graph.note_acquire(self)


# -- installation -----------------------------------------------------------

_active_graph: LockGraph | None = None
_install_depth = 0


def active_graph() -> LockGraph | None:
    return _active_graph


def _creation_site(depth: int = 2) -> str | None:
    """``file.py:lineno`` of the Lock() call site, or None when the lock
    is born outside nomad_tpu_torch/test code and should stay uninstrumented."""
    frame = sys._getframe(depth)
    fname = frame.f_code.co_filename
    base = os.path.basename(fname)
    if "nomad_tpu" not in fname and not base.startswith("test"):
        return None
    return f"{base}:{frame.f_lineno}"


def _lock_factory():
    site = _creation_site()
    if site is None or _active_graph is None:
        return _REAL_LOCK()
    return _InstrumentedLock(_active_graph, site, _REAL_LOCK())


def _rlock_factory():
    site = _creation_site()
    if site is None or _active_graph is None:
        return _REAL_RLOCK()
    return _InstrumentedRLock(_active_graph, site, _REAL_RLOCK())


def _condition_factory(lock=None):
    # a bare Condition() would build its RLock from inside threading.py
    # (filtered as stdlib); hand it an instrumented one from the real
    # caller's site instead
    if lock is None and _active_graph is not None:
        site = _creation_site()
        if site is not None:
            lock = _InstrumentedRLock(_active_graph, site, _REAL_RLOCK())
    return _REAL_CONDITION(lock)


def install() -> LockGraph:
    """Start a detection window: fresh graph, patched lock factories.
    Locks created before install() keep their real implementation —
    construct the objects under test inside the window."""
    global _active_graph, _install_depth
    _install_depth += 1
    if _active_graph is None:
        _active_graph = LockGraph()
        threading.Lock = _lock_factory
        threading.RLock = _rlock_factory
        threading.Condition = _condition_factory
    return _active_graph


def uninstall() -> None:
    global _active_graph, _install_depth
    _install_depth = max(0, _install_depth - 1)
    if _install_depth == 0:
        threading.Lock = _REAL_LOCK
        threading.RLock = _REAL_RLOCK
        threading.Condition = _REAL_CONDITION
        _active_graph = None


@contextmanager
def racecheck(strict: bool = True):
    """Detection window as a context manager; on exit, raises RaceError
    when strict and the graph saw a cycle or guarded-field violation."""
    graph = install()
    try:
        yield graph
    finally:
        uninstall()
    if strict:
        graph.assert_clean()


# -- guarded fields ----------------------------------------------------------


class guarded_by:
    """Class-level descriptor declaring which lock guards a field::

        class Store:
            watermark = guarded_by("_lock")

    While a detector is installed and the instance's lock is an
    instrumented one, every get/set verifies the current thread holds
    that lock; violations land in the graph's field report instead of
    raising at the access site (the access itself is still performed, so
    production behavior is unchanged)."""

    def __init__(self, lock_attr: str):
        self.lock_attr = lock_attr
        self.name = "<unbound>"

    def __set_name__(self, owner, name: str) -> None:
        self.name = name
        self.slot = f"_guarded_{name}"

    def _check(self, obj, op: str) -> None:
        lock = getattr(obj, self.lock_attr, None)
        if isinstance(lock, _InstrumentedBase):
            graph = lock.nta_graph
            if not graph.holds(lock):
                graph.note_unguarded(
                    f"unguarded {op} of {type(obj).__name__}.{self.name} "
                    f"without holding {self.lock_attr} "
                    f"({lock.nta_name}) on thread "
                    f"{threading.current_thread().name}"
                )

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        self._check(obj, "read")
        return getattr(obj, self.slot, None)

    def __set__(self, obj, value) -> None:
        self._check(obj, "write")
        object.__setattr__(obj, self.slot, value)
