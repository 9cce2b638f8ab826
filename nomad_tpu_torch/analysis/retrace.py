"""Build-budget checker: the port of ``nomad_tpu/analysis/retrace.py``.

The reference buckets its kernels' dynamic dimensions so a 10k-node
bench batch costs a handful of XLA compiles, and counts traces against
a budget declared per kernel. The port's kernels are hand-written, so
its "trace" is a build a call starts: a CUDA library's first load (an
``nvcc`` build when the library is not built yet) or a Triton
specialization's first launch. The kernel guard counts them per kernel
(``backend.build_counts``: a call whose launch started one, the
profile's ``traces``), and each wrapper declares how many a process may
start (``guarded(name, build_budget=...)``). The property regresses
silently: a wrapper that passes a shape or a flag into a
specialization key compiles afresh for each new value, the tests still
pass, and every pass pays a compile. ``budget_window()`` turns it into
an assertion: run a representative batch inside the window, and any
kernel whose builds *within the window* pass its budget raises with the
offending counts.

    with retrace.budget_window():
        for _ in range(64):
            kernel.place(ct, asks)     # the same kernels: 0 builds
"""

from __future__ import annotations

from contextlib import contextmanager


class RetraceBudgetExceeded(AssertionError):
    def __init__(self, offenders: list[tuple[str, int, int]]):
        self.offenders = offenders
        super().__init__(
            "; ".join(
                f"{name}: {count} builds > budget {budget}"
                for name, count, budget in offenders
            )
        )


def counts() -> dict[str, int]:
    """Cumulative builds per guarded kernel (process lifetime)."""
    from .. import backend

    return backend.build_counts()


def budgets() -> dict[str, int]:
    from .. import backend

    return backend.build_budgets()


def over_budget(
    window_counts: dict[str, int] | None = None,
) -> list[tuple[str, int, int]]:
    """(name, builds, budget) for every registered kernel past its
    budget. With no argument, checks cumulative process-lifetime counts."""
    current = window_counts if window_counts is not None else counts()
    budget_map = budgets()
    out = [
        (name, current.get(name, 0), budget)
        for name, budget in sorted(budget_map.items())
        if current.get(name, 0) > budget
    ]
    return out


def check(window_counts: dict[str, int] | None = None) -> None:
    offenders = over_budget(window_counts)
    if offenders:
        raise RetraceBudgetExceeded(offenders)


@contextmanager
def budget_window():
    """Scope a budget check to the workload inside the ``with`` block:
    deltas (not cumulative counts) are compared against each declared
    budget, so earlier builds in the process don't count against it."""
    before = counts()
    yield
    after = counts()
    deltas = {
        name: after.get(name, 0) - before.get(name, 0) for name in after
    }
    check(deltas)


def report() -> dict:
    """CLI/report payload: per-kernel builds vs budgets."""
    current = counts()
    budget_map = budgets()
    return {
        name: {
            "traces": current.get(name, 0),
            "budget": budget_map.get(name),
        }
        for name in sorted(set(current) | set(budget_map))
    }
