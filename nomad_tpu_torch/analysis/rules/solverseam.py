"""NTA016 — the CP solver is invoked only through its sanctioned seam.

The CP dispatcher's device kernel (device/cp.py ``cp_place_kernel`` and
its host oracle ``oracle_cp_place``) carries load-bearing invariants
that live OUTSIDE the kernel: ``scheduler/cp.py`` is where score rows
are assembled through the registry's ``score_group``, where the
circuit-breaker fallback to greedy binpack is decided, where the
``cp.round_perturb`` chaos hook feeds initial prices, and where the
law-13 conservation counters (``nomad.cp.*``) are recorded. A scheduler
or server module that calls the kernel directly — or constructs
``CpPlacementKernel(...)`` outside the algorithm registry — bypasses
all of that: placements commit with no conservation ledger, no breaker
protection, and score rows that may not match what binpack ranks by
(breaking the A/B's like-for-like contract).

Flagged: any call whose dotted leaf is ``cp_place_kernel``,
``oracle_cp_place``, ``CpPlacementKernel``, or ``build_cp_batch``
inside ``nomad_tpu_torch/scheduler/`` or ``nomad_tpu_torch/server/``.

Exempt: ``scheduler/algorithms.py`` (the registry constructs the kernel
wrapper) and ``scheduler/cp.py`` (the seam itself — batch assembly,
oracle cross-checks, and the A/B harness live there). ``nomad_tpu_torch/
device/`` is out of scope, as for NTA013: the rule polices dispatch,
not implementation or parity pinning.
"""

from __future__ import annotations

import ast

from ..lint import Finding, Rule, ScopedVisitor, dotted_name

_SCOPES = ("nomad_tpu_torch/scheduler/", "nomad_tpu_torch/server/")
_EXEMPT = (
    "nomad_tpu_torch/scheduler/algorithms.py",
    "nomad_tpu_torch/scheduler/cp.py",
)

_SOLVER_LEAVES = (
    "cp_place_kernel",
    "oracle_cp_place",
    "CpPlacementKernel",
    "build_cp_batch",
)


class _SolverVisitor(ScopedVisitor):
    def visit_Call(self, node: ast.Call) -> None:
        name = dotted_name(node.func) or ""
        leaf = name.rsplit(".", 1)[-1]
        if leaf in _SOLVER_LEAVES:
            self.add(
                "NTA016",
                node,
                f"direct CP solver invocation {leaf}(...): route through "
                "scheduler/algorithms.py (the cp-pack plugin) so breaker "
                "fallback, chaos perturbation, and law-13 conservation "
                "accounting stay on the path",
            )
        self.generic_visit(node)


class SolverSeamDiscipline(Rule):
    id = "NTA016"
    title = "CP solver invoked only through the algorithm registry seam"

    def applies_to(self, relpath: str) -> bool:
        if relpath in _EXEMPT:
            return False
        return relpath.startswith(_SCOPES)

    def check(self, tree, source, relpath) -> list[Finding]:
        v = _SolverVisitor(relpath)
        v.visit(tree)
        return v.findings
