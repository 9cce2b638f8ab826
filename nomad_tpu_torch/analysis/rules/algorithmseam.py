"""NTA013 — scheduler algorithms dispatch through the plugin registry.

The algorithm registry (scheduler/algorithms.py) is the single seam
between "which algorithm did the operator pick" and "which kernel runs":
``make_kernel`` maps the SchedulerConfiguration string to a placement
kernel and ``score_group`` routes dense-matrix scoring. A scheduler or
server module that constructs ``PlacementKernel(...)`` /
``HeteroPlacementKernel(...)`` directly, or calls
``score_matrix_kernel(...)`` itself, silently pins one algorithm: the
operator flips ``scheduler_algorithm`` to ``hetero-maxmin`` and that
code path keeps binpacking — no error, no test failure, just a policy
that never engages. It also forks validation: the API's "is this name
registered" check stops covering what actually runs.

Flagged: any call whose dotted leaf is ``PlacementKernel``,
``HeteroPlacementKernel``, or ``score_matrix_kernel`` inside
``nomad_tpu_torch/scheduler/`` or ``nomad_tpu_torch/server/``.

Exempt: ``scheduler/algorithms.py`` (the registry IS the dispatcher),
``scheduler/hetero.py``, and ``scheduler/cp.py`` (their kernels
delegate to the base kernel internally, and cp.py's A/B harness
benchmarks against it). The device package itself (``nomad_tpu_torch/device/``) is out
of scope — it defines the kernels and pins them against host oracles
(device/parity.py); the rule polices *dispatch*, not implementation.
"""

from __future__ import annotations

import ast

from ..lint import Finding, Rule, ScopedVisitor, dotted_name

_SCOPES = ("nomad_tpu_torch/scheduler/", "nomad_tpu_torch/server/")
_EXEMPT = (
    "nomad_tpu_torch/scheduler/algorithms.py",
    "nomad_tpu_torch/scheduler/hetero.py",
    "nomad_tpu_torch/scheduler/cp.py",
)

_DISPATCH_LEAVES = (
    "PlacementKernel",
    "HeteroPlacementKernel",
    "score_matrix_kernel",
)


class _DispatchVisitor(ScopedVisitor):
    def visit_Call(self, node: ast.Call) -> None:
        name = dotted_name(node.func) or ""
        leaf = name.rsplit(".", 1)[-1]
        if leaf in _DISPATCH_LEAVES:
            self.add(
                "NTA013",
                node,
                f"direct kernel dispatch {leaf}(...): route through "
                "scheduler/algorithms.py (make_kernel/score_group) so the "
                "configured scheduler_algorithm actually selects the "
                "kernel",
            )
        self.generic_visit(node)


class AlgorithmSeamDiscipline(Rule):
    id = "NTA013"
    title = "scheduler algorithms dispatch through the plugin registry"

    def applies_to(self, relpath: str) -> bool:
        if relpath in _EXEMPT:
            return False
        return relpath.startswith(_SCOPES)

    def check(self, tree, source, relpath) -> list[Finding]:
        v = _DispatchVisitor(relpath)
        v.visit(tree)
        return v.findings
