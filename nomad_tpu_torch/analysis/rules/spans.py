"""NTA006 — eval-lifecycle timing must flow through the span API.

A raw ``metrics.timer(...)`` in an eval-lifecycle module produces a
latency sample that is invisible to the flight recorder: the phase never
appears in a trace tree, so ``nomad-tpu trace <eval>`` and the bench
per-phase breakdown silently under-report where the pipeline spends its
time. ``tracer.span(name, timer="...")`` emits the SAME legacy sample
(tracing on or off) *and* a span, so there is no reason to bypass it in
these modules — one timing call, two surfaces.

Flagged: any call whose dotted name is ``timer`` or ends in ``.timer``
(the ``utils.metrics.Metrics.timer`` context manager). Suppress a
deliberate exception with ``# nta: allow=NTA006``.

Scope: the eval-lifecycle modules instrumented with spans —
``server/worker.py``, ``broker/{eval_broker,plan_queue,plan_apply}.py``,
``scheduler/generic.py``.
"""

from __future__ import annotations

import ast

from ..lint import Finding, Rule, ScopedVisitor, dotted_name

_LIFECYCLE_MODULES = (
    "nomad_tpu_torch/server/worker.py",
    "nomad_tpu_torch/broker/eval_broker.py",
    "nomad_tpu_torch/broker/plan_queue.py",
    "nomad_tpu_torch/broker/plan_apply.py",
    "nomad_tpu_torch/scheduler/generic.py",
)


class _Visitor(ScopedVisitor):
    def visit_Call(self, node: ast.Call) -> None:
        name = dotted_name(node.func) or ""
        if name == "timer" or name.endswith(".timer"):
            self.add(
                "NTA006",
                node,
                f"raw {name}(...) in an eval-lifecycle module: use "
                f"tracer.span(name, timer=...) so the phase shows up in "
                f"traces as well as /v1/metrics",
            )
        self.generic_visit(node)


class SpanCoverage(Rule):
    id = "NTA006"
    title = "eval-lifecycle timing goes through the span API"

    def applies_to(self, relpath: str) -> bool:
        return relpath in _LIFECYCLE_MODULES

    def check(self, tree, source, relpath) -> list[Finding]:
        v = _Visitor(relpath)
        v.visit(tree)
        return v.findings
