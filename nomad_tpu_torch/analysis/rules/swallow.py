"""NTA003 — no silent exception swallows in server/broker/state code.

A worker thread that eats an exception leaves dequeued evals unacked
forever (the broker has no redelivery deadline) and a state-store path
that eats one can ship a half-applied snapshot downstream — both failure
modes are invisible until throughput quietly halves. Every handler in
these modules must leave a trace: a log call, a metrics bump (e.g.
``count_swallowed`` from ``utils/metrics.py``), or a re-raise.

Flagged:
- any handler whose body is only ``pass``/``continue``/``...`` (whatever
  the caught type — even a narrow catch deserves one counter bump), and
- any broad catch (``except:``, ``except Exception``, ``BaseException``)
  that neither logs, nor counts, nor raises.

Scope: ``nomad_tpu_torch/server/``, ``nomad_tpu_torch/broker/``, ``nomad_tpu_torch/state/``.
"""

from __future__ import annotations

import ast

from ..lint import Finding, Rule, ScopedVisitor, dotted_name

_LOG_METHODS = {
    "debug", "info", "warning", "warn", "error", "exception", "critical",
    "log",
}
_METRIC_METHODS = {"incr", "set_gauge", "measure", "count_swallowed"}
_BROAD = {"Exception", "BaseException"}


def _exc_names(node: ast.AST | None) -> set[str]:
    if node is None:
        return set()  # bare except
    if isinstance(node, ast.Tuple):
        return {n for e in node.elts for n in _exc_names(e)}
    name = dotted_name(node)
    return {name.split(".")[-1]} if name else set()


def _is_broad(handler: ast.ExceptHandler) -> bool:
    if handler.type is None:
        return True
    return bool(_exc_names(handler.type) & _BROAD)


def _observes(handler: ast.ExceptHandler) -> bool:
    """Does the handler body log, count, or raise?"""
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            name = dotted_name(node.func) or ""
            leaf = name.split(".")[-1]
            if leaf in _METRIC_METHODS:
                return True
            if isinstance(node.func, ast.Attribute) and leaf in _LOG_METHODS:
                return True
    return False


def _pass_only(handler: ast.ExceptHandler) -> bool:
    for stmt in handler.body:
        if isinstance(stmt, (ast.Pass, ast.Continue)):
            continue
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Constant):
            continue  # docstring / ellipsis
        return False
    return True


class _Visitor(ScopedVisitor):
    def visit_ExceptHandler(self, node: ast.ExceptHandler) -> None:
        caught = (
            "bare except"
            if node.type is None
            else f"except {', '.join(sorted(_exc_names(node.type))) or '?'}"
        )
        if _pass_only(node) and not _observes(node):
            self.add(
                "NTA003",
                node,
                f"silent swallow: {caught} with pass-only body "
                f"(log at debug or bump a swallowed_errors counter)",
            )
        elif _is_broad(node) and not _observes(node):
            self.add(
                "NTA003",
                node,
                f"silent swallow: {caught} neither logs, counts, nor "
                f"re-raises",
            )
        self.generic_visit(node)


class SilentExceptionSwallow(Rule):
    id = "NTA003"
    title = "no silent exception swallows in server/broker/state"

    def applies_to(self, relpath: str) -> bool:
        return (
            relpath.startswith("nomad_tpu_torch/server/")
            or relpath.startswith("nomad_tpu_torch/broker/")
            or relpath.startswith("nomad_tpu_torch/state/")
        )

    def check(self, tree, source, relpath) -> list[Finding]:
        v = _Visitor(relpath)
        v.visit(tree)
        return v.findings
