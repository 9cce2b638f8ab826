"""NTA012 — external intake routes through the admission controller.

Overload protection (server/admission.py) only works if every seam
where outside traffic enters the eval pipeline consults the controller
*before* committing work. The architecture concentrates those seams in
two places: the HTTP/RPC handlers under ``api/`` (which turn requests
into evals via ``apply_eval_create`` / ``eval_broker.enqueue``) and the
broker package itself (whose public ``enqueue`` paths funnel through
``_enqueue_locked``, the one site that calls ``gate_enqueue``). A new
handler that injects evals without an admission check compiles, runs,
and passes every functional test — then under a 2× overload spike it
becomes the unprotected side door that sinks the high-priority SLO the
controller exists to defend.

Flagged:

- in ``api/`` modules: a function that calls ``apply_eval_create(...)``
  or ``eval_broker.enqueue*(...)`` without also making an admission-
  controller call (any dotted call through an ``admission`` attribute,
  e.g. ``self.server.admission.check_intake(...)``) somewhere in the
  same function — the gate and the injection must be visibly paired;
- in ``api/`` and ``broker/`` modules other than ``eval_broker.py``:
  any reference to ``_enqueue_locked`` or the broker's ``_ready``
  queues — internals that bypass the gated public enqueue entirely.

Scope: ``nomad_tpu_torch/api/`` and ``nomad_tpu_torch/broker/``. The broker's own
``eval_broker.py`` is exempt from the internals check (it IS the
implementation); server-side intake (``register_job`` / ``scale_job``)
gates inside ``server.py`` where NTA012's call-pairing heuristic would
be noise, so it is covered by tests rather than lint.
"""

from __future__ import annotations

import ast

from ..lint import Finding, Rule, ScopedVisitor, dotted_name

_API_PREFIX = "nomad_tpu_torch/api/"
_BROKER_PREFIX = "nomad_tpu_torch/broker/"
_BROKER_IMPL = "nomad_tpu_torch/broker/eval_broker.py"

# calls that inject work into the eval pipeline from an api/ handler
_INJECTORS = ("apply_eval_create",)
_ENQUEUE_PREFIX = "eval_broker.enqueue"

# broker internals that bypass the gated public enqueue
_INTERNALS = ("_enqueue_locked", "_ready")


def _is_admission_call(name: str) -> bool:
    """True for any dotted call routed through an ``admission``
    attribute: ``self.server.admission.check_intake`` etc."""
    parts = name.split(".")
    return "admission" in parts[:-1]


class _ApiVisitor(ScopedVisitor):
    """Per-function pairing check: collect injection calls and admission
    calls per enclosing function, emit findings for unpaired injectors
    when the function scope closes."""

    def __init__(self, relpath: str):
        super().__init__(relpath)
        # stack parallel to _scope: (injector call nodes, gated?) per fn
        self._fn_stack: list[list] = []

    def _visit_fn(self, node) -> None:
        self._fn_stack.append([[], False])
        # emit before the scope pops so findings anchor on the handler's
        # qualname, not its enclosing class
        self._scope.append(node.name)
        self.generic_visit(node)
        injectors, gated = self._fn_stack.pop()
        if not gated:
            for call_node, name in injectors:
                self.add(
                    "NTA012",
                    call_node,
                    f"{name}(...) without an admission-controller check "
                    "in the same handler: external intake must pair the "
                    "injection with admission.check_intake/gate so "
                    "overload shedding covers every entry seam",
                )
        self._scope.pop()

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    def visit_Call(self, node: ast.Call) -> None:
        name = dotted_name(node.func) or ""
        if self._fn_stack:
            leaf = name.rsplit(".", 1)[-1]
            if leaf in _INJECTORS or _ENQUEUE_PREFIX in name:
                self._fn_stack[-1][0].append((node, name))
            elif _is_admission_call(name):
                self._fn_stack[-1][1] = True
        self.generic_visit(node)


class _InternalsVisitor(ScopedVisitor):
    def _flag(self, node: ast.AST, attr: str) -> None:
        self.add(
            "NTA012",
            node,
            f"reference to broker internal '{attr}' outside "
            "eval_broker.py: inject evals through the public enqueue "
            "API so the admission gate inside _enqueue_locked applies",
        )

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if node.attr in _INTERNALS:
            self._flag(node, node.attr)
        self.generic_visit(node)


class AdmissionGateDiscipline(Rule):
    id = "NTA012"
    title = "external intake routes through the admission controller"

    def applies_to(self, relpath: str) -> bool:
        if relpath == _BROKER_IMPL:
            return False
        return relpath.startswith((_API_PREFIX, _BROKER_PREFIX))

    def check(self, tree, source, relpath) -> list[Finding]:
        findings: list[Finding] = []
        if relpath.startswith(_API_PREFIX):
            v = _ApiVisitor(relpath)
            v.visit(tree)
            findings.extend(v.findings)
        iv = _InternalsVisitor(relpath)
        iv.visit(tree)
        findings.extend(iv.findings)
        return findings
