"""NTA004 — plans are frozen once submitted to the applier.

The plan applier runs serialized against live state while the worker that
built the plan keeps running; by the time ``apply`` executes, the same
``Plan`` object (and every ``Allocation`` hanging off it) is shared with
the submitting thread, the plan queue, and — on partial commit — the
retry path. One attribute write inside the applier is a data race that
corrupts a snapshot nobody re-validates, silently poisoning every
downstream score matrix. The applier must treat the plan as immutable
input and build its mutations into ``PlanResult`` copies.

Detection: attribute-write analysis over ``broker/plan_apply.py``. A name
is *plan-tainted* when it is a parameter named ``plan`` (or annotated
``Plan``), an alias assigned from one, or a loop variable drawn from a
plan attribute (``for a in plan.node_allocation[...]``). Flagged:
attribute stores/aug-assigns on tainted names, subscript stores into plan
attributes, and mutating method calls (``append``/``update``/…) on plan
attributes.
"""

from __future__ import annotations

import ast

from ..lint import Finding, Rule, ScopedVisitor, dotted_name

_MUTATORS = {
    "append", "extend", "insert", "remove", "pop", "clear", "update",
    "setdefault", "popitem", "add", "discard", "sort", "reverse",
    "normalize", "append_alloc", "append_stopped_alloc",
    "append_preempted_alloc", "append_lost_alloc",
}


def _base_name(node: ast.AST) -> str | None:
    """Leftmost Name of an Attribute/Subscript chain."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _root_is_plan_attr(node: ast.AST, tainted: set[str]) -> bool:
    """True when the chain bottoms out in ``<tainted>.<attr>`` — i.e. the
    expression is (a view into) one of the plan's containers."""
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Call)):
        if isinstance(node, ast.Attribute):
            if (
                isinstance(node.value, ast.Name)
                and node.value.id in tainted
            ):
                return True
            node = node.value
        elif isinstance(node, ast.Subscript):
            node = node.value
        else:  # Call, e.g. plan.node_update.values()
            node = node.func
    return False


class _FuncVisitor(ScopedVisitor):
    """Per-function taint tracking; the scope stack is pre-seeded by the
    module walker."""

    def __init__(self, relpath: str, tainted: set[str]):
        super().__init__(relpath)
        self.tainted = tainted

    # -- taint propagation -------------------------------------------------
    def _taint_target(self, target: ast.AST) -> None:
        if isinstance(target, ast.Name):
            self.tainted.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._taint_target(elt)

    def visit_Assign(self, node: ast.Assign) -> None:
        value_tainted = (
            isinstance(node.value, ast.Name) and node.value.id in self.tainted
        ) or _root_is_plan_attr(node.value, self.tainted)
        for target in node.targets:
            if isinstance(target, ast.Attribute):
                self._check_attr_store(target)
            elif isinstance(target, ast.Subscript):
                self._check_subscript_store(target)
            elif value_tainted:
                self._taint_target(target)
        self.generic_visit(node)

    def visit_For(self, node: ast.For) -> None:
        if _root_is_plan_attr(node.iter, self.tainted):
            self._taint_target(node.target)
        self.generic_visit(node)

    def visit_comprehension(self, node: ast.comprehension) -> None:
        if _root_is_plan_attr(node.iter, self.tainted):
            self._taint_target(node.target)
        self.generic_visit(node)

    # -- violation checks --------------------------------------------------
    def _check_attr_store(self, target: ast.Attribute) -> None:
        base = _base_name(target.value)
        if base in self.tainted or _root_is_plan_attr(
            target.value, self.tainted
        ):
            self.add(
                "NTA004",
                target,
                f"mutation of submitted plan object: "
                f"{base or '<expr>'}.{target.attr} = ... "
                f"(the applier must build PlanResult copies)",
            )

    def _check_subscript_store(self, target: ast.Subscript) -> None:
        base = _base_name(target.value)
        if base in self.tainted or _root_is_plan_attr(
            target.value, self.tainted
        ):
            self.add(
                "NTA004",
                target,
                "mutation of submitted plan container "
                "(the applier must build PlanResult copies)",
            )

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        if isinstance(node.target, ast.Attribute):
            self._check_attr_store(node.target)
        elif isinstance(node.target, ast.Subscript):
            self._check_subscript_store(node.target)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if (
            isinstance(func, ast.Attribute)
            and func.attr in _MUTATORS
            and (
                (isinstance(func.value, ast.Name)
                 and func.value.id in self.tainted)
                or _root_is_plan_attr(func.value, self.tainted)
            )
        ):
            self.add(
                "NTA004",
                node,
                f"mutating call .{func.attr}() on submitted plan object",
            )
        self.generic_visit(node)


class _ModuleWalker(ScopedVisitor):
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        tainted = set()
        for arg in node.args.args + node.args.kwonlyargs:
            ann = dotted_name(arg.annotation) if arg.annotation else None
            if arg.arg == "plan" or (ann or "").split(".")[-1] == "Plan":
                tainted.add(arg.arg)
        if tainted:
            # the taint visitor walks the whole subtree (closures inherit
            # the taint), so don't descend again from here
            fv = _FuncVisitor(self.relpath, tainted)
            fv._scope = self._scope + [node.name]
            for stmt in node.body:
                fv.visit(stmt)
            self.findings.extend(fv.findings)
        else:
            self._push(node.name, node)


class PlanMutationAfterSubmit(Rule):
    id = "NTA004"
    title = "no mutation of plan/alloc structs inside the plan applier"

    def applies_to(self, relpath: str) -> bool:
        return relpath == "nomad_tpu_torch/broker/plan_apply.py"

    def check(self, tree, source, relpath) -> list[Finding]:
        v = _ModuleWalker(relpath)
        v.visit(tree)
        return v.findings
