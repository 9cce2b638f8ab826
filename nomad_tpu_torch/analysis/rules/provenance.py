"""NTA018 — admission/hetero thresholds carry calibration provenance.

The calibration plane (``nomad_tpu_torch/obs/calibrate.py``) exists so every
operational threshold answers "where did this number come from?" —
``default``, ``probe``, or ``learned``. A bare numeric literal compared
against a runtime quantity in ``server/admission.py`` or
``scheduler/hetero.py`` is a threshold with no provenance: it can't be
overridden by a saturation probe, never shows up in
``/v1/agent/calibration``, and silently drifts from the measured
envelope. Route it through ``CalibrationTable`` (the
``_default_config()`` seam in admission, the throughput seam in hetero)
instead.

Two shapes are flagged:

- a non-structural numeric literal used directly as an ``ast.Compare``
  operand (structural values — 0, 0.0, 1, 1.0, -1 — encode emptiness /
  identity / sentinels, not tuned thresholds, and stay legal);
- a module-level dict literal with three or more numeric values bound
  to a name containing ``DEFAULT`` or ``THRESHOLD`` — a constants table
  that bypasses the calibration table's provenance tracking.

Pre-existing offenders (the ``tier_of`` priority-tier cutpoints, which
are protocol constants shared with clients rather than tunables) live
in the ratchet baseline.
"""

from __future__ import annotations

import ast

from ..lint import Finding, Rule, ScopedVisitor

# emptiness / identity / sentinel values: comparisons against these are
# structural control flow, not tuned thresholds
_STRUCTURAL = {0, 0.0, 1, 1.0, -1}
_NAME_MARKERS = ("DEFAULT", "THRESHOLD")
_MIN_DICT_NUMERICS = 3


def _literal_value(node: ast.AST):
    """Numeric value of a (possibly negated) constant literal, or None.
    bools are constants too but never thresholds."""
    if (
        isinstance(node, ast.UnaryOp)
        and isinstance(node.op, ast.USub)
        and isinstance(node.operand, ast.Constant)
    ):
        v = node.operand.value
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            return None
        return -v
    if isinstance(node, ast.Constant):
        v = node.value
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            return None
        return v
    return None


class _Visitor(ScopedVisitor):
    def visit_Compare(self, node: ast.Compare) -> None:
        for operand in [node.left, *node.comparators]:
            value = _literal_value(operand)
            if value is None or value in _STRUCTURAL:
                continue
            self.add(
                "NTA018",
                operand,
                f"bare numeric threshold {value!r} in a comparison — "
                "route it through the calibration table "
                "(obs/calibrate.py) so it carries provenance",
            )
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        # only module-level bindings: a local dict inside a function is
        # plumbing, not a constants table
        if not self.qualname():
            for target in node.targets:
                if not isinstance(target, ast.Name):
                    continue
                name = target.id.upper()
                if not any(m in name for m in _NAME_MARKERS):
                    continue
                if not isinstance(node.value, ast.Dict):
                    continue
                numerics = sum(
                    1
                    for v in node.value.values
                    if _literal_value(v) is not None
                )
                if numerics >= _MIN_DICT_NUMERICS:
                    self.add(
                        "NTA018",
                        node,
                        f"module-level constants dict '{target.id}' holds "
                        f"{numerics} numeric defaults — source them from "
                        "the calibration table (obs/calibrate.py) so each "
                        "carries provenance",
                    )
        self.generic_visit(node)


class ConstantProvenanceDiscipline(Rule):
    id = "NTA018"
    title = "admission/hetero thresholds come from the calibration table"

    def applies_to(self, relpath: str) -> bool:
        return relpath in (
            "nomad_tpu_torch/server/admission.py",
            "nomad_tpu_torch/scheduler/hetero.py",
        )

    def check(self, tree, source, relpath) -> list[Finding]:
        v = _Visitor(relpath)
        v.visit(tree)
        return v.findings
