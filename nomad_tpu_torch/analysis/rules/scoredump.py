"""NTA014 — raw score arrays cross to operators only via the explain seam.

Placement provenance has exactly one sanctioned exit: ``obs/explain.py``
turns the kernels' dense score state into ``PlacementExplanation``
structs with named components, a pinned schema version, and bounded
top-k candidate lists. A scheduler or server module that serializes the
raw arrays instead — ``res.scores.tolist()`` into a log line,
``json.dumps``/``encode``/``print`` of ``node_rows`` or ``finals`` —
leaks an unbounded, unversioned, component-free dump: N-node fleets put
megabytes on the wire, the shape silently changes with every kernel
refactor, and downstream tooling starts parsing what was never an
interface. Route it through the explain seam, where the schema smoke
test pins the shape.

Flagged, inside ``nomad_tpu_torch/scheduler/`` and ``nomad_tpu_torch/server/``:

- ``X.<attr>.tolist()`` / ``.tobytes()`` / ``.tofile()`` where
  ``<attr>`` is a raw score field (``scores``, ``node_rows``,
  ``finals``, ``overflow_rows``, ``overflow_scores``).
- a bare ``X.<attr>`` of those names passed directly to
  ``json.dumps(...)``, ``encode(...)``, or ``print(...)``.

Not flagged: numeric use of the arrays (indexing, argmax, comparisons)
— the rule polices *egress*, not computation. ``obs/`` and ``device/``
are out of scope: explain.py IS the seam and the kernels own their
arrays.
"""

from __future__ import annotations

import ast

from ..lint import Finding, Rule, ScopedVisitor, dotted_name

_SCOPES = ("nomad_tpu_torch/scheduler/", "nomad_tpu_torch/server/")

# PlacementResult / kernel-local dense state (device/score.py)
_RAW_SCORE_ATTRS = (
    "scores",
    "node_rows",
    "finals",
    "overflow_rows",
    "overflow_scores",
)

_SERIALIZERS = ("tolist", "tobytes", "tofile")
_DUMP_SINKS = ("dumps", "encode", "print")


def _raw_attr_leaf(node: ast.expr) -> str:
    """`` res.scores`` → ``scores`` when it names a raw score field."""
    if isinstance(node, ast.Attribute) and node.attr in _RAW_SCORE_ATTRS:
        return node.attr
    return ""


class _ScoreDumpVisitor(ScopedVisitor):
    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        # res.scores.tolist() — serializing the array itself
        if (
            isinstance(func, ast.Attribute)
            and func.attr in _SERIALIZERS
        ):
            leaf = _raw_attr_leaf(func.value)
            if leaf:
                self.add(
                    "NTA014",
                    node,
                    f"raw score array dump .{leaf}.{func.attr}(): "
                    "operator-facing score data must cross through "
                    "obs/explain.py (PlacementExplanation), not as raw "
                    "arrays",
                )
        # json.dumps(res.node_rows) / encode(res.scores) / print(finals)
        name = dotted_name(func) or ""
        if name.rsplit(".", 1)[-1] in _DUMP_SINKS:
            for arg in node.args:
                leaf = _raw_attr_leaf(arg)
                if leaf:
                    self.add(
                        "NTA014",
                        node,
                        f"raw score array {leaf!r} passed to "
                        f"{name}(...): serialize placement provenance "
                        "via obs/explain.py, not raw kernel arrays",
                    )
        self.generic_visit(node)


class ScoreDumpDiscipline(Rule):
    id = "NTA014"
    title = "raw score arrays exit only through the explain seam"

    def applies_to(self, relpath: str) -> bool:
        return relpath.startswith(_SCOPES)

    def check(self, tree, source, relpath) -> list[Finding]:
        v = _ScoreDumpVisitor(relpath)
        v.visit(tree)
        return v.findings
