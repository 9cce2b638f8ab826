"""NTA021 — live migration flows only through its sanctioned seam.

The migration auction (device/migrate.py ``migrate_plan_kernel`` and
its host oracle ``oracle_migrate_plan``) prices moves against a
used-only-increases capacity model — that model IS invariant law 16's
mid-move conservation guarantee, but only if every planned move then
rides the two-phase protocol in ``server/defrag.py``: replacement
placed through a confirmed lane claim and the serialized plan applier
first, source stopped second, recovery scan bounding half-moves to one
cycle. A scheduler or server module that calls the kernel directly —
or assembles its own batch with ``build_defrag_batch`` — gets a move
list with none of that sequencing: sources could free before
replacements commit (capacity conservation broken mid-flight), moves
could bypass the lane-owner commit path, and the ``nomad.migrate.*``
ledger law 16 audits would never be written.

Flagged: any call whose dotted leaf is ``migrate_plan_kernel``,
``oracle_migrate_plan``, ``build_defrag_batch``, or ``run_defrag_ab``
inside ``nomad_tpu_torch/scheduler/`` or ``nomad_tpu_torch/server/``.

Exempt: ``scheduler/migrate.py`` (the seam itself — batch assembly,
oracle cross-check, and the ``bench.py defrag`` A/B harness) and
``server/defrag.py`` (the controller that owns the two-phase protocol).
``nomad_tpu_torch/device/`` is out of scope, as for NTA016: the rule polices
dispatch, not implementation or parity pinning.
"""

from __future__ import annotations

import ast

from ..lint import Finding, Rule, ScopedVisitor, dotted_name

_SCOPES = ("nomad_tpu_torch/scheduler/", "nomad_tpu_torch/server/")
_EXEMPT = (
    "nomad_tpu_torch/scheduler/migrate.py",
    "nomad_tpu_torch/server/defrag.py",
)

_MIGRATE_LEAVES = (
    "migrate_plan_kernel",
    "oracle_migrate_plan",
    "build_defrag_batch",
    "run_defrag_ab",
)


class _MigrateVisitor(ScopedVisitor):
    def visit_Call(self, node: ast.Call) -> None:
        name = dotted_name(node.func) or ""
        leaf = name.rsplit(".", 1)[-1]
        if leaf in _MIGRATE_LEAVES:
            self.add(
                "NTA021",
                node,
                f"direct migration-plane invocation {leaf}(...): route "
                "through server/defrag.py (the DefragController) so the "
                "two-phase place-first sequencing, lane-claim commit "
                "path, and law-16 conservation ledger stay on the path",
            )
        self.generic_visit(node)


class MigrationSeamDiscipline(Rule):
    id = "NTA021"
    title = "migration kernel invoked only through the defrag seam"

    def applies_to(self, relpath: str) -> bool:
        if relpath in _EXEMPT:
            return False
        return relpath.startswith(_SCOPES)

    def check(self, tree, source, relpath) -> list[Finding]:
        v = _MigrateVisitor(relpath)
        v.visit(tree)
        return v.findings
