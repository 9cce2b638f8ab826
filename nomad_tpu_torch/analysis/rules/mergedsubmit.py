"""NTA007 — the worker's batch path must submit through the merged queue.

The coalesced commit train exists because a 16-deep batched device pass
that commits one plan at a time serializes into 16 applier round trips,
16 FSM entries, and 16 store index bumps — the per-eval commit train the
merged path collapses into one (`PlanQueue.enqueue_merged` →
`PlanApplier.apply_merged`, one MERGED_PLAN_RESULT raft entry). A direct
per-eval submit sneaking back into the batch path silently reintroduces
the train: everything still works, the bench just quietly loses its
plans_per_commit ≈ batch-depth property.

Flagged: inside ``Worker._run_batch`` / ``Worker._commit_batch*`` (the
batch pipeline), any call whose dotted name is or ends in
``.submit_plan`` or ``plan_queue.enqueue`` — the per-eval submission
entry points. ``enqueue_merged`` is the sanctioned path. The individual
fallback (``_run_one`` and everything under it) is exempt: stale members
are SUPPOSED to retry through the single-plan path.

Scope: ``server/worker.py`` only — schedulers and direct (non-batch)
planner callers legitimately use ``submit_plan``.
"""

from __future__ import annotations

import ast

from ..lint import Finding, Rule, ScopedVisitor, dotted_name

_WORKER_MODULE = "nomad_tpu_torch/server/worker.py"

# the batch pipeline's functions: the device-pass driver and the commit
# thread it hands off to (prefix-matched so helpers split out of the
# commit path stay covered)
_BATCH_FUNCS = ("_run_batch", "_commit_batch")


class _Visitor(ScopedVisitor):
    def _in_batch_path(self) -> bool:
        return any(
            part.startswith(_BATCH_FUNCS) for part in self._scope
        )

    def visit_Call(self, node: ast.Call) -> None:
        if self._in_batch_path():
            name = dotted_name(node.func) or ""
            per_eval_submit = (
                name == "submit_plan"
                or name.endswith(".submit_plan")
                or name.endswith("plan_queue.enqueue")
            )
            if per_eval_submit:
                self.add(
                    "NTA007",
                    node,
                    f"per-eval {name}(...) in the worker batch path: the "
                    f"batched pass must coalesce through "
                    f"plan_queue.enqueue_merged so one pass stays one "
                    f"applier commit",
                )
        self.generic_visit(node)


class MergedSubmitDiscipline(Rule):
    id = "NTA007"
    title = "batched passes submit through the merged plan queue"

    def applies_to(self, relpath: str) -> bool:
        return relpath == _WORKER_MODULE

    def check(self, tree, source, relpath) -> list[Finding]:
        v = _Visitor(relpath)
        v.visit(tree)
        return v.findings
