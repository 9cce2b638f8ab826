"""NTA010 — the worker batch path mutates placement state only through
the lane-owner API.

Deterministic lane ownership (server/lanes.py) makes multi-worker commits
conflict-free *by construction* — but only while every write in the batch
pipeline goes through the sanctioned seams: the worker's own overlay via
``self._my_overlay()``, deltas tagged with ``writer=`` (the overlay's
cross-lane-write refusal keys on it), cross-lane nodes via the
``lane_claims`` reserve→confirm handshake, and committed state via the
merged plan queue. A direct write that bypasses any of these compiles,
runs, and passes a 1-worker test — then silently reintroduces exactly the
multi-worker race the lanes were built to make impossible.

Flagged inside ``Worker._run_batch`` / ``Worker._commit_batch*`` (the
batch pipeline, NTA007's scope):

- any reference to ``placement_overlay`` — the shared container must be
  reached through ``_my_overlay()`` (the accessor itself is the one
  sanctioned reader);
- ``.add_delta(...)`` calls without a ``writer=`` keyword — an untagged
  delta is invisible to the overlay's lane-ownership check;
- ``store.upsert_* / store.delete_*`` calls — workers land state through
  the plan queue's verified commit, never by writing the store directly.

Scope: ``server/worker.py`` only, same as NTA007 — schedulers and the
applier legitimately touch overlays and the store through their own
contracts.
"""

from __future__ import annotations

import ast

from ..lint import Finding, Rule, ScopedVisitor, dotted_name

_WORKER_MODULE = "nomad_tpu_torch/server/worker.py"

# the batch pipeline's functions (prefix-matched, NTA007's scoping)
_BATCH_FUNCS = ("_run_batch", "_commit_batch")

# the one sanctioned reader of the shared overlay container
_ACCESSOR = "_my_overlay"

_STORE_MUTATORS = ("upsert_", "delete_")


class _Visitor(ScopedVisitor):
    def _in_batch_path(self) -> bool:
        if any(part == _ACCESSOR for part in self._scope):
            return False
        return any(
            part.startswith(_BATCH_FUNCS) for part in self._scope
        )

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if self._in_batch_path() and node.attr == "placement_overlay":
            self.add(
                "NTA010",
                node,
                "direct placement_overlay access in the worker batch "
                "path: go through self._my_overlay() so each batching "
                "worker writes its OWN lane overlay",
            )
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        if self._in_batch_path():
            name = dotted_name(node.func) or ""
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "add_delta" and not any(
                kw.arg == "writer" for kw in node.keywords
            ):
                self.add(
                    "NTA010",
                    node,
                    "add_delta(...) without writer= in the worker batch "
                    "path: untagged deltas bypass the overlay's "
                    "cross-lane write refusal",
                )
            if (
                "store." in f"{name}."
                and any(leaf.startswith(p) for p in _STORE_MUTATORS)
            ):
                self.add(
                    "NTA010",
                    node,
                    f"direct store mutation {name}(...) in the worker "
                    "batch path: placements land through the merged "
                    "plan queue's verified commit, not store writes",
                )
        self.generic_visit(node)


class LaneOwnerDiscipline(Rule):
    id = "NTA010"
    title = "batch-path placement writes go through the lane-owner API"

    def applies_to(self, relpath: str) -> bool:
        return relpath == _WORKER_MODULE

    def check(self, tree, source, relpath) -> list[Finding]:
        v = _Visitor(relpath)
        v.visit(tree)
        return v.findings
