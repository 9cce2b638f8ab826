"""NTA001 — no wall-clock or unseeded randomness in scoring/plan-apply.

Constraint-based schedulers live or die by reproducible scoring: the same
snapshot must always produce the same plan, or replay debugging, the
score-parity suite, and the applier's optimistic-conflict accounting all
stop meaning anything. Wall-clock reads and unseeded RNG inside the
scoring path are the two mechanical ways that property silently dies.

Scope: ``nomad_tpu_torch/scheduler/``, ``nomad_tpu_torch/device/``, and
``nomad_tpu_torch/broker/plan_apply.py``. The eval broker's nack timers and the
server's heartbeat TTLs are real time by *design* and stay out of scope.

Allowed: ``time.perf_counter`` / ``time.monotonic`` (metrics timing, not
scoring inputs), seeded ``np.random.default_rng(seed)``, and ``jax.random``
(explicit key discipline). An injectable-clock *reference* (``clock or
time.time``) is fine — only calls are flagged.
"""

from __future__ import annotations

import ast

from ..lint import Finding, Rule, ScopedVisitor, dotted_name

_FORBIDDEN_CALLS = {
    "time.time": "wall-clock read",
    "time.time_ns": "wall-clock read",
    "datetime.now": "wall-clock read",
    "datetime.utcnow": "wall-clock read",
    "datetime.datetime.now": "wall-clock read",
    "datetime.datetime.utcnow": "wall-clock read",
    "datetime.date.today": "wall-clock read",
}

_RANDOM_MODULES = ("random.", "np.random.", "numpy.random.")


class _Visitor(ScopedVisitor):
    def visit_Call(self, node: ast.Call) -> None:
        name = dotted_name(node.func)
        if name:
            reason = _FORBIDDEN_CALLS.get(name)
            if reason is None:
                for prefix in _RANDOM_MODULES:
                    if name.startswith(prefix):
                        # seeded generator construction is deterministic
                        if name.endswith(".default_rng") and node.args:
                            break
                        reason = "unseeded randomness"
                        break
        else:
            reason = None
        if name and reason:
            self.add(
                "NTA001",
                node,
                f"{reason}: {name}() in a scoring/plan-apply path "
                f"(inject a clock/seed instead)",
            )
        self.generic_visit(node)


class WallClockInScoringPath(Rule):
    id = "NTA001"
    title = "no wall-clock/randomness in scheduler scoring or plan apply"

    def applies_to(self, relpath: str) -> bool:
        return (
            relpath.startswith("nomad_tpu_torch/scheduler/")
            or relpath.startswith("nomad_tpu_torch/device/")
            or relpath == "nomad_tpu_torch/broker/plan_apply.py"
        )

    def check(self, tree, source, relpath) -> list[Finding]:
        v = _Visitor(relpath)
        v.visit(tree)
        return v.findings
