"""NTA008 — broker/server/obs time flows through an injectable clock.

The chaos plane's clock-skew faults (nomad_tpu_torch.chaos) only reach a
decision if that decision reads time through the injected clock: the
broker's unack-redelivery deadline, its delayed-eval heap, and the
heartbeater's TTL expiry are exactly the paths a skewed clock is meant
to stress. A bare ``time.time()`` or ``time.sleep()`` in
``nomad_tpu_torch/broker/``, ``nomad_tpu_torch/server/``, or ``nomad_tpu_torch/obs/`` is
a decision the fault plane (and any deterministic replay) cannot steer,
so it is banned; use the ``clock=`` seam (``self._clock()``) the way
EvalBroker and NodeHeartbeater do, or take a ``sleep=`` callable. The
obs scope keeps the SLO collector and throughput-estimator windows
replayable under FakeClock; ``obs/loadgen.py`` is exempt — wall-clock
pacing of open-loop arrivals is the point there.

``time.monotonic``/``time.perf_counter`` for *measuring* (metrics
spans, wait-loop budgets in test helpers) stay legal — only ``time``
and ``sleep`` are scheduling decisions. Aliased imports
(``import time as _t``, ``from time import time, sleep``) are resolved
before matching; pre-existing offenders live in the ratchet baseline.
"""

from __future__ import annotations

import ast

from ..lint import Finding, Rule, ScopedVisitor, dotted_name

_BANNED_ATTRS = {"time", "sleep"}


class _Visitor(ScopedVisitor):
    def __init__(self, relpath: str):
        super().__init__(relpath)
        # local name → canonical dotted target, built from the module's
        # imports so aliasing can't dodge the rule
        self._module_aliases: dict[str, str] = {}  # "_t" → "time"
        self._func_aliases: dict[str, str] = {}  # "now" → "time.time"

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            if alias.name == "time":
                self._module_aliases[alias.asname or "time"] = "time"
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module == "time" and node.level == 0:
            for alias in node.names:
                if alias.name in _BANNED_ATTRS:
                    self._func_aliases[alias.asname or alias.name] = (
                        f"time.{alias.name}"
                    )
        self.generic_visit(node)

    def _resolve(self, node: ast.AST) -> str | None:
        name = dotted_name(node)
        if name is None:
            return None
        if name in self._func_aliases:
            return self._func_aliases[name]
        head, _, attr = name.rpartition(".")
        if head in self._module_aliases and attr in _BANNED_ATTRS:
            return f"time.{attr}"
        return None

    def visit_Call(self, node: ast.Call) -> None:
        target = self._resolve(node.func)
        if target is not None:
            self.add(
                "NTA008",
                node,
                f"bare {target}() in a broker/server scheduling path "
                "(thread a clock=/sleep= seam so chaos skew and replay "
                "can steer it)",
            )
        self.generic_visit(node)


class BareWallClockInBrokerServer(Rule):
    id = "NTA008"
    title = "broker/server/obs time must flow through an injectable clock"

    def applies_to(self, relpath: str) -> bool:
        if relpath == "nomad_tpu_torch/obs/loadgen.py":
            # wall-clock pacing of open-loop arrivals is intentional
            return False
        return relpath.startswith(
            ("nomad_tpu_torch/broker/", "nomad_tpu_torch/server/", "nomad_tpu_torch/obs/")
        )

    def check(self, tree, source, relpath) -> list[Finding]:
        v = _Visitor(relpath)
        v.visit(tree)
        return v.findings
