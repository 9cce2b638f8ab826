"""NTA019 — cached score state mutates only through the refresh API.

``device/cache.py`` owns the persisted score-state double buffer
(``ScoreState``): device-resident score inputs plus a bitwise host
mirror, advanced generation-by-generation through ``score_view`` /
``score_commit`` / ``score_abort``. The incremental-rescoring pin —
patched passes bit-identical to from-scratch — holds exactly because
every mutation flows through that API: the mirror is updated in the
same locked region as the device patch, and generations are immutable
once staged. A device or scheduler module that writes the cached
tensors directly (``ct.score_cache = ...``, ``state.used_host[...] =
...``, rebinding ``device_capacity``) desynchronizes mirror and device
bytes, and the divergence only surfaces passes later as a wrong reused
row — the least debuggable failure this subsystem can produce.

Flagged: any assignment, augmented assignment, or ``del`` whose target
is an attribute named ``used_dev``, ``used_host``, ``score_cache``,
``score_state``, or ``device_capacity`` inside ``nomad_tpu_torch/device/``
or ``nomad_tpu_torch/scheduler/`` — including subscripted forms like
``x.used_host[i] = ...``.

Exempt: ``device/cache.py`` itself (it IS the refresh API) and
``device/flatten.py`` (the dataclass declares the ``score_cache`` /
``device_capacity`` attachment points the cache populates).
"""

from __future__ import annotations

import ast

from ..lint import Finding, Rule, ScopedVisitor

_SCOPES = ("nomad_tpu_torch/device/", "nomad_tpu_torch/scheduler/")
_EXEMPT = (
    "nomad_tpu_torch/device/cache.py",
    "nomad_tpu_torch/device/flatten.py",
)

_PROTECTED_ATTRS = (
    "used_dev",
    "used_host",
    "score_cache",
    "score_state",
    "device_capacity",
)


def _protected_attr(target: ast.AST) -> str | None:
    """Attribute name if ``target`` writes a protected attribute,
    unwrapping subscripts (``x.used_host[i]`` mutates ``used_host``)."""
    node = target
    while isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute) and node.attr in _PROTECTED_ATTRS:
        return node.attr
    return None


class _ScoreStateVisitor(ScopedVisitor):
    def _check_targets(self, node: ast.AST, targets) -> None:
        for t in targets:
            attr = _protected_attr(t)
            if attr is not None:
                self.add(
                    "NTA019",
                    node,
                    f"direct write to cached score state .{attr}: mutate "
                    "through the DeviceStateCache refresh API (score_view/"
                    "score_commit/score_abort) so the device bytes and the "
                    "generation mirror stay bitwise in lockstep",
                )

    def visit_Assign(self, node: ast.Assign) -> None:
        self._check_targets(node, node.targets)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._check_targets(node, [node.target])
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        self._check_targets(node, node.targets)
        self.generic_visit(node)


class ScoreStateDiscipline(Rule):
    id = "NTA019"
    title = "cached score state mutates only through the refresh API"

    def applies_to(self, relpath: str) -> bool:
        if relpath in _EXEMPT:
            return False
        return relpath.startswith(_SCOPES)

    def check(self, tree, source, relpath) -> list[Finding]:
        v = _ScoreStateVisitor(relpath)
        v.visit(tree)
        return v.findings
