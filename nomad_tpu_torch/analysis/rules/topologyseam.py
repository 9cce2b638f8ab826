"""NTA020 — topology/gang pricing flows only through the cp-gang seam.

The gang kernel (device/cp.py ``cp_gang_place_kernel`` and its host
oracle ``oracle_cp_gang_place``) carries invariants that live OUTSIDE
the kernel: ``scheduler/cp.py`` is where topology id columns flatten
into one-hot level matrices (``build_gang_inputs``), where incomplete
gangs release atomically (``release_incomplete_gangs`` applied to RAW
kernel outputs, after parity), and where the ``nomad.cp.gang_*``
conservation counters are recorded. A scheduler or server module that
calls the gang kernel directly — or re-derives topology adjacency from
``topology_columns``/``topo_onehot`` for its own pricing — bypasses
all of that: gangs can stripe partial placements with no release path,
and two call sites can disagree on what "same rack" means (the one-hot
zeroes the coordinate-less column 0; an ad-hoc ``==`` comparison over
raw ids does not).

Flagged: any call whose dotted leaf is ``cp_gang_place_kernel``,
``oracle_cp_gang_place``, ``release_incomplete_gangs``,
``CpGangPlacementKernel``, ``build_gang_inputs``, ``topo_onehot``, or
``topology_columns`` inside ``nomad_tpu_torch/scheduler/`` or
``nomad_tpu_torch/server/``.

Exempt: ``scheduler/algorithms.py`` (the registry constructs the
kernel wrapper) and ``scheduler/cp.py`` (the seam itself — gang input
assembly, oracle cross-checks, atomic release, and the gang A/B
harness live there). ``nomad_tpu_torch/device/`` is out of scope, as for
NTA016: the rule polices dispatch, not implementation or parity
pinning.
"""

from __future__ import annotations

import ast

from ..lint import Finding, Rule, ScopedVisitor, dotted_name

_SCOPES = ("nomad_tpu_torch/scheduler/", "nomad_tpu_torch/server/")
_EXEMPT = (
    "nomad_tpu_torch/scheduler/algorithms.py",
    "nomad_tpu_torch/scheduler/cp.py",
)

_TOPOLOGY_LEAVES = (
    "cp_gang_place_kernel",
    "oracle_cp_gang_place",
    "release_incomplete_gangs",
    "CpGangPlacementKernel",
    "build_gang_inputs",
    "topo_onehot",
    "topology_columns",
)


class _TopologyVisitor(ScopedVisitor):
    def visit_Call(self, node: ast.Call) -> None:
        name = dotted_name(node.func) or ""
        leaf = name.rsplit(".", 1)[-1]
        if leaf in _TOPOLOGY_LEAVES:
            self.add(
                "NTA020",
                node,
                f"direct topology/gang invocation {leaf}(...): route "
                "through scheduler/algorithms.py (the cp-gang plugin) so "
                "atomic gang release, one-hot topology semantics, and the "
                "nomad.cp.gang_* conservation ledger stay on the path",
            )
        self.generic_visit(node)


class TopologySeamDiscipline(Rule):
    id = "NTA020"
    title = "topology/gang pricing routed only through the cp-gang seam"

    def applies_to(self, relpath: str) -> bool:
        if relpath in _EXEMPT:
            return False
        return relpath.startswith(_SCOPES)

    def check(self, tree, source, relpath) -> list[Finding]:
        v = _TopologyVisitor(relpath)
        v.visit(tree)
        return v.findings
