"""NTA015 — device placement goes through the mesh seam.

The port of ``nomad_tpu/analysis/rules/shardingseam.py``. The reference
flags ``jax.device_put`` / ``NamedSharding`` / ``PartitionSpec`` outside
its ``utils/backend.py``. The port's seam is ``backend.py``:
``make_mesh`` / ``get_mesh`` build the one ``MeshConfig`` a process
drives, and ``shard_put`` is the one site that lays a tensor out over it
(region-major node blocks, the degenerate one-device case, axes that do
not divide). A device or scheduler module that builds a ``MeshConfig``
or a ``ShardedTensor`` itself forks that layout logic, and one that
reaches for ``torch.distributed`` (a process group, a ``DeviceMesh``,
a collective) leaves the single-controller design whose collectives are
copies onto the lead: either way the two copies drift, and a node-axis
tensor silently lands whole on every device.

Flagged, inside ``nomad_tpu_torch/device/`` and
``nomad_tpu_torch/scheduler/``: a call whose dotted leaf is
``MeshConfig`` or ``ShardedTensor``; any use of ``torch.distributed``
(import or attribute) and of ``DeviceMesh``.

Exempt: ``device/cache.py`` — its per-shard refresh IS the seam's
partial-upload half (``ShardedTensor.with_blocks`` replaces one column's
blocks), as in the reference. ``backend.py`` is out of scope by
construction.
"""

from __future__ import annotations

import ast

from ..lint import Finding, Rule, ScopedVisitor, dotted_name

_SCOPES = ("nomad_tpu_torch/device/", "nomad_tpu_torch/scheduler/")
_EXEMPT = ("nomad_tpu_torch/device/cache.py",)

_PLACEMENT_LEAVES = ("MeshConfig", "ShardedTensor")

_SEAM = (
    "route through backend.py make_mesh / shard_put so node-axis tensors "
    "follow the mesh layout instead of landing whole on every device"
)


class _PlacementVisitor(ScopedVisitor):
    def visit_Call(self, node: ast.Call) -> None:
        name = dotted_name(node.func) or ""
        leaf = name.rsplit(".", 1)[-1]
        if leaf in _PLACEMENT_LEAVES:
            self.add(
                "NTA015", node, f"bare device placement {leaf}(...): {_SEAM}",
            )
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        name = dotted_name(node) or ""
        if name == "torch.distributed":
            self.add("NTA015", node, f"torch.distributed in a device path: {_SEAM}")
            return
        if node.attr == "DeviceMesh":
            self.add("NTA015", node, f"DeviceMesh in a device path: {_SEAM}")
        self.generic_visit(node)

    def visit_Name(self, node: ast.Name) -> None:
        if node.id == "DeviceMesh":
            self.add("NTA015", node, f"DeviceMesh in a device path: {_SEAM}")

    def visit_Import(self, node: ast.Import) -> None:
        if any(a.name.startswith("torch.distributed") for a in node.names):
            self.add("NTA015", node, f"import torch.distributed: {_SEAM}")

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        module = node.module or ""
        if module.startswith("torch.distributed") or (
            module == "torch" and any(a.name == "distributed" for a in node.names)
        ):
            self.add("NTA015", node, f"from {module} import: {_SEAM}")


class ShardingSeamDiscipline(Rule):
    id = "NTA015"
    title = "device placement goes through the mesh seam"

    def applies_to(self, relpath: str) -> bool:
        if relpath in _EXEMPT:
            return False
        return relpath.startswith(_SCOPES)

    def check(self, tree, source, relpath) -> list[Finding]:
        v = _PlacementVisitor(relpath)
        v.visit(tree)
        return v.findings
