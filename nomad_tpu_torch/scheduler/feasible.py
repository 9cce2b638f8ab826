"""Host-side hard-constraint evaluation.

Reference: scheduler/feasible.go — resolveTarget (:748-781) and
checkConstraint's operator dispatch (:785-820) with the full operand set
(=, !=, <, <=, >, >=, regexp, version, semver, set_contains*, is_set).

In the TPU design this code runs **once per computed node class** (or per
node for constraints touching ``unique.`` attributes), producing boolean
masks that ``device.flatten`` broadcasts into the dense eligibility tensor.
Regex and version parsing never reach the device — the same "classes ≪
nodes" bet the reference makes with its class memoization
(feasible.go:1029-1153).
"""

from __future__ import annotations

import re
from functools import lru_cache
from typing import Optional

from ..structs import Constraint
from ..structs.node import Node


@lru_cache(maxsize=1024)
def _compiled_regex(pattern: str):
    try:
        return re.compile(pattern)
    except re.error:
        return None


@lru_cache(maxsize=4096)
def _parse_version(v: str) -> Optional[tuple]:
    """Lenient version parse: dotted numerics with optional prerelease tag
    ("1.2.3-beta2" < "1.2.3"). Mirrors go-version's ordering closely enough
    for constraint checking."""
    v = v.strip().lstrip("v")
    if not v:
        return None
    main, _, pre = v.partition("-")
    parts = []
    for p in main.split("."):
        if not p.isdigit():
            return None
        parts.append(int(p))
    while len(parts) < 3:
        parts.append(0)
    # releases sort after prereleases of the same version
    return (tuple(parts), 1 if not pre else 0, pre)


def _check_version_constraint(lval: str, constraint_expr: str, lenient: bool) -> bool:
    """Version constraint like ">= 1.2, < 2.0" (go-version syntax).
    ``lenient`` mode (operand "version") tolerates non-semver lvals;
    strict mode ("semver") requires a clean parse."""
    lv = _parse_version(lval)
    if lv is None:
        return False
    for clause in constraint_expr.split(","):
        clause = clause.strip()
        if not clause:
            continue
        m = re.match(r"^(>=|<=|!=|><|[=<>~]+)?\s*(.+)$", clause)
        if not m:
            return False
        op = m.group(1) or "="
        rv = _parse_version(m.group(2))
        if rv is None:
            return False
        if op in ("=", "=="):
            ok = lv == rv
        elif op == "!=":
            ok = lv != rv
        elif op == ">":
            ok = lv > rv
        elif op == ">=":
            ok = lv >= rv
        elif op == "<":
            ok = lv < rv
        elif op == "<=":
            ok = lv <= rv
        elif op in ("~>",):
            # pessimistic: >= rv and < next significant release
            lo = rv[0]
            hi = list(lo[:-1])
            if len(hi) > 0:
                hi[-1] += 1
            ok = lv >= rv and lv[0] < tuple(hi) + (0,) * (3 - len(hi))
        else:
            ok = False
        if not ok:
            return False
    return True


def _lexical_or_numeric_cmp(l: str, r: str) -> Optional[int]:
    """Order comparison: numeric when both parse, else lexical
    (feasible.go checkLexicalOrder / checkOrder)."""
    try:
        lf, rf = float(l), float(r)
        return (lf > rf) - (lf < rf)
    except ValueError:
        return (l > r) - (l < r)


def check_constraint_values(operand: str, lval: Optional[str], rval: str) -> bool:
    """Operator dispatch on already-resolved values."""
    if operand == "is_set":
        return lval is not None
    if operand == "is_not_set":
        return lval is None
    if lval is None:
        return False
    if operand in ("=", "==", "is"):
        return lval == rval
    if operand in ("!=", "not"):
        return lval != rval
    if operand in ("<", "<=", ">", ">="):
        c = _lexical_or_numeric_cmp(lval, rval)
        if c is None:
            return False
        return {
            "<": c < 0,
            "<=": c <= 0,
            ">": c > 0,
            ">=": c >= 0,
        }[operand]
    if operand == "regexp":
        rx = _compiled_regex(rval)
        return rx is not None and rx.search(lval) is not None
    if operand == "version":
        return _check_version_constraint(lval, rval, lenient=True)
    if operand == "semver":
        return _check_version_constraint(lval, rval, lenient=False)
    if operand in ("set_contains", "set_contains_all"):
        have = {p.strip() for p in lval.split(",")}
        want = {p.strip() for p in rval.split(",")}
        return want <= have
    if operand == "set_contains_any":
        have = {p.strip() for p in lval.split(",")}
        want = {p.strip() for p in rval.split(",")}
        return bool(want & have)
    return False


def check_constraint(node: Node, c: Constraint) -> bool:
    """Resolve targets against the node, then dispatch. Both sides may be
    interpolations (feasible.go resolveTarget): a bare RTarget is a
    literal; an ${...} RTarget resolves against the node too."""
    lval = node.lookup_attribute(c.l_target) if c.l_target else None
    rval = c.r_target
    if rval.startswith("${") and rval.endswith("}"):
        resolved = node.lookup_attribute(rval)
        if resolved is None and c.operand not in ("is_set", "is_not_set"):
            return False
        rval = resolved if resolved is not None else ""
    return check_constraint_values(c.operand, lval, rval)


# -- volume feasibility -------------------------------------------------------

FILTER_HOST_VOLUMES = "missing compatible host volumes"
FILTER_CSI_PLUGIN = "CSI plugin is missing or unhealthy on node"
FILTER_CSI_VOLUME = "CSI volume has exhausted its available writer claims"
FILTER_CSI_NOT_FOUND = "CSI volume not found"


def check_host_volumes(node: Node, volumes: dict) -> bool:
    """HostVolumeChecker (scheduler/feasible.go:132-207): every requested
    host volume must exist on the node; a writable request can't be
    satisfied by a read-only host volume."""
    for req in volumes.values():
        if req.type not in ("", "host"):
            continue
        hv = node.host_volumes.get(req.source)
        if hv is None:
            return False
        if getattr(hv, "read_only", False) and not req.read_only:
            return False
    return True


def check_csi_volumes(snapshot, node: Node, volumes: dict) -> tuple[bool, str]:
    """CSIVolumeChecker (scheduler/feasible.go:209-339): the volume must
    exist, be schedulable, have claim capacity for the requested mode, and
    the node must run a healthy node-plugin instance for its plugin (with
    per-node volume-count budget). ``per_alloc`` requests check the
    family's first index (claims are per-source at apply time).
    """
    csi_reqs = [r for r in volumes.values() if r.type == "csi"]
    if not csi_reqs:
        return True, ""
    # seed each plugin's per-node budget with the volumes of *that plugin*
    # already attached to this node (CSIVolumeChecker counts existing
    # claims per plugin, not node-wide)
    mounted_by_plugin: dict[str, int] = {}
    attached_here: set[str] = set()
    if snapshot is not None:
        for v in snapshot.csi_volumes():
            if node.id in v.read_claims.values() or node.id in (
                v.write_claims.values()
            ):
                mounted_by_plugin[v.plugin_id] = (
                    mounted_by_plugin.get(v.plugin_id, 0) + 1
                )
                attached_here.add(v.id)
    for req in csi_reqs:
        source = f"{req.source}[0]" if req.per_alloc else req.source
        vol = snapshot.csi_volume_by_id(source) if snapshot else None
        if vol is None and req.per_alloc:
            vol = snapshot.csi_volume_by_id(req.source) if snapshot else None
        if vol is None:
            return False, FILTER_CSI_NOT_FOUND
        plugin = node.csi_node_plugins.get(vol.plugin_id)
        if plugin is None or not plugin.healthy:
            return False, FILTER_CSI_PLUGIN
        if vol.id not in attached_here:  # already-mounted volumes are free
            mounted = mounted_by_plugin.get(vol.plugin_id, 0) + 1
            mounted_by_plugin[vol.plugin_id] = mounted
            if plugin.max_volumes and mounted > plugin.max_volumes:
                return False, FILTER_CSI_PLUGIN
            attached_here.add(vol.id)  # one attach serves repeat requests
        if not vol.claimable(req.read_only):
            return False, FILTER_CSI_VOLUME
    return True, ""
