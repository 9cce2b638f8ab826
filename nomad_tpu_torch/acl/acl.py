"""Compiled ACL — merge policies into an efficiently-checkable object.

Reference: acl/acl.go. Merge rules: across policies the *maximum*
privilege wins, except ``deny`` which always wins (maxPrivilege,
acl/acl.go:67-85). Namespace/host-volume rules support glob patterns;
on lookup, an exact match wins, otherwise the matching glob with the
smallest character difference ``len(name) - len(pattern)`` is chosen
(findClosestMatchingGlob, acl/acl.go:332-354).
"""

from __future__ import annotations

import fnmatch
import threading
from typing import Iterable, Optional

from .policy import (
    HV_CAP_DENY,
    NS_CAP_DENY,
    POLICY_DENY,
    POLICY_LIST,
    POLICY_READ,
    POLICY_WRITE,
    Policy,
)

def max_privilege(a: str, b: str) -> str:
    """acl/acl.go:67-85 — deny > write > read > list."""
    if POLICY_DENY in (a, b):
        return POLICY_DENY
    if POLICY_WRITE in (a, b):
        return POLICY_WRITE
    if POLICY_READ in (a, b):
        return POLICY_READ
    if POLICY_LIST in (a, b):
        return POLICY_LIST
    return ""


def _glob_match(pattern: str, name: str) -> bool:
    # ryanuber/go-glob semantics: '*' wildcards only (no ? or []).
    return fnmatch.fnmatchcase(
        name, pattern.replace("[", "[[]").replace("?", "[?]")
    )


class ACL:
    """Compiled capability checker (acl/acl.go:42-64)."""

    def __init__(self, management: bool = False):
        self.management = management
        self.namespaces: dict[str, frozenset[str]] = {}
        self.wildcard_namespaces: dict[str, frozenset[str]] = {}
        self.host_volumes: dict[str, frozenset[str]] = {}
        self.wildcard_host_volumes: dict[str, frozenset[str]] = {}
        self.agent = ""
        self.node = ""
        self.operator = ""
        self.quota = ""
        self.plugin = ""

    # -- namespace ---------------------------------------------------------
    def _matching_caps(
        self,
        exact: dict[str, frozenset[str]],
        wild: dict[str, frozenset[str]],
        name: str,
    ) -> Optional[frozenset[str]]:
        caps = exact.get(name)
        if caps is not None:
            return caps
        matches = [
            (len(name) - len(pat), pat, caps)
            for pat, caps in sorted(wild.items())
            if _glob_match(pat, name)
        ]
        if not matches:
            return None
        matches.sort(key=lambda m: m[0])
        return matches[0][2]

    def allow_namespace_operation(self, namespace: str, op: str) -> bool:
        if self.management:
            return True
        caps = self._matching_caps(self.namespaces, self.wildcard_namespaces, namespace)
        if caps is None:
            return False
        return op in caps and NS_CAP_DENY not in caps

    allow_ns_op = allow_namespace_operation

    def allow_namespace(self, namespace: str) -> bool:
        """Any non-deny capability grants namespace visibility."""
        if self.management:
            return True
        caps = self._matching_caps(self.namespaces, self.wildcard_namespaces, namespace)
        if caps is None:
            return False
        return bool(caps) and NS_CAP_DENY not in caps

    # -- host volumes ------------------------------------------------------
    def allow_host_volume_operation(self, volume: str, op: str) -> bool:
        if self.management:
            return True
        caps = self._matching_caps(
            self.host_volumes, self.wildcard_host_volumes, volume
        )
        if caps is None:
            return False
        return op in caps and HV_CAP_DENY not in caps

    # -- coarse scopes -----------------------------------------------------
    def _coarse(self, level: str, need_write: bool) -> bool:
        if self.management:
            return True
        if level == POLICY_DENY:
            return False
        if need_write:
            return level == POLICY_WRITE
        return level in (POLICY_READ, POLICY_WRITE, POLICY_LIST)

    def allow_agent_read(self) -> bool:
        return self._coarse(self.agent, False)

    def allow_agent_write(self) -> bool:
        return self._coarse(self.agent, True)

    def allow_node_read(self) -> bool:
        return self._coarse(self.node, False)

    def allow_node_write(self) -> bool:
        return self._coarse(self.node, True)

    def allow_operator_read(self) -> bool:
        return self._coarse(self.operator, False)

    def allow_operator_write(self) -> bool:
        return self._coarse(self.operator, True)

    def allow_quota_read(self) -> bool:
        return self._coarse(self.quota, False)

    def allow_quota_write(self) -> bool:
        return self._coarse(self.quota, True)

    def allow_plugin_read(self) -> bool:
        return self._coarse(self.plugin, False)

    def allow_plugin_list(self) -> bool:
        if self.management:
            return True
        return self.plugin not in ("", POLICY_DENY)

    def is_management(self) -> bool:
        return self.management


def compile_acl(policies: Iterable[Policy]) -> ACL:
    """NewACL (acl/acl.go:88-177): union capabilities per namespace/volume,
    maxPrivilege for coarse scopes; deny capability sticks."""
    acl = ACL(management=False)
    ns_caps: dict[str, set[str]] = {}
    hv_caps: dict[str, set[str]] = {}
    for p in policies:
        for ns in p.namespaces:
            ns_caps.setdefault(ns.name, set()).update(ns.capabilities)
        for hv in p.host_volumes:
            hv_caps.setdefault(hv.name, set()).update(hv.capabilities)
        acl.agent = max_privilege(acl.agent, p.agent)
        acl.node = max_privilege(acl.node, p.node)
        acl.operator = max_privilege(acl.operator, p.operator)
        acl.quota = max_privilege(acl.quota, p.quota)
        acl.plugin = max_privilege(acl.plugin, p.plugin)
    for name, caps in ns_caps.items():
        target = acl.wildcard_namespaces if "*" in name else acl.namespaces
        target[name] = frozenset(caps)
    for name, caps in hv_caps.items():
        target = acl.wildcard_host_volumes if "*" in name else acl.host_volumes
        target[name] = frozenset(caps)
    return acl


MANAGEMENT_ACL = ACL(management=True)


class AclCache:
    """Bounded cache of compiled ACLs keyed by the contributing policy
    names + modify indexes (the reference caches by policy content hash,
    nomad/acl.go resolveTokenACL)."""

    def __init__(self, maxsize: int = 512):
        self._cache: dict[tuple, ACL] = {}
        self._lock = threading.Lock()
        self._maxsize = maxsize

    def get_or_compile(self, key: tuple, policies_fn) -> ACL:
        with self._lock:
            hit = self._cache.get(key)
            if hit is not None:
                return hit
        acl = compile_acl(policies_fn())
        with self._lock:
            if len(self._cache) >= self._maxsize:
                self._cache.clear()
            self._cache[key] = acl
        return acl
