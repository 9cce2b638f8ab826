"""ACL policy parsing — HCL rules → Policy with expanded capabilities.

Reference: acl/policy.go. Policies are HCL documents of the shape:

    namespace "default" {
      policy       = "read"
      capabilities = ["submit-job"]
    }
    host_volume "prod-*" { policy = "write" }
    node     { policy = "write" }
    agent    { policy = "read" }
    operator { policy = "write" }
    quota    { policy = "read" }
    plugin   { policy = "list" }

Coarse ``policy`` levels expand to fine-grained capability lists
(acl/policy.go:166-232); ``deny`` always wins on merge.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional

from ..utils import hcl

# Coarse policy dispositions (acl/policy.go:14-19)
POLICY_DENY = "deny"
POLICY_READ = "read"
POLICY_LIST = "list"
POLICY_WRITE = "write"
POLICY_SCALE = "scale"

# Namespace capabilities (acl/policy.go:27-48)
NS_CAP_DENY = "deny"
NS_CAP_LIST_JOBS = "list-jobs"
NS_CAP_READ_JOB = "read-job"
NS_CAP_SUBMIT_JOB = "submit-job"
NS_CAP_DISPATCH_JOB = "dispatch-job"
NS_CAP_READ_LOGS = "read-logs"
NS_CAP_READ_FS = "read-fs"
NS_CAP_ALLOC_EXEC = "alloc-exec"
NS_CAP_ALLOC_NODE_EXEC = "alloc-node-exec"
NS_CAP_ALLOC_LIFECYCLE = "alloc-lifecycle"
NS_CAP_CSI_REGISTER_PLUGIN = "csi-register-plugin"
NS_CAP_CSI_WRITE_VOLUME = "csi-write-volume"
NS_CAP_CSI_READ_VOLUME = "csi-read-volume"
NS_CAP_CSI_LIST_VOLUME = "csi-list-volume"
NS_CAP_CSI_MOUNT_VOLUME = "csi-mount-volume"
NS_CAP_LIST_SCALING_POLICIES = "list-scaling-policies"
NS_CAP_READ_SCALING_POLICY = "read-scaling-policy"
NS_CAP_READ_JOB_SCALING = "read-job-scaling"
NS_CAP_SCALE_JOB = "scale-job"
NS_CAP_SUBMIT_RECOMMENDATION = "submit-recommendation"

_VALID_NS_CAPS = {
    NS_CAP_DENY,
    NS_CAP_LIST_JOBS,
    NS_CAP_READ_JOB,
    NS_CAP_SUBMIT_JOB,
    NS_CAP_DISPATCH_JOB,
    NS_CAP_READ_LOGS,
    NS_CAP_READ_FS,
    NS_CAP_ALLOC_EXEC,
    NS_CAP_ALLOC_NODE_EXEC,
    NS_CAP_ALLOC_LIFECYCLE,
    NS_CAP_CSI_REGISTER_PLUGIN,
    NS_CAP_CSI_WRITE_VOLUME,
    NS_CAP_CSI_READ_VOLUME,
    NS_CAP_CSI_LIST_VOLUME,
    NS_CAP_CSI_MOUNT_VOLUME,
    NS_CAP_LIST_SCALING_POLICIES,
    NS_CAP_READ_SCALING_POLICY,
    NS_CAP_READ_JOB_SCALING,
    NS_CAP_SCALE_JOB,
    NS_CAP_SUBMIT_RECOMMENDATION,
}

# Host-volume capabilities (acl/policy.go:55-64)
HV_CAP_DENY = "deny"
HV_CAP_MOUNT_READONLY = "mount-readonly"
HV_CAP_MOUNT_READWRITE = "mount-readwrite"

_VALID_HV_CAPS = {HV_CAP_DENY, HV_CAP_MOUNT_READONLY, HV_CAP_MOUNT_READWRITE}

_VALID_NAME = re.compile(r"^[a-zA-Z0-9-*]{1,128}$")


class AclPolicyError(Exception):
    pass


@dataclass
class NamespacePolicy:
    name: str
    policy: str = ""
    capabilities: list[str] = field(default_factory=list)


@dataclass
class HostVolumePolicy:
    name: str
    policy: str = ""
    capabilities: list[str] = field(default_factory=list)


@dataclass
class Policy:
    namespaces: list[NamespacePolicy] = field(default_factory=list)
    host_volumes: list[HostVolumePolicy] = field(default_factory=list)
    agent: str = ""
    node: str = ""
    operator: str = ""
    quota: str = ""
    plugin: str = ""
    raw: str = ""

    def is_empty(self) -> bool:
        return (
            not self.namespaces
            and not self.host_volumes
            and not self.agent
            and not self.node
            and not self.operator
            and not self.quota
            and not self.plugin
        )


def expand_namespace_policy(policy: str) -> list[str]:
    """acl/policy.go:166-211."""
    read = [
        NS_CAP_LIST_JOBS,
        NS_CAP_READ_JOB,
        NS_CAP_CSI_LIST_VOLUME,
        NS_CAP_CSI_READ_VOLUME,
        NS_CAP_READ_JOB_SCALING,
        NS_CAP_LIST_SCALING_POLICIES,
        NS_CAP_READ_SCALING_POLICY,
    ]
    write = read + [
        NS_CAP_SCALE_JOB,
        NS_CAP_SUBMIT_JOB,
        NS_CAP_DISPATCH_JOB,
        NS_CAP_READ_LOGS,
        NS_CAP_READ_FS,
        NS_CAP_ALLOC_EXEC,
        NS_CAP_ALLOC_LIFECYCLE,
        NS_CAP_CSI_MOUNT_VOLUME,
        NS_CAP_CSI_WRITE_VOLUME,
        NS_CAP_SUBMIT_RECOMMENDATION,
    ]
    if policy == POLICY_DENY:
        return [NS_CAP_DENY]
    if policy == POLICY_READ:
        return read
    if policy == POLICY_WRITE:
        return write
    if policy == POLICY_SCALE:
        return [
            NS_CAP_LIST_SCALING_POLICIES,
            NS_CAP_READ_SCALING_POLICY,
            NS_CAP_READ_JOB_SCALING,
            NS_CAP_SCALE_JOB,
        ]
    return []


def expand_host_volume_policy(policy: str) -> list[str]:
    """acl/policy.go:221-232."""
    if policy == POLICY_DENY:
        return [HV_CAP_DENY]
    if policy == POLICY_READ:
        return [HV_CAP_MOUNT_READONLY]
    if policy == POLICY_WRITE:
        return [HV_CAP_MOUNT_READONLY, HV_CAP_MOUNT_READWRITE]
    return []


def _is_policy_valid(p: str) -> bool:
    return p in (POLICY_DENY, POLICY_READ, POLICY_WRITE, POLICY_SCALE)


def _coarse_only(p: str) -> bool:
    """agent/node/operator/quota/plugin accept deny|read|write (plugin also
    list) — acl/policy.go isPolicyValid + isPluginPolicyValid."""
    return p in (POLICY_DENY, POLICY_READ, POLICY_WRITE)


def _block_policy(block: Optional[hcl.Block], what: str, allow_list=False) -> str:
    if block is None:
        return ""
    ctx = hcl.EvalContext()
    attr = block.body.attrs.get("policy")
    if attr is None:
        return ""
    p = attr.expr(ctx)
    valid = _coarse_only(p) or (allow_list and p == POLICY_LIST)
    if not valid:
        raise AclPolicyError(f"Invalid {what} policy: {p!r}")
    return p


def parse_policy(rules: str) -> Policy:
    """Parse + validate + expand an HCL policy document (acl/policy.go:237)."""
    p = Policy(raw=rules)
    if not rules.strip():
        return p
    try:
        body = hcl.parse(rules)
    except hcl.HCLError as e:
        raise AclPolicyError(f"Failed to parse ACL Policy: {e}") from e
    ctx = hcl.EvalContext()

    for b in body.blocks_of("namespace"):
        if len(b.labels) != 1:
            raise AclPolicyError("namespace block requires exactly one label")
        ns = NamespacePolicy(name=b.labels[0])
        if "policy" in b.body.attrs:
            ns.policy = b.body.attrs["policy"].expr(ctx)
        if "capabilities" in b.body.attrs:
            ns.capabilities = list(b.body.attrs["capabilities"].expr(ctx))
        if not _VALID_NAME.match(ns.name):
            raise AclPolicyError(f"Invalid namespace name: {ns.name!r}")
        if ns.policy and not _is_policy_valid(ns.policy):
            raise AclPolicyError(f"Invalid namespace policy: {ns.policy!r}")
        for cap in ns.capabilities:
            if cap not in _VALID_NS_CAPS:
                raise AclPolicyError(f"Invalid namespace capability: {cap!r}")
        if ns.policy:
            ns.capabilities = ns.capabilities + expand_namespace_policy(ns.policy)
        p.namespaces.append(ns)

    for b in body.blocks_of("host_volume"):
        if len(b.labels) != 1:
            raise AclPolicyError("host_volume block requires exactly one label")
        hv = HostVolumePolicy(name=b.labels[0])
        if "policy" in b.body.attrs:
            hv.policy = b.body.attrs["policy"].expr(ctx)
        if "capabilities" in b.body.attrs:
            hv.capabilities = list(b.body.attrs["capabilities"].expr(ctx))
        if not _VALID_NAME.match(hv.name):
            raise AclPolicyError(f"Invalid host volume name: {hv.name!r}")
        if hv.policy and not _is_policy_valid(hv.policy):
            raise AclPolicyError(f"Invalid host volume policy: {hv.policy!r}")
        for cap in hv.capabilities:
            if cap not in _VALID_HV_CAPS:
                raise AclPolicyError(f"Invalid host volume capability: {cap!r}")
        if hv.policy:
            hv.capabilities = hv.capabilities + expand_host_volume_policy(hv.policy)
        p.host_volumes.append(hv)

    p.agent = _block_policy(body.first("agent"), "agent")
    p.node = _block_policy(body.first("node"), "node")
    p.operator = _block_policy(body.first("operator"), "operator")
    p.quota = _block_policy(body.first("quota"), "quota")
    p.plugin = _block_policy(body.first("plugin"), "plugin", allow_list=True)

    if p.is_empty():
        raise AclPolicyError(f"Invalid policy: {rules!r}")
    return p
