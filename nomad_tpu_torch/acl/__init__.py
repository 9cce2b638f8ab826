"""ACL subsystem — policies, compiled ACLs, tokens.

Reference: acl/acl.go (compiled capability checker), acl/policy.go
(HCL policy parse + shorthand expansion), nomad/structs ACLToken/ACLPolicy,
nomad/acl_endpoint.go (bootstrap/policy/token RPCs).
"""

from .acl import ACL, AclCache, MANAGEMENT_ACL, compile_acl
from .policy import (
    POLICY_DENY,
    POLICY_LIST,
    POLICY_READ,
    POLICY_SCALE,
    POLICY_WRITE,
    AclPolicyError,
    NamespacePolicy,
    Policy,
    parse_policy,
)
from .tokens import ACLPolicyRecord, ACLToken

__all__ = [
    "ACL",
    "AclCache",
    "MANAGEMENT_ACL",
    "compile_acl",
    "POLICY_DENY",
    "POLICY_LIST",
    "POLICY_READ",
    "POLICY_SCALE",
    "POLICY_WRITE",
    "AclPolicyError",
    "NamespacePolicy",
    "Policy",
    "parse_policy",
    "ACLPolicyRecord",
    "ACLToken",
]
