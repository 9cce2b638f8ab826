"""ACL token + stored-policy records.

Reference: structs.ACLToken / structs.ACLPolicy
(nomad/structs/structs.go ACL section) and the bootstrap/management
semantics of nomad/acl_endpoint.go.
"""

from __future__ import annotations

import time
import uuid
from dataclasses import dataclass, field

TOKEN_TYPE_CLIENT = "client"
TOKEN_TYPE_MANAGEMENT = "management"

ANONYMOUS_TOKEN_NAME = "Anonymous Token"
ANONYMOUS_POLICY_NAME = "anonymous"


@dataclass
class ACLPolicyRecord:
    """A named, stored policy document (structs.ACLPolicy)."""

    name: str
    description: str = ""
    rules: str = ""
    create_index: int = 0
    modify_index: int = 0

    def to_api(self) -> dict:
        return {
            "Name": self.name,
            "Description": self.description,
            "Rules": self.rules,
            "CreateIndex": self.create_index,
            "ModifyIndex": self.modify_index,
        }


@dataclass
class ACLToken:
    """structs.ACLToken: accessor (public id) + secret (bearer value)."""

    accessor_id: str = field(default_factory=lambda: str(uuid.uuid4()))
    secret_id: str = field(default_factory=lambda: str(uuid.uuid4()))
    name: str = ""
    type: str = TOKEN_TYPE_CLIENT
    policies: list[str] = field(default_factory=list)
    global_: bool = False
    create_time: float = field(default_factory=time.time)
    create_index: int = 0
    modify_index: int = 0

    def is_management(self) -> bool:
        return self.type == TOKEN_TYPE_MANAGEMENT

    def validate(self) -> list[str]:
        errs = []
        if len(self.name) > 256:
            errs.append("token name too long")
        if self.type not in (TOKEN_TYPE_CLIENT, TOKEN_TYPE_MANAGEMENT):
            errs.append("token type must be client or management")
        if self.type == TOKEN_TYPE_CLIENT and not self.policies:
            errs.append("client token missing policies")
        if self.type == TOKEN_TYPE_MANAGEMENT and self.policies:
            errs.append("management token cannot be associated with policies")
        return errs

    def to_api(self, redact_secret: bool = False) -> dict:
        return {
            "AccessorID": self.accessor_id,
            "SecretID": "" if redact_secret else self.secret_id,
            "Name": self.name,
            "Type": self.type,
            "Policies": list(self.policies),
            "Global": self.global_,
            "CreateTime": self.create_time,
            "CreateIndex": self.create_index,
            "ModifyIndex": self.modify_index,
        }
