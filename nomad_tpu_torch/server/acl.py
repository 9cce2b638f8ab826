"""Server ACL endpoints + token resolution.

Reference: nomad/acl_endpoint.go (Bootstrap, UpsertPolicies, DeletePolicies,
GetPolicy/ListPolicies, UpsertTokens, DeleteTokens, ResolveToken) and
nomad/acl.go (Server.ResolveToken → compiled ACL with cache; anonymous
token handling).
"""

from __future__ import annotations

from typing import Iterable, Optional

from .fsm import MsgType
from ..acl import (
    ACL,
    AclCache,
    MANAGEMENT_ACL,
    ACLPolicyRecord,
    ACLToken,
    compile_acl,
    parse_policy,
)
from ..acl.tokens import ANONYMOUS_POLICY_NAME, TOKEN_TYPE_MANAGEMENT


class TokenError(Exception):
    """Unknown or invalid token (maps to HTTP 403)."""


class ACLService:
    """Bound to a Server; owns the resolution cache and endpoint logic."""

    def __init__(self, server):
        self.server = server
        self.cache = AclCache()

    @property
    def enabled(self) -> bool:
        return self.server.config.acl_enabled

    # -- bootstrap ---------------------------------------------------------
    def bootstrap(self) -> ACLToken:
        """One-time creation of the initial management token
        (acl_endpoint.go Bootstrap)."""
        if not self.enabled:
            raise PermissionError("ACL support disabled")
        token = ACLToken(
            name="Bootstrap Token", type=TOKEN_TYPE_MANAGEMENT, global_=True
        )
        self.server.raft_apply_checked(MsgType.ACL_BOOTSTRAP, {"token": token})
        return token

    # -- policies ----------------------------------------------------------
    def upsert_policies(self, policies: Iterable[ACLPolicyRecord]) -> None:
        policies = list(policies)
        for p in policies:
            parse_policy(p.rules)  # validates; raises AclPolicyError
            if not p.name:
                raise ValueError("policy name required")
        self.server.raft_apply_checked(MsgType.ACL_POLICY_UPSERT, {"policies": policies})
        self.cache = AclCache()  # rules changed: drop compiled ACLs

    def delete_policies(self, names: Iterable[str]) -> None:
        names = list(names)
        self.server.raft_apply_checked(MsgType.ACL_POLICY_DELETE, {"names": names})
        self.cache = AclCache()

    # -- tokens ------------------------------------------------------------
    def upsert_tokens(self, tokens: Iterable[ACLToken]) -> list[ACLToken]:
        tokens = list(tokens)
        for t in tokens:
            errs = t.validate()
            if errs:
                raise ValueError("; ".join(errs))
            for pname in t.policies:
                if self.server.store.acl_policy_by_name(pname) is None:
                    raise ValueError(f"policy {pname!r} does not exist")
        self.server.raft_apply_checked(MsgType.ACL_TOKEN_UPSERT, {"tokens": tokens})
        return tokens

    def delete_tokens(self, accessor_ids: Iterable[str]) -> None:
        ids = list(accessor_ids)
        self.server.raft_apply_checked(MsgType.ACL_TOKEN_DELETE, {"accessor_ids": ids})

    # -- resolution --------------------------------------------------------
    def resolve_token(self, secret_id: str) -> Optional[ACL]:
        """nomad/acl.go ResolveToken. Returns None when ACLs are disabled
        (callers skip enforcement); raises TokenError on unknown secrets."""
        if not self.enabled:
            return None
        if not secret_id:
            return self._anonymous_acl()
        token = self.server.store.acl_token_by_secret(secret_id)
        if token is None:
            raise TokenError("ACL token not found")
        if token.is_management():
            return MANAGEMENT_ACL
        return self._compile_for(token.policies)

    def _anonymous_acl(self) -> ACL:
        anon = self.server.store.acl_policy_by_name(ANONYMOUS_POLICY_NAME)
        if anon is None:
            return ACL(management=False)  # denies everything
        return self._compile_for([ANONYMOUS_POLICY_NAME])

    def _compile_for(self, policy_names: list[str]) -> ACL:
        records = []
        for name in sorted(set(policy_names)):
            rec = self.server.store.acl_policy_by_name(name)
            if rec is None:
                raise TokenError(f"token policy {name!r} does not exist")
            records.append(rec)
        key = tuple((r.name, r.modify_index) for r in records)
        return self.cache.get_or_compile(
            key, lambda: [parse_policy(r.rules) for r in records]
        )
