"""The port's ACL plane (``nomad_tpu_torch.acl``, ``server/acl.py``) and
its HCL reader (``utils/hcl.py``) against the JAX package's, on the CPU.

The reference's policies (``tests/test_acl.py``) and HCL documents
(``tests/test_hcl.py``) go through both packages: each policy must parse
to the same record and compile, alone and merged, to the same
capabilities, checked over a grid of namespaces, host volumes and
operations; invalid policies and documents must be refused by both.
Through ``ACLService``: bootstrap once, policy and token upserts, token
resolution (management, client, unknown, anonymous with and without an
anonymous policy) and token validation, with ACLs enabled and disabled.

Tolerance: none. Records, capability answers and refusals are compared
exactly.
"""

import dataclasses

import pytest

from nomad_tpu import acl as ref_acl
from nomad_tpu.server import Server as RefServer
from nomad_tpu.server import ServerConfig as RefServerConfig
from nomad_tpu.server.acl import TokenError as RefTokenError
from nomad_tpu.utils import hcl as ref_hcl
from nomad_tpu_torch import acl as port_acl
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server.acl import TokenError
from nomad_tpu_torch.utils import hcl as port_hcl

POLICIES = (
    'namespace "default" { policy = "read" }',
    'namespace "dev" {\n  policy       = "write"\n  capabilities = ["alloc-node-exec"]\n}',
    'agent    { policy = "read" }\nnode     { policy = "write" }\n'
    'operator { policy = "deny" }\nquota    { policy = "read" }\nplugin   { policy = "list" }',
    'host_volume "prod-*" { policy = "write" }',
    'host_volume "data-*" { policy = "read" }',
    'namespace "default" { policy = "write" }',
    'namespace "default" { policy = "deny" }',
    'namespace "*" { policy = "deny" }',
    'namespace "prod-*" { policy = "read" }',
    'namespace "prod-*" { policy = "write" }',
    'namespace "prod-api" { policy = "deny" }',
    'node { policy = "write" }\nagent { policy = "read" }',
    'namespace "ops" { capabilities = ["list-jobs", "read-logs", "submit-job"] }\n'
    'namespace "ops-*" { policy = "scale" }',
)
INVALID = (
    'namespace "x" { policy = "bogus" }',
    'namespace "bad name!" { policy = "read" }',
    'namespace "x" { capabilities = ["not-a-cap"] }',
    "agent { }",
    'plugin { policy = "scale" }',
    'namespace "x" { policy = "read"',
)
# the merges tests/test_acl.py compiles (indexes into POLICIES)
MERGES = ((0,), (1,), (2,), (3,), (4,), (5, 6), (7, 8), (9, 10), (11,), (0, 1, 3, 12),
          tuple(range(len(POLICIES))))
NAMESPACES = ("default", "dev", "other", "prod-api", "prod-db", "prod-", "ops", "ops-1", "")
VOLUMES = ("prod-1", "data-1", "data-", "other")
NS_OPS = ("read-job", "list-jobs", "submit-job", "alloc-node-exec", "read-logs",
          "scale-job", "dispatch-job", "deny")
HV_OPS = ("mount-readonly", "mount-readwrite", "deny")
COARSE = ("agent_read", "agent_write", "node_read", "node_write", "operator_read",
          "operator_write", "quota_read", "quota_write", "plugin_read", "plugin_list")


def _record(policy):
    return dataclasses.asdict(policy)


def _answers(acl):
    return (
        acl.is_management(),
        [acl.allow_namespace_operation(ns, op) for ns in NAMESPACES for op in NS_OPS],
        [acl.allow_namespace(ns) for ns in NAMESPACES],
        [acl.allow_host_volume_operation(v, op) for v in VOLUMES for op in HV_OPS],
        [getattr(acl, f"allow_{c}")() for c in COARSE],
    )


@pytest.mark.parametrize("rules", POLICIES)
def test_policy_parses_to_the_same_record(rules):
    assert _record(port_acl.parse_policy(rules)) == _record(ref_acl.parse_policy(rules))


@pytest.mark.parametrize("rules", INVALID)
def test_invalid_policy_refused_by_both(rules):
    with pytest.raises(ref_acl.AclPolicyError) as want:
        ref_acl.parse_policy(rules)
    with pytest.raises(port_acl.AclPolicyError) as got:
        port_acl.parse_policy(rules)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("merge", MERGES, ids=lambda m: "+".join(map(str, m)))
def test_compiled_capabilities_match_reference(merge):
    want = ref_acl.compile_acl([ref_acl.parse_policy(POLICIES[i]) for i in merge])
    got = port_acl.compile_acl([port_acl.parse_policy(POLICIES[i]) for i in merge])
    assert _answers(got) == _answers(want)


def test_management_acl_and_max_privilege_match_reference():
    from nomad_tpu.acl.acl import max_privilege as ref_max
    from nomad_tpu_torch.acl.acl import max_privilege

    assert _answers(port_acl.MANAGEMENT_ACL) == _answers(ref_acl.MANAGEMENT_ACL)
    levels = ("", "list", "read", "write", "deny", "scale")
    assert [max_privilege(a, b) for a in levels for b in levels] == [
        ref_max(a, b) for a in levels for b in levels]


HCL_DOCS = (
    'count = 3\nratio = 0.5\nname = "web"\nenabled = true\nnothing = null\n'
    'tags = ["a", "b"]\nmeta = { k = "v", n = 2 }',
    '# comment\na = 1 // trailing\n/* block\n   comment */\nb = 2',
    'xs = [\n  "a",\n  "b",\n]',
    'cmd = "$${NOMAD_ADDR_http}"\nmoney = "a$$b"',
    'script = <<EOF\nline1\nline2\nEOF\n',
    'script = <<-EOF\n    indented\n    lines\n  EOF\n',
)
HCL_EXPRS = (
    "1 + 2 * 3", "(1 + 2) * 3", 'n > 3 ? "big" : "small"', "!false && true", "-n", "n % 3",
    "var.xs[1]", "var.m.k", 'var.m["k"]', 'upper("ab")', 'join(",", ["a", "b"])',
    "length([1, 2, 3])", 'format("%s-%d", "x", 3)', "min(3, 1, 2)", 'contains(["a"], "a")',
    "merge({a = 1}, {b = 2})", 'try(var.missing, "fallback")', "can(var.missing)",
    '"a-${var.region}-z"',
)


def test_hcl_reader_matches_reference():
    for doc in HCL_DOCS:
        assert port_hcl.body_to_value(port_hcl.parse(doc)) == ref_hcl.body_to_value(
            ref_hcl.parse(doc))
    env = {"n": 4, "var": {"xs": [10, 20], "m": {"k": "v"}, "region": "us"}}
    for expr in HCL_EXPRS:
        got = port_hcl.parse_expression(expr)(port_hcl.EvalContext(env))
        assert got == ref_hcl.parse_expression(expr)(ref_hcl.EvalContext(env)), expr
    block = 'job "example" {\n  group "web" {\n    count = 2\n    task "server" {}\n  }\n}'
    trees = []
    for mod in (ref_hcl, port_hcl):
        job = mod.parse(block).first("job")
        group = job.body.first("group")
        trees.append((job.labels, group.labels,
                      group.body.attrs["count"].expr(mod.EvalContext()),
                      group.body.first("task").labels))
    assert trees[0] == trees[1]
    for bad in ('a = "unterminated', "block { unclosed"):
        with pytest.raises(ref_hcl.HCLError):
            ref_hcl.parse(bad)
        with pytest.raises(port_hcl.HCLError):
            port_hcl.parse(bad)


def _service_script(server_cls, config_cls, acl_mod, token_error):
    """Bootstrap, policies, tokens and resolution through ACLService; the
    outcome of each step as plain data."""
    s = server_cls(config_cls(num_workers=0, acl_enabled=True))
    out = []
    try:
        boot = s.acl.bootstrap()
        out.append(("boot", boot.is_management(), boot.type))
        try:
            s.acl.bootstrap()
        except PermissionError as e:
            out.append(("second bootstrap", str(e)))
        out.append(("resolve boot", _answers(s.acl.resolve_token(boot.secret_id))))
        s.acl.upsert_policies([acl_mod.ACLPolicyRecord(name="readonly", rules=POLICIES[0]),
                               acl_mod.ACLPolicyRecord(name="dev", rules=POLICIES[1])])
        (tok,) = s.acl.upsert_tokens([acl_mod.ACLToken(name="ro", type="client",
                                                       policies=["readonly", "dev"])])
        out.append(("resolve client", _answers(s.acl.resolve_token(tok.secret_id))))
        for secret in ("no-such-secret",):
            try:
                s.acl.resolve_token(secret)
            except token_error as e:
                out.append(("unknown", str(e)))
        out.append(("anonymous", _answers(s.acl.resolve_token(""))))
        s.acl.upsert_policies([acl_mod.ACLPolicyRecord(name="anonymous", rules=POLICIES[0])])
        out.append(("anonymous policy", _answers(s.acl.resolve_token(""))))
        for bad in (acl_mod.ACLToken(type="client", policies=[]),
                    acl_mod.ACLToken(type="management", policies=["x"]),
                    acl_mod.ACLToken(type="client", policies=["missing"])):
            try:
                s.acl.upsert_tokens([bad])
            except ValueError as e:
                out.append(("invalid token", str(e)))
        with pytest.raises(acl_mod.AclPolicyError):
            s.acl.upsert_policies([acl_mod.ACLPolicyRecord(name="bad", rules=INVALID[0])])
        s.acl.delete_policies(["dev"])
        try:
            s.acl.resolve_token(tok.secret_id)
        except token_error as e:
            out.append(("deleted policy", str(e)))
        s.acl.delete_tokens([tok.accessor_id])
        out.append(("deleted token", s.store.acl_token_by_secret(tok.secret_id)))
    finally:
        s.shutdown()
    disabled = server_cls(config_cls(num_workers=0))
    try:
        out.append(("disabled", disabled.acl.resolve_token("anything")))
        try:
            disabled.acl.bootstrap()
        except PermissionError as e:
            out.append(("disabled bootstrap", str(e)))
    finally:
        disabled.shutdown()
    return out


def test_acl_service_matches_reference():
    want = _service_script(RefServer, RefServerConfig, ref_acl, RefTokenError)
    got = _service_script(
        Server, lambda **kw: ServerConfig(device="cpu", **kw), port_acl, TokenError)
    assert got == want
    assert len(got) == 14
