"""The port's jobspec parser and agent config (``nomad_tpu_torch.jobspec``,
``nomad_tpu_torch.agent_config``) against the JAX package's, on the CPU.

Every HCL source of the reference's ``tests/test_jobspec.py``, and jobs
that carry each construct of ``tests/test_hcl.py`` (blocks and labels,
comments, interpolation and escapes, expressions, traversal and index,
functions, heredocs, multi-line lists, ``$${`` escapes, lazy ``try`` /
``can``, interpolated object keys, and its four syntax and evaluation
errors), parsed by both packages, give equal ``encode`` output or equal
error messages (the exception's class name and text). ``parse_duration``
gives equal values or errors on the reference's cases. The reference's
unplaceable-job case runs through both schedulers (the reference's under
the scoped ``trace_state_clean`` monkeypatch, ROADMAP C-R1) and both evals
carry the same filter accounting. ``parse_agent_config`` /
``load_agent_config`` give equal ``dataclasses.asdict`` on the agent-config
cases of ``tests/test_aux_surface.py``.

No tolerance applies: everything compared is exact.
"""

import dataclasses

import pytest

from nomad_tpu import agent_config as ref_agent_config
from nomad_tpu import jobspec as ref_jobspec
from nomad_tpu import mock as ref_mock
from nomad_tpu.api.codec import encode as ref_encode
from nomad_tpu.scheduler import Harness as RefHarness
from nomad_tpu_torch import agent_config as port_agent_config
from nomad_tpu_torch import interop
from nomad_tpu_torch import jobspec as port_jobspec
from nomad_tpu_torch.api.codec import encode as port_encode
from nomad_tpu_torch.scheduler import Harness
from nomad_tpu_torch.structs import Node
from test_jobspec import EXAMPLE
from test_torch_hetero import reference_runtime


def _task(body, driver="exec"):
    return f'job "h" {{\n  group "g" {{\n    task "t" {{\n      driver = "{driver}"\n{body}\n    }}\n  }}\n}}\n'


# the HCL sources of tests/test_jobspec.py (EXAMPLE is imported from it)
JOBSPEC_SOURCES = {
    "example": EXAMPLE,
    "variables_and_locals": """
    variable "count" { default = 2 }
    variable "dc" { default = "dc1" }
    locals {
      full_name = "web-${var.dc}"
    }
    job "v" {
      datacenters = [var.dc]
      group "g" {
        count = var.count * 2
        task "t" {
          driver = "exec"
          env { NAME = local.full_name }
        }
      }
    }
    """,
    "variable_missing": 'variable "x" {}\njob "j" { group "g" { task "t" { driver = "exec" } } }',
    "periodic": """
        job "cron" {
          type = "batch"
          periodic {
            cron             = "*/15 * * * *"
            prohibit_overlap = true
          }
          group "g" { task "t" { driver = "exec" } }
        }
        """,
    "parameterized": """
        job "batch" {
          type = "batch"
          parameterized {
            payload       = "required"
            meta_required = ["input"]
          }
          group "g" { task "t" { driver = "exec" } }
        }
        """,
    "constraint_shorthands": """
        job "c" {
          constraint {
            attribute = "${attr.driver.exec.version}"
            version   = ">= 1.2"
          }
          constraint {
            attribute = "${meta.rack}"
            regexp    = "r[0-9]+"
          }
          group "g" {
            constraint { distinct_property = "${meta.rack}" }
            task "t" { driver = "exec" }
          }
        }
        """,
    "device_asks": """
        job "ml" {
          group "g" {
            task "train" {
              driver = "exec"
              resources {
                cpu    = 1000
                memory = 4096
                device "nvidia/gpu" {
                  count = 2
                  constraint {
                    attribute = "${device.attr.memory}"
                    operator  = ">="
                    value     = "8 GiB"
                  }
                }
              }
            }
          }
        }
        """,
    "no_job_block": 'group "g" {}',
    "no_groups": 'job "j" {}',
    "no_tasks": 'job "j" { group "g" {} }',
    "invalid_type": 'job "j" { type = "bogus"\n group "g" { task "t" { driver = "exec" } } }',
    "unplaceable": """
        job "nope" {
          group "g" {
            task "t" { driver = "no_such_driver" }
          }
        }
        """,
}

# jobs carrying each construct of tests/test_hcl.py
HCL_SOURCES = {
    "blocks_and_labels": """
        job "example" {
          datacenters = ["dc1"]
          group "web" {
            count = 2
            task "server" {
              driver = "exec"
            }
          }
        }
        """,
    "attrs_and_types": _task("""
      meta = { k = "v", n = "2" }
      config {
        count   = 3
        ratio   = 0.5
        name    = "web"
        enabled = true
        nothing = null
        tags    = ["a", "b"]
      }"""),
    "comments": _task("""
      # comment
      user = "a" // trailing
      /* block
         comment */
      kill_timeout = "2s\""""),
    "interpolation_and_escapes": 'variable "region" { default = "us" }\n' + _task("""
      env {
        X = "a-${var.region}-z"
        Y = "q\\"esc\\""
      }"""),
    "expressions": 'locals { n = 4 }\n' + _task("""
      env {
        A = 1 + 2 * 3
        B = (1 + 2) * 3
        C = local.n > 3 ? "big" : "small"
        D = !false && true
        E = -local.n
        F = local.n % 3
      }"""),
    "traversal_and_index": 'locals {\n  xs = [10, 20]\n  m = { k = "v" }\n}\n' + _task("""
      env {
        A = local.xs[1]
        B = local.m.k
        C = local.m["k"]
      }"""),
    "functions": _task("""
      env {
        A = upper("ab")
        B = join(",", ["a", "b"])
        C = length([1, 2, 3])
        D = format("%s-%d", "x", 3)
        E = min(3, 1, 2)
        F = contains(["a"], "a")
      }"""),
    "heredoc": _task("""
      config {
        script = <<EOF
line1
line2
EOF
        indented = <<-EOF
          indented
          lines
        EOF
      }"""),
    "multiline_lists": _task("""
      config {
        args = [
          "a",
          "b",
        ]
      }"""),
    "dollar_escape": _task("""
      config {
        cmd   = "$${NOMAD_ADDR_http}"
        money = "a$$b"
      }"""),
    "try_and_can": 'variable "x" { default = 1 }\n' + _task("""
      env {
        A = try(var.missing, "fallback")
        B = try(var.x, 99)
        C = can(var.missing)
        D = can(var.x)
      }"""),
    "interpolated_object_keys": 'variable "k" { default = "key1" }\n' + _task("""
      meta = { "${var.k}" = "v", plain = "2" }"""),
    "error_unterminated_string": 'job "j" { name = "unterminated }',
    "error_unclosed_block": 'job "j" { group "g" {',
    "error_unknown_function": _task('      user = unknown_fn()'),
    "error_missing_variable": _task('      user = missing_var'),
}

VARIABLES = {
    "variables_and_locals": [None, {"count": 5, "dc": "dc9"}],
    "variable_missing": [None, {"x": 1}, {"x": 1, "bogus": 2}],
}


def _parse(jobspec, encode, src, variables):
    try:
        return ("job", encode(jobspec.parse_job_file(src, variables)))
    except Exception as e:  # noqa: BLE001 — the error is the result
        return ("error", type(e).__name__, str(e))


CASES = [
    pytest.param(name, src, variables, id=f"{name}-{i}")
    for sources in (JOBSPEC_SOURCES, HCL_SOURCES)
    for name, src in sorted(sources.items())
    for i, variables in enumerate(VARIABLES.get(name, [None]))
]


@pytest.mark.parametrize("name, src, variables", CASES)
def test_parse_equals_reference(name, src, variables):
    ref = _parse(ref_jobspec, ref_encode, src, variables)
    port = _parse(port_jobspec, port_encode, src, variables)
    assert port == ref
    if name.startswith("error_") or name in ("no_job_block", "no_groups", "no_tasks",
                                             "invalid_type"):
        assert port[0] == "error"


def test_every_hcl_case_parses_or_fails_as_intended():
    """The HCL constructs land in the job (so the comparison above is of
    parsed values, not of two equal errors)."""
    for name, src in HCL_SOURCES.items():
        kind = _parse(port_jobspec, port_encode, src, None)[0]
        assert kind == ("error" if name.startswith("error_") else "job"), name
    env = port_jobspec.parse_job_file(HCL_SOURCES["functions"]).task_groups[0].tasks[0].env
    assert env == {"A": "AB", "B": "a,b", "C": "3", "D": "x-3", "E": "1", "F": "True"}


@pytest.mark.parametrize("value", ["30s", "5m", "1h30m", "500ms", 42, "bogus", "5x"])
def test_parse_duration_equals_reference(value):
    def parse(jobspec):
        try:
            return jobspec.parse_duration(value)
        except Exception as e:  # noqa: BLE001
            return (type(e).__name__, str(e))

    assert parse(port_jobspec) == parse(ref_jobspec)


def test_failed_placement_metrics_explain_filtering(monkeypatch):
    src = JOBSPEC_SOURCES["unplaceable"]
    nodes = [ref_mock.node() for _ in range(3)]

    def metrics(h, job):
        h.store.upsert_job(h.next_index(), job)
        ev = h_mock.eval_for(job)
        h.store.upsert_evals(h.next_index(), [ev])
        h.process(ev)
        m = h.evals[-1].failed_tg_allocs["g"]
        return m.nodes_evaluated, m.nodes_filtered, dict(m.constraint_filtered)

    ref_h = RefHarness()
    for i, n in enumerate(nodes):
        ref_h.store.upsert_node(i + 1, n)
    h_mock = ref_mock
    with reference_runtime(monkeypatch):
        ref = metrics(ref_h, ref_jobspec.parse_job_file(src))
    from nomad_tpu_torch import mock as port_mock

    port_h = Harness(device="cpu")
    for i, n in enumerate(nodes):
        port_h.store.upsert_node(i + 1, interop.from_record(Node, dataclasses.asdict(n)))
    h_mock = port_mock
    port = metrics(port_h, port_jobspec.parse_job_file(src))
    assert port == ref == (3, 3, {"missing drivers: no_such_driver": 3})


# -- agent config (tests/test_aux_surface.py::TestAgentConfig) ----------------

AGENT_HCL = """
region     = "west"
datacenter = "dc7"
data_dir   = "/var/nomad"

ports {
  http = 5646
}

server {
  enabled        = true
  num_schedulers = 3
  heartbeat_grace = "30s"
}

client {
  enabled      = true
  servers      = ["10.0.0.1:4647", "10.0.0.2:4647"]
  driver_mode  = "plugin"
  gc_max_allocs = 25

  host_volume "certs" {
    path = "/etc/ssl/certs"
  }
}

telemetry {
  collection_interval = "5s"
  publish_allocation_metrics = true
}
"""


def test_parse_agent_config_equals_reference():
    ref = ref_agent_config.parse_agent_config(AGENT_HCL)
    port = port_agent_config.parse_agent_config(AGENT_HCL)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.client.driver_mode == "plugin" and port.server.heartbeat_ttl_s == 30.0


def test_load_agent_config_merge_and_defaults(tmp_path):
    f1 = tmp_path / "a.hcl"
    f1.write_text('region = "east"\ndatacenter = "dc1"\n')
    f2 = tmp_path / "b.hcl"
    f2.write_text('datacenter = "dc2"\n')
    files = [str(f1), str(f2)]
    ref = ref_agent_config.load_agent_config(files)
    port = port_agent_config.load_agent_config(files)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert (port.region, port.datacenter, port.bind_addr) == ("east", "dc2", "127.0.0.1")
    assert dataclasses.asdict(port_agent_config.AgentConfig()) == dataclasses.asdict(
        ref_agent_config.AgentConfig())
