"""The port's source analysis (``nomad_tpu_torch.analysis``) against the
JAX package's, on the CPU: the NTA lint and its rules, the baseline
ratchet, the CLI, the lock-graph race checker, the build budgets, and
the swallow-accounting and scheduler-clock seams the rules lean on.

- Every NTA trigger and non-trigger fixture of the reference's
  ``tests/test_static_analysis.py`` (its TestNTA001–TestNTA021 classes)
  runs through the reference's ``lint.check_source`` and the port's,
  with the relpath's ``nomad_tpu/`` prefix mapped to
  ``nomad_tpu_torch/``: both give the same (rule, line, symbol) list,
  and the reference test's expected rule ids. A reference test's scope
  check compares the two rules' ``applies_to``; its "at head is clean"
  check runs the port's rule over the port's file. NTA002, NTA015 and
  NTA017 have the port's meaning (host syncs on a launch path, the
  mesh seam, the kernel build seam), so they get fixtures of their own:
  a trigger and a non-trigger each, as many cases as the reference's
  classes have.
- The whole port tree gives no finding beyond the port's baseline, and
  that baseline is the reference's 28 entries with the prefix mapped.
- The reference's TestSuppressionAndFingerprints, TestBaselineRatchet,
  TestCLI (as subprocesses of ``python -m nomad_tpu_torch.analysis``),
  TestRaceDetector, TestSwallowAccounting and TestSchedulerClock cases,
  against the port; TestRetraceBudgets becomes the build budgets
  (a fake guarded kernel that starts builds, ``analysis/retrace.py``).

The source lint is JAX-free in both packages, so nothing here needs the
reference's runtime shim.
"""

import json
import os
import subprocess
import sys
import threading
import time

import pytest
import torch

from nomad_tpu.analysis import lint as ref_lint
from nomad_tpu.analysis.rules import REGISTRY as REF_REGISTRY
from nomad_tpu_torch import backend
from nomad_tpu_torch.analysis import lint, race, retrace
from nomad_tpu_torch.analysis.rules import REGISTRY
from nomad_tpu_torch.utils.metrics import count_swallowed, global_metrics

REPO_ROOT = lint.repo_root()
REF_RULES = {cls.id: cls for cls in REF_REGISTRY}
PORT_RULES = {cls.id: cls for cls in REGISTRY}


def port_path(relpath: str) -> str:
    """A reference relpath in the port: the package prefix, and the
    reference's ``utils/backend.py`` is the port's ``backend.py``."""
    if relpath == "nomad_tpu/utils/backend.py":
        return "nomad_tpu_torch/backend.py"
    return relpath.replace("nomad_tpu/", "nomad_tpu_torch/", 1)


def run(src, relpath, rule_id):
    return lint.check_source(src, relpath, rules=[PORT_RULES[rule_id]()])


def rule_ids(findings):
    return [f.rule for f in findings]


def where(findings):
    return [(f.rule, f.line, f.symbol) for f in findings]


# -- every reference NTA fixture through both packages ------------------------
#
# (reference test, rule, source, reference relpath, expected rule ids,
#  expected symbol of the first finding or None)

_SRC_NTA004 = "def apply(plan):\n    plan.priority = 99\n"
_SRC_NTA005_TRIGGER = (
    "import threading\n"
    "class S:\n"
    "    def __init__(self):\n"
    "        self._lock = threading.Lock()\n"
    "        self._x = 0\n"
    "    def bump(self):\n"
    "        with self._lock:\n"
    "            self._x += 1\n"
    "    def peek(self):\n"
    "        return self._x\n"
)
_SRC_NTA013 = (
    "from ..device.score import PlacementKernel\n"
    "def process(cfg, ct, asks):\n"
    "    k = PlacementKernel(cfg.scheduler_algorithm)\n"
    "    return k.place(ct, asks)\n"
)
_SRC_NTA016 = (
    "from ..device.cp import cp_place_kernel\n"
    "def fast_path(batch):\n"
    "    return cp_place_kernel(batch.capacity, batch.used)\n"
)
_SRC_NTA020 = (
    "from ..device.cp import cp_gang_place_kernel, topo_onehot\n"
    "def fast_gang(batch, ct):\n"
    "    oh = topo_onehot(ct.topo_rack_ids, 8)\n"
    "    return cp_gang_place_kernel(batch.capacity, oh)\n"
)
_SRC_NTA021 = (
    "from ..device.migrate import oracle_migrate_plan\n"
    "from ..scheduler.migrate import build_defrag_batch\n"
    "def fast_moves(capacity, used, sizes, cur, budget, lam0, steps):\n"
    "    args = build_defrag_batch(capacity, used, sizes, cur)\n"
    "    return oracle_migrate_plan(*args, budget, lam0, steps)\n"
)

FIXTURES = [
    # NTA001
    ("NTA001-time_time_in_scheduler_triggers", "NTA001",
     "import time\ndef score():\n    return time.time()\n",
     "nomad_tpu/scheduler/foo.py", ["NTA001"], "score"),
    ("NTA001-datetime_now_triggers", "NTA001",
     "import datetime\ndef stamp():\n    return datetime.datetime.now()\n",
     "nomad_tpu/device/foo.py", ["NTA001"], None),
    ("NTA001-unseeded_random_triggers", "NTA001",
     "import random\ndef jitter():\n    return random.random()\n",
     "nomad_tpu/scheduler/x.py", ["NTA001"], None),
    ("NTA001-seeded_rng_does_not", "NTA001",
     "import numpy as np\ndef jitter(seed):\n"
     "    return np.random.default_rng(seed).random()\n",
     "nomad_tpu/scheduler/x.py", [], None),
    ("NTA001-injected_clock_is_clean", "NTA001",
     "def score(ctx):\n    return ctx.clock()\n",
     "nomad_tpu/scheduler/foo.py", [], None),
    ("NTA001-out_of_scope_path_ignored", "NTA001",
     "import time\ndef f():\n    return time.time()\n",
     "nomad_tpu/server/worker.py", [], None),
    # NTA003
    ("NTA003-pass_only_handler_triggers", "NTA003",
     "def f():\n    try:\n        g()\n    except ValueError:\n        pass\n",
     "nomad_tpu/server/x.py", ["NTA003"], None),
    ("NTA003-broad_handler_without_observation_triggers", "NTA003",
     "def f():\n    try:\n        g()\n    except Exception:\n        cleanup()\n",
     "nomad_tpu/broker/x.py", ["NTA003"], None),
    ("NTA003-logging_handler_is_clean", "NTA003",
     "def f():\n    try:\n        g()\n    except Exception:\n"
     "        log.exception('g failed')\n",
     "nomad_tpu/server/x.py", [], None),
    ("NTA003-count_swallowed_handler_is_clean", "NTA003",
     "def f():\n    try:\n        g()\n    except Exception as e:\n"
     "        count_swallowed('worker', e)\n",
     "nomad_tpu/server/x.py", [], None),
    ("NTA003-reraise_is_clean", "NTA003",
     "def f():\n    try:\n        g()\n    except Exception:\n        raise\n",
     "nomad_tpu/state/x.py", [], None),
    ("NTA003-scope_excludes_device", "NTA003",
     "def f():\n    try:\n        g()\n    except Exception:\n        pass\n",
     "nomad_tpu/device/x.py", [], None),
    # NTA004
    ("NTA004-attribute_store_on_plan_triggers", "NTA004", _SRC_NTA004,
     "nomad_tpu/broker/plan_apply.py", ["NTA004"], None),
    ("NTA004-mutator_call_on_plan_field_triggers", "NTA004",
     "def apply(plan):\n    plan.node_allocs['n1'].append(alloc)\n",
     "nomad_tpu/broker/plan_apply.py", ["NTA004"], None),
    ("NTA004-subscript_store_via_alias_triggers", "NTA004",
     "def apply(plan):\n    allocs = plan.node_allocs\n    allocs['n1'] = []\n",
     "nomad_tpu/broker/plan_apply.py", ["NTA004"], None),
    ("NTA004-reads_and_local_copies_are_clean", "NTA004",
     "def apply(plan):\n"
     "    mine = list(plan.node_allocs.get('n1', []))\n"
     "    mine.append(1)\n"
     "    return len(mine), plan.priority\n",
     "nomad_tpu/broker/plan_apply.py", [], None),
    ("NTA004-scope_limited_to_plan_apply", "NTA004", _SRC_NTA004,
     "nomad_tpu/broker/eval_broker.py", [], None),
    # NTA005
    ("NTA005-lock_free_read_of_guarded_field_triggers", "NTA005",
     _SRC_NTA005_TRIGGER, "nomad_tpu/state/s.py", ["NTA005"], "S.peek"),
    ("NTA005-all_accesses_locked_is_clean", "NTA005",
     _SRC_NTA005_TRIGGER.replace(
         "    def peek(self):\n        return self._x\n",
         "    def peek(self):\n        with self._lock:\n            return self._x\n",
     ),
     "nomad_tpu/state/s.py", [], None),
    ("NTA005-locked_suffix_method_exempt", "NTA005",
     _SRC_NTA005_TRIGGER.replace("def peek(self)", "def _peek_locked(self)"),
     "nomad_tpu/state/s.py", [], None),
    ("NTA005-unguarded_fields_not_flagged", "NTA005",
     "import threading\n"
     "class S:\n"
     "    def __init__(self):\n"
     "        self._lock = threading.Lock()\n"
     "        self._x = 0\n"
     "    def bump(self):\n"
     "        self._x += 1\n"
     "    def peek(self):\n"
     "        return self._x\n",
     "nomad_tpu/state/s.py", [], None),
    # NTA006
    ("NTA006-raw_timer_in_worker_triggers", "NTA006",
     "def process(metrics, ev):\n"
     "    with metrics.timer('nomad.worker.invoke_scheduler'):\n"
     "        pass\n",
     "nomad_tpu/server/worker.py", ["NTA006"], "process"),
    ("NTA006-span_with_timer_passthrough_is_clean", "NTA006",
     "def process(tracer, ev):\n"
     "    with tracer.span('invoke_scheduler',\n"
     "                     timer='nomad.worker.invoke_scheduler'):\n"
     "        pass\n",
     "nomad_tpu/server/worker.py", [], None),
    ("NTA006-out_of_scope_module_not_flagged", "NTA006",
     "def collect(metrics):\n    with metrics.timer('nomad.gc.pass'):\n        pass\n",
     "nomad_tpu/state/core_gc.py", [], None),
    ("NTA006-allow_comment_waives", "NTA006",
     "def process(metrics, ev):\n"
     "    with metrics.timer('x'):  # nta: allow=NTA006\n"
     "        pass\n",
     "nomad_tpu/server/worker.py", [], None),
    # NTA007
    ("NTA007-per_eval_enqueue_in_commit_thread_triggers", "NTA007",
     "class Worker:\n"
     "    def _commit_batch_inner(self, members):\n"
     "        for m in members:\n"
     "            self.server.plan_queue.enqueue(m.plan)\n",
     "nomad_tpu/server/worker.py", ["NTA007"], "Worker._commit_batch_inner"),
    ("NTA007-submit_plan_in_run_batch_triggers", "NTA007",
     "class Worker:\n"
     "    def _run_batch(self, batch):\n"
     "        for ev, sched in batch:\n"
     "            sched.planner.submit_plan(sched.plan)\n",
     "nomad_tpu/server/worker.py", ["NTA007"], None),
    ("NTA007-enqueue_merged_is_the_sanctioned_path", "NTA007",
     "class Worker:\n"
     "    def _commit_batch_inner(self, members, mplan):\n"
     "        return self.server.plan_queue.enqueue_merged(mplan)\n",
     "nomad_tpu/server/worker.py", [], None),
    ("NTA007-individual_fallback_path_is_exempt", "NTA007",
     "class Worker:\n"
     "    def _run_one(self, ev, token):\n"
     "        self.planner.submit_plan(self.plan)\n",
     "nomad_tpu/server/worker.py", [], None),
    # NTA008
    ("NTA008-bare_time_and_sleep_trigger", "NTA008",
     "import time\ndef sweep(self):\n    now = time.time()\n    time.sleep(0.1)\n",
     "nomad_tpu/broker/x.py", ["NTA008", "NTA008"], None),
    ("NTA008-module_alias_is_resolved", "NTA008",
     "import time as _t\ndef f():\n    return _t.time()\n",
     "nomad_tpu/server/x.py", ["NTA008"], None),
    ("NTA008-from_import_aliases_are_resolved", "NTA008",
     "from time import time as now, sleep\ndef f():\n    sleep(1)\n    return now()\n",
     "nomad_tpu/broker/x.py", ["NTA008", "NTA008"], None),
    ("NTA008-monotonic_and_injected_clock_are_clean", "NTA008",
     "import time\ndef f(self):\n    t0 = time.perf_counter()\n"
     "    time.monotonic()\n    return self._clock()\n",
     "nomad_tpu/broker/x.py", [], None),
    # NTA010
    ("NTA010-direct_placement_overlay_in_batch_path_triggers", "NTA010",
     "class Worker:\n"
     "    def _run_batch(self, batch):\n"
     "        ov = self.server.placement_overlay\n"
     "        ov.begin_pass()\n",
     "nomad_tpu/server/worker.py", ["NTA010"], "Worker._run_batch"),
    ("NTA010-add_delta_without_writer_triggers", "NTA010",
     "class Worker:\n"
     "    def _run_batch(self, batch, overlay, ct, rows, ask):\n"
     "        overlay.add_delta(ct, rows, ask)\n",
     "nomad_tpu/server/worker.py", ["NTA010"], None),
    ("NTA010-tagged_add_delta_is_the_sanctioned_path", "NTA010",
     "class Worker:\n"
     "    def _run_batch(self, batch, overlay, ct, rows, ask):\n"
     "        overlay.add_delta(ct, rows, ask, writer=self.id)\n",
     "nomad_tpu/server/worker.py", [], None),
    ("NTA010-direct_store_mutation_in_commit_thread_triggers", "NTA010",
     "class Worker:\n"
     "    def _commit_batch_inner(self, members):\n"
     "        self.server.store.upsert_plan_results(1, members)\n",
     "nomad_tpu/server/worker.py", ["NTA010"], None),
    ("NTA010-store_reads_are_clean", "NTA010",
     "class Worker:\n"
     "    def _run_batch(self, batch):\n"
     "        snap = self.server.store.snapshot()\n"
     "        self.server.store.wait_for_index(3, timeout=5.0)\n",
     "nomad_tpu/server/worker.py", [], None),
    ("NTA010-accessor_and_solo_path_are_exempt", "NTA010",
     "class Worker:\n"
     "    def _my_overlay(self):\n"
     "        return self.server.placement_overlay\n"
     "    def _run_one(self, ev, token, overlay, ct, rows, ask):\n"
     "        self.server.placement_overlay.maybe_reset()\n"
     "        overlay.add_delta(ct, rows, ask)\n",
     "nomad_tpu/server/worker.py", [], None),
    # NTA012
    ("NTA012-ungated_apply_eval_create_triggers", "NTA012",
     "class Handler:\n"
     "    def handle_thing(self, job):\n"
     "        ev = build_eval(job)\n"
     "        self.server.apply_eval_create([ev])\n",
     "nomad_tpu/api/http.py", ["NTA012"], "Handler.handle_thing"),
    ("NTA012-ungated_broker_enqueue_triggers", "NTA012",
     "class Handler:\n"
     "    def handle_thing(self, ev):\n"
     "        self.server.eval_broker.enqueue(ev)\n",
     "nomad_tpu/api/http.py", ["NTA012"], None),
    ("NTA012-gated_handler_is_clean", "NTA012",
     "class Handler:\n"
     "    def handle_thing(self, job):\n"
     "        self.server.admission.check_intake(\n"
     "            job.priority, 'job-eval')\n"
     "        ev = build_eval(job)\n"
     "        self.server.apply_eval_create([ev])\n",
     "nomad_tpu/api/http.py", [], None),
    ("NTA012-gate_in_other_function_does_not_cover", "NTA012",
     "class Handler:\n"
     "    def gate(self, job):\n"
     "        self.server.admission.check_intake(job.priority, 'x')\n"
     "    def handle_thing(self, job):\n"
     "        self.server.apply_eval_create([build_eval(job)])\n",
     "nomad_tpu/api/http.py", ["NTA012"], "Handler.handle_thing"),
    ("NTA012-broker_internal_reference_triggers", "NTA012",
     "class Blocked:\n    def release(self, ev):\n        self.broker._enqueue_locked(ev)\n",
     "nomad_tpu/broker/blocked.py", ["NTA012"], None),
    ("NTA012-ready_queue_poke_triggers", "NTA012",
     "def peek(broker):\n    return broker._ready.get('default')\n",
     "nomad_tpu/broker/blocked.py", ["NTA012"], None),
    ("NTA012-public_enqueue_from_broker_module_is_clean", "NTA012",
     "class Blocked:\n    def release(self, evals):\n        self.broker.enqueue_all(evals)\n",
     "nomad_tpu/broker/blocked.py", [], None),
    # NTA013
    ("NTA013-direct_placement_kernel_in_scheduler_triggers", "NTA013",
     _SRC_NTA013, "nomad_tpu/scheduler/custom.py", ["NTA013"], "process"),
    ("NTA013-direct_score_matrix_kernel_in_server_triggers", "NTA013",
     "from ..device.score import score_matrix_kernel\n"
     "def annotate(ct, ga):\n"
     "    return score_matrix_kernel(ct.capacity, ct.used)\n",
     "nomad_tpu/server/annotate.py", ["NTA013"], None),
    ("NTA013-registry_routed_dispatch_is_clean", "NTA013",
     "from .algorithms import make_kernel, score_group\n"
     "def process(cfg, ct, asks):\n"
     "    k = make_kernel(cfg.scheduler_algorithm)\n"
     "    return k.place(ct, asks)\n",
     "nomad_tpu/scheduler/custom.py", [], None),
    ("NTA013-registry_module_is_exempt", "NTA013",
     _SRC_NTA013, "nomad_tpu/scheduler/algorithms.py", [], None),
    ("NTA013-hetero_module_is_exempt", "NTA013",
     _SRC_NTA013, "nomad_tpu/scheduler/hetero.py", [], None),
    ("NTA013-device_package_is_out_of_scope", "NTA013",
     _SRC_NTA013, "nomad_tpu/device/parity.py", [], None),
    # NTA016
    ("NTA016-direct_kernel_call_in_scheduler_triggers", "NTA016",
     _SRC_NTA016, "nomad_tpu/scheduler/shortcut.py", ["NTA016"], "fast_path"),
    ("NTA016-direct_wrapper_construction_in_server_triggers", "NTA016",
     "from ..scheduler.cp import CpPlacementKernel, build_cp_batch\n"
     "def place(ct, asks):\n"
     "    b = build_cp_batch(ct, asks)\n"
     "    return CpPlacementKernel().place(ct, asks), b\n",
     "nomad_tpu/server/fastlane.py", ["NTA016", "NTA016"], None),
    ("NTA016-registry_routed_dispatch_is_clean", "NTA016",
     "from .algorithms import make_kernel\n"
     "def place(cfg, ct, asks):\n"
     "    return make_kernel(cfg.scheduler_algorithm).place(ct, asks)\n",
     "nomad_tpu/scheduler/custom.py", [], None),
    ("NTA016-registry_is_exempt", "NTA016",
     _SRC_NTA016, "nomad_tpu/scheduler/algorithms.py", [], None),
    ("NTA016-cp_seam_is_exempt", "NTA016",
     _SRC_NTA016, "nomad_tpu/scheduler/cp.py", [], None),
    ("NTA016-device_package_is_out_of_scope", "NTA016",
     _SRC_NTA016, "nomad_tpu/device/parity.py", [], None),
    # NTA020
    ("NTA020-direct_gang_kernel_call_in_scheduler_triggers", "NTA020",
     _SRC_NTA020, "nomad_tpu/scheduler/shortcut.py", ["NTA020", "NTA020"], "fast_gang"),
    ("NTA020-adhoc_topology_columns_in_server_triggers", "NTA020",
     "def same_rack(ct, i, j):\n"
     "    rack, _pod = ct.topology_columns()\n"
     "    return rack[i] == rack[j]\n",
     "nomad_tpu/server/affinity.py", ["NTA020"], None),
    ("NTA020-registry_routed_dispatch_is_clean", "NTA020",
     "from .algorithms import make_kernel\n"
     "def place(cfg, ct, asks):\n"
     "    return make_kernel('cp-gang').place(ct, asks)\n",
     "nomad_tpu/scheduler/custom.py", [], None),
    ("NTA020-registry_is_exempt", "NTA020",
     _SRC_NTA020, "nomad_tpu/scheduler/algorithms.py", [], None),
    ("NTA020-cp_seam_is_exempt", "NTA020",
     _SRC_NTA020, "nomad_tpu/scheduler/cp.py", [], None),
    ("NTA020-device_package_is_out_of_scope", "NTA020",
     _SRC_NTA020, "nomad_tpu/device/parity.py", [], None),
    # NTA021
    ("NTA021-direct_migrate_call_in_scheduler_triggers", "NTA021",
     _SRC_NTA021, "nomad_tpu/scheduler/shortcut.py", ["NTA021", "NTA021"], "fast_moves"),
    ("NTA021-direct_kernel_call_in_server_triggers", "NTA021",
     "from ..device.migrate import migrate_plan_kernel\n"
     "def shortcut(args, budget, lam0):\n"
     "    return migrate_plan_kernel(*args, budget, lam0, steps=8)\n",
     "nomad_tpu/server/fastmove.py", ["NTA021"], None),
    ("NTA021-controller_routed_moves_are_clean", "NTA021",
     "def repack(server):\n    return server.defrag.run_cycle()\n",
     "nomad_tpu/server/custom.py", [], None),
    ("NTA021-migrate_seam_is_exempt", "NTA021",
     _SRC_NTA021, "nomad_tpu/scheduler/migrate.py", [], None),
    ("NTA021-defrag_seam_is_exempt", "NTA021",
     _SRC_NTA021, "nomad_tpu/server/defrag.py", [], None),
    ("NTA021-device_package_is_out_of_scope", "NTA021",
     _SRC_NTA021, "nomad_tpu/device/parity.py", [], None),
    # NTA019
    ("NTA019-direct_attr_write_triggers", "NTA019",
     "def refresh(state, rows):\n    state.used_host = rows\n",
     "nomad_tpu/device/foo.py", ["NTA019"], None),
    ("NTA019-subscripted_write_triggers", "NTA019",
     "def patch(state, i, row):\n    state.used_host[i] = row\n",
     "nomad_tpu/scheduler/foo.py", ["NTA019"], None),
    ("NTA019-augmented_write_triggers", "NTA019",
     "def bump(ct):\n    ct.score_cache += 1\n",
     "nomad_tpu/device/foo.py", ["NTA019"], None),
    ("NTA019-del_triggers", "NTA019",
     "def evict(state):\n    del state.used_dev\n",
     "nomad_tpu/device/foo.py", ["NTA019"], None),
    ("NTA019-unprotected_attr_is_clean", "NTA019",
     "def note(state):\n    state.counter = 3\n    state.rows[0] = 1\n",
     "nomad_tpu/device/foo.py", [], None),
    ("NTA019-refresh_api_owner_is_exempt", "NTA019",
     "def _score_rebuild_locked(self, host):\n    self._score.used_host = host\n",
     "nomad_tpu/device/cache.py", [], None),
    ("NTA019-attachment_point_declaration_is_exempt", "NTA019",
     "def tensors(self, out, cache):\n    out.score_cache = cache\n",
     "nomad_tpu/device/flatten.py", [], None),
    ("NTA019-outside_scope_is_clean", "NTA019",
     "def f(x):\n    x.used_host = 1\n",
     "nomad_tpu/obs/foo.py", [], None),
]


@pytest.mark.parametrize(
    "rule_id,src,relpath,expected,symbol",
    [f[1:] for f in FIXTURES],
    ids=[f[0] for f in FIXTURES],
)
def test_fixture_matches_reference(rule_id, src, relpath, expected, symbol):
    ref = ref_lint.check_source(src, relpath, rules=[REF_RULES[rule_id]()])
    port = run(src, port_path(relpath), rule_id)
    assert where(port) == where(ref)
    assert rule_ids(port) == expected
    if symbol is not None:
        assert port[0].symbol == symbol
    assert all(f.path == port_path(relpath) for f in port)


# (reference test, rule, reference relpath, in scope)
SCOPES = [
    ("NTA007-other_modules_out_of_scope", "NTA007", "nomad_tpu/server/worker.py", True),
    ("NTA007-other_modules_out_of_scope-generic", "NTA007", "nomad_tpu/scheduler/generic.py", False),
    ("NTA008-scope_is_broker_and_server_only-broker", "NTA008", "nomad_tpu/broker/eval_broker.py", True),
    ("NTA008-scope_is_broker_and_server_only-heartbeat", "NTA008", "nomad_tpu/server/heartbeat.py", True),
    ("NTA008-scope_is_broker_and_server_only-generic", "NTA008", "nomad_tpu/scheduler/generic.py", False),
    ("NTA008-scope_is_broker_and_server_only-tests", "NTA008", "tests/test_broker.py", False),
    ("NTA010-other_modules_out_of_scope-worker", "NTA010", "nomad_tpu/server/worker.py", True),
    ("NTA010-other_modules_out_of_scope-overlay", "NTA010", "nomad_tpu/server/overlay.py", False),
    ("NTA010-other_modules_out_of_scope-generic", "NTA010", "nomad_tpu/scheduler/generic.py", False),
    ("NTA012-out_of_scope-http", "NTA012", "nomad_tpu/api/http.py", True),
    ("NTA012-out_of_scope-blocked", "NTA012", "nomad_tpu/broker/blocked.py", True),
    ("NTA012-out_of_scope-eval_broker", "NTA012", "nomad_tpu/broker/eval_broker.py", False),
    ("NTA012-out_of_scope-worker", "NTA012", "nomad_tpu/server/worker.py", False),
]


@pytest.mark.parametrize(
    "rule_id,relpath,in_scope", [s[1:] for s in SCOPES], ids=[s[0] for s in SCOPES],
)
def test_scope_matches_reference(rule_id, relpath, in_scope):
    assert REF_RULES[rule_id]().applies_to(relpath) is in_scope
    assert PORT_RULES[rule_id]().applies_to(port_path(relpath)) is in_scope


# the reference's "at head is clean" checks, on the port's files
HEAD_FILES = [
    ("NTA007", ("server", "worker.py")),
    ("NTA008", ("broker", "eval_broker.py")),
    ("NTA008", ("broker", "plan_queue.py")),
    ("NTA008", ("server", "heartbeat.py")),
    ("NTA010", ("server", "worker.py")),
    ("NTA012", ("api", "http.py")),
    ("NTA012", ("broker", "blocked.py")),
    ("NTA012", ("broker", "plan_apply.py")),
    ("NTA013", ("scheduler", "generic.py")),
    ("NTA013", ("scheduler", "system.py")),
    ("NTA015", ("device", "score.py")),
    ("NTA015", ("device", "flatten.py")),
    ("NTA015", ("scheduler", "algorithms.py")),
    ("NTA015", ("scheduler", "hetero.py")),
    ("NTA016", ("scheduler", "generic.py")),
    ("NTA016", ("scheduler", "system.py")),
    ("NTA016", ("server", "server.py")),
    ("NTA020", ("scheduler", "generic.py")),
    ("NTA020", ("scheduler", "system.py")),
    ("NTA020", ("server", "server.py")),
    ("NTA020", ("server", "worker.py")),
    ("NTA021", ("scheduler", "generic.py")),
    ("NTA021", ("scheduler", "system.py")),
    ("NTA021", ("server", "server.py")),
    ("NTA021", ("server", "drainer.py")),
    ("NTA021", ("server", "worker.py")),
]


@pytest.mark.parametrize(
    "rule_id,rel", HEAD_FILES, ids=[f"{r}-{'/'.join(p)}" for r, p in HEAD_FILES],
)
def test_port_file_at_head_is_clean(rule_id, rel):
    path = REPO_ROOT / "nomad_tpu_torch" / os.path.join(*rel)
    relpath = "nomad_tpu_torch/" + "/".join(rel)
    assert run(path.read_text(), relpath, rule_id) == []


@pytest.mark.parametrize("rule_id", ["NTA002", "NTA015", "NTA017", "NTA019"])
def test_whole_package_at_head_is_clean(rule_id):
    """The reference's whole-package checks (NTA017, NTA019), and the
    port's meaning of NTA002 and NTA015: zero findings to ratchet."""
    findings = lint.run_lint(REPO_ROOT, rules=[PORT_RULES[rule_id]()])
    assert findings == [], "\n".join(f.render() for f in findings)


# -- NTA002, NTA015, NTA017: the port's meaning -------------------------------

_GUARDED = (
    "from ..backend import count_launch, guarded\n"
    "@guarded('k_kernel', build_budget=1)\n"
    "def k(capacity, used):\n"
    "    if capacity.device.type == 'cpu':\n"
    "        return k_plain(capacity, used)\n"
    "    return _launch(capacity, used)\n"
    "def k_plain(capacity, used):\n"
    "    return int(used.sum().item())\n"
    "def _launch(capacity, used):\n"
    "{body}"
    "    count_launch(k)\n"
    "    return used\n"
)

NTA002_CASES = [
    ("item_on_launch_path_triggers",
     _GUARDED.format(body="    n = used.sum().item()\n"), "device/score.py", ["NTA002"], "_launch"),
    ("tolist_cpu_numpy_trigger",
     _GUARDED.format(body="    a = used.tolist()\n    b = used.cpu().numpy()\n"),
     "device/cp.py", ["NTA002", "NTA002", "NTA002"], "_launch"),
    ("cast_of_a_tensor_triggers",
     _GUARDED.format(body="    if bool((used < 0).any()):\n        raise ValueError\n"),
     "scheduler/hetero.py", ["NTA002"], "_launch"),
    ("synchronize_triggers",
     _GUARDED.format(body="    torch.cuda.synchronize()\n"), "device/migrate.py", ["NTA002"], "_launch"),
    ("cuda_branch_of_the_wrapper_triggers",
     "from ..backend import guarded\n"
     "@guarded('k_kernel', build_budget=1)\n"
     "def k(capacity):\n"
     "    if capacity.device.type != 'cpu':\n"
     "        capacity.cpu()\n"
     "    return capacity\n",
     "device/preempt.py", ["NTA002"], "k"),
    ("launch_counter_in_another_module_triggers",
     "def launch(x):\n    n = int(x.max())\n    count_launch(launch)\n    return n\n",
     "device/score_triton.py", ["NTA002"], "launch"),
    ("plain_version_and_cpu_branch_are_clean",
     _GUARDED.format(body="    pass\n"), "device/score.py", [], None),
    ("shape_reads_and_host_casts_are_clean",
     _GUARDED.format(
         body="    g, n = int(used.shape[0]), len(capacity)\n"
         "    flag = int(bool(g))\n    words = int(used.numel())\n"),
     "device/preempt.py", [], None),
    ("host_code_off_the_launch_path_is_clean",
     "def summarize(choices):\n    return choices.cpu().numpy().tolist()\n",
     "device/score.py", [], None),
    ("allow_comment_waives",
     _GUARDED.format(body="    if int(used.max()) > 3:  # nta: allow=NTA002\n        raise ValueError\n"),
     "scheduler/hetero.py", [], None),
    ("other_modules_out_of_scope",
     _GUARDED.format(body="    n = used.sum().item()\n"), "device/cache.py", [], None),
]

NTA015_CASES = [
    ("mesh_config_in_device_triggers",
     "from ..backend import MeshConfig\ndef mesh(devs):\n    return MeshConfig(devs, 1, 2, 'x')\n",
     "device/custom.py", ["NTA015"], "mesh"),
    ("sharded_tensor_in_scheduler_triggers",
     "from .. import backend\ndef pin(cfg, x):\n"
     "    return backend.ShardedTensor(cfg, ('nodes',), x.shape, x.dtype, {})\n",
     "scheduler/custom.py", ["NTA015"], "pin"),
    ("torch_distributed_triggers",
     "import torch.distributed as dist\ndef reduce(x):\n"
     "    torch.distributed.all_reduce(x)\n    return x\n",
     "device/custom.py", ["NTA015", "NTA015"], None),
    ("device_mesh_triggers",
     "from torch.distributed.device_mesh import DeviceMesh\ndef m():\n"
     "    return DeviceMesh('cuda', [0, 1])\n",
     "scheduler/custom.py", ["NTA015", "NTA015"], None),
    ("shard_put_routed_placement_is_clean",
     "from ..backend import get_mesh, make_mesh, shard_put\ndef upload(ct):\n"
     "    return shard_put(ct.capacity, ('nodes',), get_mesh())\n",
     "device/custom.py", [], None),
    ("cache_partial_upload_is_exempt",
     "from ..backend import ShardedTensor\ndef refresh(cfg, x):\n"
     "    return ShardedTensor(cfg, ('nodes',), x.shape, x.dtype, {})\n",
     "device/cache.py", [], None),
    ("backend_seam_is_out_of_scope",
     "def make(devs):\n    return MeshConfig(devs, 1, 2, 'x')\n",
     "backend.py", [], None),
]

NTA017_CASES = [
    ("ctypes_cdll_triggers",
     "import ctypes\ndef load(p):\n    return ctypes.CDLL(p)\n", "device/foo.py", ["NTA017"], "load"),
    ("cpp_extension_triggers",
     "import torch.utils.cpp_extension\ndef build():\n"
     "    return torch.utils.cpp_extension.load('k', ['k.cu'])\n",
     "scheduler/foo.py", ["NTA017"], "build"),
    ("triton_jit_triggers",
     "import triton\n@triton.jit\ndef body(x):\n    pass\n", "device/foo.py", ["NTA017"], None),
    ("from_triton_import_jit_triggers",
     "from triton import jit\n", "device/foo.py", ["NTA017"], None),
    ("nvcc_subprocess_triggers",
     "import subprocess\ndef build(src):\n"
     "    subprocess.run(['nvcc', '-shared', src])\n", "obs/foo.py", ["NTA017"], "build"),
    ("cuda_library_outside_kernel_modules_triggers",
     "from ..backend import cuda_library\ndef peek():\n"
     "    return cuda_library('cp')\n", "server/foo.py", ["NTA017"], "peek"),
    ("cuda_library_in_a_kernel_module_is_clean",
     "from ..backend import cuda_library\ndef _lib():\n"
     "    return cuda_library('cp')\n", "device/cp.py", [], None),
    ("triton_build_site_is_exempt",
     "def _build():\n    import triton\n    return triton.jit(body)\n",
     "device/score_triton.py", [], None),
    ("backend_seam_is_exempt",
     "import ctypes, subprocess\ndef f(p):\n"
     "    subprocess.run(['nvcc', p])\n    return ctypes.CDLL(p)\n",
     "backend.py", [], None),
    ("guarded_wrapper_is_clean",
     "from ..backend import guarded\n@guarded('k', build_budget=1)\ndef k(x):\n    return x\n",
     "device/foo.py", [], None),
]


@pytest.mark.parametrize(
    "rule_id,src,rel,expected,symbol",
    [("NTA002", *c[1:]) for c in NTA002_CASES]
    + [("NTA015", *c[1:]) for c in NTA015_CASES]
    + [("NTA017", *c[1:]) for c in NTA017_CASES],
    ids=[f"NTA002-{c[0]}" for c in NTA002_CASES]
    + [f"NTA015-{c[0]}" for c in NTA015_CASES]
    + [f"NTA017-{c[0]}" for c in NTA017_CASES],
)
def test_port_rule_fixture(rule_id, src, rel, expected, symbol):
    fs = run(src, f"nomad_tpu_torch/{rel}", rule_id)
    assert rule_ids(fs) == expected, [f.render() for f in fs]
    if symbol is not None:
        assert fs[0].symbol == symbol


def test_the_three_port_rules_keep_their_ids_and_report_order():
    ids = [cls.id for cls in REGISTRY]
    assert ids == [cls.id for cls in REF_REGISTRY]
    for rid in ("NTA002", "NTA015", "NTA017"):
        port, ref = PORT_RULES[rid], REF_RULES[rid]
        assert port.__name__ == ref.__name__
        assert ref.__module__.rsplit(".", 1)[-1] in (port.__doc__ or sys.modules[port.__module__].__doc__)


# -- suppression + fingerprints -------------------------------------------------


class TestSuppressionAndFingerprints:
    SRC = "import time\ndef f():\n    return time.time(){allow}\n"

    def test_bare_allow_waives_all_rules(self):
        src = self.SRC.format(allow="  # nta: allow")
        assert lint.check_source(src, "nomad_tpu_torch/scheduler/x.py") == []

    def test_named_allow_waives_only_named_rule(self):
        src = self.SRC.format(allow="  # nta: allow=NTA001")
        assert lint.check_source(src, "nomad_tpu_torch/scheduler/x.py") == []
        src = self.SRC.format(allow="  # nta: allow=NTA003")
        assert rule_ids(
            lint.check_source(src, "nomad_tpu_torch/scheduler/x.py")
        ) == ["NTA001"]

    def test_fingerprint_is_line_number_free(self):
        src = self.SRC.format(allow="")
        shifted = "\n\n\n" + src
        a = lint.check_source(src, "nomad_tpu_torch/scheduler/x.py")
        b = lint.check_source(shifted, "nomad_tpu_torch/scheduler/x.py")
        assert a[0].line != b[0].line
        assert a[0].fingerprint == b[0].fingerprint

    def test_syntax_error_reports_nta000(self):
        fs = lint.check_source("def f(:\n", "nomad_tpu_torch/scheduler/x.py")
        assert rule_ids(fs) == ["NTA000"]


# -- baseline ratchet ------------------------------------------------------------


class TestBaselineRatchet:
    def test_write_is_deterministic_sorted_and_deduped(self, tmp_path):
        f1 = lint.Finding("NTA001", "b.py", 9, "f", "m")
        f2 = lint.Finding("NTA001", "a.py", 3, "f", "m")
        dup = lint.Finding("NTA001", "b.py", 44, "f", "m")  # same print
        p = tmp_path / "baseline.json"
        lint.write_baseline([f1, f2, dup], p)
        first = p.read_text()
        lint.write_baseline([dup, f2, f1], p)
        assert p.read_text() == first
        data = json.loads(first)
        fps = [e["fingerprint"] for e in data["entries"]]
        assert fps == sorted(fps) and len(fps) == 2

    def test_diff_reports_new_and_fixed(self):
        old = lint.Finding("NTA003", "a.py", 1, "f", "old")
        new = lint.Finding("NTA003", "a.py", 2, "g", "new")
        baseline = {old.fingerprint}
        got_new, got_fixed = lint.diff_against_baseline([new], baseline)
        assert got_new == [new]
        assert got_fixed == {old.fingerprint}

    def test_whole_repo_has_no_findings_beyond_baseline(self):
        """The tier-1 gate: everything the engine flags at HEAD is already
        ratcheted in the checked-in baseline, and every baselined entry
        still fires."""
        findings = lint.run_lint(REPO_ROOT)
        baseline = lint.load_baseline(lint.default_baseline_path())
        new, fixed = lint.diff_against_baseline(findings, baseline)
        assert new == [], "new lint findings:\n" + "\n".join(
            f.render() for f in new
        )
        assert fixed == set()

    def test_baseline_is_the_reference_s_with_the_prefix_mapped(self):
        ref = json.loads(ref_lint.default_baseline_path().read_text())["entries"]
        port = json.loads(lint.default_baseline_path().read_text())["entries"]
        assert len(ref) == len(port) == 28
        mapped = [
            {k: v.replace("nomad_tpu/", "nomad_tpu_torch/") for k, v in e.items()}
            for e in ref
        ]
        assert port == mapped

    def test_registry_covers_all_rules(self):
        assert sorted(r.id for r in (cls() for cls in REGISTRY)) == [
            "NTA001", "NTA002", "NTA003", "NTA004", "NTA005", "NTA006",
            "NTA007", "NTA008", "NTA009", "NTA010", "NTA011", "NTA012",
            "NTA013", "NTA014", "NTA015", "NTA016", "NTA017", "NTA018",
            "NTA019", "NTA020", "NTA021",
        ]

    def test_default_scan_is_the_port_tree(self):
        assert lint.repo_root() == REPO_ROOT
        files = lint.iter_python_files(REPO_ROOT)
        assert files and all("nomad_tpu_torch" in p.parts for p in files)


# -- CLI ---------------------------------------------------------------------------


def run_cli(*argv, cwd=None):
    return subprocess.run(
        [sys.executable, "-m", "nomad_tpu_torch.analysis", *argv],
        capture_output=True, text=True, cwd=cwd or str(REPO_ROOT),
        env={**os.environ, "JAX_PLATFORMS": "cpu"}, timeout=120,
    )


class TestCLI:
    # --source-only keeps these subprocess tests off the kernel fleet;
    # the combined default is covered in test_torch_kernellint.py
    def test_exit_zero_at_head(self):
        r = run_cli("--source-only")
        assert r.returncode == 0, r.stdout + r.stderr
        assert "0 new finding(s)" in r.stdout

    def test_seeded_violation_exits_nonzero(self, tmp_path):
        bad = tmp_path / "nomad_tpu_torch" / "scheduler"
        bad.mkdir(parents=True)
        (bad / "bad.py").write_text(
            "import time\ndef score():\n    return time.time()\n"
        )
        empty = tmp_path / "baseline.json"
        empty.write_text('{"version": 1, "entries": []}\n')
        r = run_cli(
            "--source-only", "--root", str(tmp_path),
            "--baseline", str(empty),
        )
        assert r.returncode == 1, r.stdout + r.stderr
        assert "NTA001" in r.stdout

    def test_fix_baseline_then_clean(self, tmp_path):
        bad = tmp_path / "nomad_tpu_torch" / "server"
        bad.mkdir(parents=True)
        (bad / "bad.py").write_text(
            "def f():\n    try:\n        g()\n"
            "    except Exception:\n        pass\n"
        )
        baseline = tmp_path / "baseline.json"
        r = run_cli(
            "--source-only", "--root", str(tmp_path),
            "--baseline", str(baseline), "--fix-baseline",
        )
        assert r.returncode == 0, r.stdout + r.stderr
        r = run_cli(
            "--source-only", "--root", str(tmp_path),
            "--baseline", str(baseline),
        )
        assert r.returncode == 0
        assert "1 ratcheted" in r.stdout

    def test_unknown_rule_exits_two(self):
        assert run_cli("--rules", "NTA999").returncode == 2

    def test_json_output_parses(self):
        r = run_cli("--source-only", "--json")
        data = json.loads(r.stdout)
        assert data["source"]["new"] == []
        assert data["source"]["ratcheted"] >= 28
        assert data["source"]["fixed"] == []
        assert data["kernels"] is None

    def test_source_only_imports_no_kernel_module(self):
        code = (
            "import sys\n"
            "from nomad_tpu_torch.analysis.__main__ import main\n"
            "assert main(['--source-only']) == 0\n"
            "mods = [m for m in sys.modules if m.startswith(('nomad_tpu_torch.device', "
            "'nomad_tpu_torch.scheduler')) or m == 'torch']\n"
            "assert not mods, mods\n"
        )
        r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                           cwd=str(REPO_ROOT), timeout=120)
        assert r.returncode == 0, r.stdout + r.stderr


# -- runtime race detector ---------------------------------------------------------


class TestRaceDetector:
    def test_misordered_two_locks_report_cycle(self):
        with pytest.raises(race.RaceError, match="lock-order cycle"):
            with race.racecheck():
                a = threading.Lock()
                b = threading.Lock()

                def ab():
                    with a:
                        with b:
                            pass

                def ba():
                    with b:
                        with a:
                            pass

                t1 = threading.Thread(target=ab)
                t2 = threading.Thread(target=ba)
                t1.start(); t1.join()
                t2.start(); t2.join()

    def test_consistent_order_is_clean(self):
        with race.racecheck() as graph:
            a = threading.Lock()
            b = threading.Lock()
            for _ in range(3):
                with a:
                    with b:
                        pass
        assert graph.cycles() == []

    def test_unguarded_field_access_recorded(self):
        class Store:
            watermark = race.guarded_by("_lock")

            def __init__(self):
                self._lock = threading.Lock()
                with self._lock:
                    self.watermark = 0

        with pytest.raises(race.RaceError, match="unguarded read"):
            with race.racecheck():
                s = Store()
                _ = s.watermark  # read without the lock

    def test_guarded_access_under_lock_is_clean(self):
        class Store:
            watermark = race.guarded_by("_lock")

            def __init__(self):
                self._lock = threading.Lock()
                with self._lock:
                    self.watermark = 0

        with race.racecheck():
            s = Store()
            with s._lock:
                s.watermark = 7
                assert s.watermark == 7

    def test_condition_wait_notify_with_instrumented_rlock(self):
        with race.racecheck():
            cond = threading.Condition()
            ready = []

            def waiter():
                with cond:
                    while not ready:
                        cond.wait(timeout=5)

            t = threading.Thread(target=waiter)
            t.start()
            time.sleep(0.02)
            with cond:
                ready.append(1)
                cond.notify_all()
            t.join(timeout=5)
            assert not t.is_alive()

    def test_install_uninstall_restores_factories(self):
        real = threading.Lock
        g = race.install()
        try:
            assert threading.Lock is not real
            assert race.active_graph() is g
        finally:
            race.uninstall()
        assert threading.Lock is real
        assert race.active_graph() is None

    def test_broker_plan_queue_path_runs_clean(self):
        """The port's leader path — StateStore + PlanQueue +
        PlanApplyLoop — with all its locks instrumented: no ordering
        cycles, no guarded violations."""
        from nomad_tpu_torch.broker.plan_queue import PlanApplyLoop, PlanQueue
        from nomad_tpu_torch.state.store import StateStore
        from nomad_tpu_torch.structs import Plan

        with race.racecheck() as graph:
            store = StateStore()
            queue = PlanQueue()
            queue.set_enabled(True)
            loop = PlanApplyLoop(store, queue)
            loop.start()
            try:
                futures = []

                def submit():
                    for p in range(8):
                        futures.append(queue.enqueue(Plan(priority=p)))

                threads = [threading.Thread(target=submit) for _ in range(3)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=30)
                for f in futures:
                    f.result(timeout=30)
            finally:
                loop.stop()
        assert graph.cycles() == []
        assert graph.field_violations() == []

    def test_eval_broker_path_runs_clean(self):
        from nomad_tpu_torch.broker.eval_broker import EvalBroker
        from nomad_tpu_torch.structs import Evaluation

        with race.racecheck():
            b = EvalBroker(n_partitions=2)
            b.set_enabled(True)
            evs = [
                Evaluation(
                    namespace="default", job_id=f"j{i}", type="service",
                    priority=50, status="pending",
                )
                for i in range(16)
            ]
            b.enqueue_all(evs)

            def consume(part):
                while True:
                    got = b.dequeue_many(
                        ["service"], 4, timeout=0.2, partition=part
                    )
                    if not got:
                        return
                    for ev, tok in got:
                        b.ack(ev.id, tok)

            threads = [
                threading.Thread(target=consume, args=(p,)) for p in (0, 1)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            assert b.ready_count() == 0

    def test_env_gate_is_the_reference_s(self):
        from nomad_tpu.analysis import race as ref_race

        assert race.ENV_VAR == ref_race.ENV_VAR == "NOMAD_TPU_RACECHECK"


# -- build budgets (the reference's TestRetraceBudgets) ------------------------------


@pytest.fixture
def isolated_registry(monkeypatch):
    """The fake kernels a test registers, and their profile rows, leave
    with it: later tests in this process see the fleet alone."""
    for attr in ("_kernel_registry", "_kernel_stats", "_kernel_traces", "_last_trace_shape"):
        monkeypatch.setattr(backend, attr, dict(getattr(backend, attr)))


def _building_kernel(name, budget):
    """A guarded fake kernel whose every call with a new width starts a
    build, as a wrapper whose cache keys on the shape would."""
    seen = set()

    @backend.guarded(name, build_budget=budget)
    def k(x):
        if x.shape[0] not in seen:
            seen.add(x.shape[0])
            backend.note_compile()
        return x + 1

    return k


@pytest.mark.usefixtures("isolated_registry")
class TestBuildBudgets:
    def test_guard_counts_builds_not_calls(self):
        k = _building_kernel("test.b1", 4)
        k(torch.ones(3))
        k(torch.ones(3))  # the same width: no build
        assert retrace.counts()["test.b1"] == 1
        k(torch.ones(5))
        assert retrace.counts()["test.b1"] == 2

    def test_budget_window_raises_past_budget(self):
        k = _building_kernel("test.b2", 2)
        with pytest.raises(retrace.RetraceBudgetExceeded, match="test.b2"):
            with retrace.budget_window():
                for n in range(3, 6):  # 3 builds > budget 2
                    k(torch.ones(n))

    def test_budget_window_scopes_to_deltas(self):
        k = _building_kernel("test.b3", 1)
        k(torch.ones(3))  # a pre-window build must not count
        k(torch.ones(4))
        with retrace.budget_window():
            k(torch.ones(3))  # built already: zero builds in the window

    def test_every_guarded_kernel_declares_a_budget(self):
        from nomad_tpu_torch.analysis.kernellint import FLEET, import_fleet

        reg = import_fleet()
        budgets = retrace.budgets()
        assert set(FLEET) <= set(reg)
        guarded_names = {n for n in FLEET if reg[n].guard == n}
        assert len(guarded_names) == 11
        for name in FLEET:
            assert budgets.get(name, 0) > 0, name
        assert budgets["score_matrix_kernel"] == 12
        assert all(budgets[n] == 1 for n in FLEET if n != "score_matrix_kernel")

    def test_over_budget_reports_offenders(self):
        _building_kernel("test.b4", 4)
        assert retrace.over_budget({"test.b4": 999}) == [("test.b4", 999, 4)]

    def test_report_lists_builds_beside_budgets(self):
        k = _building_kernel("test.b5", 3)
        k(torch.ones(2))
        rep = retrace.report()
        assert rep["test.b5"] == {"traces": 1, "budget": 3}


# -- swallowed-error accounting ------------------------------------------------------


class TestSwallowAccounting:
    def _counter(self, name):
        return global_metrics.snapshot()["counters"].get(name, 0)

    def test_count_swallowed_bumps_component_counter(self):
        before = self._counter("worker.swallowed_errors")
        count_swallowed("worker", ValueError("x"))
        assert self._counter("worker.swallowed_errors") == before + 1

    def test_worker_run_one_failure_is_counted_not_silent(self):
        from nomad_tpu_torch.server.worker import Worker
        from nomad_tpu_torch.structs import Evaluation

        class _Broker:
            def ack(self, *a):
                raise AssertionError("ack must not be reached")

            def nack(self, *a):
                raise ValueError("token expired")

        class _Server:
            eval_broker = _Broker()

        w = Worker.__new__(Worker)
        w.id = 0
        w.server = _Server()
        w.stats = {"processed": 0, "acked": 0, "nacked": 0}
        w._stats_lock = threading.Lock()
        w.process_eval = lambda ev, planner: (_ for _ in ()).throw(
            RuntimeError("scheduler blew up")
        )
        ev = Evaluation(
            namespace="default", job_id="j1", type="service",
            priority=50, status="pending",
        )
        before = self._counter("worker.swallowed_errors")
        w._run_one(ev, "tok")  # must not raise
        # one bump for the failed eval, one for the failed nack cleanup
        assert self._counter("worker.swallowed_errors") == before + 2
        assert w.stats["nacked"] == 1


# -- injectable scheduler clock ----------------------------------------------------


class TestSchedulerClock:
    def test_generic_scheduler_uses_injected_clock(self):
        from nomad_tpu_torch.scheduler.generic import GenericScheduler

        s = GenericScheduler(None, None, clock=lambda: 1234.5, device="cpu")
        assert s.clock() == 1234.5

    def test_default_clock_is_wall_time(self):
        from nomad_tpu_torch.scheduler.generic import GenericScheduler

        s = GenericScheduler(None, None, device="cpu")
        assert s.clock is time.time
