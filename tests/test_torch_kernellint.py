"""The kernel lint (``nomad_tpu_torch.analysis.kernellint``) on the CPU,
against the JAX package's ``jaxlint`` where the two meet.

- **The registry and the fleet.** Every kernel wrapper is in the guard's
  table under the reference's kernel name (the 11 ``@guarded`` and the
  mesh's merge); the fleet exercise on ``device="cpu"`` calls all 12
  and records each call. Its outputs equal the reference's
  ``jaxlint/exercise.py`` fleet run under the scoped ``reference_runtime``
  shim (ROADMAP C-R1): placements node for node, every other kernel's
  integer outputs exactly and its floats within ``rtol=1e-5, atol=1e-6``
  (``exp`` differs by an ulp between the runtimes, as in
  test_torch_score.py). The 1x2-mesh pass equals the unsharded one bit
  for bit.
- **The rules**, each with a trigger and a non-trigger: JXL003 (a
  scratch guarded wrapper returning float64 against one returning
  float32), JXL004 (a wrapper whose output changes between runs; a
  scratch ``.cu`` with a float ``atomicAdd`` or a CAS loop over float
  bits), JXL005 (a kernel with no budget, one never called, a second
  pass that builds).
- **Fingerprints**: equal in two subprocesses; an edit to a scratch copy
  of a ``.cu`` changes the fingerprints of the kernels built from it
  and no other's, an edit to a ``.cuh`` (hashed into every library)
  those of every CUDA kernel and not the Triton kernel's; the table
  covers all 12.
- **The invariance differ**: explain, incremental and mesh on/off, each
  restoring the ambient state.
- **The ratchet and the CLI**: the fleet is clean at HEAD, a seeded
  finding fails the ratchet, a finding's fingerprint survives moving
  the kernel down its file, ``python -m nomad_tpu_torch.analysis
  --device cpu`` runs both halves and exits 0, and without CUDA the
  kernel half raises unless the CPU is asked for.

The reference's TestRetracer (5 cases) and its JXL001/JXL002 cases (4)
have no counterpart: the port's kernels have no jaxpr to re-trace, no
callback primitive and no baked host constants (their constants are in
the hashed source).
"""

import contextlib
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from nomad_tpu.analysis.jaxlint import exercise as ref_exercise
from nomad_tpu.device import cp as ref_cp
from nomad_tpu.device import migrate as ref_migrate
from nomad_tpu.device import preempt as ref_preempt
from nomad_tpu.device import score as ref_score
from nomad_tpu.scheduler import hetero as ref_hetero
from nomad_tpu.utils import backend as ref_backend
from nomad_tpu_torch import backend
from nomad_tpu_torch.analysis import lint
from nomad_tpu_torch.analysis.kernellint import (
    FLEET,
    diff,
    engine,
    exercise,
    fingerprint,
    import_fleet,
    production_kernels,
    rules,
)

REPO_ROOT = lint.repo_root()
RTOL, ATOL = 1e-5, 1e-6


# the coupled scans' kernels under a node-axis mesh
MESH_COUPLED = ("coupled_shard_step", "coupled_step_merge", "coupled_shard_apply")
MESH_HETERO = ("hetero_shard_step", "hetero_step_merge", "hetero_shard_apply")
MESH_CP = ("cp_shard_claim", "cp_round_merge", "cp_shard_settle")


@pytest.fixture(scope="module")
def fleet_calls():
    """The fleet exercised once on the CPU: its recorded calls."""
    return exercise.exercise_fleet("cpu")


@pytest.fixture
def isolated_registry(monkeypatch):
    """The fake kernels a test registers leave with it."""
    for attr in ("_kernel_registry", "_kernel_stats", "_kernel_traces", "_last_trace_shape"):
        monkeypatch.setattr(backend, attr, dict(getattr(backend, attr)))


def fake_kernel(name, fn, budget=1):
    """A guarded test wrapper (a non-production module, so fleet-wide
    checks ignore it) and its registry entry."""
    wrapped = backend.guarded(name, build_budget=budget)(fn)
    return wrapped, backend.kernel_registry()[name]


def calls_of(wrapped, *args):
    with backend.recording_calls() as calls:
        wrapped(*args)
    return list(calls)


# -- the registry and the fleet ---------------------------------------------------


class TestKernelRegistry:
    def test_the_fleet_is_the_guard_s_table(self):
        reg = import_fleet()
        prod = production_kernels(reg)
        assert set(prod) == set(FLEET) and len(FLEET) == 21
        assert {n for n, e in prod.items() if e.guard == n} == set(FLEET) - {
            "closed_form_topk_merge", *MESH_COUPLED, *MESH_HETERO, *MESH_CP
        }
        assert prod["closed_form_topk_merge"].guard == "place_closed_form_kernel"
        assert all(prod[n].guard == "place_value_scan_kernel" for n in MESH_COUPLED)
        assert all(prod[n].guard == "hetero_place_kernel" for n in MESH_HETERO)
        assert all(prod[n].guard == "cp_place_kernel" for n in MESH_CP)
        assert prod["score_matrix_kernel"].route == "triton"
        assert all(e.route == "cuda" for n, e in prod.items() if n != "score_matrix_kernel")

    @pytest.mark.usefixtures("isolated_registry")
    def test_guarded_registers_and_records_calls(self):
        k, entry = fake_kernel("test_kernellint.reg.add_one", lambda x: x + 1, budget=2)
        calls = calls_of(k, torch.zeros(4))
        assert entry.build_budget == 2 and entry.called
        assert [c.name for c in calls] == ["test_kernellint.reg.add_one"]
        assert calls[0].args[0].shape == (4,) and calls[0].out.dtype == torch.float32

    @pytest.mark.usefixtures("isolated_registry")
    def test_recording_ends_with_its_block(self):
        k, _ = fake_kernel("test_kernellint.reg.echo", lambda x: x)
        with backend.recording_calls() as calls:
            k(torch.zeros(2))
        k(torch.zeros(2))
        assert len(calls) == 1

    @pytest.mark.usefixtures("isolated_registry")
    def test_production_filter_excludes_test_kernels(self, fleet_calls):
        fake_kernel("test_kernellint.reg.other", lambda x: x)
        prod = production_kernels()
        assert all(e.module.startswith("nomad_tpu_torch.") for e in prod.values())
        assert "place_closed_form_kernel" in prod
        assert not any(n.startswith("test_kernellint.") for n in prod)


def test_fleet_calls_every_kernel(fleet_calls):
    assert {c.name for c in fleet_calls} == set(FLEET)
    firsts = [c.args[0] if c.args else c.kwargs["capacity"] for c in fleet_calls]
    firsts = [x[0] if isinstance(x, list) else x for x in firsts]  # the merge's lists
    assert {x.device.type for x in firsts} == {"cpu"}


# -- the fleet against the reference's ---------------------------------------------

_REF_KERNELS = (
    (ref_score, "score_matrix_kernel"),
    (ref_preempt, "find_preemption_kernel"),
    (ref_preempt, "choose_preemption_node_kernel"),
    (ref_hetero, "hetero_place_kernel"),
    (ref_cp, "cp_place_kernel"),
    (ref_cp, "cp_gang_place_kernel"),
    (ref_migrate, "migrate_plan_kernel"),
)


@contextlib.contextmanager
def reference_runtime(monkeypatch):
    """The reference's traced_jit path on this jax, for one block only."""
    with monkeypatch.context() as mp:
        mp.setattr(
            jax.core, "trace_state_clean", jax._src.core.trace_state_clean,
            raising=False,
        )
        mp.setattr(ref_backend, "_mesh_config", ref_backend.MeshConfig(None, 1, 1, "test"))
        yield mp


def _reference_kernel_calls(mp):
    """Record the reference kernels' outermost calls (a kernel that
    calls another inside its trace records once)."""
    calls, depth = [], [0]
    for mod, name in _REF_KERNELS:
        orig = getattr(mod, name)

        def rec(*a, _orig=orig, _name=name, **kw):
            depth[0] += 1
            try:
                out = _orig(*a, **kw)
            finally:
                depth[0] -= 1
            if depth[0] == 0:
                calls.append((_name, out))
            return out

        mp.setattr(mod, name, rec)
    return calls


def _arrays(out):
    return [np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
            for x in (out if isinstance(out, tuple) else (out,))]


def _assert_close(got, want, what):
    assert got.shape == want.shape and got.dtype == want.dtype, what
    if got.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)
    else:
        assert (got == want).all(), what


def _assert_placements(port, ref, what):
    assert len(port) == len(ref), what
    for i, (p, r) in enumerate(zip(port, ref)):
        np.testing.assert_array_equal(p.node_rows, r.node_rows, err_msg=f"{what} {i}")
        np.testing.assert_allclose(p.scores, r.scores, rtol=RTOL, atol=ATOL, err_msg=f"{what} {i}")
        np.testing.assert_array_equal(p.overflow_rows, r.overflow_rows, err_msg=f"{what} {i}")


def test_fleet_equals_the_reference_s(monkeypatch):
    pieces = ("run_score_matrix", "run_preemption", "run_hetero", "run_cp",
              "run_cp_gang", "run_migrate")
    with reference_runtime(monkeypatch) as mp:
        ref_ct = ref_exercise._cluster()
        ref_asks = [
            ref_exercise._ask(ref_ct, "fast-a", 3),
            ref_exercise._ask(ref_ct, "fast-b", 2),
            ref_exercise._ask(ref_ct, "scan", 3,
                              blocks=ref_exercise._blocks(ref_ct, ref_score.BLOCK_TARGET_SPREAD)),
            ref_exercise._ask(ref_ct, "chunked", 40,
                              blocks=ref_exercise._blocks(ref_ct, ref_score.BLOCK_TARGET_SPREAD)),
            ref_exercise._ask(ref_ct, "opv", 40,
                              blocks=ref_exercise._blocks(ref_ct, ref_score.BLOCK_EVEN_SPREAD)),
        ]
        ref_places = ref_score.PlacementKernel("binpack").place(ref_ct, ref_asks)
        ref_calls = _reference_kernel_calls(mp)
        for piece in pieces:
            getattr(ref_exercise, piece)()
    _assert_placements(exercise.run_placement_paths("cpu"), ref_places, "placement")
    with backend.recording_calls() as port_calls:
        for piece in pieces:
            getattr(exercise, piece)("cpu")
    assert [c.name for c in port_calls] == [n for n, _ in ref_calls]
    for call, (name, out) in zip(port_calls, ref_calls):
        got, want = _arrays(call.out), _arrays(out)
        assert len(got) == len(want), name
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close(g, w, f"{name} output {i}")


def test_sharded_pass_equals_the_unsharded_one():
    """The 1x2-mesh closed form (a launch a cell and the merge) places
    node for node, bit for bit, as one device does."""
    one = exercise.run_placement_paths("cpu")[:2]
    with backend.recording_calls() as calls:
        two = exercise.run_sharded_closed_form("cpu")
    assert [c.name for c in calls] == ["closed_form_topk_merge", "place_closed_form_kernel"]
    for a, b in zip(one, two):
        assert a.node_rows.tobytes() == b.node_rows.tobytes()
        assert a.scores.tobytes() == b.scores.tobytes()


# -- the rules ------------------------------------------------------------------------


@pytest.mark.usefixtures("isolated_registry")
class TestJXL003DtypeDiscipline:
    def test_float64_output_triggers(self):
        k, e = fake_kernel("test_kernellint.jxl003.wide", lambda x: x.to(torch.float64))
        fs = rules.check_dtype_discipline(e, calls_of(k, torch.zeros(4)))
        assert [f.rule for f in fs] == ["JXL003"]
        assert "float64" in fs[0].message and "output" in fs[0].message

    def test_half_and_int64_inputs_trigger(self):
        k, e = fake_kernel("test_kernellint.jxl003.inputs", lambda x, i: x.float())
        fs = rules.check_dtype_discipline(
            e, calls_of(k, torch.zeros(4, dtype=torch.float16), torch.zeros(4, dtype=torch.int64)),
        )
        assert sorted(f.message.split()[0] for f in fs) == ["float16", "int64"]

    def test_pinned_f32_i32_and_masks_are_clean(self):
        k, e = fake_kernel(
            "test_kernellint.jxl003.pinned",
            lambda x, m: ((x * 1.5).to(torch.float32), m.to(torch.int32), m),
        )
        fs = rules.check_dtype_discipline(e, calls_of(k, torch.zeros(4), torch.ones(4, dtype=torch.bool)))
        assert fs == []


@pytest.mark.usefixtures("isolated_registry")
class TestJXL004Determinism:
    def test_output_that_changes_between_runs_triggers(self):
        state = [0.0]

        def drifting(x):
            state[0] += 1e-3
            return x + state[0]

        k, e = fake_kernel("test_kernellint.jxl004.drift", drifting)
        a, b = calls_of(k, torch.zeros(4)), calls_of(k, torch.zeros(4))
        fs = rules.check_determinism(e, a, b)
        assert [f.rule for f in fs] == ["JXL004"]
        assert "uint32" in fs[0].message

    def test_repeatable_output_is_clean(self):
        k, e = fake_kernel("test_kernellint.jxl004.same", lambda x: (x * 3.0, x > 0))
        x = torch.linspace(-1, 1, 8)
        assert rules.check_determinism(e, calls_of(k, x), calls_of(k, x)) == []

    def test_float_atomic_add_in_a_scratch_cu_triggers(self, tmp_path):
        csrc = tmp_path / "csrc"
        shutil.copytree(backend.CSRC_DIR, csrc)
        entry = import_fleet()["hetero_place_kernel"]
        assert rules.check_source_determinism(entry, csrc) == []
        src = csrc / "hetero.cu"
        src.write_text(src.read_text() + (
            "\n__global__ void scratch_sum(float* total, const float* x) {\n"
            "  atomicAdd(&total[0], x[threadIdx.x]);\n}\n"
        ))
        fs = rules.check_source_determinism(entry, csrc)
        assert [f.rule for f in fs] == ["JXL004"]
        assert "float atomicAdd on 'total'" in fs[0].message

    def test_cas_loop_over_float_bits_triggers_integer_atomics_do_not(self):
        cas = (
            "__device__ void add(int* p, float v) {\n"
            "  int old = *p, seen;\n"
            "  do { seen = old;\n"
            "       old = atomicCAS(p, seen, __float_as_int(__int_as_float(seen) + v));\n"
            "  } while (seen != old);\n}\n"
        )
        assert [m for _, m in rules.scan_float_atomics(cas)] == ["atomicCAS loop over float bits"]
        ints = "__global__ void k(int* hist, unsigned* bar) { atomicAdd(&hist[3], 1); atomicMax(bar + 1, 2u); }\n"
        assert rules.scan_float_atomics(ints) == []

    def test_triton_atomics_trigger(self):
        body = "def body(p):\n    tl.atomic_add(p, 1.0)\n"
        assert [line for line, _ in rules.scan_triton_atomics(body)] == [2]

    def test_fleet_sources_have_no_float_atomics(self):
        for name, entry in production_kernels(import_fleet()).items():
            assert rules.check_source_determinism(entry) == [], name


@pytest.mark.usefixtures("isolated_registry")
class TestJXL005BuildHazards:
    def test_missing_budget_triggers(self):
        k, e = fake_kernel("test_kernellint.jxl005.nobudget", lambda x: x, budget=None)
        msgs = [f.message for f in rules.check_build_hazards(e, calls_of(k, torch.zeros(2)), 0)]
        assert len(msgs) == 1 and "build_budget" in msgs[0]

    def test_never_called_and_second_pass_build_trigger(self):
        _, e = fake_kernel("test_kernellint.jxl005.cold", lambda x: x, budget=1)
        msgs = [f.message for f in rules.check_build_hazards(e, [], 2)]
        assert any("never called" in m for m in msgs)
        assert any("second pass started 2" in m for m in msgs)

    def test_declared_budget_is_clean(self):
        k, e = fake_kernel("test_kernellint.jxl005.ok", lambda x: x, budget=1)
        assert rules.check_build_hazards(e, calls_of(k, torch.zeros(2)), 0) == []


# -- fingerprints ------------------------------------------------------------------------


class TestFingerprints:
    def test_table_covers_the_fleet(self):
        table = fingerprint.fingerprint_table()
        assert set(table) == set(FLEET)
        for name, configs in table.items():
            assert configs, name
            for fp in configs.values():
                assert len(fp) == 16 and int(fp, 16) >= 0, (name, configs)
        assert set(table["choose_preemption_node_kernel"]) == {
            "preempt.cu:nomad_find_choose_preemption",
            "preempt.cu:nomad_choose_preemption_node",
        }
        assert set(table["score_matrix_kernel"]) == {"source"}

    def test_same_source_same_fingerprint_in_a_copy(self, tmp_path):
        csrc = tmp_path / "csrc"
        shutil.copytree(backend.CSRC_DIR, csrc)
        assert fingerprint.fingerprint_table(csrc=csrc) == fingerprint.fingerprint_table()

    def test_a_cu_edit_changes_its_kernels_and_no_other(self, tmp_path):
        csrc = tmp_path / "csrc"
        shutil.copytree(backend.CSRC_DIR, csrc)
        before = fingerprint.fingerprint_table(csrc=csrc)
        (csrc / "cp.cu").write_text((csrc / "cp.cu").read_text() + "\n// edited\n")
        after = fingerprint.fingerprint_table(csrc=csrc)
        changed = {n for n in before if before[n] != after[n]}
        assert changed == {"cp_place_kernel", "cp_gang_place_kernel", *MESH_CP}

    def test_a_cuh_edit_changes_every_cuda_kernel_and_not_the_triton_one(self, tmp_path):
        csrc = tmp_path / "csrc"
        shutil.copytree(backend.CSRC_DIR, csrc)
        before = fingerprint.fingerprint_table(csrc=csrc)
        header = csrc / "candidate.cuh"
        header.write_text(header.read_text() + "\n// edited\n")
        after = fingerprint.fingerprint_table(csrc=csrc)
        changed = {n for n in before if before[n] != after[n]}
        assert changed == set(FLEET) - {"score_matrix_kernel"}

    def test_triton_key_and_body_change_its_fingerprint(self):
        key = (False, True, True, False)
        base = fingerprint.triton_fingerprint()
        assert fingerprint.triton_fingerprint(key) != base
        assert fingerprint.triton_fingerprint(key) != fingerprint.triton_fingerprint((True, True, True, False))
        assert fingerprint.triton_fingerprint(source=fingerprint.triton_source() + "#") != base

    def test_call_configs_read_the_specialization(self, fleet_calls):
        reg = import_fleet()
        sm = [c for c in fleet_calls if c.name == "score_matrix_kernel"]
        labels = [fingerprint.call_configs(reg["score_matrix_kernel"], c) for c in sm]
        assert labels == [
            ["algorithm_spread=False, throughputs=None, n%16==0=True, n==1=False"],
            ["algorithm_spread=False, throughputs=given, n%16==0=True, n==1=False"],
        ]

    def test_fingerprints_stable_across_processes(self):
        code = (
            "import json\n"
            "from nomad_tpu_torch.analysis.kernellint.fingerprint import fingerprint_table\n"
            "print(json.dumps(fingerprint_table(), sort_keys=True))\n"
        )
        tables = []
        for _ in range(2):
            r = subprocess.run(
                [sys.executable, "-c", code], capture_output=True, text=True,
                cwd=str(REPO_ROOT), timeout=300,
            )
            assert r.returncode == 0, r.stderr
            tables.append(json.loads(r.stdout.strip().splitlines()[-1]))
        assert tables[0] and tables[0] == tables[1]
        assert set(tables[0]) == set(FLEET)


# -- the invariance differ -----------------------------------------------------------------


class TestInvarianceDiffer:
    @pytest.fixture(scope="class")
    def proofs(self):
        return diff.prove_all("cpu")

    def test_explain_on_off_launches_the_same_kernels(self, proofs):
        rep = proofs["explain"]
        assert rep["ok"], rep
        assert "place_closed_form_kernel" in rep["kernels"]
        assert rep["added"] == rep["removed"] == [] and rep["added_builds"] == 0

    def test_incremental_on_off_launches_the_same_kernels(self, proofs):
        rep = proofs["incremental"]
        assert rep["ok"], rep
        assert "place_closed_form_kernel" in rep["kernels"]
        assert rep["added"] == rep["removed"] == [] and rep["added_builds"] == 0

    def test_incremental_differ_restores_ambient_state(self, proofs):
        assert os.environ.get("NOMAD_TPU_INCREMENTAL") in (None, "off")
        assert backend.incremental_enabled() is False

    def test_mesh_on_off_adds_exactly_the_merge(self, proofs):
        rep = proofs["mesh"]
        assert rep["ok"], rep
        assert {k for k, _, _ in rep["added"]} == {
            "closed_form_topk_merge", *MESH_COUPLED, *MESH_HETERO, *MESH_CP
        }
        assert rep["removed"] == [] and rep["mesh_shape"] == [1, 2]

    def test_mesh_differ_restores_ambient_state(self, proofs):
        assert os.environ.get("NOMAD_TPU_MESH") in (None, "off")
        assert not backend.get_mesh().active

    def test_a_kernel_the_mesh_drops_fails_the_proof(self):
        rep = diff._report("c", {("a", "x", "1"), ("b", "y", "2")}, {("a", "x", "1")}, 0)
        assert not rep["ok"] and rep["removed"] == [["b", "y", "2"]]
        rep = diff._report("c", set(), {("a", "x", "1")}, 1, expect_added={"a"})
        assert not rep["ok"]


# -- engine + ratchet ------------------------------------------------------------------------


class TestEngineAndRatchet:
    def test_fleet_is_clean_at_head(self):
        """Every kernel analyzed, zero findings beyond the checked-in
        (empty) baseline."""
        findings, reports = engine.analyze_kernels("cpu")
        baseline = lint.load_baseline(engine.default_baseline_path())
        new, _ = lint.diff_against_baseline(findings, baseline)
        assert set(reports) == set(FLEET)
        assert all(r["calls"] >= 1 for r in reports.values())
        assert new == [], "new kernel lint findings:\n" + "\n".join(f.render() for f in new)
        assert json.loads(engine.default_baseline_path().read_text())["entries"] == []

    def test_run_kernellint_exit_zero_at_head(self):
        code, new, fixed, reports = engine.run_kernellint(device="cpu")
        assert code == 0 and new == [] and fixed == set()

    @pytest.mark.usefixtures("isolated_registry")
    def test_seeded_finding_fails_ratchet(self, tmp_path):
        k, e = fake_kernel("test_kernellint.ratchet.dirty", lambda x: x.double(), budget=None)
        calls = calls_of(k, torch.zeros(2))
        fs = rules.check_kernel(e, calls, calls, 0)
        assert {f.rule for f in fs} == {"JXL003", "JXL005"}
        # a fresh empty baseline reports it as new; absorbing it makes a
        # second diff clean — the same ratchet discipline as the source lint
        bp = tmp_path / "baseline.json"
        new, _ = lint.diff_against_baseline(fs, lint.load_baseline(bp))
        assert new
        lint.write_baseline(fs, bp)
        new, _ = lint.diff_against_baseline(fs, lint.load_baseline(bp))
        assert new == []

    def test_finding_fingerprints_survive_kernel_motion(self):
        a = lint.Finding("JXL004", "nomad_tpu_torch/device/cp.py", 100, "cp_place_kernel", "msg")
        b = lint.Finding("JXL004", "nomad_tpu_torch/device/cp.py", 999, "cp_place_kernel", "msg")
        assert a.fingerprint == b.fingerprint

    def test_without_cuda_the_kernel_half_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device resolves")
        with pytest.raises(RuntimeError, match="CUDA device requested"):
            engine.analyze_kernels()
        with pytest.raises(RuntimeError, match="CUDA device requested"):
            exercise.exercise_fleet()


# -- combined CLI ------------------------------------------------------------------------------


def _cli(*argv):
    return subprocess.run(
        [sys.executable, "-m", "nomad_tpu_torch.analysis", *argv],
        capture_output=True, text=True, cwd=str(REPO_ROOT),
        env={**os.environ, "JAX_PLATFORMS": "cpu"}, timeout=300,
    )


class TestCombinedCLI:
    def test_device_cpu_runs_both_and_exits_zero(self):
        r = _cli("--json", "--device", "cpu")
        assert r.returncode == 0, r.stdout + r.stderr
        data = json.loads(r.stdout)
        assert data["source"]["new"] == [] and data["source"]["fixed"] == []
        assert data["kernels"]["new"] == []
        assert data["kernels"]["analyzed"] == 21
        assert set(data["kernels"]["fingerprints"]) == set(FLEET)

    def test_without_cuda_the_default_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device resolves")
        r = _cli("--kernels-only")
        assert r.returncode != 0
        assert "CUDA device requested" in r.stderr
