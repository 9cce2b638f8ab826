"""The port's bounded-budget migration plane against the JAX reference, on
the CPU.

- the device program: seeded numpy inputs (a fragmented defrag fleet, and
  general inputs with non-broadcast scores and random eligibility)
  through the reference's raw jitted program
  (``migrate_plan_kernel.jitted``), its NumPy oracle
  (``oracle_migrate_plan``) and the port's ``migrate_plan`` on CPU
  tensors, which runs the plain PyTorch version — across seeds and
  budgets, on a tie-heavy case (equal scores and gains, all-infeasible
  rows, -0.0 in used0 and lam0), with a perturbed ``lam0`` and cut short
  by ``steps``; the reference's oracle invariants, run against the port;
- the host copies (fleet, batch, scores, packing efficiency, schema) and
  the A/B harness ``run_defrag_ab``;
- the wrapper's launch count, through a stand-in library, and on the card
  (``cuda``-marked, skipped without one) the kernel against the plain
  version.

Tolerance: none. Every output is compared bit for bit (uint32 views of
the f32 outputs, equality of the i32 ones), the host arrays byte for byte
and the report value for value, as the reference pins its program to its
oracle. The reference's ``run_defrag_ab`` goes through ``traced_jit``,
which calls ``jax.core.trace_state_clean``, gone in this jax (ROADMAP
C-R1): it runs inside the scoped monkeypatch of ``tests/test_torch_e2e.py``.
"""

import json

import numpy as np
import pytest
import torch

from nomad_tpu.device import migrate as ref_mig
from nomad_tpu.scheduler import migrate as ref_smig
from nomad_tpu_torch.device import migrate as port_mig
from nomad_tpu_torch.scheduler import migrate as port_smig
from test_torch_hetero import _fake_library, assert_bits_equal, reference_runtime


def _fleet_inputs(seed=42, n_nodes=32, n_allocs=64):
    """(args, lam0, steps) of one pass over a fragmented defrag fleet."""
    capacity, used, sizes, cur, _ = ref_smig.build_defrag_fleet(n_nodes, n_allocs, seed=seed)
    args = list(ref_smig.build_defrag_batch(capacity, used, sizes, cur))
    return args, np.zeros(n_nodes, np.float32), ref_smig._steps_for(n_allocs)


def _general_inputs(seed, n=48, a=96, ties=False, perturbed=False):
    """(args, lam0, steps): contended integer resources, scores on a 1/16
    grid that differ by row (many exact ties), random eligibility; with
    ``ties`` every score and stay value equal, three all-infeasible rows
    and -0.0 in used0 and lam0; with ``perturbed`` lam0 on a 1/8 grid."""
    rng = np.random.default_rng(seed)
    cap = np.tile(np.array([4000, 8192, 102400, 1000], np.float32), (n, 1))
    used = np.floor(cap * rng.uniform(0.0, 0.6, (n, 1))).astype(np.float32)
    used[:, 3] = 0.0
    sizes = np.zeros((a, 4), np.float32)
    sizes[:, 0] = rng.choice([200.0, 400.0, 800.0, 1600.0], a)
    sizes[:, 1] = rng.choice([512.0, 1024.0, 2048.0], a)
    sizes[:, 2] = 300.0
    cur = rng.integers(0, n, a).astype(np.int32)
    eligible = rng.random((a, n)) < 0.8
    scores = (np.round(rng.random((a, n)) * 16) / 16).astype(np.float32)
    cur_scores = (np.round(rng.random(a) * 8) / 16).astype(np.float32)
    move_cost = np.full(a, ref_smig.MOVE_COST, np.float32)
    lam0 = np.zeros(n, np.float32)
    if ties:
        scores[:] = 0.75
        cur_scores[:] = 0.125
        eligible[:] = True
        eligible[:3] = False
        used[used == 0] = -0.0
        used[::5] = -0.0
        lam0[::2] = -0.0
    if perturbed:
        lam0 = (rng.integers(0, 4, n) * 0.125).astype(np.float32)
    args = [cap, used, sizes, cur, eligible, scores, cur_scores, move_cost]
    return args, lam0, ref_smig._steps_for(a)


def _port(args, budget, lam0, steps):
    t = [torch.from_numpy(np.ascontiguousarray(x)) for x in (*args, lam0)]
    return port_mig.migrate_plan(*t[:8], budget, t[8], steps)


def _run(args, lam0, budget, steps):
    """The port's outputs, after the reference's jitted program and its
    oracle are held to each other and the port to the oracle."""
    ref = ref_mig.migrate_plan_kernel.jitted(*args, np.int32(budget), lam0, steps=steps)
    oracle = ref_mig.oracle_migrate_plan(*args, np.int32(budget), lam0, steps)
    port = _port(args, budget, lam0, steps)
    assert_bits_equal(ref, oracle, "reference vs its oracle")
    assert_bits_equal(port, oracle, "port vs the reference's oracle")
    return port


# -- the device program ----------------------------------------------------------


@pytest.mark.parametrize("seed", [3, 11, 42])
def test_migrate_plan_matches_reference_bit_for_bit(seed):
    args, lam0, steps = _fleet_inputs(seed)
    port = _run(args, lam0, 8, steps)
    assert (port[0] >= 0).any()  # the pass did real work


@pytest.mark.parametrize("budget", [0, 1, 3, 8, 200])
def test_migrate_plan_across_budgets(budget):
    args, lam0, steps = _fleet_inputs(n_nodes=48, n_allocs=96)
    port = _run(args, lam0, budget, steps)
    assert int(port[3]) <= budget
    assert int(port[4]) >= 1  # even budget 0 runs (and prices) one round


@pytest.mark.parametrize("budget", [12, 192])
@pytest.mark.parametrize("seed", [0, 1])
def test_migrate_plan_general_scores(seed, budget):
    """Scores that differ by row and random eligibility: claims spread
    over many nodes, several commits a round."""
    args, lam0, steps = _general_inputs(seed, n=96, a=192)
    port = _run(args, lam0, budget, steps)
    assert int(port[3]) > 1


def test_migrate_plan_ties():
    args, lam0, steps = _general_inputs(5, ties=True)
    port = _run(args, lam0, 96, steps)
    dest = port[0].numpy()
    assert (dest[:3] == -1).all()  # all-infeasible rows never move
    assert int(port[3]) > 0
    # -0.0 is gone from the outputs after the first round, as in the reference
    assert not np.signbit(port[2].numpy()).any()
    assert not np.signbit(port[5].numpy()).any()


def test_migrate_plan_perturbed_prices():
    args, lam0, steps = _general_inputs(7, perturbed=True)
    for budget in (8, 96):
        port = _run(args, lam0, budget, steps)
    assert (port[5].numpy() != 0).any()


@pytest.mark.parametrize("steps", [1, 2, 3])
def test_migrate_plan_stops_on_steps(steps):
    """Cut short while the auction still has claimants and budget."""
    args, lam0, _ = _fleet_inputs(42, n_nodes=48, n_allocs=96)
    port = _run(args, lam0, 96, steps)
    assert int(port[4]) == steps


def test_migrate_plan_zero_steps_returns_inputs():
    args, lam0, _ = _general_inputs(5, ties=True)
    port = _run(args, lam0, 8, 0)
    assert np.signbit(port[2].numpy()).any()  # used0 as given, -0.0 kept
    assert int(port[4]) == 0


# -- the reference's oracle invariants, against the port -------------------------


def test_used_only_increases_and_fits():
    args, lam0, steps = _fleet_inputs()
    capacity, used0 = args[0], args[1]
    used = _port(args, 8, lam0, steps)[2].numpy()
    assert (used >= used0 - np.float32(1e-3)).all()
    assert (used <= capacity + np.float32(1e-3)).all()


def test_budget_caps_moves_exactly():
    args, lam0, steps = _fleet_inputs()
    for budget in (0, 1, 3, 8):
        dest, _, _, moves, _, _ = _port(args, budget, lam0, steps)
        assert int(moves) == int((dest >= 0).sum())
        assert int(moves) <= budget


def test_moves_strictly_positive_priced_gain():
    args, lam0, steps = _fleet_inputs()
    dest, gains, _, moves, _, _ = _port(args, 8, lam0, steps)
    dest, gains = dest.numpy(), gains.numpy()
    moved = dest >= 0
    assert int(moves) > 0
    assert (gains[moved] > 0.0).all()
    assert (gains[~moved] == 0.0).all()
    assert (dest[moved] != args[3][moved]).all()


def test_zero_move_cost_still_capacity_safe():
    capacity, used, sizes, cur, _ = ref_smig.build_defrag_fleet(16, 48, seed=9)
    args = list(ref_smig.build_defrag_batch(capacity, used, sizes, cur))
    args[7] = np.zeros_like(args[7])  # move_cost = 0: max pressure
    lam0 = np.zeros(16, np.float32)
    port = _run(args, lam0, 48, ref_smig._steps_for(48))
    assert (port[2].numpy() <= capacity + np.float32(1e-3)).all()


# -- host copies and the A/B harness ---------------------------------------------


@pytest.mark.parametrize("shape", [(12, 64, 1), (32, 64, 42), (96, 192, 7)])
def test_fleet_and_batch_equal_reference_byte_for_byte(shape):
    n, a, seed = shape
    ref = ref_smig.build_defrag_fleet(n, a, seed=seed)
    port = port_smig.build_defrag_fleet(n, a, seed=seed)
    for r, p in zip(ref, port):
        assert r.dtype == p.dtype and r.tobytes() == p.tobytes()
    capacity, used, sizes, cur, ready = ref
    eligible = np.random.default_rng(seed).random((a, n)) < 0.7
    for elig in (None, eligible):
        rb = ref_smig.build_defrag_batch(capacity, used, sizes, cur, elig)
        pb = port_smig.build_defrag_batch(capacity, used, sizes, cur, elig)
        for r, p in zip(rb, pb):
            assert r.dtype == p.dtype and r.tobytes() == p.tobytes()
    assert ref_mig.packing_efficiency(capacity, used, ready) == port_mig.packing_efficiency(
        capacity, used, ready
    )
    assert ref_smig._steps_for(a) == port_smig._steps_for(a)


def test_packing_efficiency_equals_reference():
    rng = np.random.default_rng(2)
    cases = [
        (np.full((8, 2), 100.0, np.float32), np.zeros((8, 2), np.float32), np.ones(8, bool)),
        (np.full((4, 1), 10.0, np.float32), np.array([[0], [0], [0], [5]], np.float32),
         np.array([True, True, True, False])),
        (np.zeros((0, 2), np.float32), np.zeros((0, 2), np.float32), np.zeros(0, bool)),
    ]
    for _ in range(4):
        cap = np.full((20, 4), 1000.0, np.float32)
        used = np.where(rng.random((20, 1)) < 0.5, 0.0,
                        np.floor(rng.random((20, 4)) * 500)).astype(np.float32)
        cases.append((cap, used, rng.random(20) < 0.9))
    for cap, used, ready in cases:
        assert ref_mig.packing_efficiency(cap, used, ready) == port_mig.packing_efficiency(
            cap, used, ready
        )


def test_constants_and_schema_equal_reference():
    assert port_smig.MOVE_COST == ref_smig.MOVE_COST
    assert port_smig.MOVE_COST.dtype == np.float32
    assert port_smig.DEFRAG_SCHEMA == ref_smig.DEFRAG_SCHEMA


def _flatten(d, prefix=""):
    out = []
    for k, v in d.items():
        path = f"{prefix}.{k}" if prefix else k
        out.extend(_flatten(v, path) if isinstance(v, dict) else [path])
    return out


@pytest.mark.parametrize(
    "kw", [dict(), dict(n_nodes=24, n_allocs=48, budget=6, seed=42)],
    ids=["defaults", "small"],
)
def test_run_defrag_ab_matches_reference(monkeypatch, kw):
    with reference_runtime(monkeypatch):
        ref = ref_smig.run_defrag_ab(**kw)
    port = port_smig.run_defrag_ab(**kw, device="cpu")
    assert port == ref
    assert json.dumps(port, sort_keys=True) == json.dumps(ref, sort_keys=True)
    assert port["ok"], port
    assert tuple(sorted(_flatten(port))) == port_smig.DEFRAG_SCHEMA


def test_run_defrag_ab_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_smig.run_defrag_ab()


# -- the wrapper and the kernel ---------------------------------------------------


def test_wrapper_runs_plain_on_cpu_without_launching():
    before = port_mig.migrate_plan.launches
    args, lam0, steps = _fleet_inputs()
    _port(args, 8, lam0, steps)
    port_smig.run_defrag_ab(n_nodes=24, n_allocs=48, budget=6, device="cpu")
    assert port_mig.migrate_plan.launches == before


def test_migrate_launcher_counts_only_launches(monkeypatch):
    """``migrate_plan``'s count moves by one for each launch that
    succeeds, and by nothing for an empty alloc axis, zero steps or a
    refused launch; the kernel refuses D other than 4."""
    args, lam0, steps = _fleet_inputs()
    inputs = [torch.from_numpy(np.ascontiguousarray(x)).clone() for x in (*args, lam0)]

    def launch(status, rows, steps=steps):
        launched = _fake_library(monkeypatch, port_mig, "nomad_migrate_plan", status,
                                 nomad_migrate_scratch_words=64)
        before = port_mig.migrate_plan.launches
        a = inputs[5].shape[0]
        lanes = [t[:rows] if t.dim() and t.shape[0] == a else t for t in inputs]
        try:
            out = port_mig._launch_migrate(lanes, 8, steps)
            assert out[0].shape == (rows,) and out[2].shape == inputs[1].shape
        except RuntimeError:
            assert port_mig.migrate_plan.launches == before and len(launched) == 1
            raise
        return port_mig.migrate_plan.launches - before, len(launched)

    assert launch(0, rows=0) == (0, 0)
    assert launch(0, rows=64, steps=0) == (0, 0)
    assert launch(0, rows=64) == (1, 1)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        launch(1, rows=64)
    wide = [torch.zeros(t.shape[0], 5) if t.dim() == 2 and t.shape[1] == 4 else t
            for t in inputs]
    with pytest.raises(ValueError, match="D=4"):
        port_mig._launch_migrate(wide, 8, steps)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fleet", "general", "ties"])
def test_cuda_kernel_matches_plain_version(kind):
    """On the card: the kernel against the plain version, every output
    bit for bit (the comparison chip_smoke.py makes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    if kind == "fleet":
        args, lam0, steps = _fleet_inputs(n_nodes=96, n_allocs=192)
    else:
        args, lam0, steps = _general_inputs(3, n=96, a=192, ties=kind == "ties")
    t = [torch.from_numpy(np.ascontiguousarray(x)).cuda() for x in (*args, lam0)]
    before = port_mig.migrate_plan.launches
    for budget in (0, 1, 8, 192):
        got = port_mig.migrate_plan(*t[:8], budget, t[8], steps)
        want = port_mig.migrate_plan_plain(*t[:8], budget, t[8], steps)
        torch.cuda.synchronize()
        assert_bits_equal(got, [w.cpu() for w in want], f"{kind} budget {budget}")
    assert port_mig.migrate_plan.launches == before + 4
