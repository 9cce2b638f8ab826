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
- the kernel's early exit (``csrc/migrate.cu``): a small torch walk over
  a row's sorted candidate list, with the kernel's stop tests, its list
  cut at K entries, its chunks and its skipped unfit head, held against
  the dense first-index argmax by ``hypothesis`` (ties at the stop
  boundary, ±0.0, negative and NaN prices, all-infeasible and
  single-candidate rows);
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
from hypothesis import given, settings
from hypothesis import strategies as st

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


def _general_inputs(seed, n=48, a=96, ties=False, perturbed=False, prices=None):
    """(args, lam0, steps): contended integer resources, scores on a 1/16
    grid that differ by row (many exact ties), random eligibility; with
    ``ties`` every score and stay value equal, three all-infeasible rows
    and -0.0 in used0 and lam0; with ``perturbed`` lam0 on a 1/8 grid.
    ``prices`` as ``chip_smoke.py``'s phase 9 sets them for the kernel's
    early exit: "positive", "negative", "boundary" (0 or 1/16 under the
    1/16 score grid) or "priced_out" (scores falling with the node index
    on every row, the first 2,048 nodes priced out)."""
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
    grids = {"positive": (1, 9, 0.125), "negative": (-4, 5, 0.125), "boundary": (0, 2, 0.0625)}
    if prices in grids:
        lo, hi, step = grids[prices]
        lam0 = (rng.integers(lo, hi, n) * step).astype(np.float32)
    elif prices == "priced_out":
        falling = (np.round((1.0 - np.arange(n) / n) * 16) / 16).astype(np.float32)
        scores = np.ascontiguousarray(np.broadcast_to(falling, (a, n)))
        lam0[:2048] = 4.0
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


@pytest.mark.parametrize("prices", ["positive", "negative", "boundary"])
def test_migrate_plan_early_exit_prices(prices):
    """The prices phase 9 gives the kernel's early exit: the least price
    above 0, below 0, and on the score grid's half step."""
    args, lam0, steps = _general_inputs(7, n=96, a=192, prices=prices)
    port = _run(args, lam0, 192, steps)
    assert int(port[3]) > 1


def test_migrate_plan_priced_out_run():
    """Every row's best node past a run of 2,048 priced-out nodes, longer
    than the kernel's 1,024-entry candidate list."""
    args, lam0, steps = _general_inputs(8, n=2600, a=48, prices="priced_out")
    port = _run(args, lam0, 48, steps)
    dest = port[0].numpy()
    assert (dest[dest >= 0] >= 2048).all() and int(port[3]) > 1


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


# -- the kernel's early exit -------------------------------------------------------


def _order_key(x: np.ndarray) -> np.ndarray:
    """u32 keys ordering f32 values as the floats do, -0 folded onto +0
    (``csrc/migrate.cu``'s ``order_key``)."""
    u = np.where(x == 0, np.float32(0), x).astype(np.float32).view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def _key_value(k: int) -> np.float32:
    k = np.uint32(k)
    bits = k & np.uint32(0x7FFFFFFF) if k & np.uint32(0x80000000) else ~k
    return np.array([bits], np.uint32).view(np.float32)[0]


def _dense_claim(base, lam, cand, fit):
    """The reference's claim of one row: the first-index argmax of the
    priced gain over the feasible nodes, or None."""
    g = torch.from_numpy(base) - torch.from_numpy(lam)
    feas = torch.from_numpy(cand & fit) & (g > 0)
    if not bool(feas.any()):
        return None
    umask = torch.where(feas, g, -torch.inf)
    n = int(torch.nonzero(umask == umask.max())[0])
    return n, float(g[n])


class _List:
    """A row's candidate list as the kernel builds it: the first K
    candidates in (base desc, node asc) order of the folded keys, its
    tail key, the largest key below the tail, and the first entry left
    out (key 0 = none)."""

    def __init__(self, base, cand, k):
        keys = _order_key(base)
        nodes = np.flatnonzero(cand)
        order = nodes[np.lexsort((nodes, ~keys[nodes]))]
        self.nodes, self.base = order[:k], base[order[:k]]
        left = order[k:]
        if left.size:
            t = int(keys[self.nodes[-1]])
            self.tail = t
            below = keys[left][keys[left] < t]
            self.next = int(below.max()) if below.size else 0
            self.first_out, self.first_out_node = int(keys[left[0]]), int(left[0])
        else:
            self.tail = int(keys[self.nodes[-1]]) if self.nodes.size else 0
            self.next, self.first_out, self.first_out_node = 0, 0, -1


def _settles(b, bk, bn, best, best_n, lmin, tail, nxt):
    """The kernel's stop tests at an entry of base ``b`` (key ``bk``,
    node ``bn``): the strict one, then the tie ones (the float below the
    base, or the tail run's next base, gains less than best)."""
    lmin = np.float32(lmin)
    bound = np.float32(b) - lmin
    have = best_n is not None
    if (bound < best) if have else not bound > 0:
        return True
    if not (have and bound == best and bn > best_n):
        return False
    if _key_value(bk - 1) - lmin < best:
        return True
    return bool(bk == tail and (nxt == 0 or _key_value(nxt) - lmin < best))


def _walk(lst, lam, fit, start, chunk):
    """The kernel's walk of one row from ``start``, ``chunk`` entries at a
    time: (settled, (best node or None, best gain), next start)."""
    finite = lam[~np.isnan(lam)]
    lmin = np.float32(finite.min()) if finite.size else np.float32(np.inf)
    best, best_n = -np.inf, None
    leading, new_start = True, start
    n_list = lst.nodes.size
    for c0 in range(start, n_list, chunk):
        idx = np.arange(c0, min(c0 + chunk, n_list))
        nodes = lst.nodes[idx]
        g = lst.base[idx] - lam[nodes]
        fits = fit[nodes]
        for n, gg, f in zip(nodes, g, fits):
            if f and gg > 0 and (gg > best or (gg == best and n < best_n)):
                best, best_n = gg, int(n)
        if leading:
            lead = int(np.argmax(fits)) if fits.any() else idx.size  # unfit head
            new_start = c0 + lead
            leading = lead == idx.size
        b = lst.base[idx[-1]]
        if _settles(b, int(_order_key(np.array([b]))[0]), int(nodes[-1]), best,
                    best_n, lmin, lst.tail, lst.next):
            return True, (best_n, best), new_start
    if lst.first_out == 0:
        return True, (best_n, best), new_start
    ok = _settles(_key_value(lst.first_out), lst.first_out, lst.first_out_node,
                  best, best_n, lmin, lst.tail, lst.next)
    return ok, (best_n, best), new_start


# coarse grids (exact ties), neighbouring floats, subnormals, and bases
# and prices large enough that a subtraction rounds two bases together
_BASES = st.sampled_from([-1.0, -0.0625, -0.0, 0.0, 0.0625, 0.125, 0.1875, 0.25,
                          0.5, 0.75, 1.0, 1.0000001, 1e-45, -1e-45, 3.0e7, 3.0000002e7])
_LAMS = st.sampled_from([-0.5, -0.125, -0.0, 0.0, 0.0625, 0.125, 0.25, 0.5, 2.0,
                         float("nan"), 1e-45, 1.0, 3.0e7])


@settings(derandomize=True, max_examples=400, deadline=None)
@given(
    n=st.integers(1, 24),
    data=st.data(),
    k=st.integers(1, 26),
    chunk=st.sampled_from([1, 2, 3, 32]),
)
def test_early_exit_walk_equals_the_dense_argmax(n, data, k, chunk):
    """Over two rounds (usage only grows, so a node unfit in the first
    stays unfit; prices move freely): wherever the walk settles, its
    claim is the dense first-index argmax; where it does not, the kernel
    scans the row densely. Bases and prices on coarse grids make exact
    ties at the stop boundary common; large ones make a subtraction round
    two bases onto one bound."""
    base = np.array(data.draw(st.lists(_BASES, min_size=n, max_size=n)), np.float32)
    cand = np.array(data.draw(st.lists(st.booleans(), min_size=n, max_size=n)))
    lst = _List(base, cand, k)
    start = 0
    fit = np.ones(n, bool)
    for _ in range(2):
        lam = np.array(data.draw(st.lists(_LAMS, min_size=n, max_size=n)), np.float32)
        fit = fit & np.array(data.draw(st.lists(st.booleans(), min_size=n, max_size=n)))
        settled, (best_n, best), start = _walk(lst, lam, fit, start, chunk)
        if settled:
            want = _dense_claim(base, lam, cand, fit)
            got = None if best_n is None else (best_n, float(best))
            assert got == want


def test_early_exit_settles_ties_in_the_tail_run():
    """Every base equal (the tie-heavy cases): the strict test never
    fires, the tail-run test settles the row once the cheapest fitting
    node is found, inside a list cut short."""
    n = 64
    base = np.full(n, 0.5, np.float32)
    lst = _List(base, np.ones(n, bool), 16)
    lam = np.zeros(n, np.float32)
    lam[:5] = 0.25  # claimed in earlier rounds
    fit = np.ones(n, bool)
    fit[5] = False
    settled, (best_n, best), _ = _walk(lst, lam, fit, 0, 32)
    assert settled and (best_n, float(best)) == _dense_claim(base, lam, np.ones(n, bool), fit)
    assert best_n == 6
    lam[:16] = 0.25  # every listed node priced out: the row goes dense
    assert not _walk(lst, lam, fit, 0, 32)[0]


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


@pytest.mark.cuda
@pytest.mark.parametrize("prices", ["positive", "negative", "boundary", "priced_out"])
def test_cuda_kernel_early_exit_cases(prices):
    """On the card: phase 9's early-exit cases at a test's size (a list
    cut short at 1,024 entries, dense rows, exact ties at the stop
    boundary), every output bit for bit against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    n, a = (2600, 64) if prices == "priced_out" else (2048, 256)
    args, lam0, steps = _general_inputs(9, n=n, a=a, prices=prices)
    t = [torch.from_numpy(np.ascontiguousarray(x)).cuda() for x in (*args, lam0)]
    for budget in (1, a):
        got = port_mig.migrate_plan(*t[:8], budget, t[8], steps)
        want = port_mig.migrate_plan_plain(*t[:8], budget, t[8], steps)
        torch.cuda.synchronize()
        assert_bits_equal(got, [w.cpu() for w in want], f"{prices} budget {budget}")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1001, 16388, 16390])
def test_cuda_kernel_load_and_staging_forms(n):
    """On the card: N not a multiple of 4 (scalar score loads), N above
    16,384 (the list build reads the grid again instead of staging the
    keys in shared memory), and both; every output bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    args, lam0, steps = _general_inputs(10, n=n, a=48)
    t = [torch.from_numpy(np.ascontiguousarray(x)).cuda() for x in (*args, lam0)]
    got = port_mig.migrate_plan(*t[:8], 48, t[8], steps)
    want = port_mig.migrate_plan_plain(*t[:8], 48, t[8], steps)
    torch.cuda.synchronize()
    assert_bits_equal(got, [w.cpu() for w in want], f"N {n}")
    assert int(got[3]) > 0
