"""The port's CP auction (cp-pack) against the JAX reference, on the CPU.

Three layers, each with the same inputs on both sides:

- the device program: seeded numpy inputs through the reference's raw
  jitted program (``cp_place_kernel.jitted``), its NumPy oracle
  (``oracle_cp_place``) and the port's ``cp_place`` on CPU tensors (the
  plain PyTorch version), with and without distinct_hosts, with priority
  ties, with a perturbed ``lam0``, cut short by ``steps``, and on a
  tie-heavy case (equal scores and priorities, all-infeasible rows, -0.0
  in used0);
- ``CpPlacementKernel.place`` (scores through the registry's
  ``score_group``) and the A/B harness ``run_cp_ab``;
- whole evaluations through both ``Harness``es under ``cp-pack``.

Tolerance: the program's outputs (choices, choice_scores, used, rounds,
lam) bit for bit (uint32 views); placements, rounds and the A/B report
exactly. Where the score rows come from the score matrix (the kernel
object, the Harness), its ``exp`` differs between the runtimes by a few
ulp (see test_torch_score.py): slot and alloc scores and the solver's
gap agree within ``rtol=1e-5, atol=1e-6`` (the gap, a sum over slots,
within 1e-4). Reference calls through
``traced_jit`` run inside the scoped monkeypatch (ROADMAP C-R1).
"""

import dataclasses

import numpy as np
import pytest
import torch

from nomad_tpu import mock as ref_mock
from nomad_tpu.device import cp as ref_cp
from nomad_tpu.scheduler import cp as ref_scp
from nomad_tpu.scheduler import hetero as ref_hetero
from nomad_tpu_torch import interop
from nomad_tpu_torch.device import cp as port_cp
from nomad_tpu_torch.scheduler import cp as port_scp
from nomad_tpu_torch.scheduler.algorithms import make_kernel
from nomad_tpu.structs import Constraint, Resources, Task, TaskGroup
from test_torch_hetero import (
    ATOL,
    RTOL,
    _fake_library,
    assert_bits_equal,
    assert_same_provenance,
    assert_same_plans,
    plans,
    reference_runtime,
    run_both,
)


def _inputs(seed, g=10, n=40, distinct=True, prio_ties=False, ties=False):
    """(capacity, used0, asks, counts, eligible, scores, prio, job_counts,
    distinct, jobgrp, lam0): contended integer resources, scores on a
    1/8 grid (many exact ties), three priority tiers, groups of three per
    job."""
    rng = np.random.default_rng(seed)
    cap = np.tile(np.array([4000, 8192, 102400, 1000], np.float32), (n, 1))
    used = np.floor(cap * rng.uniform(0.0, 0.5, (n, 1))).astype(np.float32)
    asks = np.tile(np.array([1500, 2048, 300, 0], np.float32), (g, 1))
    asks[::2, 0] = 1000
    counts = rng.integers(1, 6, g).astype(np.int32)
    eligible = rng.random((g, n)) < 0.9
    scores = (np.round(rng.random((g, n)) * 8) / 8).astype(np.float32)
    prio = rng.choice([30.0, 50.0, 80.0], g).astype(np.float32)
    job_counts = (rng.random((g, n)) < 0.1).astype(np.int32)
    dist = (rng.random(g) < 0.4) if distinct else np.zeros(g, bool)
    jobgrp = (np.arange(g) // 3).astype(np.int32)
    lam0 = np.zeros(n, np.float32)
    if prio_ties:
        prio[:] = 50.0
    if ties:
        scores[:] = 0.0
        prio[:] = 50.0
        eligible[:2] = False
        used[used == 0] = -0.0
        used[::5] = -0.0
    return [cap, used, asks, counts, eligible, scores, prio, job_counts,
            dist, jobgrp, lam0]


CASES = {
    "distinct": dict(),
    "no_distinct": dict(distinct=False),
    "priority_ties": dict(prio_ties=True),
    "ties": dict(ties=True),
}


def _run(args, steps, max_c):
    ref = ref_cp.cp_place_kernel.jitted(*args, steps=steps, max_c=max_c)
    oracle = ref_cp.oracle_cp_place(*args, steps, max_c)
    port = port_cp.cp_place(
        *[torch.from_numpy(np.ascontiguousarray(a)) for a in args], steps, max_c
    )
    assert_bits_equal(ref, oracle, "reference vs its oracle")
    return port, oracle


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", list(CASES))
def test_cp_place_matches_reference_bit_for_bit(case, seed):
    args = _inputs(seed, **CASES[case])
    port, oracle = _run(args, 64, 8)
    assert_bits_equal(port, oracle, case)
    assert int(port[3]) > 0


def test_cp_place_perturbed_prices():
    args = _inputs(2)
    args[-1] = ref_scp.perturb_prices(args[0].shape[0])
    for steps in (64, 1):
        port, oracle = _run(args, steps, 8)
        assert_bits_equal(port, oracle, f"lam0 perturbed, steps {steps}")
    # one round in, the perturbation still shows in the prices
    assert (port[4].numpy() != 0).any()


def test_cp_place_stops_on_steps():
    args = _inputs(3)
    port, oracle = _run(args, 2, 8)
    assert_bits_equal(port, oracle, "steps 2")
    assert int(port[3]) == 2


def count_auction_launches(monkeypatch, common, gang_args=None, max_c=8):
    """(count moved, launches made) of ``_launch_auction`` for an empty
    group axis, zero steps and one launch, through a stand-in library;
    then a refused launch, which raises and counts nothing."""
    what = "cp_place" if gang_args is None else "cp_gang_place"
    wrapper = getattr(port_cp, what)
    g = common[2].shape[0]

    def launch(status, rows, steps=64):
        launched = _fake_library(monkeypatch, port_cp, "nomad_cp_place", status,
                                 nomad_cp_scratch_words=64)
        before = wrapper.launches
        lanes = [t[:rows] if t.dim() and t.shape[0] == g else t for t in common]
        gang = gang_args and [
            t[:rows] if isinstance(t, torch.Tensor) and t.dim() == 1 else t
            for t in gang_args
        ]
        try:
            out = port_cp._launch_auction(what, lanes, steps, max_c, gang)
            assert out[0].shape == (rows, max_c)
        except RuntimeError:
            assert wrapper.launches == before and len(launched) == 1
            raise
        return wrapper.launches - before, len(launched)

    assert launch(0, rows=0) == (0, 0)
    assert launch(0, rows=g, steps=0) == (0, 0)
    assert launch(0, rows=g) == (1, 1)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        launch(1, rows=g)


def test_cp_launcher_counts_only_launches(monkeypatch):
    """``cp_place``'s count moves by one for each launch that succeeds,
    and by nothing for an empty group axis, zero steps or a refused
    launch."""
    common = [torch.from_numpy(np.ascontiguousarray(a)) for a in _inputs(0)]
    count_auction_launches(monkeypatch, common)


def test_cp_helpers_count_siblings_exactly():
    """The per-(job, node) count table equals the reference's integer
    product ``same @ assigned``."""
    rng = np.random.default_rng(4)
    assigned = rng.integers(0, 3, (9, 20)).astype(np.int32)
    jobgrp = np.array([5, 5, 2, 7, 2, 5, 9, 9, 7], np.int32)
    want = ref_cp._cp_siblings(jobgrp, assigned)
    got = port_cp._cp_siblings(torch.from_numpy(jobgrp), torch.from_numpy(assigned))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


# -- the kernel object and the A/B harness --------------------------------------


def test_kernel_place_matches_reference(monkeypatch):
    ct = ref_hetero.build_mixed_fleet(64, seed=8)
    asks = ref_scp.build_cp_asks(ct, 6, 5, seed=9)
    with reference_runtime(monkeypatch):
        ref = ref_scp.CpPlacementKernel().place(ct, asks, explain=True)
    port = port_scp.CpPlacementKernel(device="cpu").place(
        interop.cluster_from_numpy(dataclasses.asdict(ct)),
        interop.asks_from_numpy([dataclasses.asdict(a) for a in asks]),
        explain=True,
    )
    for r, p in zip(ref, port):
        np.testing.assert_array_equal(p.node_rows, r.node_rows)
        # the slot scores are the score matrix's (its exp differs by ulps)
        np.testing.assert_allclose(p.scores, r.scores, rtol=RTOL, atol=ATOL)
        assert_same_provenance(p.explanation.cp, r.explanation.cp)
        assert p.explanation.algorithm == "cp-pack"
        assert [c.node_row for c in p.explanation.top_candidates] == [
            c.node_row for c in r.explanation.top_candidates
        ]


def test_run_cp_ab_matches_reference(monkeypatch):
    kw = dict(n_nodes=96, n_jobs=6, count_per_job=8, seed=42)
    with reference_runtime(monkeypatch):
        ref = ref_scp.run_cp_ab(**kw)
    port = port_scp.run_cp_ab(**kw, device="cpu")
    assert port == ref
    assert port_scp.cp_schema_of(port) == port_scp.CP_SCHEMA


def test_capped_batch_delegates_to_binpack():
    ct = ref_hetero.build_mixed_fleet(32, seed=8)
    asks = ref_scp.build_cp_asks(ct, 3, 4, seed=9)
    asks[1].slot_caps = np.full(ct.padded_n, 2.0, np.float32)
    pct = interop.cluster_from_numpy(dataclasses.asdict(ct))
    pasks = interop.asks_from_numpy([dataclasses.asdict(a) for a in asks])
    kern = make_kernel("cp-pack", device="cpu")
    for g, w in zip(kern.place(pct, pasks), kern._base.place(pct, pasks)):
        np.testing.assert_array_equal(g.node_rows, w.node_rows)


# -- whole evaluations -----------------------------------------------------------


def test_harness_cp_pack_matches_reference(monkeypatch):
    """Three-group jobs at three priority tiers, one with distinct_hosts,
    on a contended 40-node cluster under cp-pack: the same plans."""
    nodes = [ref_mock.node() for _ in range(40)]
    jobs = []
    for j, prio in enumerate((30, 80, 50, 50)):
        job = ref_mock.job(priority=prio)
        job.task_groups = [
            TaskGroup(name=f"tg{k}", count=4 + k, tasks=[
                Task(name=f"tg{k}", driver="exec",
                     resources=Resources(cpu=900 + 300 * j, memory_mb=1024))
            ])
            for k in range(3)
        ]
        if j == 2:
            job.constraints.append(Constraint(operand="distinct_hosts"))
        jobs.append(job)
    ref, port = run_both(monkeypatch, nodes, jobs, "cp-pack")
    assert_same_plans(ref, port, jobs)
    placed, _, _ = plans(port, jobs)
    distinct = [node for (_, node) in placed[jobs[2].id].elements()]
    assert len(distinct) == len(set(distinct)) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("gang", [False, True])
def test_cuda_auction_tie_heavy_g100(gang):
    """On the card: the CP auction (and its gang instantiation, gangs of
    four groups on racks and pods) at G 100 on a tie-heavy case (equal
    scores and priorities, all-infeasible rows, -0.0 in used0): every
    output bit for bit against the plain version (the per-node
    resolution's tie order: priority, then u, then the least group)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    args = [torch.from_numpy(np.ascontiguousarray(a)).cuda()
            for a in _inputs(4, g=100, n=512, ties=True)]
    if not gang:
        got = port_cp.cp_place(*args, 128, 8)
        want = port_cp.cp_place_plain(*args, 128, 8)
    else:
        g, n = args[5].shape
        gang_ids = torch.arange(g, dtype=torch.int32).div(4, rounding_mode="floor") + 1
        w = torch.tensor([0.5, -0.25, 0.125, 0.0], dtype=torch.float32).repeat(g // 4)
        level_ids = torch.stack([torch.arange(n) // 16 + 1, torch.arange(n) // 64 + 1,
                                 torch.arange(n) // 8 + 1]).to(torch.int32)
        widths = (n // 16 + 1, n // 64 + 1, n // 8 + 1)
        extra = [gang_ids.cuda(), w.cuda(), (-w).cuda(), (w / 2).cuda(), level_ids.cuda()]
        got = port_cp.cp_gang_place_ids(*args[:10], *extra, widths, args[10], 128, 8)
        want = port_cp.cp_gang_place_ids_plain(*args[:10], *extra, widths, args[10], 128, 8)
    torch.cuda.synchronize()
    assert_bits_equal(got, [x.cpu() for x in want], f"gang={gang}")
    assert int(got[3]) > 0



@pytest.mark.cuda
def test_cuda_auction_unaligned_node_rows():
    """On the card: capacity and used0 at an offset that is not 16-byte
    aligned, so the row pass reads a node's four dims one by one; the
    outputs bit for bit against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    args = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in _inputs(5, g=30, n=256)]
    for i in (0, 1):  # capacity, used0: the same values one float in
        shifted = torch.empty(args[i].numel() + 1, dtype=torch.float32, device="cuda")
        shifted[1:] = args[i].reshape(-1)
        args[i] = shifted[1:].view(args[i].shape)
    assert args[0].data_ptr() % 16 != 0
    got = port_cp.cp_place(*args, 64, 8)
    want = port_cp.cp_place_plain(*args, 64, 8)
    torch.cuda.synchronize()
    assert_bits_equal(got, [x.cpu() for x in want], "unaligned")
