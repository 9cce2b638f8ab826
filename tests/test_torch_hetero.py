"""The port's heterogeneity-aware placement against the JAX reference, on
the CPU.

Three layers, each with the same inputs on both sides:

- the device program: seeded numpy inputs through the reference's raw
  jitted program (``hetero_place_kernel.jitted``), its NumPy oracle
  (``oracle_hetero_place``) and the port's ``hetero_place`` on CPU
  tensors, which runs the plain PyTorch version — for each policy, on a
  mixed fleet, on a tie-heavy case and on a pass cut short by ``steps``;
- the kernel object (``HeteroPlacementKernel.place``) and the A/B
  harness (``run_hetero_ab``) on the same cluster tensors;
- whole evaluations through both ``Harness``es under each ``hetero-*``
  algorithm, plans compared per job, node for node.

Tolerance: the program's outputs are compared bit for bit (uint32 views),
as the reference pins its program to its oracle; placements and the A/B
report exactly. Alloc scores through the Harness agree within
``rtol=1e-5, atol=1e-6`` (the explanation replay evaluates ``exp``, whose
polynomials differ between the runtimes; see test_torch_score.py).

The reference's ``traced_jit`` calls ``jax.core.trace_state_clean``, gone
in this jax (ROADMAP C-R1): every reference call that goes through it runs
inside a monkeypatch scoped to its block, as in ``tests/test_torch_e2e.py``.
"""

import collections
import contextlib
import dataclasses
import types

import jax
import jax._src.core
import numpy as np
import pytest
import torch

from nomad_tpu import mock as ref_mock
from nomad_tpu.scheduler import Harness as RefHarness
from nomad_tpu.scheduler import hetero as ref_hetero
from nomad_tpu.state import SchedulerConfiguration as RefConfig
from nomad_tpu.state import StateStore as RefStore
from nomad_tpu.utils import backend as ref_backend
from nomad_tpu_torch import interop
from nomad_tpu_torch import mock as port_mock
from nomad_tpu_torch.scheduler import Harness as PortHarness
from nomad_tpu_torch.scheduler import hetero as port_hetero
from nomad_tpu_torch.scheduler.algorithms import make_kernel
from nomad_tpu_torch.scheduler.generic import wire_throughput_source
from nomad_tpu_torch.state import SchedulerConfiguration as PortConfig

RTOL, ATOL = 1e-5, 1e-6
POLICIES = ("maxmin", "makespan", "cost")
CLASSES = ("tpu-v5e", "tpu-v4", "gpu-a100", "cpu")


@contextlib.contextmanager
def reference_runtime(monkeypatch):
    """The reference's traced_jit path on this jax, for one block only."""
    with monkeypatch.context() as mp:
        mp.setattr(
            jax.core, "trace_state_clean", jax._src.core.trace_state_clean,
            raising=False,
        )
        mp.setattr(ref_backend, "_mesh_config", ref_backend.MeshConfig(None, 1, 1, "test"))
        yield


def assert_bits_equal(got, want, what=""):
    """Every output identical, floats compared as uint32 views."""
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        g = np.asarray(g.cpu() if isinstance(g, torch.Tensor) else g)
        w = np.asarray(w)
        assert g.shape == w.shape, (what, i)
        assert (g.view(np.uint32) == w.astype(g.dtype).view(np.uint32)).all(), (what, i)


# -- the device program --------------------------------------------------------


def _mixed_inputs(seed=3):
    ct = ref_hetero.build_mixed_fleet(48, seed=seed)
    asks = ref_hetero.build_mixed_asks(ct, 5, 7, seed=seed + 1)
    b = ref_hetero.build_hetero_batch(ct, asks)
    args = (b.capacity, b.used, b.asks, b.counts, b.eligible, b.tp, b.tpmax, b.cost)
    return args, b.steps, b.max_c


def _tie_inputs():
    """Equal keys everywhere, -0.0 in used0 and in an ask, all-infeasible
    rows, zero counts: the first index decides every pick."""
    rng = np.random.default_rng(11)
    g, n = 12, 40
    cap = np.tile(np.array([4000, 8192, 102400, 1000], np.float32), (n, 1))
    used = np.zeros((n, 4), np.float32)
    used[::3] = -0.0
    asks = np.tile(np.array([1500, 1024, 300, 0], np.float32), (g, 1))
    asks[::4, 3] = -0.0
    counts = rng.integers(0, 5, g).astype(np.int32)
    eligible = np.ones((g, n), bool)
    eligible[2] = False
    eligible[5, :30] = False
    tp = np.ones((g, n), np.float32)
    tp[7] = 0.0
    tpmax = np.where(eligible, tp, np.float32(0)).max(axis=1).astype(np.float32)
    cost = np.ones(n, np.float32)
    steps = 1 << int(np.ceil(np.log2(max(int(counts.sum()), 1))))
    return (cap, used, asks, counts, eligible, tp, tpmax, cost), steps, 8


@pytest.mark.parametrize("case", ["mixed", "ties", "steps_cut"])
@pytest.mark.parametrize("policy", POLICIES)
def test_hetero_place_matches_reference_bit_for_bit(policy, case):
    args, steps, max_c = _tie_inputs() if case == "ties" else _mixed_inputs()
    if case == "steps_cut":
        steps = 7
    pid = port_hetero.POLICY_IDS[policy]
    ref = ref_hetero.hetero_place_kernel.jitted(
        *args, policy=pid, steps=steps, max_c=max_c
    )
    oracle = ref_hetero.oracle_hetero_place(*args, pid, steps, max_c)
    port = port_hetero.hetero_place(
        *[torch.from_numpy(np.ascontiguousarray(a)) for a in args], pid, steps, max_c
    )
    assert_bits_equal(ref, oracle, "reference vs its oracle")
    assert_bits_equal(port, oracle, f"{policy} {case}")
    placed = int((port[0] >= 0).sum())
    if case == "steps_cut":
        assert placed == 7
    else:
        assert placed > 0


def _fake_library(monkeypatch, module, symbol, status, **extra):
    """Stands in for a csrc library in ``module`` so that its launcher's
    bookkeeping runs on CPU tensors: ``symbol`` records its arguments and
    returns ``status``; ``extra`` entry points return what they are
    given. Returns the list of recorded launches."""
    launched = []

    def launch(*args):
        launched.append(args)
        return status

    lib = types.SimpleNamespace(
        **{symbol: launch},
        **{name: (lambda value: lambda *args: value)(v) for name, v in extra.items()},
    )
    for fn in vars(lib).values():
        fn.argtypes = None  # as a ctypes function before its first call
    monkeypatch.setattr(module, "cuda_library", lambda name: lib)
    monkeypatch.setattr(module, "current_stream", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    return launched


def test_hetero_launcher_counts_only_launches(monkeypatch):
    """``hetero_place``'s count moves by one for each launch that
    succeeds, and by nothing for an empty group axis, zero steps or a
    refused launch."""
    args, steps, max_c = _mixed_inputs()
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    g = args[2].shape[0]

    def launch(status, rows, steps=steps):
        launched = _fake_library(monkeypatch, port_hetero, "nomad_hetero_place", status)
        before = port_hetero.hetero_place.launches
        lanes = [a[:rows] if a.shape[0] == g else a for a in args]
        try:
            choices, _, _ = port_hetero._launch_hetero(lanes, 0, steps, max_c)
            assert choices.shape == (rows, max_c)
        except RuntimeError:
            assert port_hetero.hetero_place.launches == before and len(launched) == 1
            raise
        return port_hetero.hetero_place.launches - before, len(launched)

    assert launch(0, rows=0) == (0, 0)
    assert launch(0, rows=g, steps=0) == (0, 0)
    assert launch(0, rows=g) == (1, 1)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        launch(1, rows=g)


def test_hetero_place_raises_on_a_count_above_max_c():
    args, steps, _ = _mixed_inputs()
    with pytest.raises(ValueError, match="max_c"):
        port_hetero.hetero_place(
            *[torch.from_numpy(np.ascontiguousarray(a)) for a in args], 0, steps, 4
        )


# -- the kernel object and the A/B harness --------------------------------------


def assert_same_provenance(got, want):
    """CP solver provenance: iterations and agreement exact, the gap
    (a sum of score-matrix entries) within the score tolerance."""
    assert got["iterations"] == want["iterations"]
    assert got["agreement"] == want["agreement"]
    np.testing.assert_allclose(got["gap"], want["gap"], rtol=RTOL, atol=1e-4)


def _port_cluster(ct):
    return interop.cluster_from_numpy(dataclasses.asdict(ct))


def _port_asks(asks):
    return interop.asks_from_numpy([dataclasses.asdict(a) for a in asks])


@pytest.mark.parametrize("policy", POLICIES)
def test_kernel_place_matches_reference(policy, monkeypatch):
    ct = ref_hetero.build_mixed_fleet(64, seed=5)
    asks = ref_hetero.build_mixed_asks(ct, 4, 9, seed=6)
    with reference_runtime(monkeypatch):
        ref = ref_hetero.HeteroPlacementKernel(policy).place(ct, asks, explain=True)
    port = port_hetero.HeteroPlacementKernel(policy, device="cpu").place(
        _port_cluster(ct), _port_asks(asks), explain=True
    )
    for r, p in zip(ref, port):
        np.testing.assert_array_equal(p.node_rows, r.node_rows)
        assert (p.scores.view(np.uint32) == r.scores.view(np.uint32)).all()
        assert p.explanation.algorithm == r.explanation.algorithm
        assert [c.node_row for c in p.explanation.top_candidates] == [
            c.node_row for c in r.explanation.top_candidates
        ]


def test_classless_batch_delegates_to_binpack():
    ct = ref_hetero.build_mixed_fleet(32, seed=5)
    ct.device_class_ids = np.zeros(ct.padded_n, dtype=np.int32)
    ct.device_class_vocab = {"": 0}
    asks = ref_hetero.build_mixed_asks(ct, 3, 5, seed=6)
    pct, pasks = _port_cluster(ct), _port_asks(asks)
    kern = port_hetero.HeteroPlacementKernel("maxmin", device="cpu")
    got = kern.place(pct, pasks)
    want = kern._base.place(pct, pasks)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.node_rows, w.node_rows)
        np.testing.assert_array_equal(g.scores, w.scores)


def test_run_hetero_ab_matches_reference(monkeypatch):
    kw = dict(n_nodes=96, n_jobs=6, count_per_job=8, seed=42)
    with reference_runtime(monkeypatch):
        ref = ref_hetero.run_hetero_ab(**kw)
    port = port_hetero.run_hetero_ab(**kw, device="cpu")
    assert port == ref
    assert port["oracle_mismatches"] == 0


def test_learned_throughputs_raise():
    """Learned mode is ported (the calibration plane): it wires the
    process-global estimator and raises nothing; an unknown source still
    raises, and declared mode and non-hetero kernels touch nothing."""
    from nomad_tpu_torch.obs.calibrate import global_estimator

    with pytest.raises(ValueError, match="throughput source"):
        port_hetero.HeteroPlacementKernel("maxmin", throughput_source="bogus",
                                          device="cpu")
    kern = port_hetero.HeteroPlacementKernel(
        "maxmin", throughput_source="learned", device="cpu"
    )
    assert kern.throughput_source == "learned" and kern.estimator is None
    kern = make_kernel("hetero-cost", device="cpu")
    wire_throughput_source(kern, PortConfig())  # declared: nothing to wire
    assert kern.throughput_source == "declared" and kern.estimator is None
    wire_throughput_source(kern, PortConfig(throughput_source="learned"))
    assert kern.throughput_source == "learned"
    assert kern.estimator is global_estimator
    binpack = make_kernel("binpack", device="cpu")
    wire_throughput_source(binpack, PortConfig(throughput_source="learned"))
    assert not hasattr(binpack, "estimator")


# -- whole evaluations -----------------------------------------------------------


def _drive(harness, eval_for, jobs, eval_ids):
    for job, eval_id in zip(jobs, eval_ids):
        ev = eval_for(job, id=eval_id)
        harness.store.upsert_evals(harness.next_index(), [ev])
        harness.process(ev)


def run_both(monkeypatch, nodes, jobs, algorithm, existing=()):
    """The same store (nodes, jobs, existing allocs) and evals through the
    reference Harness and the port's Harness on the CPU, under
    ``algorithm``."""
    records = (
        [dataclasses.asdict(n) for n in nodes],
        [dataclasses.asdict(j) for j in jobs],
        [dataclasses.asdict(a) for a in existing],
    )
    ids = [f"eval-{i}" for i in range(len(jobs))]
    ref_store = RefStore()
    ref_store.set_scheduler_config(1, RefConfig(scheduler_algorithm=algorithm))
    for n in nodes:
        ref_store.upsert_node(2, n)
    for j in jobs:
        ref_store.upsert_job(3, j)
    ref_store.upsert_allocs(4, list(existing))
    ref = RefHarness(ref_store)
    with reference_runtime(monkeypatch):
        _drive(ref, ref_mock.eval_for, jobs, ids)
    port_store = interop.store_from_records(*records)
    port_store.set_scheduler_config(5, PortConfig(scheduler_algorithm=algorithm))
    port = PortHarness(port_store, device="cpu")
    _drive(port, port_mock.eval_for,
           [port_store.job_by_id(j.namespace, j.id) for j in jobs], ids)
    return ref, port


def plans(h, jobs):
    """Per job: the live allocs' (group, node) multiset and scores, the
    eval statuses, the failed groups and the created evals."""
    out = {}
    for j in jobs:
        allocs = [
            a for a in h.store.allocs_by_job(j.namespace, j.id)
            if not a.terminal_status()
        ]
        out[j.id] = collections.Counter((a.task_group, a.node_id) for a in allocs)
    evals = [(e.id, e.status, sorted(e.failed_tg_allocs)) for e in h.evals]
    created = sorted((e.job_id, e.status, e.triggered_by) for e in h.created_evals)
    return out, evals, created


def alloc_scores(h, jobs):
    return sorted(
        (a.node_id, a.task_group, float(v))
        for j in jobs
        for a in h.store.allocs_by_job(j.namespace, j.id)
        for k, v in a.metrics.scores.items()
        if k.endswith(".score")
    )


def assert_same_plans(ref, port, jobs):
    assert plans(port, jobs) == plans(ref, jobs)
    rs, ps = alloc_scores(ref, jobs), alloc_scores(port, jobs)
    assert [k[:2] for k in ps] == [k[:2] for k in rs]
    np.testing.assert_allclose([s for *_, s in ps], [s for *_, s in rs],
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("policy", POLICIES)
def test_harness_hetero_matches_reference(policy, monkeypatch):
    """A mixed-class cluster, three throughput-carrying jobs and one
    class-agnostic job (which the policy delegates to binpack) under
    ``hetero-<policy>``: the same plans, node for node."""
    rng = np.random.default_rng(23)
    nodes = []
    for i in range(48):
        n = ref_mock.node(device_class=CLASSES[int(rng.integers(0, 4))])
        n.node_resources.cpu = (4000, 8000, 16000)[i % 3]
        n.node_resources.memory_mb = (8192, 16384, 32768)[i % 3]
        n.compute_class()
        nodes.append(n)
    jobs = []
    for j in range(3):
        job = ref_mock.job(throughputs=port_hetero.throughput_profile(j, CLASSES))
        job.task_groups[0].count = 12
        job.task_groups[0].tasks[0].resources.cpu = (500, 1000, 2000)[j]
        jobs.append(job)
    plain = ref_mock.job()
    plain.task_groups[0].count = 6
    jobs.append(plain)
    ref, port = run_both(monkeypatch, nodes, jobs, f"hetero-{policy}")
    assert_same_plans(ref, port, jobs)
    placed, _, _ = plans(port, jobs)
    assert sum(sum(c.values()) for c in placed.values()) == 3 * 12 + 6
