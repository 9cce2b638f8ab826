"""The port's incremental rescoring (``device/cache.py`` score half, the
``used_device`` seam) against the JAX reference's, on the CPU.

Mirrors ``tests/test_incremental.py``:

- bit identity: for binpack, spread (with a spread-coupled lane on the
  value scan), hetero-maxmin and cp-pack over three passes of churn, the
  node rows and scores (uint32 views) with the seam on equal those with
  it off, and the node rows equal the reference's degenerate-mesh run;
- counter accounting: rescored / reused / patches / rebuilds / swaps /
  generation equal the reference's on the same passes, and off-mode
  touches nothing;
- the generation protocol (swap order, no swap on a zero-dirty pass,
  abort then self-heal) and the rebuild triggers (shape flip, layout-gen
  bump, invalidate);
- every generation holds its own bytes: ``verify_score_view() == []``
  after every pass, and a CPU generation never aliases the caller's
  ``used``;
- ``cuda``-marked tests of the same matrix on the card (skip here).

Tolerance: the port's on/off runs are compared bit for bit. Against the
reference, node rows exactly and scores bit for bit for the hetero and
CP kernels (the reference pins them to a NumPy oracle); the closed-form
and value-scan scores within ``rtol=1e-5, atol=1e-6``, since ``exp``
differs by an ulp between the runtimes (see test_torch_score.py).
Counters exactly.

The reference's ``traced_jit`` needs the scoped ``trace_state_clean``
monkeypatch of ``tests/test_torch_e2e.py`` (ROADMAP C-R1).
"""

import dataclasses
from dataclasses import replace

import numpy as np
import pytest
import torch

from nomad_tpu.analysis.jaxlint.exercise import _ask, _blocks, _cluster
from nomad_tpu.device.cache import DeviceStateCache as RefCache
from nomad_tpu.device.score import BLOCK_TARGET_SPREAD
from nomad_tpu.scheduler.algorithms import make_kernel as ref_make_kernel
from nomad_tpu.scheduler.cp import build_cp_asks
from nomad_tpu.scheduler.hetero import build_mixed_asks, build_mixed_fleet
from nomad_tpu.utils import backend as ref_backend
from nomad_tpu_torch import backend as port_backend
from nomad_tpu_torch import interop
from nomad_tpu_torch.device.cache import DeviceStateCache
from nomad_tpu_torch.scheduler.algorithms import make_kernel
from test_torch_hetero import reference_runtime

RTOL, ATOL = 1e-5, 1e-6
ALGOS = ("binpack", "spread", "hetero-maxmin", "cp-pack")
# kernels whose outputs the reference pins bit for bit
BITWISE_ALGOS = ("hetero-maxmin", "cp-pack")


@pytest.fixture
def incr_env(monkeypatch):
    """Opt into the incremental score cache through the one variable both
    packages read; restores the default-off resolution afterwards."""

    def activate(spec="on"):
        monkeypatch.setenv("NOMAD_TPU_INCREMENTAL", spec)
        port_backend.reset_incremental()
        ref_backend.reset_incremental()
        return port_backend.incremental_enabled()

    yield activate
    monkeypatch.delenv("NOMAD_TPU_INCREMENTAL", raising=False)
    port_backend.reset_incremental()
    ref_backend.reset_incremental()


# -- workloads ----------------------------------------------------------------


def _workload(algo: str, seed: int):
    """Reference (cluster, asks) for one algorithm family, fresh arrays
    a call. "spread" adds a target-spread lane (value scan route)."""
    if algo in ("binpack", "spread"):
        ct = _cluster()
        asks = [_ask(ct, f"a{seed}", 3), _ask(ct, f"b{seed}", 2)]
        if algo == "spread":
            asks.append(
                _ask(ct, f"s{seed}", 3, blocks=_blocks(ct, BLOCK_TARGET_SPREAD))
            )
        return ct, asks
    ct = build_mixed_fleet(48, seed=seed)
    if algo == "cp-pack":
        return ct, build_cp_asks(ct, 6, 4, seed=seed + 1)
    return ct, build_mixed_asks(ct, 6, 4, seed=seed + 1)


def _port(ct, asks):
    return (
        interop.cluster_from_numpy(dataclasses.asdict(ct)),
        interop.asks_from_numpy([dataclasses.asdict(a) for a in asks]),
    )


def _run_passes(algo, seed, incremental, side="port", passes=3,
                monkeypatch=None, check=None):
    """``passes`` kernel passes with deterministic churn between them
    (two rows' usage moves, as alloc commits do between scheduler
    passes). Returns per-pass [(rows, score uint32 view)], the cache
    (None off) and the lane count."""
    ct, asks = _workload(algo, seed)
    if side == "port":
        ct, asks = _port(ct, asks)
        cache = DeviceStateCache("cpu") if incremental else None
        kernel = make_kernel(algo, device="cpu")
    else:
        cache = RefCache() if incremental else None
        kernel = ref_make_kernel(algo)
    if cache is not None:
        ct.score_cache = cache
    rng = np.random.default_rng(seed)
    out = []
    for p in range(passes):
        if side == "port":
            results = kernel.place(ct, asks)
        else:
            with reference_runtime(monkeypatch):
                results = kernel.place(ct, asks)
        out.append([
            (
                np.asarray(r.node_rows).copy(),
                np.asarray(r.scores, dtype=np.float32).view(np.uint32).copy(),
            )
            for r in results
        ])
        if cache is not None:
            cache.score_commit()
            if check is not None:
                check(cache)
        for _ in range(2):
            row = int(rng.integers(0, ct.num_nodes))
            ct.used[row, 0] += np.float32(16.0 * (p + 1))
    return out, cache, len(asks)


def _assert_same(got, want, bitwise=True):
    assert len(got) == len(want)
    for p, (gp, wp) in enumerate(zip(got, want)):
        assert len(gp) == len(wp)
        for lane, (g, w) in enumerate(zip(gp, wp)):
            np.testing.assert_array_equal(g[0], w[0], err_msg=f"{p}/{lane}")
            if bitwise:
                np.testing.assert_array_equal(g[1], w[1], err_msg=f"{p}/{lane}")
            else:
                np.testing.assert_allclose(
                    g[1].view(np.float32), w[1].view(np.float32),
                    rtol=RTOL, atol=ATOL, err_msg=f"{p}/{lane}",
                )


COUNTER_KEYS = (
    "score_rows_rescored", "score_rows_reused", "score_patch_uploads",
    "score_full_rebuilds", "score_swaps", "score_gen",
)


# -- bit identity -------------------------------------------------------------


class TestBitIdentity:
    @pytest.mark.parametrize("algo", ALGOS)
    def test_incremental_matches_scratch_and_reference(
        self, algo, incr_env, monkeypatch
    ):
        """On == off byte for byte in the port, and the reference's
        degenerate-mesh incremental run places the same rows."""
        seed = 7
        off, _, _ = _run_passes(algo, seed, incremental=False)
        incr_env("on")
        on, cache, _ = _run_passes(
            algo, seed, incremental=True,
            check=lambda c: c.verify_score_view() == [] or pytest.fail("diverged"),
        )
        _assert_same(on, off)
        ref, _, _ = _run_passes(
            algo, seed, incremental=True, side="ref", monkeypatch=monkeypatch
        )
        _assert_same(on, ref, bitwise=algo in BITWISE_ALGOS)
        c = cache.device_counters()
        assert c["score_full_rebuilds"] >= 1
        assert c["score_rows_reused"] > 0
        assert cache.verify_score_view() == []

    @pytest.mark.parametrize("seed", [3, 11, 29])
    def test_degenerate_bit_identity(self, seed, incr_env):
        off, _, _ = _run_passes("binpack", seed, incremental=False)
        incr_env("on")
        on, cache, _ = _run_passes("binpack", seed, incremental=True)
        _assert_same(on, off)
        assert cache.verify_score_view() == []


# -- counter accounting -------------------------------------------------------


class TestCounterAccounting:
    @pytest.mark.parametrize("algo", ALGOS)
    def test_counters_equal_reference(self, algo, incr_env, monkeypatch):
        """The same passes give the reference's counters. For cp-pack the
        port scores every ask of a pass in ONE score-matrix launch
        (``score_groups``), where the reference calls ``score_group``
        once an ask: its G - 1 extra views a pass are zero-dirty, so
        every counter but ``reused`` is equal, and ``reused`` differs by
        exactly (G - 1) · rows a pass."""
        incr_env("on")
        passes = 3
        _, port_cache, g = _run_passes(algo, 7, True, passes=passes)
        _, ref_cache, _ = _run_passes(
            algo, 7, True, side="ref", passes=passes, monkeypatch=monkeypatch
        )
        got = port_cache.device_counters()
        want = ref_cache.device_counters()
        if algo == "cp-pack":
            rows = port_cache._score.used_host.shape[0]
            want = dict(
                want,
                score_rows_reused=want["score_rows_reused"]
                - (g - 1) * rows * passes,
            )
        assert {k: got[k] for k in COUNTER_KEYS} == {
            k: want[k] for k in COUNTER_KEYS
        }

    def test_rescored_reused_exact(self, incr_env):
        """16-row cluster: pass 1 rebuilds (16 rescored), a 1-row churn
        makes pass 2 rescore 1 and reuse 15, a clean pass 3 reuses 16
        with no generation bump — the reference test's numbers."""
        incr_env("on")
        ref_ct = _cluster()
        ct, asks = _port(ref_ct, [_ask(ref_ct, "a", 3), _ask(ref_ct, "b", 2)])
        cache = DeviceStateCache("cpu")
        ct.score_cache = cache
        kernel = make_kernel("binpack", device="cpu")

        kernel.place(ct, asks)
        cache.score_commit()
        c = cache.device_counters()
        assert (c["score_full_rebuilds"], c["score_rows_rescored"],
                c["score_rows_reused"], c["score_patch_uploads"],
                c["score_swaps"], c["score_gen"]) == (1, 16, 0, 0, 1, 1)

        ct.used[0, 0] += 128.0
        kernel.place(ct, asks)
        cache.score_commit()
        c = cache.device_counters()
        assert (c["score_full_rebuilds"], c["score_rows_rescored"],
                c["score_rows_reused"], c["score_patch_uploads"],
                c["score_swaps"], c["score_gen"]) == (1, 17, 15, 1, 2, 2)

        kernel.place(ct, asks)
        cache.score_commit()
        c = cache.device_counters()
        assert (c["score_rows_rescored"], c["score_rows_reused"],
                c["score_swaps"], c["score_gen"]) == (17, 31, 2, 2)
        assert cache.verify_score_view() == []

    def test_off_mode_touches_nothing(self):
        ref_ct = _cluster()
        ct, asks = _port(ref_ct, [_ask(ref_ct, "a", 3)])
        cache = DeviceStateCache("cpu")
        ct.score_cache = cache
        make_kernel("binpack", device="cpu").place(ct, asks)
        c = cache.device_counters()
        assert c["score_full_rebuilds"] == 0
        assert c["score_rows_rescored"] == 0
        assert c["score_gen"] == 0
        assert cache.verify_score_view() is None


# -- the generation protocol --------------------------------------------------


def _port_ct():
    return _port(_cluster(), [])[0]


class TestGenerationProtocol:
    def test_swap_ordering_and_zero_dirty_no_swap(self, incr_env):
        incr_env("on")
        ct = _port_ct()
        cache = DeviceStateCache("cpu")
        u1 = ct.used.copy()
        cache.score_view(ct, u1)
        assert cache.device_counters()["score_gen"] == 1
        cache.score_commit()
        assert cache._score is not None and cache._score.gen == 1
        assert cache._score_staged is None
        # identical bytes: staged rides the same generation, no swap
        first = cache._score.used_dev
        assert cache.score_view(ct, u1) is first
        cache.score_commit()
        assert cache._score.gen == 1
        assert cache.device_counters()["score_swaps"] == 1
        # dirty bytes: staged gen 2, commit swaps; gen 1 is untouched
        u2 = u1.copy()
        u2[3, 1] += 7.0
        dev2 = cache.score_view(ct, u2)
        assert dev2 is not first
        assert cache._score.gen == 1
        np.testing.assert_array_equal(first.numpy(), u1)
        cache.score_commit()
        assert cache._score.gen == 2
        assert cache.verify_score_view() == []

    def test_abort_drops_staged_and_next_pass_self_heals(self, incr_env):
        incr_env("on")
        ct = _port_ct()
        cache = DeviceStateCache("cpu")
        u1 = ct.used.copy()
        cache.score_view(ct, u1)
        cache.score_commit()
        u2 = u1.copy()
        u2[5, 0] += 3.0
        cache.score_view(ct, u2)
        cache.score_abort()
        assert cache._score_staged is None
        assert cache._score.gen == 1
        dev = cache.score_view(ct, u2)
        np.testing.assert_array_equal(dev.numpy(), u2)
        cache.score_commit()
        assert cache._score.gen == 2
        assert cache.verify_score_view() == []

    def test_generation_matches_reference_protocol(self, incr_env, monkeypatch):
        """The same view / commit / abort sequence on both caches gives
        the same generation, swaps and counters at every step."""
        incr_env("on")
        ref_ct = _cluster()
        ct = _port_ct()
        port, ref = DeviceStateCache("cpu"), RefCache()
        u = ct.used.copy()
        steps = []
        for op in ("view", "commit", "view", "dirty", "view", "abort",
                   "view", "commit", "dirty", "view", "commit", "view"):
            if op == "dirty":
                u = u.copy()
                u[len(steps) % 16, 2] += 1.0
            elif op == "view":
                with reference_runtime(monkeypatch):
                    ref.score_view(ref_ct, u)
                port.score_view(ct, u)
            else:
                getattr(ref, f"score_{op}")()
                getattr(port, f"score_{op}")()
            steps.append(op)
            got, want = port.device_counters(), ref.device_counters()
            assert {k: got[k] for k in COUNTER_KEYS} == {
                k: want[k] for k in COUNTER_KEYS
            }, steps


# -- rebuild triggers ---------------------------------------------------------


class TestRebuildTriggers:
    def test_shape_flip_rebuilds(self, incr_env):
        incr_env("on")
        ct = _port_ct()
        cache = DeviceStateCache("cpu")
        cache.score_view(ct, ct.used)
        cache.score_commit()
        bigger = np.zeros((ct.padded_n * 2, ct.used.shape[1]), np.float32)
        bigger[: ct.padded_n] = ct.used
        dev = cache.score_view(ct, bigger)
        np.testing.assert_array_equal(dev.numpy(), bigger)
        assert cache.device_counters()["score_full_rebuilds"] == 2
        assert cache.verify_score_view() == []

    def test_layout_gen_bump_rebuilds(self, incr_env):
        incr_env("on")
        ct = _port_ct()
        cache = DeviceStateCache("cpu")
        cache.score_view(ct, ct.used)
        cache.score_commit()
        cache.score_view(replace(ct, layout_gen=ct.layout_gen + 1), ct.used)
        assert cache.device_counters()["score_full_rebuilds"] == 2

    def test_invalidate_evicts_score_state(self, incr_env):
        incr_env("on")
        ct = _port_ct()
        cache = DeviceStateCache("cpu")
        cache.score_view(ct, ct.used)
        cache.score_commit()
        cache.invalidate()
        assert cache.verify_score_view() is None
        assert cache.device_counters()["score_gen"] == 0


# -- every generation holds its own bytes -------------------------------------


class TestResidentBytes:
    @pytest.mark.parametrize("algo", ALGOS)
    def test_generation_unchanged_after_every_pass(self, algo, incr_env):
        """No kernel wrapper writes into the ``used`` tensor it is given:
        after every pass the newest generation still equals its mirror,
        and the committed tensor of pass p still holds pass p's bytes
        after the later passes."""
        incr_env("on")
        kept = []

        def check(cache):
            assert cache.verify_score_view() == []
            st = cache._score
            kept.append((st.used_dev, st.used_host.copy()))

        _run_passes(algo, 5, True, check=check)
        for dev, host in kept:
            np.testing.assert_array_equal(
                dev.numpy().view(np.uint32), host.view(np.uint32)
            )

    def test_cpu_generation_does_not_alias_callers_used(self, incr_env):
        incr_env("on")
        ct = _port_ct()
        cache = DeviceStateCache("cpu")
        used = ct.used.copy()
        before = used.copy()
        dev = cache.score_view(ct, used)
        assert not np.shares_memory(dev.numpy(), used)
        assert not np.shares_memory(dev.numpy(), cache._score_staged.used_host)
        used[:] += 99.0  # the caller's live array churns
        np.testing.assert_array_equal(dev.numpy(), before)
        assert cache.verify_score_view() == []
        # a patched generation does not alias either
        used2 = before.copy()
        used2[1, 1] += 2.0
        dev2 = cache.score_view(ct, used2)
        used2[:] = -1.0
        assert dev2.numpy()[1, 1] == before[1, 1] + 2.0
        assert cache.verify_score_view() == []

    def test_verify_reports_a_written_generation(self, incr_env):
        incr_env("on")
        ct = _port_ct()
        cache = DeviceStateCache("cpu")
        dev = cache.score_view(ct, ct.used)
        dev[2, 0] += 1.0  # what no wrapper may do
        problems = cache.verify_score_view()
        assert len(problems) == 1 and "gen-1" in problems[0]


# -- the tensors() attach, the schema, the overlap note -----------------------


def test_tensors_attach_only_when_on(incr_env):
    from nomad_tpu_torch import mock

    from nomad_tpu_torch.state import StateStore

    store = StateStore()
    for i in range(4):
        store.upsert_node(1 + i, mock.node())
    cache = DeviceStateCache("cpu")
    assert cache.tensors(store.snapshot()).score_cache is None
    incr_env("on")
    assert cache.tensors(store.snapshot()).score_cache is cache


def test_device_counters_schema_equals_reference():
    assert set(DeviceStateCache("cpu").device_counters()) == set(
        RefCache().device_counters()
    )


def test_note_overlap_accumulates():
    cache = DeviceStateCache("cpu")
    cache.note_overlap(2.5)
    cache.note_overlap(-1.0)  # clamped
    cache.note_overlap(1.25)
    assert cache.device_counters()["pipeline_overlap_ms"] == 3.75


def test_harness_evals_equal_with_seam_on_and_off(incr_env):
    """Whole evals through the port's Harness: the same plans with the
    seam off and on, and on the on arm a commit after each eval leaves
    the generation consistent."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.scheduler import Harness
    from nomad_tpu_torch.state import StateStore

    import copy

    nodes = [mock.node() for _ in range(24)]

    def drive(on):
        store = StateStore()
        for i, n in enumerate(nodes):
            store.upsert_node(1 + i, copy.deepcopy(n))
        h = Harness(store, device="cpu")
        placed = []
        for j in range(4):
            job = mock.job()
            job.id = f"job-{j}"
            job.task_groups[0].count = 5
            store.upsert_job(h.next_index(), job)
            ev = mock.eval_for(job, id=f"eval-{j}")
            store.upsert_evals(h.next_index(), [ev])
            h.process(ev)
            if on:
                h.device_cache.score_commit()
                assert h.device_cache.verify_score_view() == []
            placed.append(sorted(
                (a.name, a.node_id, a.metrics.scores.get(a.node_id))
                for a in store.allocs_by_job(job.namespace, job.id)
            ))
        return placed, h.device_cache.device_counters()

    off, c_off = drive(False)
    incr_env("on")
    on, c_on = drive(True)
    assert on == off
    assert c_off["score_gen"] == 0
    assert c_on == expected_eval_counters(on, padded_n=32)


def expected_eval_counters(placed, padded_n):
    """What a run of one-pass evals with a commit after each must count
    (the prediction chip_smoke.py's "incremental" path checks on the
    card): the first pass rebuilds every row; each later pass patches
    exactly the rows the previous eval placed on."""
    dirty = [len({node for _name, node, _score in job}) for job in placed[:-1]]
    n = len(placed)
    return {
        "shard_uploads": 0, "full_uploads": 0, "dirty_regions": 0,
        "score_rows_rescored": padded_n + sum(dirty),
        "score_rows_reused": (n - 1) * padded_n - sum(dirty),
        "score_patch_uploads": n - 1,
        "score_full_rebuilds": 1,
        "score_swaps": n,
        "score_gen": n,
        "pipeline_overlap_ms": 0.0,
    }


# -- on the card ---------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ALGOS)
def test_cuda_incremental_matches_scratch(algo, monkeypatch):
    """On the card: on == off bit for bit over the churn passes, the
    patch path (a whole upload of the new generation) served, and every
    generation equal to its mirror."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    ct, asks = _port(*_workload(algo, 7))

    def run(on):
        monkeypatch.setenv("NOMAD_TPU_INCREMENTAL", "on" if on else "off")
        port_backend.reset_incremental()
        c, a = interop.cluster_from_numpy(dataclasses.asdict(ct)), list(asks)
        cache = DeviceStateCache("cuda") if on else None
        if cache is not None:
            c.score_cache = cache
        kernel = make_kernel(algo, device="cuda")
        out = []
        for p in range(3):
            res = kernel.place(c, a)
            out.append([(r.node_rows.copy(), r.scores.view(np.uint32).copy())
                        for r in res])
            if cache is not None:
                cache.score_commit()
                assert cache.verify_score_view() == []
            c.used[p, 0] += np.float32(16.0)
        return out, cache

    try:
        off, _ = run(False)
        on, cache = run(True)
    finally:
        monkeypatch.delenv("NOMAD_TPU_INCREMENTAL", raising=False)
        port_backend.reset_incremental()
    _assert_same(on, off)
    assert cache.device_counters()["score_patch_uploads"] >= 2


def test_dirty_rows_are_bitwise(incr_env):
    """A row whose bits change between 0.0 and -0.0 is dirty, so the
    generation stays bitwise equal to the pass's ``used``; rows with
    equal bits are not, and the diff matches the float compare wherever
    no sign of zero or NaN is involved."""
    from nomad_tpu_torch.device.cache import _dirty_rows

    incr_env("on")
    ct = _port_ct()
    cache = DeviceStateCache("cpu")
    used = np.zeros_like(ct.used)
    cache.score_view(ct, used)
    flipped = used.copy()
    flipped[4, 2] = -0.0
    dev = cache.score_view(ct, flipped)
    assert cache.device_counters()["score_patch_uploads"] == 1
    np.testing.assert_array_equal(dev.numpy().view(np.uint32), flipped.view(np.uint32))
    assert cache.verify_score_view() == []
    rng = np.random.default_rng(0)
    a = rng.random((64, 4), dtype=np.float32)
    b = a.copy()
    b[[3, 17, 63], [0, 3, 1]] += 1.0
    np.testing.assert_array_equal(_dirty_rows(a, b), np.flatnonzero(np.any(a != b, axis=1)))
    odd = rng.random((8, 3), dtype=np.float32)  # 12-byte rows: uint32 words
    odd2 = odd.copy()
    odd2[5, 2] += 1.0
    np.testing.assert_array_equal(_dirty_rows(odd, odd2), [5])
