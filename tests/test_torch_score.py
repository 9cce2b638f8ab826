"""The port's score kernels against the JAX reference, on the CPU.

The same seeded inputs (made with numpy) go through the reference's raw
jitted programs (``place_closed_form_kernel.jitted``,
``score_matrix_kernel.jitted``: the ``traced_jit`` wrappers cannot run on
this jax, see ROADMAP C-R1) and through the port's functions on CPU
tensors, which run the plain PyTorch versions.

Tolerance: choices must be identical, and scores agree within
``rtol=1e-5, atol=1e-6``. The two runtimes evaluate ``exp`` with
different polynomials (XLA's against PyTorch's), and the reference
itself documents a 1-ulp ``exp`` leak (device/score.py ``_pow10``); the
bar is a few ulp of the scores, which lie in [-2, 1]. A choice flip
would be admitted only where the reference's own scores for the two
picks lie within 4 ulp, and would be listed in ROADMAP queue C with its
seed; none occurs on these inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomad_tpu.device import parity as ref_parity
from nomad_tpu.device import score as ref_score
from nomad_tpu_torch.device import score as port_score

RTOL, ATOL = 1e-5, 1e-6
ULPS = 4


def _dense(ct, asks):
    pn = ct.padded_n
    return dict(
        asks=np.stack([a.ask for a in asks]).astype(np.float32),
        eligible=np.stack([a.eligible for a in asks]).astype(bool),
        job_counts=np.stack([a.job_counts for a in asks]).astype(np.int32),
        desired_totals=np.array([a.desired_total for a in asks], np.float32),
        penalty_nodes=np.stack([a.penalty_nodes for a in asks]).astype(bool),
        affinity_scores=np.stack([a.affinity_scores for a in asks]).astype(np.float32),
        has_affinities=np.array([a.has_affinities for a in asks], bool),
        distinct_hosts=np.array([a.distinct_hosts for a in asks], bool),
        slot_caps=np.stack(
            [
                a.slot_caps if a.slot_caps is not None
                else np.full(pn, np.inf, np.float32)
                for a in asks
            ]
        ).astype(np.float32),
    )


def _ref_place(ct, b, spread, max_j, k, jitter):
    fused = np.asarray(
        ref_score.place_closed_form_kernel.jitted(
            ct.capacity, ct.used, **b,
            algorithm_spread=jnp.asarray(spread),
            counts=np.zeros(len(b["asks"]), np.int32),
            max_j=max_j, k=k, jitter=jitter,
        )
    )
    return fused[:, :k], fused[:, k:].view(np.float32)


def _port_place(ct, b, spread, max_j, k, jitter):
    t = torch.from_numpy
    ch, sc = port_score.place_closed_form(
        t(ct.capacity), t(ct.used), **{key: t(v) for key, v in b.items()},
        algorithm_spread=spread, max_j=max_j, k=k,
        jitter=None if jitter is None else t(jitter),
    )
    return ch.numpy(), sc.numpy()


def _assert_same_picks(ref_ch, ref_sc, ch, sc):
    flips = np.argwhere(ref_ch != ch)
    for g, i in flips:
        gap = abs(float(ref_sc[g, i]) - float(sc[g, i]))
        assert gap <= ULPS * np.spacing(np.float32(abs(ref_sc[g, i]))), (
            f"choice flip at lane {g} slot {i}: ref node {ref_ch[g, i]} "
            f"({ref_sc[g, i]!r}) vs port node {ch[g, i]} ({sc[g, i]!r})"
        )
    assert len(flips) == 0, f"{len(flips)} near-tie flips: list them in ROADMAP C"
    fin = np.isfinite(ref_sc)
    assert (np.isfinite(sc) == fin).all()
    np.testing.assert_allclose(sc[fin], ref_sc[fin], rtol=RTOL, atol=ATOL)


def _config2(seed=11):
    return ref_parity.build_config2(n_nodes=200, n_jobs=4, count=40, seed=seed)


def _knobs(ct, asks, rng, component):
    pn = ct.padded_n
    spread, jitter = False, None
    for a in asks:
        if component == "job_counts":
            a.job_counts = ((rng.random(pn) < 0.25) * rng.integers(1, 4, pn)).astype(np.int32) * ct.ready
        elif component == "penalty":
            a.penalty_nodes = (rng.random(pn) < 0.1) & ct.ready
        elif component == "affinity":
            a.has_affinities = True
            a.affinity_scores = rng.choice([-0.5, 0.0, 0.5, 1.0], pn).astype(np.float32) * ct.ready
        elif component == "slot_caps":
            a.slot_caps = np.where(rng.random(pn) < 0.5, rng.integers(0, 3, pn), np.inf).astype(np.float32)
        elif component == "distinct_hosts":
            a.distinct_hosts = True
            a.job_counts = (rng.random(pn) < 0.3).astype(np.int32) * ct.ready
    if component == "spread_algorithm":
        spread = True
    if component == "jitter":
        rows = np.arange(pn, dtype=np.int64)
        h = (rows * 2654435761 + 3 * 40503) & 0xFFFFFFFF
        jitter = ((h % 65536).astype(np.float32) / 65536.0) * 2e-5
    return spread, jitter


@pytest.mark.parametrize(
    "component",
    [
        "config2",
        "job_counts",
        "penalty",
        "affinity",
        "slot_caps",
        "distinct_hosts",
        "spread_algorithm",
        "jitter",
        "k_above_plane",
    ],
)
def test_place_closed_form_matches_reference(component):
    ct, asks = _config2()
    rng = np.random.default_rng(5)
    spread, jitter = _knobs(ct, asks, rng, component)
    kern = port_score.PlacementKernel(device="cpu")
    max_j = kern._max_j(ct, asks)
    k = port_score._steps_bucket(max(a.count for a in asks) + 16)
    if component == "k_above_plane":
        ct, asks = ref_parity.build_config2(n_nodes=5, n_jobs=2, count=40, seed=3)
        max_j = 16
        k = 256  # > padded N (8) × J (16)
    b = _dense(ct, asks)
    ref = _ref_place(ct, b, spread, max_j, k, jitter)
    port = _port_place(ct, b, spread, max_j, k, jitter)
    _assert_same_picks(*ref, *port)
    if component == "k_above_plane":
        assert (port[0][:, 8 * 16:] == -1).all()


def test_placement_kernel_place_matches_reference_kernel():
    """The port's host wrapper (group padding, J/k buckets, unpacking)
    around the plain version against the reference's raw program run
    with the reference's own buckets."""
    ct, asks = ref_parity.build_config2(n_nodes=300, n_jobs=3, count=60, seed=21)
    kern = port_score.PlacementKernel(device="cpu")
    results = kern.place(ct, asks)
    max_j = ref_score.PlacementKernel._j_bucket(
        max(min(int(np.floor(np.min(ct.capacity.max(0)[:2] / a.ask[:2]))) + 1, a.count) for a in asks)
    )
    assert max_j == kern._max_j(ct, asks)
    k = ref_score._steps_bucket(60 + 16)
    padded = ref_score._pad_group_axis(list(asks), ct.padded_n)
    ref_ch, ref_sc = _ref_place(ct, _dense(ct, padded), False, max_j, k, None)
    for gi, (a, r) in enumerate(zip(asks, results)):
        np.testing.assert_array_equal(r.node_rows, ref_ch[gi, : a.count])
        np.testing.assert_array_equal(r.overflow_rows, ref_ch[gi, a.count :])
        np.testing.assert_allclose(r.scores, ref_sc[gi, : a.count], rtol=RTOL, atol=ATOL)


def _score_inputs(seed=9):
    ct, asks = _config2(seed)
    rng = np.random.default_rng(seed)
    for c in ("job_counts", "penalty", "affinity"):
        _knobs(ct, asks, rng, c)
    asks[0].distinct_hosts = True
    b = _dense(ct, asks)
    b.pop("slot_caps")
    tp = rng.choice([0.0, 0.25, 0.5, 1.0], b["eligible"].shape).astype(np.float32)
    return ct, b, tp


@pytest.mark.parametrize("with_throughputs", [False, True])
@pytest.mark.parametrize("spread", [False, True])
def test_score_matrix_matches_reference(with_throughputs, spread):
    ct, b, tp = _score_inputs()
    tp = tp if with_throughputs else None
    order = [
        "asks", "eligible", "job_counts", "desired_totals", "penalty_nodes",
        "affinity_scores", "has_affinities", "distinct_hosts",
    ]
    ref_f, ref_fits = ref_score.score_matrix_kernel.jitted(
        ct.capacity, ct.used, *[b[key] for key in order],
        jnp.asarray(spread), tp,
    )
    ref_f, ref_fits = np.asarray(ref_f), np.asarray(ref_fits)
    t = torch.from_numpy
    f, fits = port_score.score_matrix(
        t(ct.capacity), t(ct.used), *[t(b[key]) for key in order], spread,
        None if tp is None else t(tp),
    )
    f, fits = f.numpy(), fits.numpy()
    np.testing.assert_array_equal(fits, ref_fits)
    fin = np.isfinite(ref_f)
    assert (np.isfinite(f) == fin).all()
    np.testing.assert_allclose(f[fin], ref_f[fin], rtol=RTOL, atol=ATOL)


def test_score_group_matches_score_matrix_row():
    """score_group (the registry seam) returns one row of score_matrix."""
    from nomad_tpu_torch.interop import asks_from_numpy, cluster_from_numpy
    from nomad_tpu_torch.scheduler.algorithms import score_group
    import dataclasses

    ref_ct, ref_asks = _config2(seed=4)
    ct = cluster_from_numpy(
        {f.name: getattr(ref_ct, f.name) for f in dataclasses.fields(ref_ct)}
    )
    [ga] = asks_from_numpy([dataclasses.asdict(ref_asks[0])])
    finals, fits, ex = score_group(ct, ga, ga.desired_total, explain=True, device="cpu")
    b = _dense(ref_ct, ref_asks[:1])
    b.pop("slot_caps")
    ref_f, ref_fits = ref_score.score_matrix_kernel.jitted(
        ref_ct.capacity, ref_ct.used, *[
            b[key] for key in (
                "asks", "eligible", "job_counts", "desired_totals",
                "penalty_nodes", "affinity_scores", "has_affinities",
                "distinct_hosts",
            )
        ],
        jnp.asarray(False), None,
    )
    np.testing.assert_array_equal(fits, np.asarray(ref_fits)[0])
    fin = np.isfinite(finals)
    np.testing.assert_allclose(finals[fin], np.asarray(ref_f)[0][fin], rtol=RTOL, atol=ATOL)
    assert ex.top_candidates and ex.top_candidates[0].node_row == int(np.argmax(finals))


def test_coupled_groups_raise_not_implemented(monkeypatch):
    """Coupled groups and ``force_scan`` place: the config-3 input, and a
    ``force_scan=True`` kernel on it, give the reference's placements
    (its side under the scoped C-R1 shim of test_torch_e2e.py)."""
    import dataclasses

    import jax
    import jax._src.core

    from nomad_tpu.utils import backend as ref_backend
    from nomad_tpu_torch.interop import asks_from_numpy, cluster_from_numpy

    ct, asks = ref_parity.build_config3(n_nodes=100, n_jobs=1, count=10)
    with monkeypatch.context() as mp:
        mp.setattr(
            jax.core, "trace_state_clean", jax._src.core.trace_state_clean,
            raising=False,
        )
        mp.setattr(ref_backend, "_mesh_config", ref_backend.MeshConfig(None, 1, 1, "test"))
        ref = ref_score.PlacementKernel().place(ct, asks)
        ref_scan = ref_score.PlacementKernel(force_scan=True).place(ct, asks)
    pct = cluster_from_numpy({f.name: getattr(ct, f.name) for f in dataclasses.fields(ct)})
    pasks = asks_from_numpy([dataclasses.asdict(a) for a in asks])
    port = port_score.PlacementKernel(device="cpu").place(pct, pasks)
    port_scan = port_score.PlacementKernel(force_scan=True, device="cpu").place(pct, pasks)
    for r, p in ((ref[0], port[0]), (ref_scan[0], port_scan[0])):
        assert (p.node_rows >= 0).all()
        np.testing.assert_array_equal(p.node_rows, r.node_rows)
        np.testing.assert_array_equal(p.overflow_rows, r.overflow_rows)
        np.testing.assert_allclose(p.scores, r.scores, rtol=RTOL, atol=ATOL)


def test_cpu_tensors_never_launch_kernels():
    before = port_score.place_closed_form.launches
    ct, asks = _config2()
    port_score.PlacementKernel(device="cpu").place(ct, asks)
    assert port_score.place_closed_form.launches == before


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    """On the card: both kernels against their plain versions (the same
    comparison chip_smoke.py makes at the headline shape)."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: the CUDA and Triton kernels run only on the card")
    ct, asks = _config2()
    rng = np.random.default_rng(2)
    for c in ("job_counts", "penalty", "affinity", "slot_caps"):
        _knobs(ct, asks, rng, c)
    b = _dense(ct, asks)
    dev = torch.device("cuda")
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    args = [t(ct.capacity), t(ct.used)] + [t(b[key]) for key in b]
    ch, sc = port_score.place_closed_form(*args, False, 48, 64)
    chp, scp = port_score.place_closed_form_plain(*args, False, 48, 64)
    assert torch.equal(ch, chp)
    fin = torch.isfinite(scp)
    torch.testing.assert_close(sc[fin], scp[fin], rtol=RTOL, atol=ATOL)
    f, fits = port_score.score_matrix(*args[:-1], False)
    fp, fitsp = port_score.component_scores(*args[:-1], False)
    assert torch.equal(fits, fitsp)
    fin = torch.isfinite(fp)
    torch.testing.assert_close(f[fin], fp[fin], rtol=RTOL, atol=ATOL)


def test_group_axis_chunks_give_the_reference_picks(monkeypatch):
    """A pass whose lanes exceed the scratch budget splits the group axis
    into launches of ``chunk`` lanes; every lane still gets the picks the
    reference's one unsplit program gives it."""
    ct, asks = ref_parity.build_config2(n_nodes=300, n_jobs=5, count=40, seed=8)
    kern = port_score.PlacementKernel(device="cpu")
    max_j = kern._max_j(ct, asks)
    k = port_score._steps_bucket(40 + port_score.OVERFLOW_CANDIDATES)
    # room for two lanes per launch: 5 lanes run as 2 + 2 + 1
    monkeypatch.setattr(
        port_score, "SCRATCH_BUDGET_BYTES", 2 * (k * 8 + ct.padded_n * 14)
    )
    launches = []
    real = port_score.place_closed_form
    monkeypatch.setattr(
        port_score, "place_closed_form",
        lambda *a, **kw: launches.append(kw["asks"].shape[0]) or real(*a, **kw),
    )
    results = kern.place(ct, asks)
    assert len(launches) == 3
    padded = ref_score._pad_group_axis(list(asks), ct.padded_n)
    ref_ch, ref_sc = _ref_place(ct, _dense(ct, padded), False, max_j, k, None)
    for gi, (a, r) in enumerate(zip(asks, results)):
        np.testing.assert_array_equal(r.node_rows, ref_ch[gi, : a.count])
        np.testing.assert_array_equal(r.overflow_rows, ref_ch[gi, a.count :])
        np.testing.assert_allclose(r.scores, ref_sc[gi, : a.count], rtol=RTOL, atol=ATOL)
