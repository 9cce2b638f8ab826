"""The hetero pass and the CP and gang auctions on the node-axis mesh, on
the CPU.

Under a CPU mesh (``backend.make_mesh(dp, mp, "cpu")``) ``hetero_place``,
``cp_place``, ``cp_gang_place`` and ``cp_gang_place_ids`` take inputs laid
out as the reference lays them (``nomad_tpu/scheduler/hetero.py`` and
``nomad_tpu/scheduler/cp.py``, their ``shard_put`` calls) and run the
sharded algorithm through the plain versions of its kernels: every
cell's candidates (``hetero_shard_step_plain``, ``cp_shard_claim_plain``),
one merge a step or round on the mesh lead over every group
(``hetero_step_merge_plain``, ``cp_round_merge_plain``) and every cell's
apply or settle (``hetero_shard_apply_plain``, ``cp_shard_settle_plain``),
each plain call filed under the "shard" or "merge" layout
(``backend.mesh_layouts``). Held here:

- each pass (hetero under its three policies) at 1x2, 1x4, 2x2, 2x4, 1x8
  and 4x2 against the one-device plain version and the reference's NumPy
  oracle (``oracle_hetero_place``, ``oracle_cp_place``,
  ``oracle_cp_gang_place``), and only the "shard" / "merge" layouts;
- a node axis the mesh does not divide runs the one-device pass,
  "gathered";
- the edge cases, one test each: equal keys on nodes in two cells, a
  group whose every feasible node lies in one cell, G not divisible by
  dp, negative hetero asks, a gang whose rack spans two cells, claimants
  that all price at -inf, and ``rounds`` and ``waits`` under contention;
- a ``hypothesis`` property over small random shapes and meshes;
- the kernel objects (``make_kernel(..., mesh=)``) against the unsharded
  objects and the reference's.

Tolerance: every output bit for bit (uint32 views) against the one-device
plain version and the reference's oracle; against the reference's kernel
objects node rows exactly and the score-matrix-derived slot scores within
``rtol=1e-5, atol=1e-6`` (``exp`` differs by an ulp between the
runtimes). The card's tests of the kernels are in
``tests/test_torch_mesh_card.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from test_torch_hetero import assert_bits_equal
from test_torch_mesh_plugins import _port, traced

from nomad_tpu.device import cp as ref_cp
from nomad_tpu.scheduler import cp as ref_scp
from nomad_tpu.scheduler import hetero as ref_hetero
from nomad_tpu.scheduler.algorithms import make_kernel as ref_make_kernel
from nomad_tpu_torch import backend
from nomad_tpu_torch.device import cp as C
from nomad_tpu_torch.scheduler import hetero as H
from nomad_tpu_torch.scheduler.algorithms import make_kernel

MESHES = [(1, 2), (1, 4), (2, 2), (2, 4), (1, 8), (4, 2)]
POLICIES = sorted(H.POLICY_IDS)
RTOL, ATOL = 1e-5, 1e-6
# the reference's layouts (its shard_put calls); () = on the lead
HETERO_AXES = (("nodes",), ("nodes",), ("groups",), ("groups",), ("groups", "nodes"),
               ("groups", "nodes"), ("groups",), ())
CP_AXES = (("nodes",), ("nodes",), ("groups",), ("groups",), ("groups", "nodes"),
           ("groups", "nodes"), ("groups",), ("groups", "nodes"), ("groups",), (), ())
WEIGHT_AXES = ((), (), (), ())
LAYOUTS = {
    "hetero": {"hetero_shard_step:shard", "hetero_step_merge:merge", "hetero_shard_apply:shard"},
    "cp": {"cp_shard_claim:shard", "cp_round_merge:merge", "cp_shard_settle:shard"},
}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _put(xs, axes, cfg):
    return [backend.shard_put(x, ax, cfg) for x, ax in zip(xs, axes)]


def _assert_sharded_layouts(kind):
    """The pass's launches are all the mesh kernels' ("shard" / "merge")."""
    got = set(backend.mesh_layouts())
    assert got == LAYOUTS[kind], got


# -- the cases -----------------------------------------------------------------------


@dataclasses.dataclass
class Hetero:
    args: list  # the eight inputs, host arrays
    steps: int
    max_c: int


@dataclasses.dataclass
class Cp:
    args: list  # the eleven inputs of cp_place (lam0 last), host arrays
    steps: int
    max_c: int
    gang: list = None  # gang, w_rack, w_pod, w_ici, rack_oh, pod_oh, ici_oh
    level_ids: np.ndarray = None
    widths: tuple = None


def hetero_case(n=48, jobs=8, count=4, seed=11) -> Hetero:
    ct = ref_hetero.build_mixed_fleet(n, seed=seed)
    asks = ref_hetero.build_mixed_asks(ct, jobs, count, seed=seed + 1)
    b = ref_hetero.build_hetero_batch(ct, asks)
    return Hetero([b.capacity, b.used, b.asks, b.counts, b.eligible, b.tp, b.tpmax, b.cost],
                  b.steps, b.max_c)


def cp_case(n=64, jobs=6, count=6, seed=7, monkeypatch=None) -> Cp:
    ct = ref_hetero.build_mixed_fleet(n, seed=seed)
    asks = ref_scp.build_cp_asks(ct, jobs, count, seed=seed + 1)
    with traced(monkeypatch):
        b = ref_scp.build_cp_batch(ct, asks)
    return Cp([b.capacity, b.used, b.asks, b.counts, b.eligible, b.scores, b.prio,
               b.job_counts, b.distinct, b.jobgrp, b.lam0], b.steps, b.max_c)


def gang_case(n=64, jobs=4, groups=3, seed=7, monkeypatch=None) -> Cp:
    ct = ref_scp.build_topo_fleet(n, seed=seed)
    asks = ref_scp.build_gang_asks(ct, jobs, groups, seed=seed + 1)
    with traced(monkeypatch):
        b = ref_scp.build_cp_batch(ct, asks)
    gi = ref_scp.build_gang_inputs(ct, asks)
    c = Cp([b.capacity, b.used, b.asks, b.counts, b.eligible, b.scores, b.prio,
            b.job_counts, b.distinct, b.jobgrp, b.lam0], b.steps, b.max_c)
    return _with_gang(c, gi.gang, gi.w_rack, gi.w_pod, gi.w_ici,
                      [gi.rack_oh, gi.pod_oh, gi.ici_oh])


def _with_gang(c: Cp, gang, w_rack, w_pod, w_ici, onehots) -> Cp:
    c.gang = [gang, w_rack, w_pod, w_ici, *onehots]
    c.level_ids = np.stack([
        np.where(oh.any(axis=1), oh.argmax(axis=1), 0) for oh in onehots
    ]).astype(np.int32)
    c.widths = tuple(int(oh.shape[1]) for oh in onehots)
    return c


# -- the passes, three ways ----------------------------------------------------------


def hetero_three(h: Hetero, policy: str, cfg):
    """(sharded, one-device plain, oracle) outputs of one hetero case."""
    pid = H.POLICY_IDS[policy]
    one = H.hetero_place(*[_t(a) for a in h.args], pid, h.steps, h.max_c)
    oracle = ref_hetero.oracle_hetero_place(*h.args, pid, h.steps, h.max_c)
    backend.reset_mesh_layouts()
    got = H.hetero_place(*_put(h.args, HETERO_AXES, cfg), pid, h.steps, h.max_c)
    return got, one, oracle


def cp_three(c: Cp, cfg):
    one = C.cp_place(*[_t(a) for a in c.args], c.steps, c.max_c)
    oracle = ref_cp.oracle_cp_place(*c.args, c.steps, c.max_c)
    backend.reset_mesh_layouts()
    got = C.cp_place(*_put(c.args, CP_AXES, cfg), c.steps, c.max_c)
    return got, one, oracle


def gang_three(c: Cp, cfg, ids: bool):
    """The gang auction, one-hot (``ids`` False) or id form."""
    oracle = ref_cp.oracle_cp_gang_place(*c.args[:10], *c.gang, c.args[10], c.steps, c.max_c)
    common = [_t(a) for a in c.args]
    sharded = _put(c.args, CP_AXES, cfg)
    weights = [_t(w) for w in c.gang[:4]]
    if ids:
        one = C.cp_gang_place_ids(*common[:10], *weights, _t(c.level_ids), c.widths,
                                  common[10], c.steps, c.max_c)
        backend.reset_mesh_layouts()
        got = C.cp_gang_place_ids(
            *sharded[:10], *_put(c.gang[:4], WEIGHT_AXES, cfg),
            backend.shard_put(c.level_ids, (None, "nodes"), cfg), c.widths, sharded[10],
            c.steps, c.max_c,
        )
    else:
        one = C.cp_gang_place(*common[:10], *weights, *[_t(oh) for oh in c.gang[4:]],
                              common[10], c.steps, c.max_c)
        backend.reset_mesh_layouts()
        got = C.cp_gang_place(
            *sharded[:10], *_put(c.gang[:4], WEIGHT_AXES, cfg),
            *_put(c.gang[4:], (("nodes",),) * 3, cfg), sharded[10], c.steps, c.max_c,
        )
    return got, one, oracle


def _check(got, one, oracle, what):
    assert_bits_equal(got, [x.numpy() for x in one], f"{what}: sharded vs one device")
    assert_bits_equal(got, [np.asarray(x) for x in oracle], f"{what}: sharded vs the oracle")


# -- every pass under every mesh --------------------------------------------------------


class TestPassesSharded:
    @pytest.mark.parametrize("policy", POLICIES)
    @pytest.mark.parametrize("dp,mp", MESHES)
    def test_hetero(self, policy, dp, mp):
        got, one, oracle = hetero_three(hetero_case(), policy, backend.make_mesh(dp, mp, "cpu"))
        _check(got, one, oracle, f"hetero {policy} {dp}x{mp}")
        _assert_sharded_layouts("hetero")

    @pytest.mark.parametrize("dp,mp", MESHES)
    def test_cp(self, dp, mp, monkeypatch):
        got, one, oracle = cp_three(cp_case(monkeypatch=monkeypatch),
                                    backend.make_mesh(dp, mp, "cpu"))
        _check(got, one, oracle, f"cp {dp}x{mp}")
        _assert_sharded_layouts("cp")

    @pytest.mark.parametrize("ids", [False, True], ids=["onehot", "ids"])
    @pytest.mark.parametrize("dp,mp", MESHES)
    def test_gang(self, dp, mp, ids, monkeypatch):
        got, one, oracle = gang_three(gang_case(monkeypatch=monkeypatch),
                                      backend.make_mesh(dp, mp, "cpu"), ids)
        _check(got, one, oracle, f"gang {dp}x{mp}")
        _assert_sharded_layouts("cp")


class TestNonDividingAxis:
    @pytest.mark.parametrize("kind", ["hetero", "cp", "gang"])
    def test_runs_gathered(self, kind, monkeypatch):
        """60 nodes under 1x8: the one-device pass on the lead, filed
        "gathered"; outputs as without the mesh."""
        cfg = backend.make_mesh(1, 8, "cpu")
        if kind == "hetero":
            h = hetero_case()
            h.args = [a[:60] if i in (0, 1) else a[:, :60] if i in (4, 5) else
                      a[:60] if i == 7 else a for i, a in enumerate(h.args)]
            got, one, oracle = hetero_three(h, "maxmin", cfg)
            name = "hetero_place"
        else:
            c = cp_case(monkeypatch=monkeypatch) if kind == "cp" else gang_case(
                monkeypatch=monkeypatch)
            c.args = [a[:60] if i in (0, 1, 10) else a[:, :60] if i in (4, 5, 7) else a
                      for i, a in enumerate(c.args)]
            if kind == "cp":
                got, one, oracle = cp_three(c, cfg)
                name = "cp_place"
            else:
                _with_gang(c, *c.gang[:4], [oh[:60] for oh in c.gang[4:]])
                got, one, oracle = gang_three(c, cfg, ids=True)
                name = "cp_gang_place"  # the id form's launches count there
        _check(got, one, oracle, f"{kind} gathered")
        assert backend.mesh_layouts() == {f"{name}:gathered": 1}


# -- the edge cases ---------------------------------------------------------------------


def _edge_hetero(case):
    """A small hetero batch (16 nodes, 4 groups) bent into one edge case."""
    rng = np.random.default_rng(5)
    n, g = 16, 4
    capacity = np.tile(np.array([4000, 8192, 1e5, 1000], np.float32), (n, 1))
    used = np.zeros((n, 4), np.float32)
    asks = np.tile(np.array([1000, 1024, 100, 0], np.float32), (g, 1))
    counts = np.full(g, 5, np.int32)
    eligible = np.ones((g, n), bool)
    tp = rng.choice([0.5, 1.0, 2.0], size=(g, n)).astype(np.float32)
    cost = rng.choice([1.0, 2.0], size=n).astype(np.float32)
    if case == "tie_across_cells":
        tp[:] = 1.0  # every node ties: the lowest global node wins, cell after cell
        cost[:] = 1.0
    elif case == "feasible_in_one_cell":
        eligible[:, : n - 4] = False  # only the last cell of 1x4 holds nodes
    elif case == "groups_not_divisible":
        g = 3
        asks, counts, eligible, tp = asks[:g], counts[:g], eligible[:g], tp[:g]
    elif case == "negative_asks":
        asks[1, 0] = -1500.0  # group 1 frees cpu where it lands
        asks[2, 1] = -2048.0
        capacity[::3, 0] = 1500.0
    tpmax = np.where(eligible, tp, 0).max(axis=1).astype(np.float32)
    return Hetero([capacity, used, asks, counts, eligible, tp, tpmax, cost], 32, 8)


def _edge_cp(case):
    """A small CP batch (16 nodes, 6 groups) bent into one edge case."""
    rng = np.random.default_rng(9)
    n, g = 16, 6
    capacity = np.tile(np.array([4000, 8192, 1e5, 1000], np.float32), (n, 1))
    used = np.zeros((n, 4), np.float32)
    asks = np.tile(np.array([1500, 2048, 100, 0], np.float32), (g, 1))
    counts = np.full(g, 3, np.int32)
    eligible = np.ones((g, n), bool)
    scores = (rng.integers(0, 8, size=(g, n)) / 8).astype(np.float32)
    prio = np.full(g, 50.0, np.float32)
    job_counts = np.zeros((g, n), np.int32)
    distinct = np.zeros(g, bool)
    jobgrp = np.array([0, 0, 1, 1, 2, 3], np.int32)
    lam0 = np.zeros(n, np.float32)
    if case == "tie_across_cells":
        scores[:] = 0.5
    elif case == "feasible_in_one_cell":
        eligible[:, :12] = False
    elif case == "groups_not_divisible":
        g = 5
        asks, counts, eligible, scores, prio, job_counts, distinct, jobgrp = (
            x[:g] for x in (asks, counts, eligible, scores, prio, job_counts, distinct, jobgrp))
    elif case == "claims_at_minus_inf":
        scores[:, :] = -np.inf  # every claimant prices at -inf: node 0, group 0's rule
        eligible[:, :2] = False
    elif case == "contention":
        eligible[:, 4:] = False  # six groups on four nodes: waits, many rounds
        prio[::2] = 70.0
        distinct[1] = True
    steps = 64
    return Cp([capacity, used, asks, counts, eligible, scores, prio, job_counts, distinct,
               jobgrp, lam0], steps, 4)


def _edge_gang(case):
    c = _edge_cp("contention" if case == "contention" else "tie_across_cells"
                 if case == "tie_across_cells" else "none")
    g, n = c.args[5].shape
    gang = np.array([1, 1, 1, 2, 2, 0], np.int32)[:g]
    w_rack = np.array([1.0, 1.0, 1.0, -0.5, -0.5, 0.0], np.float32)[:g]
    w_pod = np.full(g, 0.25, np.float32)
    w_ici = np.array([0.5, 0.5, 0.5, 0.0, 0.0, 0.0], np.float32)[:g]
    rack = np.zeros(n, np.int32)
    rack[2:10] = 1  # rack 1 spans the cells of 1x2, 1x4 and 1x8
    rack[10:] = 2
    pod = np.ones(n, np.int32)
    ici = 1 + np.arange(n) % 3
    onehots = []
    for ids, w in ((rack, 4), (pod, 2), (ici, 4)):
        oh = np.zeros((n, w), np.int32)
        oh[np.arange(n)[ids > 0], ids[ids > 0]] = 1
        onehots.append(oh)
    return _with_gang(c, gang, w_rack, w_pod, w_ici, onehots)


EDGE_MESHES = [(1, 2), (1, 4), (2, 2), (2, 4), (1, 8)]


class TestEdgeCases:
    @pytest.mark.parametrize("policy", POLICIES)
    @pytest.mark.parametrize("case", ["tie_across_cells", "feasible_in_one_cell",
                                      "groups_not_divisible", "negative_asks"])
    def test_hetero(self, case, policy):
        h = _edge_hetero(case)
        for dp, mp in EDGE_MESHES:
            got, one, oracle = hetero_three(h, policy, backend.make_mesh(dp, mp, "cpu"))
            _check(got, one, oracle, f"hetero {case} {policy} {dp}x{mp}")
            _assert_sharded_layouts("hetero")
        assert (one[0] >= 0).sum() > 0

    @pytest.mark.parametrize("case", ["tie_across_cells", "feasible_in_one_cell",
                                      "groups_not_divisible", "claims_at_minus_inf",
                                      "contention"])
    def test_cp(self, case):
        c = _edge_cp(case)
        for dp, mp in EDGE_MESHES:
            got, one, oracle = cp_three(c, backend.make_mesh(dp, mp, "cpu"))
            _check(got, one, oracle, f"cp {case} {dp}x{mp}")
            _assert_sharded_layouts("cp")
        assert int(one[3]) >= 1
        if case == "claims_at_minus_inf":
            assert int(one[0][0, 0]) == 0  # group 0 took node 0, as the reference does

    @pytest.mark.parametrize("case", ["rack_across_cells", "contention", "tie_across_cells"])
    def test_gang(self, case):
        c = _edge_gang(case)
        for dp, mp in EDGE_MESHES:
            for ids in (False, True):
                got, one, oracle = gang_three(c, backend.make_mesh(dp, mp, "cpu"), ids)
                _check(got, one, oracle, f"gang {case} {dp}x{mp} ids={ids}")
                _assert_sharded_layouts("cp")
        if case == "contention":
            assert int(one[5].sum()) > 0 and int(one[3]) > 1  # waits and rounds count


# -- a property over small shapes ---------------------------------------------------------


@settings(max_examples=30, deadline=None, derandomize=True)
@given(
    seed=st.integers(0, 2**16),
    n=st.sampled_from([8, 16]),
    g=st.integers(1, 6),
    mesh=st.sampled_from([(1, 2), (2, 2), (1, 4), (2, 4), (3, 2)]),
    policy=st.sampled_from(POLICIES),
)
def test_property_sharded_equals_one_device(seed, n, g, mesh, policy):
    """Random small batches with coarse values (so ties are common),
    negative asks now and then: every pass's sharded outputs equal its
    one-device plain outputs, bit for bit."""
    rng = np.random.default_rng(seed)
    cfg = backend.make_mesh(*mesh, "cpu")
    capacity = rng.choice([2.0, 4.0, 8.0], size=(n, 4)).astype(np.float32)
    used = rng.choice([0.0, 1.0], size=(n, 4)).astype(np.float32)
    asks = rng.choice([-1.0, 0.0, 1.0, 2.0], size=(g, 4), p=[0.1, 0.3, 0.4, 0.2]).astype(
        np.float32)
    counts = rng.integers(0, 5, size=g).astype(np.int32)
    eligible = rng.random((g, n)) < 0.7
    tp = rng.choice([0.0, 1.0, 2.0], size=(g, n)).astype(np.float32)
    tpmax = np.where(eligible, tp, 0).max(axis=1).astype(np.float32)
    cost = rng.choice([1.0, 2.0], size=n).astype(np.float32)
    h = Hetero([capacity, used, asks, counts, eligible, tp, tpmax, cost], 32, 4)
    got, one, _ = hetero_three(h, policy, cfg)
    assert_bits_equal(got, [x.numpy() for x in one], "hetero property")
    c = Cp([capacity, used, np.abs(asks), counts, eligible,
            rng.choice([0.0, 0.25, 0.5], size=(g, n)).astype(np.float32),
            rng.choice([10.0, 20.0], size=g).astype(np.float32),
            rng.integers(0, 2, size=(g, n)).astype(np.int32), rng.random(g) < 0.3,
            rng.integers(0, 3, size=g).astype(np.int32),
            rng.choice([0.0, 0.125], size=n).astype(np.float32)], 32, 4)
    got, one, _ = cp_three(c, cfg)
    assert_bits_equal(got, [x.numpy() for x in one], "cp property")


# -- the kernel objects -------------------------------------------------------------------


class TestKernelObjects:
    @pytest.mark.parametrize("name", ["hetero-maxmin", "hetero-makespan", "hetero-cost",
                                      "cp-pack", "cp-gang"])
    @pytest.mark.parametrize("dp,mp", [(1, 4), (2, 4)])
    def test_make_kernel_under_mesh(self, name, dp, mp, monkeypatch):
        """The kernel object under the mesh places as the unsharded object
        and the reference's object, and its plugin pass runs sharded."""
        if name == "cp-gang":
            ct = ref_scp.build_topo_fleet(64, seed=7)
            asks = ref_scp.build_gang_asks(ct, 4, 3, seed=8)
        else:
            ct = ref_hetero.build_mixed_fleet(64, seed=7)
            asks = (ref_hetero.build_mixed_asks(ct, 6, 5, seed=8) if name.startswith("hetero")
                    else ref_scp.build_cp_asks(ct, 6, 6, seed=8))
        with traced(monkeypatch):
            ref = ref_make_kernel(name).place(ct, asks)
        one = make_kernel(name, mesh=backend.MeshConfig(None, 1, 1, "test"),
                          device="cpu").place(*_port(ct, asks))
        backend.reset_mesh_layouts()
        got = make_kernel(name, mesh=backend.make_mesh(dp, mp, "cpu"),
                          device="cpu").place(*_port(ct, asks))
        kind = "hetero" if name.startswith("hetero") else "cp"
        assert LAYOUTS[kind] <= set(backend.mesh_layouts()), backend.mesh_layouts()
        assert not any(k.endswith(":gathered") for k in backend.mesh_layouts())
        assert len(got) == len(one) == len(ref)
        for g, o, r in zip(got, one, ref):
            np.testing.assert_array_equal(g.node_rows, o.node_rows)
            np.testing.assert_array_equal(np.asarray(g.scores, np.float32).view(np.uint32),
                                          np.asarray(o.scores, np.float32).view(np.uint32))
            np.testing.assert_array_equal(g.node_rows, r.node_rows)
            np.testing.assert_allclose(g.scores, r.scores, rtol=RTOL, atol=ATOL)
