"""The batched scoring of a CP pass (``score_groups``, called by
``build_cp_batch``) on the CPU.

A pass scores every ask against one cluster snapshot in one
``score_matrix`` launch (two where only some asks carry a throughput
axis: with and without it). Held here:

- ``build_cp_batch`` gives arrays identical to the per-ask
  ``score_group`` loop it replaced, and to the reference's
  ``build_cp_batch``, on a cp-pack, a cp-gang and a mixed-throughput
  ask list;
- the plain ``score_matrix`` at G > 1 gives the rows of G = 1 calls, bit
  for bit;
- one pass makes one ``score_matrix`` call, two with mixed throughputs.

Tolerance: the port's own arrays bit for bit (uint32 views of the
scores). Against the reference the score rows agree within ``rtol=1e-5,
atol=1e-6`` (XLA's ``exp`` against PyTorch's, test_torch_score.py's
bar) and every other array exactly. Reference calls through
``traced_jit`` run inside the scoped monkeypatch (ROADMAP C-R1).
"""

import dataclasses

import numpy as np
import pytest
import torch

from nomad_tpu.scheduler import cp as ref_scp
from nomad_tpu.scheduler import hetero as ref_hetero
from nomad_tpu_torch import interop
from nomad_tpu_torch.device import score as port_score
from nomad_tpu_torch.scheduler import algorithms as port_algorithms
from nomad_tpu_torch.scheduler import cp as port_scp
from test_torch_hetero import ATOL, RTOL, reference_runtime

BATCH_FIELDS = ("capacity", "used", "asks", "counts", "eligible", "scores", "prio",
                "job_counts", "distinct", "jobgrp", "lam0")


def _cp_pack():
    ct = ref_hetero.build_mixed_fleet(96, seed=8)
    asks = ref_scp.build_cp_asks(ct, 6, 5, seed=9)
    for a in asks:  # uniform: every ask scores without a throughput axis
        a.throughputs, a.has_throughputs = None, False
    return ct, asks


def _cp_gang():
    ct = ref_scp.build_topo_fleet(96, seed=5)
    return ct, ref_scp.build_gang_asks(ct, 4, 3, seed=6)


def _mixed():
    """The hetero profiles (TPU-hungry, GPU-leaning, indifferent), one ask
    whose best eligible class rates 0 (scored without the axis, as
    ``score_group`` does), affinities and job counts on some rows."""
    ct = ref_hetero.build_mixed_fleet(96, seed=3)
    asks = ref_scp.build_cp_asks(ct, 8, 4, seed=4)
    rng = np.random.default_rng(5)
    zero = next(a for a in asks if a.has_throughputs)
    zero.throughputs = np.zeros_like(zero.throughputs)
    for a in asks[::3]:
        a.has_affinities = True
        a.affinity_scores = rng.choice([-0.5, 0.0, 0.5], ct.padded_n).astype(np.float32)
        a.job_counts = (rng.random(ct.padded_n) < 0.2).astype(np.int32) * ct.ready
        a.penalty_nodes = (rng.random(ct.padded_n) < 0.1) & ct.ready
    return ct, asks


CASES = {"cp_pack": _cp_pack, "cp_gang": _cp_gang, "mixed": _mixed}


def _to_port(ct, asks):
    return (
        interop.cluster_from_numpy(dataclasses.asdict(ct)),
        interop.asks_from_numpy([dataclasses.asdict(a) for a in asks]),
    )


def _per_ask_batch(ct, asks):
    """build_cp_batch's score rows as the per-ask score_group loop made
    them."""
    scores = np.zeros((len(asks), ct.padded_n), dtype=np.float32)
    eligible = np.stack([a.eligible for a in asks]).copy()
    for i, a in enumerate(asks):
        finals, fits = port_algorithms.score_group(
            ct, a, float(a.desired_total), device="cpu"
        )
        scores[i] = np.where(fits, finals, np.float32(0.0))
        eligible[i] &= fits
    return scores, eligible


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x


@pytest.mark.parametrize("case", list(CASES))
def test_build_cp_batch_matches_per_ask_scoring_and_reference(monkeypatch, case):
    ct, asks = CASES[case]()
    pct, pasks = _to_port(ct, asks)
    got = port_scp.build_cp_batch(pct, pasks, device="cpu")
    scores, eligible = _per_ask_batch(pct, pasks)
    np.testing.assert_array_equal(_bits(got.scores), _bits(scores))
    np.testing.assert_array_equal(got.eligible, eligible)
    assert got.scores.dtype == np.float32 and got.eligible.dtype == bool

    with reference_runtime(monkeypatch):
        ref = ref_scp.build_cp_batch(ct, asks)
    for name in BATCH_FIELDS:
        g, r = getattr(got, name), np.asarray(getattr(ref, name))
        assert g.shape == r.shape and g.dtype == r.dtype, name
        if name == "scores":
            np.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL)
        else:
            np.testing.assert_array_equal(g, r, err_msg=name)
    assert (got.steps, got.max_c) == (ref.steps, ref.max_c)
    assert got.eligible.any(axis=1).all()


@pytest.mark.parametrize("with_tp", [False, True])
@pytest.mark.parametrize("spread", [False, True])
def test_score_matrix_rows_at_g_equal_g1_calls(with_tp, spread):
    """The plain score matrix at G 7 gives, row for row, what seven G = 1
    calls give (the batched call replaces the per-ask loop)."""
    rng = np.random.default_rng(11)
    g, n = 7, 64
    cap = np.tile(np.array([4000, 8192, 102400, 1000], np.float32), (n, 1))
    cap[::5, 0] = 0.0  # a dimension without capacity: fraction 1
    used = np.floor(cap * rng.uniform(0.0, 0.9, (n, 1))).astype(np.float32)
    args = [
        cap, used,
        rng.choice([250.0, 500.0, 1000.0], (g, 4)).astype(np.float32),
        rng.random((g, n)) < 0.9,
        ((rng.random((g, n)) < 0.3) * rng.integers(1, 3, (g, n))).astype(np.int32),
        rng.integers(0, 40, g).astype(np.float32),
        rng.random((g, n)) < 0.1,
        rng.choice([-0.5, 0.0, 0.5], (g, n)).astype(np.float32),
        rng.random(g) < 0.5,
        rng.random(g) < 0.3,
    ]
    tp = rng.choice([0.0, 0.25, 0.5, 1.0], (g, n)).astype(np.float32) if with_tp else None
    t = torch.from_numpy
    f, ok = port_score.score_matrix(*[t(a) for a in args], spread,
                                    None if tp is None else t(tp))
    for i in range(g):
        row = [a if a.shape == (n, 4) else a[i:i + 1] for a in args]
        fi, oki = port_score.score_matrix(*[t(np.ascontiguousarray(a)) for a in row], spread,
                                          None if tp is None else t(tp[i:i + 1]))
        np.testing.assert_array_equal(_bits(f[i:i + 1].numpy()), _bits(fi.numpy()))
        np.testing.assert_array_equal(ok[i:i + 1].numpy(), oki.numpy())
    assert ok.any() and not ok.all()


@pytest.mark.parametrize("case,launches", [("cp_pack", 1), ("cp_gang", 1), ("mixed", 2)])
def test_one_pass_makes_one_score_matrix_call(monkeypatch, case, launches):
    """A pass's asks go to ``score_matrix`` together: one call, two where
    only some asks carry throughputs; ``score_group`` stays one call an
    ask."""
    ct, asks = CASES[case]()
    pct, pasks = _to_port(ct, asks)
    calls = []
    real = port_score.score_matrix

    def counting(*args, **kwargs):
        calls.append(args[2].shape[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(port_score, "score_matrix", counting)
    port_scp.build_cp_batch(pct, pasks, device="cpu")
    assert len(calls) == launches and sum(calls) == len(pasks)
    calls.clear()
    port_algorithms.score_group(pct, pasks[0], 4, device="cpu")
    assert calls == [1]
