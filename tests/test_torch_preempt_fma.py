"""The find pass's distance: ``fma_square_add``, the port's float32
``fma(x, x, acc)``, against the exact result (``fractions.Fraction``
rounded once to float32, ties to even) on random and adversarial inputs,
and ``resource_distance`` bit for bit against the reference's jitted
``jnp.sum(rel * rel, axis=-1)``, a chain of fused multiply-adds on the
CPU (ROADMAP C-P3). No tolerance: both must be exact."""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomad_tpu.device import preempt as ref_preempt
from nomad_tpu_torch.device import preempt as port_preempt
from test_torch_preempt import _inputs, _wide_inputs

F32 = np.float32


def _round_f32(q: Fraction) -> np.float32:
    """The float32 nearest the exact ``q``, ties to the even significand."""
    guess = F32(float(q))  # within one float32 ulp of q
    cands = {guess, np.nextafter(guess, F32(np.inf)), np.nextafter(guess, F32(-np.inf))}
    best = min(cands, key=lambda c: (abs(Fraction(float(c)) - q),
                                     int(np.array(c, F32).view(np.uint32)) & 1))
    return F32(best)


def _exact(x, acc):
    return np.array([_round_f32(Fraction(float(a)) ** 2 + Fraction(float(c)))
                     for a, c in zip(x, acc)], F32)


def _port(x, acc):
    return port_preempt.fma_square_add(torch.from_numpy(x), torch.from_numpy(acc)).numpy()


def _assert_bits(got, want):
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3, 1e12])
def test_fma_square_add_is_one_rounding_on_random_inputs(scale):
    rng = np.random.default_rng(int(scale * 7) % 1000 + 5)
    x = (rng.standard_normal(4000) * scale).astype(F32)
    acc = (rng.standard_normal(4000) * scale ** 2).astype(F32)
    acc[::3] = np.abs(acc[::3])
    _assert_bits(_port(x, acc), _exact(x, acc))


def test_fma_square_add_on_half_way_and_exponent_gap_inputs():
    """x = odd / 4,096 with its square a float32 tie (odd^2 is odd and x^2 lies in [1, 2),
    so x^2 lies half-way between two float32s), plus an acc far below it
    that decides the tie: a float64 sum rounded to nearest lands on the
    tie and a second rounding to even goes the wrong way; rounding to odd
    does not. Also sums that cancel to a float32 exactly, zeros,
    subnormal accs and accs far above the square."""
    odd = np.arange(4097, 5793, 2)
    x = (odd / 4096).astype(F32)
    assert all(Fraction(float(v)) ** 2 * 2 ** 23 % 1 == Fraction(1, 2) for v in x)
    xs, accs = [], []
    for e in (-30, -60, -80, -120, -140):
        for sign in (1.0, -1.0):
            xs.append(x)
            accs.append(np.full(x.shape, sign * 2.0 ** e, F32))
    gap = np.array([1.0, 3.0, 2.0 ** 20, 2.0 ** -20, 0.0, 1e-45, -1e-45, 1e18], F32)
    xs.append(np.repeat(gap, gap.size))
    accs.append(np.tile(gap, gap.size))
    cancel = np.array([1.5, 3.0, 0.1], F32)
    xs.append(cancel)
    accs.append(-(cancel.astype(np.float64) ** 2).astype(F32))
    xs.append(np.array([0.0, -0.0, 2.0 ** -70], F32))
    accs.append(np.array([0.0, 0.0, 2.0 ** -126], F32))
    x_all, acc_all = np.concatenate(xs), np.concatenate(accs)
    want = _exact(x_all, acc_all)
    _assert_bits(_port(x_all, acc_all), want)
    naive = ((x_all.astype(np.float64) ** 2) + acc_all.astype(np.float64)).astype(F32)
    assert (naive.view(np.uint32) != want.view(np.uint32)).any()  # the cases bite


def _ref_distance(ask, res):
    with jax.default_device(jax.devices("cpu")[0]):
        fn = jax.jit(ref_preempt.resource_distance)
        return np.asarray(fn(jnp.asarray(ask)[None, None, :], jnp.asarray(res)))


@pytest.mark.parametrize("make", [
    lambda: _wide_inputs(196_609, n=2, seed=13),
    lambda: _inputs("random", 8192, n=12, seed=11),
    lambda: _inputs("random", 64, n=96, seed=2),
], ids=["wide_196609", "v8192", "v64"])
def test_resource_distance_matches_reference_bit_for_bit(make):
    args = make()
    ask, res = args[2], args[4]
    got = port_preempt.resource_distance(torch.from_numpy(ask)[None, None, :],
                                         torch.from_numpy(res)).numpy()
    _assert_bits(got, _ref_distance(ask, res))


@pytest.mark.parametrize("make", [
    lambda: _inputs("random", 8, n=4096, seed=3),
    lambda: _inputs("random", 1025, n=64, seed=3),
    lambda: _wide_inputs(196_608, n=8, seed=13),
], ids=["v8", "v1025", "wide_196608"])
def test_choice_score_has_no_contraction(monkeypatch, make):
    """The choice's score (fit x penalty) holds no multiply-add that XLA
    contracts: the port's plain version equals the reference's jitted
    program bit for bit wherever the two runtimes' ``exp`` agree, which
    is on every node but where the reference's penalty
    ``preemption_score(net)`` itself differs by an ulp (XLA's ``exp``
    against a correctly rounded one; 5 of 64 nodes at V 1,025). Best node,
    feasible, k, net and order are identical."""
    from test_torch_preempt import reference_runtime

    args = make()
    with reference_runtime(monkeypatch):
        ref = [np.asarray(x) for x in ref_preempt.choose_preemption_node_kernel.jitted(*args)]
        ref_penalty = np.asarray(jax.jit(ref_preempt.preemption_score)(ref[3]))
    got = [x.numpy() for x in port_preempt.choose_preemption_node_plain(
        *[torch.from_numpy(np.ascontiguousarray(a)) for a in args])]
    for g, w in zip(got[:5], ref[:5]):
        np.testing.assert_array_equal(g, w)
    port_penalty = port_preempt.preemption_score(torch.from_numpy(ref[3].copy())).numpy()
    exp_differs = port_penalty.view(np.uint32) != ref_penalty.view(np.uint32)
    score_differs = got[5].view(np.uint32) != ref[5].view(np.uint32)
    assert not (score_differs & ~exp_differs).any()
