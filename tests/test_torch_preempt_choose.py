"""The preemption choice kernel's redesign (``csrc/preempt.cu``,
``choose_kernel`` and ``choose_wide_kernel``), modelled in NumPy and
held against ``choose_preemption_node_plain``, on the CPU; the
wrapper's cross-block scratch protocol; and, on the card, calls queued
back to back on one stream.

The model is the kernel's float32 arithmetic order:

- V <= 32: a warp holds 32 / Vp rows (Vp the next power of two of V),
  lane l victim l % Vp of row l / Vp. Every lane loads its 16-byte record
  and mask byte and zeroes an unmasked record by a select; the row's
  freed total is a butterfly over its Vp lanes (offsets Vp / 2 down to
  1, each lane adding its partner's partial sum);
- V > 32: a warp a row, lane l adding victims l, l + 32, ... in order,
  then a butterfly over the 32 lanes;
- the row's score from the freed total as the plain version computes it,
  then the argmax word order_key(score) << 32 | ~row, whose largest is
  the first-index argmax.

Tolerances. On integer-valued resources (MHz, MiB) every partial sum is
an integer below 2^24 and exact in float32 in any order, so the freed
totals, scores and best row equal the plain version's exactly. On
fractional resources the butterfly adds in another order than the plain
version's sum, so a freed total may differ in its last bits: the scores
agree within ``rtol=1e-5, atol=1e-6`` (the tolerance of
``test_torch_preempt.py``), -inf in the same rows, and the best row is
the same wherever the top two scores are further apart than that.
"""

import numpy as np
import pytest
import torch

from nomad_tpu_torch.device import preempt as port_preempt
from test_torch_closed_form_cluster import order_key

RTOL, ATOL = 1e-5, 1e-6
WIDTHS = (1, 8, 32, 33)


def _inputs(v, n=64, seed=0, fractional=False):
    """(capacity, used, ask, eligible, victim_res, victim_prio,
    victim_mask) as numpy: mock-node capacities, 0..V victims a node,
    usage near the fitting edge so that about half the rows are feasible."""
    rng = np.random.default_rng(seed + 97 * v)
    cap = np.tile(np.array([3900, 7936, 98304, 1000], np.float32), (n, 1))
    cap[rng.random(n) < 0.1, 1] = 0.0
    nv = rng.integers(0, v + 1, n)
    mask = np.arange(v)[None, :] < nv[:, None]
    if fractional:
        res = rng.uniform(50.0, 900.0, (n, v, 4)).astype(np.float32)
    else:
        res = np.stack([
            rng.integers(50, 900, (n, v)), rng.integers(64, 2048, (n, v)),
            rng.integers(0, 4000, (n, v)), rng.integers(0, 100, (n, v)),
        ], -1).astype(np.float32)
    prio = rng.choice([10, 20, 30, 40], (n, v)).astype(np.int32)
    res[~mask] = 0.0
    prio[~mask] = 0
    used = (res.sum(axis=1) * rng.uniform(0.3, 1.0, (n, 1))).astype(np.float32)
    used += np.array([100, 256, 4096, 0], np.float32)
    ask = np.array([1000, 1024, 300, 10], np.float32)
    eligible = rng.random(n) < 0.9
    return cap, used, ask, eligible, res, prio, mask


def freed_model(res, mask):
    """The kernel's freed totals [N, 4], in its float32 order of adds."""
    n, v, _ = res.shape
    x = np.where(mask[:, :, None], res, np.float32(0)).astype(np.float32)
    if v <= 32:
        vp = 1 << (v - 1).bit_length()
        lanes = np.zeros((n, vp, 4), np.float32)
        lanes[:, :v] = x
        off = vp // 2
        while off:
            lanes = lanes + lanes[:, np.arange(vp) ^ off]
            off //= 2
        return lanes[:, 0]
    lanes = np.zeros((n, 32, 4), np.float32)
    for i in range(v):  # lane i % 32 adds its victims in index order
        lanes[:, i % 32] = lanes[:, i % 32] + x[:, i]
    off = 16
    while off:
        lanes = lanes + lanes[:, np.arange(32) ^ off]
        off //= 2
    return lanes[:, 0]


def choose_model(args):
    """(best, score) of the kernel: the plain version's score arithmetic on
    the model's freed totals, then the largest argmax word."""
    capacity, used, ask, eligible, res, prio, mask = args
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    feasible, _k, net, _order = port_preempt.find_preemption_plain(*t)
    freed = torch.from_numpy(freed_model(res, mask))
    proposed = t[1] - freed + t[2]
    free_frac = torch.where(
        t[0] > 0, (t[0] - proposed) / torch.clamp(t[0], min=1e-9), 1.0
    )
    fit = port_preempt._div(
        torch.clamp(
            (20.0 - port_preempt._pow10(free_frac[:, 0])) - port_preempt._pow10(free_frac[:, 1]),
            0.0, 18.0,
        ),
        18.0,
    )
    score = torch.where(feasible, fit * port_preempt.preemption_score(net), -torch.inf).numpy()
    words = (order_key(score).astype(np.uint64) << np.uint64(32)) | (
        np.uint64(0xFFFFFFFF) - np.arange(len(score), dtype=np.uint64)
    )
    return int(np.argmax(words)), score


def _plain(args):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    best, feasible, k, net, order, score = port_preempt.choose_preemption_node_plain(*t)
    return int(best), score.numpy()


@pytest.mark.parametrize("v", WIDTHS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_model_equals_plain_on_integer_inputs(v, seed):
    args = _inputs(v, seed=seed)
    best, score = choose_model(args)
    want_best, want_score = _plain(args)
    assert np.isfinite(want_score).any() and np.isneginf(want_score).any()
    np.testing.assert_array_equal(score.view(np.uint32), want_score.view(np.uint32))
    assert best == want_best


@pytest.mark.parametrize("v", WIDTHS)
def test_model_agrees_with_plain_on_fractional_inputs(v):
    args = _inputs(v, seed=5, fractional=True)
    best, score = choose_model(args)
    want_best, want_score = _plain(args)
    np.testing.assert_array_equal(np.isneginf(score), np.isneginf(want_score))
    fin = np.isfinite(want_score)
    np.testing.assert_allclose(score[fin], want_score[fin], rtol=RTOL, atol=ATOL)
    top = np.sort(want_score[fin])[-2:]
    if len(top) < 2 or top[1] - top[0] > ATOL + RTOL * abs(top[1]):
        assert best == want_best


def test_all_infeasible_picks_row_zero():
    args = list(_inputs(8, seed=3))
    args[3] = np.zeros_like(args[3])  # nothing eligible
    best, score = choose_model(args)
    assert np.isneginf(score).all() and best == 0 == _plain(args)[0]


def test_wrapper_keeps_one_scratch_per_stream(monkeypatch):
    """The choice launch zeroes no scratch per call: the first call on a
    stream makes its two zero words, every later call on that stream
    passes the same ones (the kernel leaves them zero), and another
    stream gets its own."""
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in _inputs(8, n=16)]
    feasible, _k, net, _order = port_preempt.find_preemption_plain(*args)
    passed, made = [], []
    stream = {"now": 7}

    def fake_kernel(*a):
        passed.append(a[9])  # the scratch pointer
        return 0

    real_zeros = torch.zeros

    def counting_zeros(*a, **kw):
        made.append(a)
        return real_zeros(*a, **kw)

    monkeypatch.setattr(port_preempt, "_choice_scratch", {})
    monkeypatch.setattr(port_preempt, "_library", lambda *_a: fake_kernel)
    monkeypatch.setattr(port_preempt, "current_stream", lambda dev: stream["now"])
    monkeypatch.setattr(torch, "zeros", counting_zeros)
    before = port_preempt.choose_preemption_node.launches
    for _ in range(3):
        port_preempt.launch_choice(args, feasible, net)
    assert len(set(passed)) == 1 and len(made) == 1
    stream["now"] = 9
    port_preempt.launch_choice(args, feasible, net)
    assert len(set(passed)) == 2 and len(made) == 2
    assert port_preempt.choose_preemption_node.launches == before + 4


def test_wrapper_makes_no_scratch_inside_a_graph_capture(monkeypatch):
    """A stream being captured that has no scratch yet is refused: the
    zeroing would become a node of the graph, in the graph's memory."""
    made = []
    monkeypatch.setattr(port_preempt, "_choice_scratch", {})
    monkeypatch.setattr(port_preempt, "current_stream", lambda dev: 7)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    monkeypatch.setattr(torch, "zeros", lambda *a, **kw: made.append(a))
    with pytest.raises(RuntimeError, match="before capturing"):
        port_preempt._scratch_for(torch.device("cuda", 0))
    assert made == [] and port_preempt._choice_scratch == {}


# -- on the card ----------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("v", WIDTHS)
def test_cuda_calls_back_to_back_match_plain(v):
    """On the card: four calls with different inputs queued on one stream
    with no host sync between them, each identical to the plain version
    (the scratch each launch leaves zero is the next one's)."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: the preemption CUDA kernels run only on the card")
    dev = torch.device("cuda")
    cases = [[torch.from_numpy(np.ascontiguousarray(a)).to(dev)
              for a in _inputs(v, n=n, seed=s)] for n, s in ((4096, 0), (64, 1), (2048, 2), (5, 3))]
    torch.cuda.synchronize()
    got = [port_preempt.choose_preemption_node(*a) for a in cases]
    torch.cuda.synchronize()
    for a, g in zip(cases, got):
        want = port_preempt.choose_preemption_node_plain(*a)
        for x, w in zip(g, want):
            assert torch.equal(x, w.to(x.dtype))


@pytest.mark.cuda
def test_cuda_graph_replays_interleave_with_eager_calls():
    """On the card: a graph of one choice launch, captured on a stream
    after an eager call there, replayed between eager calls with other
    inputs on that stream and no host sync; every result identical to
    the plain version (the replays and the eager calls share the capture
    stream's scratch, one after another)."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: the preemption CUDA kernels run only on the card")
    dev = torch.device("cuda")
    cases = [[torch.from_numpy(np.ascontiguousarray(a)).to(dev)
              for a in _inputs(8, n=n, seed=s)] for n, s in ((4096, 4), (2048, 5), (64, 6))]
    passes = [port_preempt.find_preemption(*a) for a in cases]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graphed, (feasible, _k, net, _order) = cases[0], passes[0]
    with torch.cuda.stream(stream):
        port_preempt.launch_choice(graphed, feasible, net)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        g_best, g_score = port_preempt.launch_choice(graphed, feasible, net)
    want = [port_preempt.choose_preemption_node_plain(*a) for a in cases]
    eager = []
    with torch.cuda.stream(stream):
        for i in (1, 2, 1, 2):
            graph.replay()
            eager.append((i, port_preempt.launch_choice(cases[i], passes[i][0], passes[i][2])))
        graph.replay()
    torch.cuda.synchronize()
    assert int(g_best) == int(want[0][0]) and torch.equal(g_score, want[0][-1])
    for i, (best, score) in eager:
        assert int(best) == int(want[i][0]) and torch.equal(score, want[i][-1])
