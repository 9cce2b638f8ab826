"""The find pass's forms (``csrc/preempt.cu``), modelled in NumPy on the
CPU and held bit for bit against ``find_preemption_plain`` and the
reference's ``find_preemption_kernel`` (reached through ``.jitted``).

Each model is its kernel's algorithm in its float32 order of operations:

- the warp form (V <= 32, ``find_warp_pass``): a warp of 32 / Vp rows,
  one victim a lane; a bitonic network of lane shuffles over each row's
  Vp lanes, then each lane takes its sorted victim's record from the
  lane that holds it (lane seg * Vp + index), a shuffle scan of the
  prefixes (Hillis-Steele, offsets 1, 2, ... inside the segment), and the
  first fitting lane by a ballot;
- a warp a row (32 < Vp <= 1,024, ``find_row_warp_kernel``): lane l loads
  victims l, l + 32, ... and keeps their words as positions l * E + e
  (E = Vp / 32) of one bitonic network, strides below E inside a lane and
  larger ones by shuffles; each lane's run of E sorted positions is
  totalled from the staged records, the runs' totals are scanned over the
  lanes, each lane walks its run from its exclusive prefix, and the first
  lane with a fit (a ballot and ``__ffs``) gives k and net;
- a row over a cluster of S blocks (``find_cluster_kernel``): block r
  holds positions [r * slice, (r + 1) * slice); four stable LSD passes of
  8-bit digits of the 32-bit key: every block's digit counts summed over
  the cluster, a word's position the row's words of lower digits, then
  its digit's words in the slices before its block, then those before it
  in its slice (the warps before it in its round of 512 positions, or of
  1,024, two a thread, in a slice of more than 2,048; the lanes before it
  in its warp: ``__match_any_sync``), a pass skipped where one digit
  holds the whole row; then each block's threads total their runs of the
  sorted slice, a warp scan, a scan of the 16 warps' totals, the slices'
  totals added in block order, each run walked from its prefix, and the
  first fit the least over the cluster.

Tolerances: none. The resources are integers (MHz, MiB), so every prefix
sum is exact in float32 whatever the order of its adds, and the kernels'
outputs equal the plain version's bit for bit. The ``cuda``-marked tests
at the end hold the kernels themselves to the plain version on the card
and skip here.
"""

import numpy as np
import pytest
import torch

from nomad_tpu.device import preempt as ref_preempt
from nomad_tpu_torch.device import preempt as port_preempt
from test_torch_closed_form_cluster import order_key
from test_torch_preempt import _inputs, _wide_inputs, reference_runtime

F32 = np.float32
PAD = np.uint64(0xFFFFFFFFFFFFFFFF)
LOW = np.uint64(0xFFFFFFFF)
CLUSTER_THREADS = 512
CLUSTER_WARPS = CLUSTER_THREADS // 32
WIDE_SLICE = 2048  # a slice above it takes rounds of two positions a thread
CLUSTER_SLICE = 12288
OUTPUTS = ("feasible", "k", "net", "order")
KINDS = ("random", "ties", "all_masked", "none_feasible")


def _pow2(v):
    return 1 << max(v - 1, 0).bit_length()


def fma_sq(x, acc):
    """float32 fma(x, x, acc) with one rounding: the exact float64 square
    plus acc, rounded to odd (TwoSum's error, a step toward it off an even
    last bit), then to float32."""
    p = x.astype(np.float64) ** 2
    c = acc.astype(np.float64)
    s = p + c
    back = s - p
    err = (p - (s - back)) + (c - back)
    step = (err != 0) & ((s.view(np.int64) & 1) == 0)
    return np.where(step, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s).astype(F32)


def sort_words(args):
    """u64[N, V] sort words, order_key(key) << 32 | index, in the kernels'
    float32 arithmetic of the key (the squares summed by the fused
    multiply-add chain of ``victim_key``)."""
    _cap, _used, ask, _elig, res, prio, mask = args
    rel = (res - ask) / np.maximum(ask, F32(1))
    total = rel[..., 0] * rel[..., 0]
    for d in range(1, 4):
        total = fma_sq(rel[..., d], total)
    dist = np.sqrt(total)
    key = prio.astype(F32) * F32(1e4) + np.minimum(dist, F32(9e3))
    key = np.where(mask, key, F32(1e9)).astype(F32)
    n, v = mask.shape
    idx = np.broadcast_to(np.arange(v, dtype=np.uint64), (n, v))
    return (order_key(key).astype(np.uint64) << np.uint64(32)) | idx


def fits(args, rows, freed):
    """The fit test of rows ``rows`` (broadcast over freed's middle axes)."""
    cap, used, ask = args[0], args[1], args[2]
    u = used[rows].reshape(used[rows].shape[:1] + (1,) * (freed.ndim - 2) + (4,))
    c = cap[rows].reshape(u.shape)
    return ((u - freed) + ask <= c).all(axis=-1)


def hs_scan(x, width):
    """Inclusive Hillis-Steele scan along axis 1 inside segments of
    ``width`` lanes, the kernel's __shfl_up_sync order (float32 or int)."""
    lanes = x.shape[1]
    seg = np.arange(lanes) % width
    off = 1
    while off < width:
        up = np.zeros_like(x)
        up[:, off:] = x[:, :-off]
        keep = (seg >= off).reshape((1, lanes) + (1,) * (x.ndim - 2))
        x = np.where(keep, x + up, x)
        off *= 2
    return x


def exclusive(inc):
    """The lane before's inclusive value (__shfl_up_sync by 1), zero in
    lane 0."""
    ex = np.zeros_like(inc)
    ex[:, 1:] = inc[:, :-1]
    return ex


def bitonic(w, lane_width=None):
    """The kernels' bitonic network over the last axis: stage (size,
    stride) keeps the smaller of a position and its partner q ^ stride
    where (q & stride == 0) equals (q & size == 0), else the larger. With
    ``lane_width`` E, strides below E are the in-lane compare-swaps of a
    warp a row, the others its shuffles: the same rule either way."""
    vp = w.shape[-1]
    q = np.arange(vp)
    size = 2
    while size <= vp:
        stride = size // 2
        while stride:
            o = w[..., q ^ stride]
            lower = (q & stride) == 0
            ascending = (q & size) == 0
            if lane_width is not None and stride < lane_width:
                # in the lane: the pair (e, e | stride) swapped when out of order
                swap = np.where(lower, w > o, o > w) == ascending
                w = np.where(swap, o, w)
            else:
                w = np.where(lower == ascending, np.minimum(o, w), np.maximum(o, w))
            stride //= 2
        size *= 2
    return w


def write_rows(args, first, net):
    """(feasible, k, net) from each row's first fitting position (-1 for
    none) and the priority prefix there."""
    eligible = args[3]
    any_fit = (first >= 0) & eligible
    return (
        any_fit,
        np.where(any_fit, first + 1, 0).astype(np.int32),
        np.where(any_fit, net, 0).astype(F32),
    )


def warp_model(args):
    """The warp form (V <= 32)."""
    res, prio, mask = args[4], args[5], args[6]
    n, v = mask.shape
    width = _pow2(v)
    w = np.full((n, width), PAD)
    w[:, :v] = sort_words(args)
    w = bitonic(w)
    sub = np.arange(width)
    slot = sub < v
    idx = (w & LOW).astype(np.int64)
    src = idx & (width - 1)  # the lane (in the row's segment) holding it
    pad = lambda x: np.concatenate(  # noqa: E731
        [x, np.zeros((n, width - v) + x.shape[2:], x.dtype)], axis=1)
    rows = np.arange(n)[:, None]
    real = slot & pad(mask)[rows, src]
    freed = np.where(real[..., None], pad(res)[rows, src], F32(0))
    p = np.where(real, pad(prio)[rows, src], 0)
    freed, p = hs_scan(freed, width), hs_scan(p, width)
    fit = real & fits(args, np.arange(n), freed)
    first = np.where(fit.any(axis=1), fit.argmax(axis=1), -1)
    net = p[np.arange(n), np.maximum(first, 0)]
    return (*write_rows(args, first, net), idx[:, :v].astype(np.int32))


def row_model(args):
    """A warp a row (32 < Vp <= 1,024)."""
    res, prio, mask = args[4], args[5], args[6]
    n, v = mask.shape
    vp = _pow2(v)
    e_per = vp // 32
    words = np.full((n, vp), PAD)
    words[:, :v] = sort_words(args)
    # lane l keeps victims l, l + 32, ... as positions l * E + e
    lane, e = np.meshgrid(np.arange(32), np.arange(e_per), indexing="ij")
    w = np.empty((n, vp), np.uint64)
    w[:, (lane * e_per + e).ravel()] = words[:, (lane + 32 * e).ravel()]
    w = bitonic(w, lane_width=e_per)
    idx = (w & LOW).astype(np.int64).reshape(n, 32, e_per)
    q = (lane * e_per + e)[None]
    inside = q < v
    rows = np.arange(n)[:, None, None]
    safe = np.where(inside, idx, 0)
    r = np.where((inside & mask[rows, safe])[..., None], res[rows, safe], F32(0))
    pr = np.where(inside & mask[rows, safe], prio[rows, safe], 0)
    total = np.zeros((n, 32, 4), F32)
    total_prio = np.zeros((n, 32), np.int64)
    for k in range(e_per):  # the lane's run, in order
        total = total + r[:, :, k]
        total_prio = total_prio + pr[:, :, k]
    freed = exclusive(hs_scan(total, 32))
    p = exclusive(hs_scan(total_prio, 32))
    first = np.full((n, 32), -1)
    net = np.zeros((n, 32), np.int64)
    for k in range(e_per):
        freed = freed + r[:, :, k]
        p = p + pr[:, :, k]
        hit = (first < 0) & inside[:, :, k] & mask[rows[:, :, 0], safe[:, :, k]]
        hit &= fits(args, np.arange(n), freed)
        first = np.where(hit, q[:, :, k], first)
        net = np.where(hit, p, net)
    # ballot and __ffs: the first lane with a fit
    found = first >= 0
    lane_hit = np.where(found.any(axis=1), found.argmax(axis=1), 0)
    at = np.arange(n)
    out_first = np.where(found.any(axis=1), first[at, lane_hit], -1)
    order = np.empty((n, vp), np.int64)
    order[:, (lane * e_per + e).ravel()] = idx.reshape(n, -1)
    return (*write_rows(args, out_first, net[at, lane_hit]), order[:, :v].astype(np.int32))


def cluster_sort(words, s):
    """The cluster's stable LSD radix sort of one row's words over ``s``
    blocks; returns the sorted words (block r's buffer holds positions
    [r * slice, (r + 1) * slice))."""
    v = words.shape[0]
    slice_ = -(-v // s)
    round_ = CLUSTER_THREADS * (2 if slice_ > WIDE_SLICE else 1)
    bufs = [words[r * slice_:(r + 1) * slice_].copy() for r in range(s)]
    for shift in (32, 40, 48, 56):
        digit = [((b >> np.uint64(shift)) & np.uint64(255)).astype(np.int64) for b in bufs]
        hist = np.stack([np.bincount(d, minlength=256) for d in digit])
        total = hist.sum(axis=0)
        if (total == v).any():
            continue  # one digit holds the whole row
        lower = np.cumsum(total) - total
        out = [np.empty_like(b) for b in bufs]
        for r in range(s):
            base = lower + hist[:r].sum(axis=0)
            for r0 in range(0, len(bufs[r]), round_):
                d = digit[r][r0:r0 + round_]
                t = np.arange(len(d))
                warp = t // 32  # the round's warps: the first part's 16, then the next's
                # __match_any_sync: the lanes before this one in its warp with its digit
                lanes = np.full(-(-len(d) // 32) * 32, -1)
                lanes[:len(d)] = d
                lanes = lanes.reshape(-1, 32)
                same = lanes[:, :, None] == lanes[:, None, :]
                below = (same & np.tri(32, k=-1, dtype=bool)).sum(axis=2).ravel()[:len(d)]
                counts = np.zeros((round_ // 32, 256), np.int64)
                np.add.at(counts, (warp, d), 1)
                offsets = base[None, :] + np.cumsum(counts, axis=0) - counts
                base = base + counts.sum(axis=0)
                g = offsets[warp, d] + below
                for owner in np.unique(g // slice_):
                    at = g // slice_ == owner
                    out[owner][g[at] - owner * slice_] = bufs[r][r0:r0 + round_][at]
        bufs = out
    return np.concatenate(bufs)


def cluster_model(args, s):
    """A row over a cluster of ``s`` blocks."""
    res, prio, mask = args[4], args[5], args[6]
    n, v = mask.shape
    slice_ = -(-v // s)
    words = sort_words(args)
    firsts, nets, orders = [], [], []
    for row in range(n):
        idx = (cluster_sort(words[row], s) & LOW).astype(np.int64)
        orders.append(idx)
        m = mask[row, idx]
        r = np.where(m[:, None], res[row, idx], F32(0))
        pr = np.where(m, prio[row, idx], 0)
        slices = []
        for b in range(s):  # each block's runs of its slice
            lo, hi = b * slice_, min(v, (b + 1) * slice_)
            count = max(hi - lo, 0)
            per = -(-count // CLUSTER_THREADS)
            bounds = [(min(t * per, count), min(t * per + per, count))
                      for t in range(CLUSTER_THREADS)]
            total = np.zeros((CLUSTER_THREADS, 4), F32)
            tprio = np.zeros(CLUSTER_THREADS, np.int64)
            for t, (b0, b1) in enumerate(bounds):
                for j in range(lo + b0, lo + b1):
                    total[t] = total[t] + r[j]
                    tprio[t] += pr[j]
            inc = hs_scan(total.reshape(CLUSTER_WARPS, 32, 4), 32)
            inc_prio = hs_scan(tprio.reshape(CLUSTER_WARPS, 32), 32)
            warp_inc = np.zeros((1, 32, 4), F32)
            warp_inc[0, :CLUSTER_WARPS] = inc[:, 31]
            warp_prio = np.zeros((1, 32), np.int64)
            warp_prio[0, :CLUSTER_WARPS] = inc_prio[:, 31]
            warp_inc, warp_prio = hs_scan(warp_inc, 32), hs_scan(warp_prio, 32)
            slices.append((lo, bounds, exclusive(inc), exclusive(inc_prio),
                           exclusive(warp_inc)[0], exclusive(warp_prio)[0],
                           warp_inc[0, CLUSTER_WARPS - 1], warp_prio[0, CLUSTER_WARPS - 1]))
        hit = None
        pre, pre_prio = np.zeros(4, F32), 0
        for lo, bounds, lane_ex, lane_ex_prio, warp_ex, warp_ex_prio, tot, tot_prio in slices:
            for t, (b0, b1) in enumerate(bounds):
                wi, li = divmod(t, 32)
                freed = (pre + warp_ex[wi]) + lane_ex[wi, li]
                p = pre_prio + warp_ex_prio[wi] + lane_ex_prio[wi, li]
                for j in range(lo + b0, lo + b1):
                    if not m[j]:
                        continue
                    freed = freed + r[j]
                    p += pr[j]
                    if fits(args, np.array([row]), freed[None, None])[0, 0]:
                        if hit is None or j < hit[0]:
                            hit = (j, p)
                        break
            pre, pre_prio = pre + tot, pre_prio + tot_prio
        firsts.append(-1 if hit is None else hit[0])
        nets.append(0 if hit is None else hit[1])
    return (*write_rows(args, np.array(firsts), np.array(nets)),
            np.stack(orders).astype(np.int32))


def _plain(args):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    return [x.numpy() for x in port_preempt.find_preemption_plain(*t)]


def _reference(monkeypatch, args):
    with reference_runtime(monkeypatch):
        return [np.asarray(x) for x in ref_preempt.find_preemption_kernel.jitted(*args)]


def _assert_same(got, want, what):
    for name, g, w in zip(OUTPUTS, got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=f"{what}: {name}")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("v", [1, 5, 8, 32])
def test_warp_model_matches_plain(kind, v):
    args = _inputs(kind, v, n=64, seed=3)
    _assert_same(warp_model(args), _plain(args), f"warp V={v} {kind}")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("v", [33, 64, 200, 1024])
def test_row_model_matches_plain(kind, v):
    args = _inputs(kind, v, n=24, seed=5)
    _assert_same(row_model(args), _plain(args), f"warp a row V={v} {kind}")


@pytest.mark.parametrize("s", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("kind", ["random", "ties"])
def test_cluster_model_matches_plain(kind, s):
    v = 1025 if s == 1 else 3000
    args = _inputs(kind, v, n=3, seed=7)
    _assert_same(cluster_model(args, s), _plain(args), f"cluster S={s} V={v} {kind}")


@pytest.mark.parametrize("kind", ["all_masked", "none_feasible"])
def test_cluster_model_edge_rows(kind):
    args = _inputs(kind, 1500, n=2, seed=9)
    _assert_same(cluster_model(args, 4), _plain(args), kind)


def test_cluster_sort_keeps_index_order_across_slices():
    """Every key tied: the order is the index order, across the slices'
    boundaries, only because each block's ties start after the slices
    before it (the `before` term of a digit's first position)."""
    words = np.arange(5000, dtype=np.uint64) | (np.uint64(0xC0000000) << np.uint64(32))
    words[::7] = words[::7] ^ (np.uint64(1) << np.uint64(40))  # two keys, many ties
    got = cluster_sort(words, 8) & LOW
    want = np.argsort(words >> np.uint64(32), kind="stable")
    np.testing.assert_array_equal(got.astype(np.int64), want)


@pytest.mark.parametrize("v, model", [
    (8, "warp"), (32, "warp"), (33, "row"), (1024, "row"), (1025, "cluster"),
])
def test_models_match_reference_at_the_form_edges(monkeypatch, v, model):
    """Each model against the reference's jitted program at its form's
    edges (V 32/33, 1,024/1,025), and the plain version with it."""
    args = _inputs("random", v, n=12, seed=11)
    ref = _reference(monkeypatch, args)
    got = {"warp": warp_model, "row": row_model}.get(model, lambda a: cluster_model(a, 2))(args)
    _assert_same(got, ref, f"{model} V={v} against the reference")
    _assert_same(_plain(args), ref, f"plain V={v} against the reference")
    assert port_preempt.find_form(v) == {
        "warp": "warp", "row": "warp a row", "cluster": "cluster"}[model]


def test_cluster_model_at_capacity_matches_plain_and_reference(monkeypatch):
    """V at the cluster form's capacity (16 blocks of 12,288 positions),
    and one past it, where the global-scratch form takes over: all four
    outputs identical to the reference's, the order too (the distance is
    the reference's fused multiply-add chain, ROADMAP C-P3)."""
    cap = port_preempt.CLUSTER_VICTIMS
    assert cap == 16 * CLUSTER_SLICE
    assert port_preempt.find_form(cap) == "cluster"
    assert port_preempt.find_form(cap + 1) == port_preempt.GLOBAL_FORM
    args = _wide_inputs(cap, n=2, seed=13)
    plain = _plain(args)
    _assert_same(cluster_model(args, 16), plain, "cluster S=16 at capacity")
    assert plain[0].any()
    _assert_same(plain, _reference(monkeypatch, args), "at the capacity")
    past = _wide_inputs(cap + 1, n=2, seed=13)
    _assert_same(_plain(past), _reference(monkeypatch, past), "one past the capacity")


def test_cluster_model_at_8192_matches_plain_and_reference(monkeypatch):
    """V 8,192 on 12 rows, where summing separately rounded squares gave
    6,195 distances off the reference's by an ulp: the cluster model, the
    plain version and the reference identical in all four outputs."""
    args = _inputs("random", 8192, n=12, seed=11)
    plain = _plain(args)
    _assert_same(cluster_model(args, 2), plain, "cluster S=2 at V 8,192")
    _assert_same(plain, _reference(monkeypatch, args), "plain V=8192 against the reference")


# -- on the card ----------------------------------------------------------------


def _card(args):
    return [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in args]


@pytest.mark.cuda
@pytest.mark.parametrize("v", [1, 8, 32])
def test_cuda_fused_and_standalone_find_match_plain(v):
    """On the card at V <= 32: the choice's launch carries the find pass
    (one launch, counted on ``find_preemption.carried``), and its outputs
    equal the standalone find launch's and the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: the preemption CUDA kernels run only on the card")
    t = _card(_inputs("random", v, n=4096, seed=17))
    carried, launches = port_preempt.find_preemption.carried, port_preempt.find_preemption.launches
    chosen = port_preempt.choose_preemption_node(*t)
    assert port_preempt.find_preemption.carried == carried + 1
    assert port_preempt.find_preemption.launches == launches
    alone = port_preempt.find_preemption(*t)
    want = port_preempt.choose_preemption_node_plain(*t)
    torch.cuda.synchronize()
    for g, w in zip(chosen, want):
        assert torch.equal(g, w.to(g.dtype))
    for g, w in zip(alone, want[1:5]):
        assert torch.equal(g, w.to(g.dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("v, form", [
    (33, "warp a row"), (1024, "warp a row"), (1025, "cluster"), (8192, "cluster"),
    (16 * CLUSTER_SLICE + 1, "global"),
])
def test_cuda_each_form_matches_plain(v, form):
    """On the card: each form of the find pass, as the wrapper counted it
    at the launch, identical to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: the preemption CUDA kernels run only on the card")
    t = _card(_wide_inputs(v, n=64 if v < 100_000 else 4, seed=19))
    before = dict(port_preempt.find_preemption.forms)
    got = port_preempt.find_preemption(*t)
    ran = [f for f, c in port_preempt.find_preemption.forms.items() if c != before.get(f, 0)]
    assert len(ran) == 1 and ran[0].startswith(form), ran
    want = port_preempt.find_preemption_plain(*t)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w.to(g.dtype))
