"""Triton kernel for the dense [G, N] score matrix.

Replaces ``nomad_tpu/device/score.py:score_matrix_kernel`` (the vmapped
``component_scores``). The function is one elementwise pass over the
groups × nodes grid with a 4-wide reduction over the resource dims
(``all(used + ask <= capacity)``): no sequential state, no selection and
no matrix product, so it stays Triton. Each program takes one group and
``BLOCK_N`` nodes, masks the ragged edge, and writes (final f32, fits
u8).

What bounds it on the H100: memory. Per (g, n) it reads 10 bytes of
per-lane node inputs (eligible and penalty as bytes, job_counts i32,
affinity f32; throughputs f32 when given) and writes 5 (final f32, fits
u8), against ~30 f32 operations; capacity and usage ([N, 4]) are shared
by every group and stay in L2. The design keeps it to one pass that
reads each input once, with no [G, N, D] intermediate in device memory.

Design: one cell a thread (``BLOCK_N`` 128 in four warps), so a call at
G = 1 spreads over 128 programs at 16,384 nodes and 79 at 10,000, and
each node's capacity and usage row arrives as one 16-byte vector load
(a [BLOCK_N, 4] tile) whose cpu and mem columns are picked out within the
thread. A thread's byte inputs and its fits byte are single accesses
that a warp coalesces into one 32-byte sector. Tiles of 1,024 nodes with
eight cells a thread and four scalar loads a row held 150 registers a
thread and left 16 programs at G = 1 (``tools/score_matrix_profile.py``
times both bodies at several tilings; PERF.md keeps the numbers).

Numerics follow the reference: IEEE division (``div_rn``), libdevice's
``expf`` rather than the approximate ``ex2``, and no FMA contraction
(``enable_fp_fusion=False``), so each sum is rounded as the plain
PyTorch version rounds it.

Triton is imported, and the kernel built, inside ``score_matrix_triton``
the first time it runs: the module itself imports without Triton.
"""

from __future__ import annotations

import os
import threading

import torch

from ..backend import BUILD_DIR, count_launch, note_compile, same_device

# ln(10) and BINPACK_MAX_SCORE appear as literals in the kernel body:
# Triton kernels may read only constexpr globals
BLOCK_N = 128
NUM_WARPS = 4
# no FMA contraction: each sum rounds as the plain version's does
ENABLE_FP_FUSION = False

_build_lock = threading.Lock()
_kernel = None
# specializations launched so far: a new one compiles at its first call
_specializations: set = set()
# bound by _build(): the Triton language module and its libdevice
tl = None
libdevice = None


def _score_matrix_body(
    cap_ptr, used_ptr, asks_ptr, elig_ptr, jc_ptr, dt_ptr, pen_ptr,
    aff_ptr, haff_ptr, dh_ptr, tp_ptr, final_ptr, fits_ptr, n_nodes,
    ALG_SPREAD: tl.constexpr, HAS_TP: tl.constexpr, BLOCK: tl.constexpr,
):
    g = tl.program_id(1)
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n_nodes
    gn = g.to(tl.int64) * n_nodes + offs
    dim = tl.arange(0, 4)

    ask = tl.load(asks_ptr + g * 4 + dim)
    dt = tl.load(dt_ptr + g)
    haff = tl.load(haff_ptr + g) != 0
    dh = tl.load(dh_ptr + g) != 0

    # each node's capacity and usage row as one 16-byte vector
    row = offs[:, None] * 4 + dim[None, :]
    cap = tl.load(cap_ptr + row, mask=mask[:, None], other=0.0)
    prop = tl.load(used_ptr + row, mask=mask[:, None], other=0.0) + ask[None, :]
    fits = tl.min((prop <= cap).to(tl.int32), axis=1) != 0
    # the cpu and mem columns: a max over one value and -infs is exact
    ninf = -float("inf")
    c0 = tl.max(tl.where(dim[None, :] == 0, cap, ninf), axis=1)
    c1 = tl.max(tl.where(dim[None, :] == 1, cap, ninf), axis=1)
    p0 = tl.max(tl.where(dim[None, :] == 0, prop, ninf), axis=1)
    p1 = tl.max(tl.where(dim[None, :] == 1, prop, ninf), axis=1)
    elig = tl.load(elig_ptr + gn, mask=mask, other=0) != 0
    jc = tl.load(jc_ptr + gn, mask=mask, other=0)
    pen = tl.load(pen_ptr + gn, mask=mask, other=0) != 0
    aff = tl.load(aff_ptr + gn, mask=mask, other=0.0)

    fits = fits & elig & ((jc == 0) | (dh == 0))

    f0 = tl.where(c0 > 0, libdevice.div_rn(c0 - p0, tl.maximum(c0, 1e-9)), 1.0)
    f1 = tl.where(c1 > 0, libdevice.div_rn(c1 - p1, tl.maximum(c1, 1e-9)), 1.0)
    pow_sum = libdevice.exp(2.302585092994046 * f0) + libdevice.exp(2.302585092994046 * f1)
    if ALG_SPREAD:
        fit = tl.minimum(tl.maximum(pow_sum - 2.0, 0.0), 18.0)
    else:
        fit = tl.minimum(tl.maximum(20.0 - pow_sum, 0.0), 18.0)
    fit = libdevice.div_rn(fit, 18.0)

    coll = jc.to(tl.float32)
    anti = tl.where(jc > 0, libdevice.div_rn(-(coll + 1.0), tl.maximum(dt, 1.0)), 0.0)
    resched = tl.where(pen, -1.0, 0.0)
    aff_c = tl.where(haff, aff, 0.0)
    n_comp = 1.0 + (jc > 0).to(tl.float32)
    n_comp = n_comp + pen.to(tl.float32)
    n_comp = n_comp + haff.to(tl.float32)
    total = fit + anti
    total = total + resched
    total = total + aff_c
    if HAS_TP:
        tp = tl.load(tp_ptr + gn, mask=mask, other=0.0)
        fits = fits & (tp > 0.0)
        total = total + tp
        n_comp = n_comp + 1.0
    final = libdevice.div_rn(total, n_comp)
    final = tl.where(fits, final, -float("inf"))
    tl.store(final_ptr + gn, final, mask=mask)
    tl.store(fits_ptr + gn, fits.to(tl.uint8), mask=mask)


def _build():
    """Import Triton and JIT-wrap the kernel body, once per process."""
    global _kernel, tl, libdevice
    with _build_lock:
        if _kernel is not None:
            return _kernel
        # keep Triton's compile cache inside the checkout's build tree
        os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
        import triton
        import triton.language as language

        try:  # triton >= 3.1
            from triton.language.extra import libdevice as ld
        except ImportError:  # triton 3.0
            from triton.language.extra.cuda import libdevice as ld
        tl, libdevice = language, ld
        _kernel = triton.jit(_score_matrix_body)
        return _kernel


def specialization_key(algorithm_spread, has_throughputs: bool, n: int) -> tuple:
    """The key Triton compiles one binary for: the constexprs and the
    node count's divisibility by 16 (``n == 1`` specializes too)."""
    return (bool(algorithm_spread), bool(has_throughputs), n % 16 == 0, n == 1)


def launched_specializations() -> list[tuple]:
    """The specialization keys this process has launched, sorted."""
    with _build_lock:
        return sorted(_specializations)


def score_matrix_triton(
    capacity, used, asks, eligible, job_counts, desired_totals,
    penalty_nodes, affinity_scores, has_affinities, distinct_hosts,
    algorithm_spread: bool, throughputs=None, layout=None,
):
    """Launch the Triton score-matrix kernel on CUDA tensors; returns
    (final f32[G, N], fits bool[G, N]). ``layout``: the mesh layout the
    launch is filed under ("shard" for a node slice's launch)."""
    dev = capacity.device
    if dev.type != "cuda":
        raise ValueError(f"score_matrix_triton: needs CUDA tensors, got {dev}")
    inputs = (
        capacity, used, asks, eligible, job_counts, desired_totals,
        penalty_nodes, affinity_scores, has_affinities, distinct_hosts,
        throughputs,
    )
    same_device(inputs, dev, "score_matrix_triton")
    n = capacity.shape[0]
    g = asks.shape[0]
    want = [
        ("capacity", capacity, torch.float32, (n, 4)),
        ("used", used, torch.float32, (n, 4)),
        ("asks", asks, torch.float32, (g, 4)),
        ("eligible", eligible, torch.bool, (g, n)),
        ("job_counts", job_counts, torch.int32, (g, n)),
        ("desired_totals", desired_totals, torch.float32, (g,)),
        ("penalty_nodes", penalty_nodes, torch.bool, (g, n)),
        ("affinity_scores", affinity_scores, torch.float32, (g, n)),
        ("has_affinities", has_affinities, torch.bool, (g,)),
        ("distinct_hosts", distinct_hosts, torch.bool, (g,)),
    ]
    if throughputs is not None:
        want.append(("throughputs", throughputs, torch.float32, (g, n)))
    for name, t, dtype, shape in want:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"score_matrix_triton: {name} must be {dtype} {shape}, "
                f"got {t.dtype} {tuple(t.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"score_matrix_triton: {name} must be contiguous")
    final = torch.empty((g, n), dtype=torch.float32, device=dev)
    fits = torch.empty((g, n), dtype=torch.bool, device=dev)
    if g == 0 or n == 0:
        return final, fits
    kernel = _build()
    # Triton compiles one binary per constexpr set and per integer
    # argument's divisibility by 16 (n == 1 specializes too): tell the
    # kernel guard's watchdog that this call may be compiling
    spec = specialization_key(algorithm_spread, throughputs is not None, n)
    with _build_lock:
        if spec not in _specializations:
            _specializations.add(spec)
            note_compile()
    grid = (-(-n // BLOCK_N), g)
    kernel[grid](
        capacity, used, asks,
        eligible.view(torch.uint8), job_counts, desired_totals,
        penalty_nodes.view(torch.uint8), affinity_scores,
        has_affinities.view(torch.uint8), distinct_hosts.view(torch.uint8),
        throughputs if throughputs is not None else affinity_scores,
        final, fits.view(torch.uint8), n,
        ALG_SPREAD=bool(algorithm_spread),
        HAS_TP=throughputs is not None,
        BLOCK=BLOCK_N,
        num_warps=NUM_WARPS,
        enable_fp_fusion=ENABLE_FP_FUSION,
    )
    count_launch(score_matrix_triton, layout=layout)
    return final, fits


score_matrix_triton.launches = 0

