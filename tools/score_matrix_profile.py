"""Score-matrix kernel variants on one NVIDIA GPU.

    python3 tools/score_matrix_profile.py

Times the port's Triton score-matrix body at several tilings (nodes a
program, warps a program) beside its earlier body, ``scalar_rows_body``
(1,024 nodes a program in four warps, eight cells a thread, a node's
capacity and usage read as four scalar loads each), at G 1, 3, 100 and
128 on the headline inputs (``chip_smoke.py`` phase 3: 10,000 nodes
padded to 16,384) and at G 1 on 10,001 nodes, each by CUDA-graph replay of 20 launches and held bit for
bit against ``component_scores``, with the registers a thread and an
empty Triton kernel's time as the floor. Prints one line a case and a
JSON summary last; the card's name and power limit first. No jax.
"""

import json
import sys
from pathlib import Path

import torch
import triton
import triton.language as tl

try:  # triton >= 3.1
    from triton.language.extra import libdevice
except ImportError:  # triton 3.0
    from triton.language.extra.cuda import libdevice

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as C  # noqa: E402
from nomad_tpu_torch.device import score as S  # noqa: E402
from nomad_tpu_torch.device import score_triton as ST  # noqa: E402

TILINGS = ((64, 1), (64, 2), (128, 2), (128, 4), (256, 4), (256, 8), (512, 4), (1024, 4))


@triton.jit
def noop(out_ptr):
    tl.store(out_ptr, 1.0)


@triton.jit
def scalar_rows_body(
    cap_ptr, used_ptr, asks_ptr, elig_ptr, jc_ptr, dt_ptr, pen_ptr,
    aff_ptr, haff_ptr, dh_ptr, tp_ptr, final_ptr, fits_ptr, n_nodes,
    ALG_SPREAD: tl.constexpr, HAS_TP: tl.constexpr, BLOCK: tl.constexpr,
):
    g = tl.program_id(1)
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n_nodes
    gn = g.to(tl.int64) * n_nodes + offs

    a0 = tl.load(asks_ptr + g * 4 + 0)
    a1 = tl.load(asks_ptr + g * 4 + 1)
    a2 = tl.load(asks_ptr + g * 4 + 2)
    a3 = tl.load(asks_ptr + g * 4 + 3)
    dt = tl.load(dt_ptr + g)
    haff = tl.load(haff_ptr + g) != 0
    dh = tl.load(dh_ptr + g) != 0

    c0 = tl.load(cap_ptr + offs * 4 + 0, mask=mask, other=0.0)
    c1 = tl.load(cap_ptr + offs * 4 + 1, mask=mask, other=0.0)
    c2 = tl.load(cap_ptr + offs * 4 + 2, mask=mask, other=0.0)
    c3 = tl.load(cap_ptr + offs * 4 + 3, mask=mask, other=0.0)
    p0 = tl.load(used_ptr + offs * 4 + 0, mask=mask, other=0.0) + a0
    p1 = tl.load(used_ptr + offs * 4 + 1, mask=mask, other=0.0) + a1
    p2 = tl.load(used_ptr + offs * 4 + 2, mask=mask, other=0.0) + a2
    p3 = tl.load(used_ptr + offs * 4 + 3, mask=mask, other=0.0) + a3
    elig = tl.load(elig_ptr + gn, mask=mask, other=0) != 0
    jc = tl.load(jc_ptr + gn, mask=mask, other=0)
    pen = tl.load(pen_ptr + gn, mask=mask, other=0) != 0
    aff = tl.load(aff_ptr + gn, mask=mask, other=0.0)

    fits = (p0 <= c0) & (p1 <= c1) & (p2 <= c2) & (p3 <= c3) & elig
    fits = fits & ((jc == 0) | (dh == 0))

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




def launcher(kernel, block, warps, a):
    g, n = a[3].shape
    final = torch.empty((g, n), dtype=torch.float32, device=a[0].device)
    fits = torch.empty((g, n), dtype=torch.bool, device=a[0].device)
    grid = (-(-n // block), g)

    def go():
        return kernel[grid](
            a[0], a[1], a[2], a[3].view(torch.uint8), a[4], a[5], a[6].view(torch.uint8),
            a[7], a[8].view(torch.uint8), a[9].view(torch.uint8), a[7], final,
            fits.view(torch.uint8), n, ALG_SPREAD=False, HAS_TP=False, BLOCK=block,
            num_warps=warps, enable_fp_fusion=False,
        )
    return go, final, fits


def main() -> int:
    if not torch.cuda.is_available():
        print("score_matrix_profile: needs CUDA", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(C.card_line(), flush=True)
    ct = C.build_cluster(10_000, seed=42)
    b, _, _ = C.device_batch(ct, C.build_asks(ct, 100, 1000, seed=7), dev)
    args, _ = C.score_matrix_inputs(b, dev)
    cases = {f"G={g}": [a if i < 2 else a[:g].contiguous() for i, a in enumerate(args)]
             for g in (1, 3, 100, 128)}
    cases["G=1 N=10001"] = [a[:10001].contiguous() if i < 2 else a[:1, :10001].contiguous()
                            if a.dim() == 2 else a[:1].contiguous() for i, a in enumerate(args)]
    variants = [("scalar rows", scalar_rows_body, 1024, 4)] + [
        ("port", ST._build(), block, warps) for block, warps in TILINGS
    ]
    flag = torch.zeros(1, device=dev)
    out = {"noop_ms": C.graph_ms(lambda: noop[(1,)](flag))}
    print(f"empty Triton kernel: {out['noop_ms']!r} ms", flush=True)
    for label, a in cases.items():
        want, want_fits = S.component_scores(*a, False, None)
        for name, kernel, block, warps in variants:
            go, final, fits = launcher(kernel, block, warps, a)
            compiled = go()
            torch.cuda.synchronize()
            assert torch.equal(fits, want_fits), (label, name, block, warps)
            assert torch.equal(final.view(torch.int32), want.view(torch.int32)), (label, name)
            key = f"{label} {name} {block} nodes a program, {warps} warps"
            out[key] = {"ms": C.graph_ms(go), "registers": getattr(compiled, "n_regs", None)}
            print(f"{key}: {out[key]['ms']!r} ms, {out[key]['registers']} registers a thread, "
                  "identical to plain", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
