"""Where a find-preemption launch's time goes, on one NVIDIA GPU.

    python3 tools/preempt_find_profile.py
    python3 tools/preempt_find_profile.py --forms

Builds ``nomad_tpu_torch/csrc/preempt.cu`` with ``-DNOMAD_PREEMPT_PROFILE``
(its ``PROF_LAP`` marks: thread 0 of each of the first 16 blocks adds the
``clock64`` cycles of each stage) and the port's nvcc flags under
``build/nomad_tpu_torch/profile/``, prints ptxas's report of each kernel's
registers and shared memory (this build's: the marks add a few), binds
the library in place of the preemption one, and runs ``find_preemption``
on ``chip_smoke.preempt_inputs`` (seeded integer victims) at V 8, 64 and
256 on 16,384 nodes, V 8,192 on 256 and V 32,768 on 64 (the widths
PERF.md gives), and at the edges of the find pass's forms (V 32, 33,
1,024 and 1,025 on 4,096 nodes); at V 8 also ``choose_preemption_node``,
whose launch carries the find pass. Prints the card's name and power
limit, the SM clock, then per case the form the wrapper launched
(``chip_smoke.launched_find_form``: the wrapper's count at the launch),
the mean cycles a launch of each stage in block 0 and the most any of
the first 16 blocks took (the cluster form's sort split into its passes'
digit counts, their exchange over the cluster, the rounds that place the
words and the wait for every word to land), the launch's ms by
CUDA-graph replay, and whether its outputs are identical to the plain
version. A stage's count is its block's: a lap is taken after the
stage's last instruction issues, so a load's latency lands in the stage
that first uses its value, and barrier waits land in the stage before.

``--forms`` times the port's own build instead, with no marks: at V 64
to 196,608 every form that can take the width (a warp a row up to V
1,024, a cluster of 1 to 16 blocks whose slices fit, the global
scratch), asked for through ``_launch_find``'s ``want``, the ms of a
launch by CUDA-graph replay beside the form the plan picks, each launch
identical to plain. The forms' bounds (W, the cluster size rule) are
read from this table. No jax.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as C  # noqa: E402
from nomad_tpu_torch import backend  # noqa: E402
from nomad_tpu_torch.device import preempt as P  # noqa: E402

STAGES = {
    0: "key", 1: "sort", 6: "sort: radix counts", 7: "sort: radix exchange",
    8: "sort: radix rounds", 9: "sort: radix landed", 2: "gather", 3: "scan and fit",
    4: "write", 5: "choice",
}
LAUNCHES = 20
CASES = (  # (V, N)
    (8, 16384), (64, 16384), (256, 16384), (8192, 256), (32768, 64),
    (32, 4096), (33, 4096), (1024, 4096), (1025, 4096),
)
FORM_CASES = (  # (V, N)
    (64, 16384), (256, 16384), (512, 4096), (1024, 4096), (1025, 4096), (2048, 2048),
    (8192, 256), (32768, 64), (196608, 8),
)
ROW, CLUSTER, GLOBAL = 1, 2, 3  # csrc/preempt.cu's form codes


def forms(dev) -> int:
    """The forms' table (``--forms``)."""
    print(C.card_line(), flush=True)
    for v, n in FORM_CASES:
        c = C.preempt_inputs(dev, v, n=n)
        args = [c[k] for k in C.PREEMPT_INPUTS]
        want = P.find_preemption_plain(*args)
        picked = C.launched_find_form(lambda: P.find_preemption(*args))
        row = {}
        asks = [(CLUSTER, s) for s in (1, 2, 4, 8, 16) if -(-v // s) <= P.CLUSTER_VICTIMS // 16]
        asks = ([(ROW, 1)] if v <= P.ROW_WIDTH else []) + asks
        asks += [(GLOBAL, 1)] if v >= 1024 else []  # a thread's run: Vp / 1,024 positions
        for form, s in asks:
            launch = lambda: P._launch_find(args, want=(form, s))  # noqa: E731
            try:
                got = launch()
            except RuntimeError as e:  # not resident at this size
                row[f"{form}/{s}"] = f"refused ({e})"
                continue
            torch.cuda.synchronize()
            assert all(torch.equal(g, w.to(g.dtype)) for g, w in zip(got, want)), (v, form, s)
            label = {ROW: "warp a row", CLUSTER: f"cluster S={s}", GLOBAL: "global"}[form]
            row[label] = C.graph_ms(launch)
        print(f"forms V={v} N={n}: picked {picked!r}; ms "
              + ", ".join(f"{k} {ms!r}" for k, ms in row.items())
              + "; identical to plain True", flush=True)
        del c, args, want
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("preempt_find_profile: needs CUDA", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    if sys.argv[1:] == ["--forms"]:
        return forms(dev)
    print(C.card_line(), flush=True)
    out_dir = backend.BUILD_DIR / "profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / "libpreempt_profile.so"
    built = subprocess.run(
        [backend.nvcc_path(), *backend.NVCC_FLAGS, "-DNOMAD_PREEMPT_PROFILE",
         "-Xptxas=-v", "-o", str(so), str(backend.CSRC_DIR / "preempt.cu")],
        check=True, capture_output=True, text=True,
    )
    for line in built.stderr.splitlines():  # each kernel's registers and memory
        if "ptxas info" in line and "Function properties" not in line:
            print(line.strip(), flush=True)
    lib = ctypes.CDLL(str(so))
    lib.nomad_preempt_profile.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.nomad_preempt_profile.restype = ctypes.c_int
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"SM clock (now, max): {clocks}", flush=True)
    real_lib = P.cuda_library
    P.cuda_library = lambda name: lib if name == "preempt" else real_lib(name)
    counts = (ctypes.c_longlong * 256)()
    try:
        for v, n in CASES:
            c = C.preempt_inputs(dev, v, n=n)
            args = [c[k] for k in C.PREEMPT_INPUTS]
            names = ("find_preemption", "choose_preemption_node") if v == 8 else (
                "find_preemption",)
            for name in names:
                kernel, plain = getattr(P, name), getattr(P, f"{name}_plain")
                launch = lambda: kernel(*args)  # noqa: E731
                form = C.launched_find_form(launch)
                torch.cuda.synchronize()
                assert lib.nomad_preempt_profile(None, 1) == 0
                for _ in range(LAUNCHES):
                    launch()
                torch.cuda.synchronize()
                assert lib.nomad_preempt_profile(ctypes.addressof(counts), 0) == 0
                runs = max(counts[15], 1)
                most = {i: max(counts[16 * b + i] for b in range(16)) for i in STAGES}
                split = ", ".join(
                    f"{stage} {counts[i] / runs:.0f} ({most[i] / runs:.0f})"
                    for i, stage in STAGES.items() if most[i]
                )
                got, want = kernel(*args), plain(*args)
                torch.cuda.synchronize()
                same = all(torch.equal(g, w.to(g.dtype)) for g, w in zip(got, want))
                ms = C.graph_ms(launch)
                print(f"{name} V={v} N={n} form {form}: cycles a launch, block 0 "
                      f"(most of the first 16 blocks): {split}; total "
                      f"{sum(counts[i] for i in STAGES) / runs:.0f}; ms {ms!r}; "
                      f"identical to plain {same}", flush=True)
                assert same, (name, v, n)
            del c, args
    finally:
        P.cuda_library = real_lib
    return 0


if __name__ == "__main__":
    sys.exit(main())
