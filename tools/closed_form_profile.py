"""Where a closed-form launch's time goes, on one NVIDIA GPU.

    python3 tools/closed_form_profile.py
    python3 tools/closed_form_profile.py --sizes

Builds ``nomad_tpu_torch/csrc/closed_form.cu`` with
``-DNOMAD_CLOSED_FORM_PROFILE`` (its ``PROF_LAP`` marks: thread 0 of each
of the first 16 blocks adds the ``clock64`` cycles of each phase) and the
port's nvcc flags under ``build/nomad_tpu_torch/profile/``, prints
ptxas's report of each kernel's registers and shared memory (this
build's: the marks add a few), binds the library in place of the
closed-form one, and runs ``place_closed_form`` on the schedule path's
last pass (``chip_smoke.main_path``'s recorded call), its shape
(``chip_smoke.schedule_inputs``: N 16,384, J 16, k 1,024 at G 1, 8, 32
and 128; and G 1 at k 8,192) and the headline shape (G 128, N 16,384,
J 80, k 1,024), in every form the kernel has (the one-block form and
each cluster size, asked for through ``closed_form_plan``). Prints the
card's name and power limit, the SM clock, then per case and form the
mean cycles a launch of each phase in block 0 and the most any block of
lane 0 took (each block's too for the form the
wrapper chose), the launch's ms by CUDA-graph replay, and whether it is
identical to the plain version. Thread 0's clock includes its waits at
barriers, so a phase's count is its block's; in the cluster form
"stage, slowest block" is the wait at an extra cluster barrier after
the stage, which only this build has.

``--sizes`` times the port's own build instead, with no marks: the
schedule shape at G from 1 to 256 lanes (below, at and past the SM
count) in each cluster size 2 to 16, the ms of a launch by CUDA-graph
replay beside the size ``closed_form_plan`` picks, each launch identical
to plain. The cluster-size rule is read from this table. No jax.
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
from nomad_tpu_torch.device import score as S  # noqa: E402

# PROF_LAP slots: 0-4 the one-block form, 5-11 the cluster form
PHASES = {
    0: "floor", 1: "threshold", 2: "compaction", 3: "sort", 4: "scores",
    5: "stage", 6: "floor", 7: "threshold", 8: "counts and exchange",
    9: "ties", 13: "rank: gather", 14: "rank: count", 10: "rank: scores", 11: "exit",
    12: "stage, slowest block",
}
LAUNCHES = 20
SIZES_G = (1, 8, 9, 16, 24, 28, 32, 33, 48, 64, 96, 128, 133, 256)


def cases(dev):
    """(label, args, spread, max_j, k, jitter) of each case."""
    _, calls, _ = C.main_path(dev)  # the schedule path's own passes
    c = calls[-1]
    yield ("schedule path's last pass", [c[key] for key in C.CLOSED_FORM_INPUTS],
           c["algorithm_spread"], c["max_j"], c["k"], c["jitter"])
    for g in (1, 8, 32, 128):
        args, max_j, k = C.schedule_inputs(dev, g)
        yield f"schedule G={g} N=16384 J=16 k=1024", args, False, max_j, k, None
    args, max_j, k = C.schedule_inputs(dev, 1, k=8192)
    yield "schedule G=1 N=16384 J=16 k=8192", args, False, max_j, k, None
    ct = C.build_cluster(10_000, seed=42)
    b, max_j, k = C.device_batch(ct, C.build_asks(ct, 100, 1000, seed=7), dev)
    yield "headline G=128 N=16384 J=80 k=1024", C.closed_form_args(b), False, max_j, k, None


def asking(form):
    """``closed_form_plan`` asking for ``form`` blocks a lane (None: the
    wrapper's own choice)."""
    if form is None:
        return REAL_PLAN
    return lambda g, n, kpad: REAL_PLAN(g, n, kpad, form)


REAL_PLAN = S.closed_form_plan


def sizes(dev) -> int:
    """The cluster-size table (``--sizes``)."""
    print(C.card_line(), flush=True)
    try:
        for g in SIZES_G:
            args, max_j, k = C.schedule_inputs(dev, g)
            want = S.place_closed_form_plain(*args, False, max_j, k, None)
            row = {}
            for form in (None, 2, 4, 8, 16):
                S.closed_form_plan = asking(form)
                launch = lambda: S.place_closed_form(*args, False, max_j, k, None)  # noqa: E731
                got, blocks = C.launched_form(launch)
                assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (g, form)
                if form is None:
                    row["picked"] = blocks
                else:
                    assert blocks == form, (g, form, blocks)
                    row[f"S={form}"] = C.graph_ms(launch)
            print(f"sizes G={g} N=16384 J=16 k=1024: picked S={row.pop('picked')}; ms "
                  + ", ".join(f"{key} {ms!r}" for key, ms in row.items())
                  + "; identical to plain True", flush=True)
    finally:
        S.closed_form_plan = REAL_PLAN
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("closed_form_profile: needs CUDA", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    if sys.argv[1:] == ["--sizes"]:
        return sizes(dev)
    print(C.card_line(), flush=True)
    out_dir = backend.BUILD_DIR / "profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / "libclosed_form_profile.so"
    built = subprocess.run(
        [backend.nvcc_path(), *backend.NVCC_FLAGS, "-DNOMAD_CLOSED_FORM_PROFILE",
         "-Xptxas=-v", "-o", str(so), str(backend.CSRC_DIR / "closed_form.cu")],
        check=True, capture_output=True, text=True,
    )
    for line in built.stderr.splitlines():  # each kernel's registers and memory
        if "ptxas info" in line and ("Function properties" not in line):
            print(line.strip(), flush=True)
    lib = ctypes.CDLL(str(so))
    lib.nomad_closed_form_profile.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.nomad_closed_form_profile.restype = ctypes.c_int
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"SM clock (now, max): {clocks}", flush=True)
    real_lib = S.cuda_library
    S.cuda_library = lambda name: lib if name == "closed_form" else real_lib(name)
    counts = (ctypes.c_longlong * 256)()
    try:
        for label, args, spread, max_j, k, jitter in cases(dev):
            g, n = args[3].shape
            for form in (None, 1, 2, 4, 8, 16):
                S.closed_form_plan = asking(form)
                launch = lambda: S.place_closed_form(*args, spread, max_j, k, jitter)  # noqa: E731
                try:
                    _, blocks = C.launched_form(launch)
                except RuntimeError as e:  # a block's share does not fit this form
                    print(f"{label} form S={form}: refused ({e})", flush=True)
                    continue
                if form is None:
                    chosen = blocks
                elif blocks == chosen:
                    continue  # timed as the wrapper's choice
                torch.cuda.synchronize()
                assert lib.nomad_closed_form_profile(None, 1) == 0
                for _ in range(LAUNCHES):
                    launch()
                torch.cuda.synchronize()
                assert lib.nomad_closed_form_profile(ctypes.addressof(counts), 0) == 0
                runs = max(counts[15], 1)
                lane = range(min(blocks, 16))
                most = {i: max(counts[16 * b + i] for b in lane) for i in PHASES}
                split = ", ".join(
                    f"{name} {counts[i] / runs:.0f} ({most[i] / runs:.0f})"
                    for i, name in PHASES.items() if counts[i]
                )
                got = launch()
                want = S.place_closed_form_plain(*args, spread, max_j, k, jitter)
                same = bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))
                ms = C.graph_ms(launch)
                if form is None and blocks > 1:  # each block's laps
                    for i in (5, 12, 6, 7, 8, 9, 13, 14, 10):
                        print(f"  {PHASES[i]} by block:",
                              [round(counts[16 * b + i] / runs) for b in lane], flush=True)
                print(f"{label} form {f'chosen S={blocks}' if form is None else f'S={form}'}: "
                      f"cycles a launch, block 0 (most of lane 0's blocks): {split}; "
                      f"total {sum(counts[:15]) / runs:.0f}; "
                      f"ms {ms!r}; identical to plain {same}", flush=True)
    finally:
        S.cuda_library = real_lib
        S.closed_form_plan = REAL_PLAN
    return 0


if __name__ == "__main__":
    sys.exit(main())
