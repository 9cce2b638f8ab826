"""Where a step of the coupled cluster kernel's time goes, on one NVIDIA GPU.

    python3 tools/coupled_step_profile.py

Writes a copy of ``nomad_tpu_torch/csrc/coupled.cu`` whose
``chunked_cluster_kernel`` counts ``clock64`` cycles by phase in block 0,
thread 0 (the tables, the scoring pass, the walk with its first two
parts, the cluster barrier, the merge, and the bump with the head moves),
builds it with the port's nvcc flags under ``build/nomad_tpu_torch/``,
binds it in place of the coupled library, and runs the value scan and
the chunked scan on ``chip_smoke.py``'s phase 11 inputs. Prints the
card's name and power limit, the SM clock, then the mean cycles a step
of each phase by case. Thread 0's clock includes its waits at the
barriers, so a phase's count is the block's, not one thread's work.
No jax.
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

PHASES = ("tables", "scoring", "walk", "cluster barrier", "merge", "bump and head moves",
          "walk: the warps' heads", "walk: the slice's heads")
CASES = (
    ("place_value_scan", "scan", dict(racks=32)),
    ("place_spread_chunked", "chunked", dict(racks=32)),
    ("place_spread_chunked", "chunked", dict(racks=25, cap_zones=40)),
    ("place_value_scan", "scan", dict(racks=25, node_blocks=1, count=40)),
)


def profiled_source() -> str:
    src = (ROOT / "nomad_tpu_torch/csrc/coupled.cu").read_text()
    a = src.index("chunked_cluster_kernel(Inputs in")
    b = src.index("// Dynamic shared memory each kernel may take")
    k = src[a:b]

    def hook(anchor, before="", after=""):
        nonlocal k
        assert k.count(anchor) == 1, anchor
        k = k.replace(anchor, before + anchor + after)

    lap = "    tB = clock64(); pr[{0}] += tB - tA; tA = tB;\n"
    hook("  int n_placed = 0;\n",
         after="  long long pr[8] = {0, 0, 0, 0, 0, 0, 0, 0}, tA = 0, tB = 0, tW = 0;\n"
               "  int nsteps = 0;\n")
    hook("    const int par = step & 1;\n", after="    tA = clock64(); ++nsteps;\n")
    hook("    compute_tables(L);  // frozen for the whole chunk\n", after=lap.format(0))
    hook("    // 1. each warp's heads", before=lap.format(1) + "    tW = tB;\n")
    hook("    // 2. the slice's top", before="    pr[6] += clock64() - tW; tW = clock64();\n")
    hook("    const int nh = s_ntop;\n", after="    pr[7] += clock64() - tW;\n")
    hook("    cluster.sync();\n\n    // every block merges",
         before=lap.format(2))
    hook("    // every block merges the cluster's walks", before=lap.format(3))
    hook("    const int taken = __syncthreads_count(take);\n", after=lap.format(4))
    hook("    __syncthreads();  // counts bumped this chunk feed the next tables\n",
         after=lap.format(5))
    hook("  cluster.sync();  // no block leaves while another may read its shared memory\n}",
         before="  if (blockIdx.x == 0 && tid == 0) {\n"
                "    for (int q = 0; q < 8; ++q) g_prof[q] = pr[q];\n"
                "    g_prof[8] = nsteps;\n  }\n")
    out = src[:a] + k + src[b:]
    anchor = "namespace {\n\nconstexpr int kThreads"
    assert out.count(anchor) == 1
    out = out.replace(anchor, "__device__ long long g_prof[16];\n\n" + anchor)
    return out + (
        '\nextern "C" int nomad_profile_read(long long* host) {\n'
        "  return static_cast<int>(cudaMemcpyFromSymbol(host, g_prof, sizeof(g_prof)));\n}\n"
    )


def main() -> int:
    if not torch.cuda.is_available():
        print("coupled_step_profile: needs CUDA", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(C.card_line(), flush=True)
    out_dir = backend.BUILD_DIR / "profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / "coupled_profile.cu"
    cu.write_text(profiled_source())
    so = out_dir / "libcoupled_profile.so"
    subprocess.run([backend.nvcc_path(), *backend.NVCC_FLAGS, f"-I{backend.CSRC_DIR}",
                    "-o", str(so), str(cu)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.nomad_profile_read.argtypes = [ctypes.c_void_p]
    lib.nomad_profile_read.restype = ctypes.c_int
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"SM clock (now, max): {clocks}", flush=True)
    real = S.cuda_library
    S.cuda_library = lambda name: lib if name == "coupled" else real(name)
    counts = (ctypes.c_longlong * 16)()
    try:
        for name, route, kw in CASES:
            c = C.coupled_inputs(dev, route=route, **kw)
            for _ in range(3):
                getattr(S, name)(**c)
            torch.cuda.synchronize()
            assert lib.nomad_profile_read(ctypes.addressof(counts)) == 0
            steps = max(counts[8], 1)
            split = ", ".join(f"{p} {counts[i] / steps:.0f}" for i, p in enumerate(PHASES))
            print(f"{name} {kw}: {counts[8]} steps; cycles a step: {split}", flush=True)
    finally:
        S.cuda_library = real
    return 0


if __name__ == "__main__":
    sys.exit(main())
