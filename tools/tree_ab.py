"""Two checkouts of the repo compared on one NVIDIA GPU: the "schedule"
path's eval latency and the end-to-end server bench, arm by arm.

    python3 tools/tree_ab.py TREE_A TREE_B [--pairs 4]

Each tree is a directory holding a checkout (``git archive`` of a
commit). The arms run in the order A, B, B, A, A, B, B, A, ... (``--pairs``
pairs), each in a process of its own started in its tree: it builds that
tree's kernels, runs ``chip_smoke.main_path`` (10 service evals of 1,000
allocs on 10,000 mock nodes through the Harness, then the score_group
path), ``bench_torch.bench_end_to_end`` at ``chip_smoke.SERVER_BENCH``
and ``chip_smoke.guard_cost`` (µs a synchronized closed-form call through
the kernel guard and straight). Prints the card's name and power limit
first, one JSON line an arm (the schedule path's eval p50 / p99 in ms,
the bench's allocs/s and eval p50 / p99 in ms, the guard's µs a call
both ways), and the medians by tree last. No jax.
"""

import argparse
import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
from pathlib import Path

ARM = "AB "


def run_arm() -> None:
    """One arm, in the current directory's tree."""
    sys.path.insert(0, os.getcwd())
    import bench_torch
    import chip_smoke as C
    from nomad_tpu_torch import backend

    dev = backend.resolve_device("cuda")
    backend.build_all()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        C.main_path(dev)
    line = next(l for l in buf.getvalue().splitlines()
                if l.startswith("[main]") and " evals in " in l)
    p50, p99 = re.search(r"eval p50_ms=([\d.]+) p99_ms=([\d.]+)", line).groups()
    b = bench_torch.bench_end_to_end(**C.SERVER_BENCH, device=dev)
    with contextlib.redirect_stdout(io.StringIO()):
        guard = C.guard_cost(dev)
    print(ARM + json.dumps({
        "schedule_p50_ms": float(p50), "schedule_p99_ms": float(p99),
        "server_allocs_per_sec": b["allocs_per_sec"],
        "server_p50_ms": b["eval_latency_ms"]["p50"],
        "server_p99_ms": b["eval_latency_ms"]["p99"],
        "guarded_us_per_call": guard["guarded_us_per_call"],
        "straight_us_per_call": guard["straight_us_per_call"],
    }), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs=2)
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--arm", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.arm:
        run_arm()
        return 0
    me = Path(__file__).resolve()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)
    order = [0, 1, 1, 0] * ((args.pairs + 1) // 2)
    runs = {tree: [] for tree in args.trees}
    for i in order[: 2 * args.pairs]:
        tree = args.trees[i]
        out = subprocess.run(
            [sys.executable, str(me), *args.trees, "--arm"], cwd=tree,
            capture_output=True, text=True, check=True,
        ).stdout
        row = json.loads(next(l for l in out.splitlines() if l.startswith(ARM))[len(ARM):])
        runs[tree].append(row)
        print(json.dumps({"tree": tree, **row}), flush=True)
    print(json.dumps({
        tree: {k: statistics.median(r[k] for r in rows) for k in rows[0]}
        for tree, rows in runs.items()
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
