"""The end-to-end bench with the admission controller as shipped against
thresholds that one of its votes cannot reach, on one NVIDIA GPU.

    python3 tools/admission_ab.py [--reps 2]

``bench_torch.bench_end_to_end`` at its defaults (10,000 nodes, 100 jobs
x 250 allocs, every leader service running) under four arms, each rep
running them in a rotated order:

- ``shipped``: the calibration table's thresholds;
- ``no_p99_vote``: the eval-latency p99 vote out of reach;
- ``no_imbalance_vote``: the arrival-over-completion vote out of reach;
- ``normal``: every vote out of reach, so the level stays NORMAL and the
  worker keeps its 16-eval / 0.2 s dequeue window.

Prints the card's name and power limit first, one JSON line a run
(allocs/s, evals/s, eval p50 / p99, the admission block, merged commits
and their size, ``invoke_scheduler``'s mean) and a summary of medians
last. No jax.
"""

import argparse
import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import bench_torch  # noqa: E402

OUT_OF_REACH = 1e12
ARMS = {
    "shipped": None,
    "no_p99_vote": {"brownout_p99_ms": OUT_OF_REACH, "shed_p99_ms": OUT_OF_REACH},
    "no_imbalance_vote": {"imbalance_ratio": OUT_OF_REACH},
    "normal": {
        "brownout_p99_ms": OUT_OF_REACH, "shed_p99_ms": OUT_OF_REACH,
        "imbalance_ratio": OUT_OF_REACH, "brownout_backlog": OUT_OF_REACH,
        "shed_backlog": OUT_OF_REACH,
    },
}
KEYS = ("allocs_per_sec", "evals_per_sec", "eval_latency_ms", "elapsed_s", "admission")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("admission_ab: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    print(bench_torch.card_line(), flush=True)
    names = list(ARMS)
    runs = {name: [] for name in names}
    for rep in range(args.reps):
        order = names[rep % len(names):] + names[:rep % len(names)]
        for name in order:
            out = bench_torch.bench_end_to_end(device="cuda", admission_overrides=ARMS[name])
            assert out["drained"] and out["unaccounted_allocs"] == 0, out
            row = {"arm": name, "rep": rep, **{k: out[k] for k in KEYS},
                   "merged_commits": out["commit_train"]["merged_commits"],
                   "applier_batch_size": out["commit_train"]["applier_batch_size"],
                   "invoke_scheduler_mean_ms":
                       out["phase_breakdown_ms"]["invoke_scheduler"]["mean_ms"]}
            runs[name].append(row)
            print(json.dumps(row, sort_keys=True), flush=True)
    summary = {
        name: {
            "allocs_per_sec": statistics.median(r["allocs_per_sec"] for r in rows),
            "p50_ms": statistics.median(r["eval_latency_ms"]["p50"] for r in rows),
            "p99_ms": statistics.median(r["eval_latency_ms"]["p99"] for r in rows),
            "levels": sorted({r["admission"]["level"] for r in rows}),
            "merged_commits": [r["merged_commits"] for r in rows],
        }
        for name, rows in runs.items()
    }
    print(json.dumps({"summary": summary}, sort_keys=True), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
