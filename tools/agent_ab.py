"""The "server" path and the "agent" path's HTTP front door at one size,
alternated in one process on one NVIDIA GPU: what the HTTP layer costs
end to end.

    python3 tools/agent_ab.py [--pairs 3]

The arms run in the order S, A, A, S, S, A, ... (``--pairs`` pairs). S is
``chip_smoke.server_path`` (``bench_torch.bench_end_to_end`` at
``chip_smoke.SERVER_BENCH``, its calls recorded, its gates held); A is
``chip_smoke.agent_http_path`` at the same size (the same jobs registered
through the SDK, one HTTP request a job, its calls recorded the same
way, its gates held). Prints the card's name and power limit first, one
JSON line an arm (allocs/s, eval p50 / p99 in ms, and for A the register
request p50 / p99 in ms and the read-back seconds), and the medians by
arm last. No jax.
"""

import argparse
import contextlib
import io
import json
import os
import statistics
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke as C
    from nomad_tpu_torch import backend

    if not torch.cuda.is_available():
        print("agent_ab: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    dev = backend.resolve_device("cuda")
    backend.build_all()
    print(C.card_line(), flush=True)
    runs = {"server": [], "agent": []}
    server_out = None
    for i in range(args.pairs):
        for arm in ("server", "agent") if i % 2 == 0 else ("agent", "server"):
            with contextlib.redirect_stdout(io.StringIO()):
                if arm == "server":
                    server_out = C.server_path(dev)[2]
                    row = {
                        "allocs_per_sec": server_out["allocs_per_sec"],
                        "eval_p50_ms": server_out["eval_latency_ms"]["p50"],
                        "eval_p99_ms": server_out["eval_latency_ms"]["p99"],
                    }
                else:
                    s = C.agent_http_path(dev, server_out)[2]
                    row = {
                        "allocs_per_sec": s["allocs_per_sec"],
                        "eval_p50_ms": s["eval_latency_ms"]["p50"],
                        "eval_p99_ms": s["eval_latency_ms"]["p99"],
                        "register_p50_ms": s["register_ms"]["p50"],
                        "register_p99_ms": s["register_ms"]["p99"],
                        "readback_s": s["readback_s"],
                    }
            runs[arm].append(row)
            print(json.dumps({"arm": arm, **row}), flush=True)
    print(json.dumps({
        arm: {k: statistics.median(r[k] for r in rows) for k in rows[0]}
        for arm, rows in runs.items()
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
