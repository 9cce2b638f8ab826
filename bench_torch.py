"""End-to-end bench of the PyTorch/CUDA port's server.

    python3 bench_torch.py [--device cuda|cpu] [--nodes N] [--jobs J] [--per-job P]
                           [--mesh dp,mp|auto|off]

The JAX package's ``bench.py end_to_end`` block run through the port's
server (``nomad_tpu_torch.server``): the same node recipe (25 racks, ssd on
every 4th node, every 3rd at 8,000 MHz / 16 GiB), the same jobs (mixed
service / batch, an even rack spread and an ssd affinity, 250 or 500 MHz
tasks), the same warmup and drain, and the same result keys, with
``phase_breakdown_ms`` from the port's flight recorder. It adds the
device, eval latency p50 / p99 from ``trace_latencies`` (queue wait plus
dequeue → ack, one per measured eval), the checks a run must pass
(``failed_evals``, ``committed_overcommit``, ``swallowed``), the admission
controller's state at the end of the run (``admission``: level, level
changes, deferred and shed decisions, broker deferrals) and, on the card,
the card's name and power limit as ``nvidia-smi`` gives them. The server
runs every leader service, as the reference's bench does.

``--mesh`` sets the process mesh (``NOMAD_TPU_MESH``'s grammar) before
anything resolves it: the server's device cache and kernels lay their
passes out over it. A spec asking for more devices than there are
raises before any output (the CPU counts as 8). The line's ``mesh``
block says what ran: shape, axis names, devices, nodes per shard, and
the measured time of one cross-shard top-k merge at this run's padded
node bucket.

Every kernel library is built and loaded before the server starts, so no
eval's deadline meets a compiler. Prints one JSON line. Defaults: the
card, 10,000 nodes, 100 jobs x 250 allocs, one batching worker.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def build_kernels(device) -> None:
    """Build (in parallel) and load every CUDA library, so the first eval
    never waits on nvcc. Nothing to build for the CPU."""
    from nomad_tpu_torch import backend

    if backend.resolve_device(device).type != "cuda":
        return
    for name in backend.build_all():
        backend.cuda_library(name)


def _pop_mesh_arg(argv: list):
    """Strip ``--mesh SPEC`` / ``--mesh=SPEC`` from argv and activate the
    mesh by seeding ``NOMAD_TPU_MESH`` before the first ``get_mesh()``
    resolution. Returns the spec or None; junk fails fast."""
    import os

    from nomad_tpu_torch.backend import get_mesh, parse_mesh_spec, reset_mesh

    spec = None
    for i, arg in enumerate(argv):
        if arg == "--mesh" and i + 1 < len(argv):
            spec = argv[i + 1]
            del argv[i:i + 2]
            break
        if arg.startswith("--mesh="):
            spec = arg.split("=", 1)[1]
            del argv[i]
            break
    if spec is not None:
        parse_mesh_spec(spec)
        os.environ["NOMAD_TPU_MESH"] = spec
        reset_mesh()
        get_mesh()  # raises here when the devices are too few
    return spec


MERGE_K = 16  # candidates a shard forwards in the measured merge
MERGE_REPS = 10


def mesh_block(n_nodes: int = 0) -> dict:
    """The mesh's self-description for the JSON line: shape, axis names,
    devices, per-shard node counts and the measured time of one
    cross-shard top-k merge (``closed_form_topk_merge``: S shards' top
    16 of a random plane at this run's padded node bucket, merged on the
    lead; the kernel on the card, its plain version on the CPU), in µs
    over ``MERGE_REPS`` calls after a warm-up."""
    from nomad_tpu_torch.backend import direct_launches, get_mesh
    from nomad_tpu_torch.device.flatten import node_bucket
    from nomad_tpu_torch.device.score import closed_form_topk_merge

    cfg = get_mesh()
    out = dict(cfg.describe())
    if not cfg.active or not n_nodes:
        return out
    pn = node_bucket(n_nodes)
    mp = cfg.n_node_shards
    out["padded_nodes"] = pn
    out["nodes_per_shard"] = pn // mp if pn % mp == 0 else None
    if pn % mp != 0:
        return out
    seg = pn // mp
    flat = torch.from_numpy(np.random.default_rng(0).random(pn, dtype=np.float32))
    rows, scores = [], []
    for j in range(mp):
        v, i = torch.sort(flat[j * seg:(j + 1) * seg], descending=True, stable=True)
        rows.append(i[:MERGE_K].to(torch.int32)[None].contiguous().to(cfg.lead))
        scores.append(v[:MERGE_K][None].contiguous().to(cfg.lead))
    cuda = cfg.lead.type == "cuda"
    with direct_launches():
        closed_form_topk_merge(rows, scores, seg, MERGE_K)
        if cuda:
            torch.cuda.synchronize(cfg.lead)
        t0 = time.perf_counter()
        for _ in range(MERGE_REPS):
            closed_form_topk_merge(rows, scores, seg, MERGE_K)
        if cuda:
            torch.cuda.synchronize(cfg.lead)
    out["topk_merge_us"] = (time.perf_counter() - t0) / MERGE_REPS * 1e6
    out["topk_merge_on"] = "kernel" if cuda else "plain version (CPU)"
    return out


def committed_overcommit(store) -> int:
    """Nodes whose committed (non-terminal) usage exceeds capacity."""
    from nomad_tpu_torch.structs.resources import node_comparable_capacity

    bad = 0
    for node in store.nodes():
        cap = node_comparable_capacity(node).to_vector()
        used = np.zeros_like(cap)
        for a in store.allocs_by_node(node.id):
            if not a.terminal_status():
                used += a.comparable_resources().to_vector()
        bad += int(np.any(used > cap))
    return bad


def percentile_ms(values_s, q: float) -> float:
    return float(np.percentile(np.asarray(values_s) * 1e3, q)) if values_s else 0.0


def bench_node(i: int, racks: int = 25):
    """Node ``i`` of the bench's recipe: 4,000 MHz / 8 GiB mock nodes in
    dc1, rack ``r<i % racks>``, ssd on every 4th, every 3rd (i % 3 == 1)
    at 8,000 MHz / 16 GiB."""
    from nomad_tpu_torch import mock

    node = mock.node()
    node.datacenter = "dc1"
    node.attributes["platform.rack"] = f"r{i % racks}"
    node.attributes["storage.type"] = "ssd" if i % 4 == 0 else "hdd"
    if i % 3 == 1:
        node.node_resources.cpu = 8000
        node.node_resources.memory_mb = 16384
    node.compute_class()
    return node


def bench_job(j: int, per_job: int):
    """Job ``j`` of the bench (``bench-<j>``): a batch job for every 3rd
    (j % 3 == 2), else a service job, of ``per_job`` allocs at 250 or 500
    MHz (seeded by ``j``), with an even rack spread and an ssd affinity."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import Affinity, Spread

    job = mock.batch_job() if j % 3 == 2 else mock.job()
    job.id = f"bench-{j}"
    tg = job.task_groups[0]
    tg.count = per_job
    tg.tasks[0].resources.cpu = int(np.random.default_rng(j).choice([250, 500]))
    job.spreads = [Spread(attribute="${attr.platform.rack}", weight=50)]
    job.affinities = [
        Affinity(l_target="${attr.storage.type}", r_target="ssd", operand="=", weight=50)
    ]
    return job


def warm_up(server, per_job: int) -> bool:
    """The bench's warmup: run the batch depths the measured run will hit
    (1 for stragglers and the full EVAL_BATCH_SIZE-deep pass) on the
    server's cluster before the clock starts, then stop and drain the warm
    jobs so the measured run starts on an empty cluster. True when both
    drains finished."""
    from nomad_tpu_torch.server.worker import EVAL_BATCH_SIZE

    warm_ids = []
    for w in range(EVAL_BATCH_SIZE + 1):
        warm = bench_job(10_000_000 + w, per_job)
        warm.id = f"warmup-{w}"
        warm_ids.append(warm.id)
        server.register_job(warm)
    placed = server.wait_for_evals(timeout=600)
    for wid in warm_ids:
        server.deregister_job("default", wid)
    stopped = server.wait_for_evals(timeout=600)
    return placed and stopped


def bench_end_to_end(
    n_nodes: int = 10_000, n_jobs: int = 100, per_job: int = 250, racks: int = 25,
    device="cuda", admission_overrides=None,
) -> dict:
    """BASELINE config-3 shape: mixed service/batch with spread+affinity
    through the full server pipeline, on ``device``, with one batching
    worker (the reference bench's default). ``admission_overrides`` go to
    ``ServerConfig`` as they are (``tools/admission_ab.py`` compares the
    shipped thresholds with thresholds the run never reaches)."""
    from nomad_tpu_torch.obs import flight_recorder, phase_breakdown
    from nomad_tpu_torch.obs.recorder import trace_latencies
    from nomad_tpu_torch.server import Server, ServerConfig
    from nomad_tpu_torch.utils.metrics import global_metrics

    build_kernels(device)
    server = Server(ServerConfig(
        num_workers=1, num_batch_workers=1, device=device,
        admission_overrides=admission_overrides,
    ))
    server.establish_leadership()
    try:
        # seed nodes directly into state (setup, not the measured path)
        for i in range(n_nodes):
            server.store.upsert_node(i + 1, bench_node(i, racks))
        warm_up(server, per_job)
        warm_live = sum(
            1 for a in server.store.allocs()
            if a.job_id.startswith("warmup-") and not a.terminal_status()
        )
        global_metrics.reset()
        flight_recorder.clear()

        t0 = time.perf_counter()
        for j in range(n_jobs):
            server.register_job(bench_job(j, per_job))
        ok = server.wait_for_evals(timeout=600)
        if server.device_cache.device.type == "cuda":
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0

        placed = sum(
            1 for a in server.store.allocs()
            if a.job_id.startswith("bench-") and not a.terminal_status()
        )
        snap = global_metrics.snapshot()
        plan = snap["samples"].get("nomad.plan.apply", {})
        invoke = snap["samples"].get("nomad.worker.invoke_scheduler", {})
        verify_batch = snap["samples"].get("nomad.plan.verify_batch", {})
        counters = snap["counters"]
        plan_commits = int(counters.get("nomad.plan.commits", 0))
        committed_plans = int(counters.get("nomad.plan.committed_plans", 0))
        merged_commits = int(counters.get("nomad.plan.merged_commits", 0))
        merged_members = int(counters.get("nomad.plan.merged_members", 0))
        # per-eval counter, not the invoke_scheduler sample count: the
        # batched pass emits one timer sample per multi-eval batch
        evals = int(counters.get("nomad.worker.evals_processed", n_jobs))
        batch_completed = int(counters.get("nomad.worker.batch_evals_completed", 0))
        batch_conflicts = int(counters.get("nomad.worker.batch_conflict_fallbacks", 0))
        batch_singles = int(counters.get("nomad.worker.batch_single_fallbacks", 0))
        batch_total = batch_completed + batch_conflicts
        solo_evals = int(counters.get("nomad.worker.solo_evals", 0))
        # every unplaced alloc must be attributable: blocked evals park
        # the shortfall with per-TG failure reasons
        blocked = server.blocked_evals.captured()
        blocked_queued = 0
        failed_reasons: dict = {}
        for bev in blocked:
            blocked_queued += sum(bev.queued_allocations.values())
            for metric in bev.failed_tg_allocs.values():
                m = getattr(metric, "metric", metric)
                for reason, cnt in (m.dimension_exhausted or {}).items():
                    key = f"exhausted:{reason}"
                    failed_reasons[key] = failed_reasons.get(key, 0) + cnt
                for reason, cnt in (m.constraint_filtered or {}).items():
                    key = f"filtered:{reason}"
                    failed_reasons[key] = failed_reasons.get(key, 0) + cnt
        traces = flight_recorder.traces()
        eval_s = [trace_latencies(t)[0] for t in traces]
        adm = server.admission.snapshot()
        return {
            "config": f"{n_nodes} nodes, {n_jobs} jobs x {per_job} allocs, "
            f"spread+affinity, mixed service/batch",
            "device": str(server.device_cache.device),
            "card": card_line() if server.device_cache.device.type == "cuda" else None,
            "batch_workers": 1,
            "warm_allocs_live_at_start": warm_live,
            "drained": ok,
            "placed": placed,
            "total": n_jobs * per_job,
            "blocked_evals": len(blocked),
            "blocked_queued_allocs": blocked_queued,
            "unaccounted_allocs": n_jobs * per_job - placed - blocked_queued,
            "failed_tg_reasons": failed_reasons,
            "failed_evals": sum(
                1 for e in server.store.evals()
                if e.job_id.startswith("bench-") and e.status == "failed"
            ),
            "committed_overcommit": committed_overcommit(server.store),
            # every intentionally swallowed exception by component (the
            # worker's, the applier's "lanes"), and the batched passes
            # that failed and fell back to solo evals
            "swallowed": {
                **{
                    k[: -len(".swallowed_errors")]: int(v)
                    for k, v in counters.items() if k.endswith(".swallowed_errors")
                },
                "batch_kernel_errors": int(
                    counters.get("nomad.worker.batch_kernel_errors", 0)
                ),
            },
            # the overload plane over the whole run (warmup included):
            # at this load it stays NORMAL and admits everything
            "admission": {
                "level": adm["level"],
                "level_changes": adm["level_changes"],
                "deferred": sum(c["deferred"] for c in adm["counters"].values()),
                "shed": sum(c["shed"] for c in adm["counters"].values()),
                "submitted": sum(c["submitted"] for c in adm["counters"].values()),
                "broker_deferred": int(server.eval_broker.counters["admission_deferred"]),
                "conserved": server.admission.conserved(),
            },
            "elapsed_s": round(elapsed, 3),
            "evals_per_sec": round(evals / elapsed, 1),
            "allocs_per_sec": round(placed / elapsed, 1),
            "eval_latency_ms": {
                "evals": len(eval_s),
                "p50": percentile_ms(eval_s, 50),
                "p99": percentile_ms(eval_s, 99),
            },
            "plan_apply_p99_ms": round(plan.get("p99_ms", 0.0), 2),
            "plan_apply_mean_ms": round(plan.get("mean_ms", 0.0), 2),
            "invoke_scheduler_p99_ms": round(invoke.get("p99_ms", 0.0), 2),
            "batch": {
                "evals_completed_in_batch": batch_completed,
                "conflict_fallbacks": batch_conflicts,
                "single_path_evals": batch_singles,
                "solo_evals": solo_evals,
                "conflict_rate": round(batch_conflicts / batch_total, 3)
                if batch_total else 0.0,
            },
            "lanes": {
                "lane_conflicts": int(counters.get("nomad.plan.lane_conflicts", 0)),
                "cross_lane_handoffs": int(
                    counters.get("nomad.plan.cross_lane_handoffs", 0)
                ),
                "handoff_fallbacks": int(
                    counters.get("nomad.worker.lane_handoff_fallbacks", 0)
                ),
                "stale_token_drops": int(
                    counters.get("nomad.worker.stale_token_drops", 0)
                ),
            },
            "commit_train": {
                "plan_commits": plan_commits,
                "plans_per_commit": round(committed_plans / plan_commits, 2)
                if plan_commits else 0.0,
                "merged_commits": merged_commits,
                "applier_batch_size": round(merged_members / merged_commits, 2)
                if merged_commits else 0.0,
                "verify_batch_p95_ms": round(verify_batch.get("p95_ms", 0.0), 2),
            },
            "device_cache": {
                "full_flattens": server.device_cache.full_flattens,
                "incremental_refreshes": server.device_cache.incremental_refreshes,
                **server.device_cache.device_counters(),
            },
            # where the eval pipeline spends its time, from the span
            # traces of the measured run (flight recorder cleared at t0)
            "phase_breakdown_ms": phase_breakdown(traces),
        }
    finally:
        server.shutdown()


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    _pop_mesh_arg(argv)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nodes", type=int, default=10_000)
    ap.add_argument("--jobs", type=int, default=100)
    ap.add_argument("--per-job", type=int, default=250)
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("bench_torch: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    out = bench_end_to_end(args.nodes, args.jobs, args.per_job, device=args.device)
    out["mesh"] = mesh_block(args.nodes)
    print(json.dumps(out, sort_keys=True), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
