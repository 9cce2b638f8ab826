"""Profiling / self-diagnosis surface — the pprof analog.

Reference: Go pprof is first-class in the agent
(command/agent/http.go:331 `/v1/agent/pprof/*`, command/agent/pprof/) and
`nomad operator debug` captures a support bundle of pprof + logs + state
(command/operator_debug.go:54). Python equivalents:

- goroutine profile → thread dump via sys._current_frames();
- CPU profile      → sampling profiler over the same frame table
  (collapsed-stack counts, flamegraph-ready);
- heap profile     → tracemalloc top allocations (enabled on demand);
- operator debug   → one JSON bundle of metrics, broker/raft/worker
  stats, and the thread dump.
"""

from __future__ import annotations

import threading
import time
import traceback
import sys
from collections import Counter


def thread_dump() -> dict:
    """pprof/goroutine analog: every thread's current stack."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for ident, frame in sys._current_frames().items():
        stack = traceback.format_stack(frame)
        out[f"{names.get(ident, 'unknown')}-{ident}"] = [
            line.strip() for line in stack
        ]
    return out


def sample_profile(seconds: float = 1.0, hz: int = 100) -> dict:
    """pprof/profile analog: sample all threads' stacks at ``hz`` for
    ``seconds``; returns collapsed stacks (semicolon-joined frames →
    sample count), ready for flamegraph tooling."""
    samples: Counter = Counter()
    interval = 1.0 / max(hz, 1)
    deadline = time.monotonic() + seconds
    me = threading.get_ident()
    n = 0
    while time.monotonic() < deadline:
        for ident, frame in sys._current_frames().items():
            if ident == me:
                continue
            frames = []
            f = frame
            while f is not None:
                code = f.f_code
                frames.append(f"{code.co_filename.rsplit('/', 1)[-1]}:{code.co_name}")
                f = f.f_back
            samples[";".join(reversed(frames))] += 1
        n += 1
        time.sleep(interval)
    return {
        "duration_s": seconds,
        "samples": n,
        "collapsed": dict(samples.most_common(200)),
    }


def heap_profile(top: int = 50) -> dict:
    """pprof/heap analog via tracemalloc; starts tracing on first call
    (subsequent calls diff against a warm tracer)."""
    import tracemalloc

    if not tracemalloc.is_tracing():
        tracemalloc.start()
        return {"started": True, "note": "tracing enabled; call again for stats"}
    snap = tracemalloc.take_snapshot()
    stats = snap.statistics("lineno")[:top]
    return {
        "started": False,
        "total_kb": sum(s.size for s in stats) // 1024,
        "top": [
            {
                "site": str(s.traceback[0]) if s.traceback else "?",
                "size_kb": s.size // 1024,
                "count": s.count,
            }
            for s in stats
        ],
    }


def debug_bundle(server) -> dict:
    """`nomad operator debug` analog (command/operator_debug.go:54): one
    self-contained diagnostic capture of the server's moving parts."""
    from .metrics import global_metrics

    bundle: dict = {
        "captured_at": time.time(),
        "metrics": global_metrics.snapshot(),
        "threads": thread_dump(),
    }
    try:
        broker = server.eval_broker
        bundle["eval_broker"] = {
            **dict(getattr(broker, "stats", {}) or {}),
            "ready": broker.ready_count(),
            "unacked": len(broker._unack),
        }
    except Exception:
        pass
    try:
        bundle["blocked_evals"] = dict(server.blocked_evals.stats)
    except Exception:
        pass
    try:
        bundle["workers"] = [dict(w.stats) for w in server.workers]
    except Exception:
        pass
    try:
        bundle["device_cache"] = {
            "full_flattens": server.device_cache.full_flattens,
            "incremental_refreshes": server.device_cache.incremental_refreshes,
            "hits": server.device_cache.hits,
            "stale_builds": server.device_cache.stale_builds,
        }
    except Exception:
        pass
    raft = getattr(server, "raft", None)
    if raft is not None:
        try:
            bundle["raft"] = raft.stats()
        except Exception:
            pass
    return bundle
