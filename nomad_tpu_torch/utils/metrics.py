"""In-process metrics registry.

Reference: armon/go-metrics gauges/timers used throughout the reference
(`nomad.worker.*` worker.go:461,495,553; `nomad.plan.*` plan_apply.go:185)
surfaced at /v1/metrics (http.go:333). Counters, gauges and timing
samples with mean/max, zero dependencies.

Timing series are held as bounded :class:`~nomad_tpu_torch.utils.hist.LogHistogram`
buckets — O(buckets) memory per key no matter how many samples are
recorded, so a minutes-long soak can't grow the registry. Percentiles
read from bucket counts land within one ~7%-wide bucket of the exact
sorted-list answer; count/mean/max stay exact.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

from .hist import LogHistogram, pct_nearest_rank


class Metrics:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._samples: dict[str, LogHistogram] = {}

    def incr(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def measure(self, name: str, seconds: float) -> None:
        with self._lock:
            hist = self._samples.get(name)
            if hist is None:
                hist = self._samples[name] = LogHistogram()
            hist.record(seconds)

    @contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.measure(name, time.perf_counter() - t0)

    @staticmethod
    def _pct(sorted_buf: list[float], q: float) -> float:
        return pct_nearest_rank(sorted_buf, q)

    def histograms(self) -> dict[str, LogHistogram]:
        """Point-in-time copies of every timing series, for callers
        (the SLO collector) that want to window-diff bucket counts."""
        with self._lock:
            return {name: h.copy() for name, h in self._samples.items()}

    def snapshot(self) -> dict:
        # copy under the lock, summarize outside it: a percentile read
        # walks every bucket per series, and holding the registry lock
        # through it would stall every measure()/incr() on the worker
        # hot path while /v1/metrics renders
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = {name: h.copy() for name, h in self._samples.items()}
        samples = {name: h.snapshot() for name, h in hists.items()}
        return {
            "counters": counters,
            "gauges": gauges,
            "samples": samples,
        }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._samples.clear()


global_metrics = Metrics()
