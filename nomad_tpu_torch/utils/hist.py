"""Bounded telemetry primitives: log-bucketed histograms and
per-second time-series rings.

The original metrics registry kept a raw ``list[float]`` per sample key
and re-sorted it on every snapshot — fine for a drain bench, unusable
over a minutes-long soak where a single hot series records hundreds of
samples per second. Both structures here are O(1) per record and hold a
fixed amount of memory regardless of how many samples pass through:

* :class:`LogHistogram` — geometric buckets over ``[lo, hi)`` with
  ~7% relative width, so any percentile read is within one bucket
  (≤ ~3.5% relative error) of the exact sorted-list answer while count,
  sum, min and max stay exact.
* :class:`TimeSeriesRing` — a fixed number of per-second slots for
  "what did queue depth / arrival rate look like over the last N
  seconds", overwriting the oldest second as the clock advances.

Everything here is plain Python with no locking: callers (the metrics
registry, the SLO collector) serialize access with their own locks.
"""

from __future__ import annotations

import math


def pct_nearest_rank(sorted_buf: list[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted buffer — the one
    formula used repo-wide (metrics snapshots, trace phase breakdowns,
    histogram reads all agree on it)."""
    if not sorted_buf:
        return 0.0
    i = min(len(sorted_buf) - 1, int(round(q * (len(sorted_buf) - 1))))
    return sorted_buf[i]


class LogHistogram:
    """Fixed-memory histogram with geometrically-spaced buckets.

    Values are clamped into ``[lo, hi)``; bucket ``i`` covers
    ``[lo * growth**i, lo * growth**(i+1))``. With the defaults
    (1 microsecond .. 1 hour, 7% growth) that is ~325 buckets — a few
    KB per series, forever, versus an unbounded sample list.
    """

    __slots__ = (
        "lo", "hi", "growth", "_log_growth", "_log_lo",
        "counts", "count", "total", "min", "max",
    )

    def __init__(
        self, lo: float = 1e-6, hi: float = 3600.0, growth: float = 1.07
    ):
        if not (lo > 0 and hi > lo and growth > 1.0):
            raise ValueError("need lo > 0, hi > lo, growth > 1")
        self.lo = lo
        self.hi = hi
        self.growth = growth
        self._log_growth = math.log(growth)
        self._log_lo = math.log(lo)
        n = int(math.ceil((math.log(hi) - self._log_lo) / self._log_growth))
        self.counts = [0] * n
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def _index(self, value: float) -> int:
        if value < self.lo:
            return 0
        i = int((math.log(value) - self._log_lo) // self._log_growth)
        return min(i, len(self.counts) - 1)

    def record(self, value: float) -> None:
        self.counts[self._index(value)] += 1
        self.count += 1
        self.total += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value

    def merge(self, other: "LogHistogram") -> None:
        if len(other.counts) != len(self.counts):
            raise ValueError("histogram geometry mismatch")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.total += other.total
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)

    def _bucket_value(self, i: int) -> float:
        # geometric midpoint of the bucket, clamped to the observed
        # range so p0/p100 reads never invent values outside it
        mid = self.lo * self.growth ** (i + 0.5)
        return min(max(mid, self.min), self.max)

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile, same rank formula as
        :func:`pct_nearest_rank`, answered from bucket counts — the
        result lands inside the true sample's bucket, i.e. within one
        bucket width of the exact sorted-list answer."""
        if self.count == 0:
            return 0.0
        rank = min(self.count - 1, int(round(q * (self.count - 1))))
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen > rank:
                return self._bucket_value(i)
        return self.max

    def diff(self, base: "LogHistogram") -> "LogHistogram":
        """Windowed view: this histogram minus an earlier snapshot of
        the same series. Bucket counts, count and total subtract
        exactly; min/max can't be un-merged, so the window keeps the
        lifetime extremes (documented approximation — percentile reads
        only use them to clamp bucket midpoints)."""
        if len(base.counts) != len(self.counts):
            raise ValueError("histogram geometry mismatch")
        h = self.copy()
        for i, c in enumerate(base.counts):
            h.counts[i] -= c
        h.count -= base.count
        h.total -= base.total
        return h

    def copy(self) -> "LogHistogram":
        h = LogHistogram.__new__(LogHistogram)
        h.lo = self.lo
        h.hi = self.hi
        h.growth = self.growth
        h._log_growth = self._log_growth
        h._log_lo = self._log_lo
        h.counts = list(self.counts)
        h.count = self.count
        h.total = self.total
        h.min = self.min
        h.max = self.max
        return h

    def snapshot(self) -> dict:
        """The registry's sample shape: count/mean/max exact,
        percentiles within one bucket of exact."""
        if self.count == 0:
            return {
                "count": 0, "mean_ms": 0.0, "p50_ms": 0.0,
                "p95_ms": 0.0, "p99_ms": 0.0, "max_ms": 0.0,
            }
        return {
            "count": self.count,
            "mean_ms": (self.total / self.count) * 1000,
            "p50_ms": self.percentile(0.50) * 1000,
            "p95_ms": self.percentile(0.95) * 1000,
            "p99_ms": self.percentile(0.99) * 1000,
            "max_ms": self.max * 1000,
        }


class TimeSeriesRing:
    """Per-second slots over a sliding window of ``seconds``.

    ``observe(t, value)`` records a gauge-style sample into the slot for
    second ``int(t)``; ``incr(t, n)`` accumulates a counter. Advancing
    past a slot's horizon clears it, so memory is fixed at
    ``seconds`` slots no matter how long the soak runs.
    """

    __slots__ = ("seconds", "_epoch", "_counts", "_sums", "_maxes", "_events")

    def __init__(self, seconds: int = 600):
        if seconds <= 0:
            raise ValueError("seconds must be positive")
        self.seconds = seconds
        self._epoch = [-1] * seconds   # which absolute second owns the slot
        self._counts = [0] * seconds   # gauge samples in the slot
        self._sums = [0.0] * seconds
        self._maxes = [0.0] * seconds
        self._events = [0.0] * seconds  # counter accumulation

    def _slot(self, t: float) -> int:
        sec = int(t)
        i = sec % self.seconds
        if self._epoch[i] != sec:
            self._epoch[i] = sec
            self._counts[i] = 0
            self._sums[i] = 0.0
            self._maxes[i] = 0.0
            self._events[i] = 0.0
        return i

    def observe(self, t: float, value: float) -> None:
        i = self._slot(t)
        self._counts[i] += 1
        self._sums[i] += value
        if self._counts[i] == 1 or value > self._maxes[i]:
            self._maxes[i] = value

    def incr(self, t: float, n: float = 1.0) -> None:
        self._events[self._slot(t)] += n

    def _live(self, now: float) -> list[int]:
        horizon = int(now) - self.seconds
        return [
            i for i in range(self.seconds)
            if self._epoch[i] > horizon and self._epoch[i] >= 0
        ]

    def series(self, now: float) -> list[tuple[int, float, float, float]]:
        """(second, mean, max, events) rows for live slots, oldest
        first — the raw per-second trajectory for a report."""
        rows = []
        for i in self._live(now):
            n = self._counts[i]
            rows.append((
                self._epoch[i],
                self._sums[i] / n if n else 0.0,
                self._maxes[i],
                self._events[i],
            ))
        rows.sort()
        return rows

    def stats(self, now: float) -> dict:
        """Aggregate over live slots: mean-of-means, global max, total
        events, events/sec over the covered span."""
        rows = self.series(now)
        if not rows:
            return {"seconds": 0, "mean": 0.0, "max": 0.0,
                    "events": 0.0, "events_per_s": 0.0}
        span = len(rows)
        sampled = [r for r in rows if r[1] or r[2]]
        mean = (
            sum(r[1] for r in sampled) / len(sampled) if sampled else 0.0
        )
        events = sum(r[3] for r in rows)
        return {
            "seconds": span,
            "mean": mean,
            "max": max(r[2] for r in rows),
            "events": events,
            "events_per_s": events / span,
        }
