"""Process-wide metrics registry (ServerMetrics/BrokerMetrics analog):
counters, gauges, timers and histograms keyed by name.

Copy of the registry part of pinot_tpu/utils/metrics.py: `Counter`, `Gauge`,
`Timer`, `Histogram`, `MetricsRegistry` (`snapshot`, `reset`) and the
process registry `METRICS`.  Trace spans, the Prometheus exposition and the
cross-server federation come with the observability slice of the port.
Emitters call METRICS.counter("dist.queries").inc() on the hot path (dict
lookups only).

Thread-safety contract: concurrent queries and the residency staging thread
mutate the same metric objects, so every read-modify-write holds that
metric's own lock (a bare `+=` on an attribute is NOT atomic in CPython),
and snapshot() copies the name->metric maps under the registry lock before
reading each metric under its own.
"""
from __future__ import annotations

import bisect
import threading
from typing import Any, Dict, Tuple


class Counter:
    __slots__ = ("value", "_lock")

    def __init__(self) -> None:
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n


class Gauge:
    __slots__ = ("value", "_lock")

    def __init__(self) -> None:
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        # single attribute store: atomic under the GIL, no lock needed
        self.value = float(v)

    def add(self, delta: float) -> None:
        """Locked increment for gauges tracking a live count (in-flight
        scatters, pinned bytes) where += would lose concurrent updates."""
        with self._lock:
            self.value += float(delta)


class Timer:
    """Count + total + max milliseconds (the cheap aggregate slice when a
    full histogram is overkill — latency-critical paths use Histogram)."""

    __slots__ = ("count", "total_ms", "max_ms", "_lock")

    def __init__(self) -> None:
        self.count = 0
        self.total_ms = 0.0
        self.max_ms = 0.0
        self._lock = threading.Lock()

    def update(self, ms: float) -> None:
        with self._lock:
            self.count += 1
            self.total_ms += ms
            if ms > self.max_ms:
                self.max_ms = ms

    @property
    def mean_ms(self) -> float:
        with self._lock:
            return self.total_ms / self.count if self.count else 0.0

    def _snap(self) -> Dict[str, Any]:
        with self._lock:
            mean = self.total_ms / self.count if self.count else 0.0
            return {"count": self.count, "meanMs": mean, "maxMs": self.max_ms}


# log-spaced millisecond bucket upper bounds: 0.1ms .. ~52s, doubling —
# the same scale promhttp's ExponentialBuckets(0.1, 2, 20) would pick for a
# query-latency histogram (sub-ms kernel launches up to deadline-scale tails)
_HIST_BOUNDS_MS: Tuple[float, ...] = tuple(0.1 * (2.0 ** k) for k in range(20))


class Histogram:
    """Fixed log-spaced ms buckets + count/sum/max/min; p50/p95/p99 come from
    a cumulative bucket walk with linear interpolation inside the bucket (the
    HdrHistogram-lite answer — a few percent of bucket width, allocation-free
    on the update path)."""

    __slots__ = ("bounds", "counts", "count", "sum_ms", "max_ms", "min_ms", "_lock")

    def __init__(self, bounds: Tuple[float, ...] = _HIST_BOUNDS_MS) -> None:
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)  # last slot = +Inf overflow
        self.count = 0
        self.sum_ms = 0.0
        self.max_ms = 0.0
        self.min_ms = float("inf")
        self._lock = threading.Lock()

    def update(self, ms: float) -> None:
        i = bisect.bisect_left(self.bounds, ms)
        with self._lock:
            self.counts[i] += 1
            self.count += 1
            self.sum_ms += ms
            if ms > self.max_ms:
                self.max_ms = ms
            if ms < self.min_ms:
                self.min_ms = ms

    def _quantile_locked(self, q: float) -> float:
        """Caller holds self._lock."""
        if not self.count:
            return 0.0
        target = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if not c:
                continue
            prev_cum = cum
            cum += c
            if cum >= target:
                if i >= len(self.bounds):
                    return self.max_ms  # overflow bucket: best bound we have
                lo = self.bounds[i - 1] if i else 0.0
                hi = self.bounds[i]
                frac = (target - prev_cum) / c
                return min(lo + (hi - lo) * frac, self.max_ms)
        return self.max_ms

    def _snap(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "count": self.count,
                "meanMs": self.sum_ms / self.count if self.count else 0.0,
                "maxMs": self.max_ms,
                "minMs": self.min_ms if self.count else 0.0,
                "p50Ms": self._quantile_locked(0.50),
                "p95Ms": self._quantile_locked(0.95),
                "p99Ms": self._quantile_locked(0.99),
            }


class MetricsRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._timers: Dict[str, Timer] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter())
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge())
        return g

    def timer(self, name: str) -> Timer:
        t = self._timers.get(name)
        if t is None:
            with self._lock:
                t = self._timers.setdefault(name, Timer())
        return t

    def histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(name, Histogram())
        return h

    def _copies(self):
        """Stable name->metric copies: concurrent registration must never
        blow up the snapshot iteration (dict-changed-size)."""
        with self._lock:
            return (
                dict(self._counters),
                dict(self._gauges),
                dict(self._timers),
                dict(self._histograms),
            )

    def snapshot(self) -> Dict[str, Any]:
        counters, gauges, timers, hists = self._copies()
        return {
            "counters": {k: c.value for k, c in counters.items()},
            "gauges": {k: g.value for k, g in gauges.items()},
            "timers": {k: t._snap() for k, t in timers.items()},
            "histograms": {k: h._snap() for k, h in hists.items()},
        }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._timers.clear()
            self._histograms.clear()


METRICS = MetricsRegistry()
