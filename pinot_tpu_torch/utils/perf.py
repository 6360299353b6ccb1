"""Performance observatory: the analytic cost model, roofline %, and the
per-table/per-shape perf ledger.

Trimmed copy of pinot_tpu/utils/perf.py:

- KernelCost / analytic_cost(): the cost of one launch (bytes, flops) with
  its `source`.  The JAX package's capture_cost reads XLA's cost analysis on
  a TPU; a hand-written CUDA kernel has none, so every launch records the
  analytic model and says so (`source == "analytic"`).  Flops follow what
  the CUDA fused scan does: one add a row into its group's slot for the
  count and one per sum entry, not the one-hot matmul the JAX model counts.
- analytic_bytes_per_row(): bytes the scan streams per row under the
  packed-storage model (the JAX package's fallback cost model, which its
  CPU runs use too).  ExecutionStats.kernel_bytes = bytes per row x rows
  scanned.
- roofline_pct() = achieved bytes/s / the card's peak: 3.35e12 B/s, the
  H100 SXM's HBM rate (NVIDIA data sheet), in place of the JAX package's
  TPU table.
- PerfLedger: rolling windows of rows/s, bytes/s, roofline %, compile ms,
  plan-cache outcome and QPS keyed (table, shape digest).  Both engines
  record every query; the residency manager reads a table's bytes/s as its
  eviction heat (segment/residency.py).

The bench-history regression gate waits for a benchmark.
"""
from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, Optional, Tuple

from pinot_tpu_torch.utils.metrics import METRICS

# H100 SXM peak HBM bandwidth (NVIDIA data sheet), bytes/s
PEAK_HBM_BYTES_PER_SEC = 3.35e12


def analytic_bytes_per_row(columns, bitmap_params: int = 0) -> float:
    """Bytes the scan streams per row under the packed-storage model: each
    needed column at its stored width — bit-packed dict columns at
    `code_bits / 8` (the uint32 lane words are what actually stream; see
    segment/packing.py), unpacked dict codes at code dtype width, raw
    columns at value width — null bitmaps at 1 byte/row, plus one uint32
    per 32 rows per row-sharded index-bitmap parameter — the same model
    bench.py uses."""
    bpr = 0.0
    for c in columns:
        arr = c.codes if getattr(c, "codes", None) is not None else c.values
        if arr is not None:
            bits = getattr(c, "code_bits", None)
            if bits and getattr(c, "packed", None) is not None:
                bpr += bits / 8.0  # MV columns never pack, so no width factor
            else:
                bpr += arr.dtype.itemsize
        if getattr(c, "nulls", None) is not None:
            bpr += 1
    return bpr + bitmap_params * 4.0 / 32.0


@dataclass
class KernelCost:
    """Cost model for one launch (the JAX package's KernelCost without the
    XLA source's lowering and compile times)."""

    flops: float = 0.0
    bytes_accessed: float = 0.0
    source: str = "analytic"


def analytic_cost(
    num_rows: int,
    bytes_per_row: float,
    *,
    kind: str = "aggregation",
    num_groups: int = 0,
    num_entries: int = 1,
) -> KernelCost:
    """Analytic cost of one launch over `num_rows` rows.  Group-bys add each
    row into its group's slot: one add for the count and one per entry;
    plain aggregations a couple of ops a row an entry; selections one
    predicate op a row."""
    num_entries = max(1, num_entries)
    if kind.startswith("groupby") and num_groups > 0:
        flops_per_row = 1.0 + num_entries
    elif kind == "selection":
        flops_per_row = 1.0
    else:
        flops_per_row = 2.0 * num_entries
    return KernelCost(flops=float(num_rows) * flops_per_row, bytes_accessed=float(num_rows) * bytes_per_row)


def combine_sources(a: Optional[str], b: Optional[str]) -> Optional[str]:
    """Merge two cost-source tags when stats accumulate across launches."""
    if a is None or a == b:
        return b if a is None else a
    if b is None:
        return a
    return "mixed"


def roofline_pct(bytes_accessed: float, seconds: float) -> Optional[float]:
    """Achieved HBM bandwidth as % of device peak; None when unmeasurable."""
    if bytes_accessed <= 0 or seconds <= 0:
        return None
    return 100.0 * (bytes_accessed / seconds) / PEAK_HBM_BYTES_PER_SEC


@dataclass
class _LedgerEntry:
    window: int
    queries: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    compile_ms_total: float = 0.0
    rows_per_sec: Deque[float] = field(default_factory=collections.deque)
    bytes_per_sec: Deque[float] = field(default_factory=collections.deque)
    roofline: Deque[float] = field(default_factory=collections.deque)
    latency_ms: Deque[float] = field(default_factory=collections.deque)
    arrivals: Deque[float] = field(default_factory=collections.deque)

    def push(self, dq: Deque[float], v: float) -> None:
        dq.append(v)
        while len(dq) > self.window:
            dq.popleft()


def _win_stats(dq: Deque[float]) -> Dict[str, float]:
    if not dq:
        return {"last": 0.0, "mean": 0.0, "max": 0.0, "p99": 0.0}
    vals = list(dq)
    ordered = sorted(vals)
    p99 = ordered[min(len(ordered) - 1, int(round(0.99 * (len(ordered) - 1))))]
    return {
        "last": round(vals[-1], 3),
        "mean": round(sum(vals) / len(vals), 3),
        "max": round(max(vals), 3),
        # windowed tail: the autopilot's primary feedback signal
        "p99": round(p99, 3),
    }


def _window_qps(arrivals: Deque[float]) -> float:
    """Arrival rate over the rolling window: (n-1) queries per elapsed span.
    Span-based rather than per-second bucketing so short test bursts still
    read as a meaningful rate."""
    if len(arrivals) < 2:
        return 0.0
    span = arrivals[-1] - arrivals[0]
    return (len(arrivals) - 1) / span if span > 0 else 0.0


class PerfLedger:
    """Rolling perf windows keyed (table, shape digest).

    Gauges are per-table only (`perf.{table}.rowsPerSec` etc. — table names
    are a bounded set, same precedent as `server.segmentBytes.{table}`);
    shape digests stay inside the snapshot payload so metric-name
    cardinality never tracks query shapes."""

    def __init__(self, window: int = 128) -> None:
        self.window = window
        self._lock = threading.Lock()
        self._entries: Dict[Tuple[str, str], _LedgerEntry] = {}

    def record(
        self,
        table: str,
        shape_fp: str,
        *,
        rows: float,
        time_ms: float,
        kernel_bytes: float = 0.0,
        compile_ms: float = 0.0,
        cache_hit: Optional[bool] = None,
        engine: str = "sse",
    ) -> None:
        if not table:
            table = "_unknown"
        rows_ps = rows / (time_ms / 1000.0) if time_ms > 0 else 0.0
        bytes_ps = kernel_bytes / (time_ms / 1000.0) if time_ms > 0 else 0.0
        roof = roofline_pct(kernel_bytes, time_ms / 1000.0)
        now = time.monotonic()
        with self._lock:
            key = (table, shape_fp or "")
            e = self._entries.get(key)
            if e is None:
                e = self._entries[key] = _LedgerEntry(window=self.window)
            e.queries += 1
            if cache_hit is True:
                e.cache_hits += 1
            elif cache_hit is False:
                e.cache_misses += 1
            e.compile_ms_total += compile_ms
            e.push(e.rows_per_sec, rows_ps)
            e.push(e.bytes_per_sec, bytes_ps)
            e.push(e.latency_ms, time_ms)
            if roof is not None:
                e.push(e.roofline, roof)
            e.push(e.arrivals, now)
            table_arrivals = [
                t for (tb, _), en in self._entries.items() if tb == table for t in en.arrivals
            ]
        # gauge export outside the ledger lock (gauge ops take their own)
        table_arrivals.sort()
        qps_dq: Deque[float] = collections.deque(table_arrivals[-self.window :])
        g = METRICS.gauge
        g(f"perf.{table}.rowsPerSec").set(rows_ps)
        g(f"perf.{table}.bytesPerSec").set(bytes_ps)
        g(f"perf.{table}.qps").set(_window_qps(qps_dq))
        if roof is not None:
            g(f"perf.{table}.rooflinePct").set(roof)
        if compile_ms > 0:
            g(f"perf.{table}.lastCompileMs").set(compile_ms)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            items = list(self._entries.items())
        tables: Dict[str, Any] = {}
        for (table, fp), e in items:
            t = tables.setdefault(table, {"queries": 0, "qps": 0.0, "shapes": {}})
            t["queries"] += e.queries
            hitseen = e.cache_hits + e.cache_misses
            t["shapes"][fp or "-"] = {
                "queries": e.queries,
                "qps": round(_window_qps(e.arrivals), 3),
                "rowsPerSec": _win_stats(e.rows_per_sec),
                "bytesPerSec": _win_stats(e.bytes_per_sec),
                "rooflinePct": _win_stats(e.roofline),
                "latencyMs": _win_stats(e.latency_ms),
                "compileMsTotal": round(e.compile_ms_total, 3),
                "planCacheHitRate": round(e.cache_hits / hitseen, 3) if hitseen else None,
            }
        for table, t in tables.items():
            arrivals = sorted(
                ts
                for (tb, _), e in items
                if tb == table
                for ts in e.arrivals
            )
            t["qps"] = round(_window_qps(collections.deque(arrivals[-self.window :])), 3)
        return {"window": self.window, "tables": tables}

    def reset(self) -> None:
        with self._lock:
            self._entries.clear()


PERF_LEDGER = PerfLedger()
