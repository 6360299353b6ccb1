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

- Bench-history gate (copy of the JAX package's): bench_record() distills
  one benchmark report into a history line, append_bench_history /
  load_bench_history keep the JSONL file, and check_regression() compares
  the latest record against a pinned baseline with a noise-aware
  allowance clamped to [15%, 19%] (`cli perf --check`).  The port has no
  history of its own yet: the caller names both files.  The JAX package's
  capture_cost (XLA's cost analysis) has no counterpart here.
"""
from __future__ import annotations

import collections
import json
import math
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Tuple

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


def _finite(v: Any) -> Optional[float]:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return None
    return f if math.isfinite(f) and f >= 0 else None


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


# ---------------------------------------------------------------------------
# bench-history regression gate
# ---------------------------------------------------------------------------

# Higher-is-better throughput series the gate compares run-over-run.
GATE_METRICS: Tuple[str, ...] = (
    "kernel_rows_per_sec",
    "e2e_rows_per_sec",
    "warm_p50_rows_per_sec",
    "effective_bytes_per_sec",
    "batched_qps",
    # packed-forward-index sections (bench.py scan_bound / agg_bound): a
    # low-selectivity filter scan and a group-by-heavy aggregation, both
    # streaming bit-packed columns
    "scan_bound_rows_per_sec",
    "agg_bound_rows_per_sec",
    # tiered-storage working-set sweep (bench.py working_set_sweep): rows/s
    # with the working set at 1x and 4x the HBM cache budget, plus the
    # prefetch-hit rate of the staged copy stream on the 4x (capacity-
    # exceeding) leg — the regime the r11 ledger used to simply 503
    "ws_sweep_1x_rows_per_sec",
    "ws_sweep_4x_rows_per_sec",
    "ws_prefetch_hit_rate",
    # 2-D mesh scale-out (bench.py mesh_scaling): shard-axis capacity ratio
    # (full shard width vs one device) and replica-axis concurrent-QPS ratio
    # (ReplicatedEngine R=2 vs R=1).  In-image both hover near 1.0 (emulated
    # devices share the container's cores) — gated as regression canaries
    # for the hierarchical-combine and replica-routing paths, not as
    # scaling claims
    "mesh_shard_speedup",
    "mesh_replica_qps_scale",
)

# Lower-is-better latency series: the gate fails when these RISE past the
# allowance (drop is computed with the sign flipped).  hedged_p99_ms is the
# tail_latency bench's hedged p99 under one 10x-degraded replica — the
# tail-tolerance layer's whole point is keeping it near the fault-free p99.
# failover_blackout_ms is the HA drill's control-plane blackout in SIM time
# (lease expiry + standby replay-to-tip + handle adoption): the election
# protocol's cost, which a regression in lease/fence/promote code inflates.
# autopilot_admitted_p99_ms is the autopilot_overload bench's admitted-p99
# at 3x offered load under a seeded gray fault with the closed loop driving
# the knobs — the adaptive-serving layer's headline number.
GATE_METRICS_LOWER: Tuple[str, ...] = (
    "hedged_p99_ms",
    "failover_blackout_ms",
    "autopilot_admitted_p99_ms",
)

# Allowance bounds: at least 15% slack (CI-grade CPU runs are noisy even
# with bench.py's median-of-pairs machinery), never 20%+ — the acceptance
# bar is that a true ≥20% throughput regression always trips the gate.
_MIN_ALLOWED_DROP = 0.15
_MAX_ALLOWED_DROP = 0.19
_NOISE_MULT = 1.25


def bench_record(report: Dict[str, Any], *, bench: str = "ssb_groupby") -> Dict[str, Any]:
    """Distill one bench.py report into the flat history-line schema the
    gate compares.  Timestamps are stamped by the caller (bench.py)."""
    sweep = report.get("distinct_literal_sweep", {}) or {}
    roofline = report.get("roofline", {}) or {}
    qps = report.get("concurrent_qps", {}) or {}
    tail = report.get("tail_latency", {}) or {}
    scan_b = report.get("scan_bound", {}) or {}
    agg_b = report.get("agg_bound", {}) or {}
    ws = report.get("working_set_sweep", {}) or {}
    fo = report.get("failover", {}) or {}
    ms = report.get("mesh_scaling", {}) or {}
    ap = report.get("autopilot_overload", {}) or {}
    return {
        "schema": 1,
        "bench": bench,
        "backend": report.get("backend"),
        "rows": report.get("rows"),
        "device_kind": roofline.get("device_kind"),
        "metrics": {
            "kernel_rows_per_sec": report.get("value"),
            "e2e_rows_per_sec": report.get("value_e2e"),
            "warm_p50_rows_per_sec": sweep.get("warm_p50_rows_per_sec"),
            "effective_bytes_per_sec": report.get("effective_bytes_per_sec"),
            "cost_bytes_per_sec": roofline.get("cost_bytes_per_sec"),
            "roofline_pct": roofline.get("kernel_roofline_pct"),
            "plan_cache_hit_rate": (report.get("plan_cache", {}) or {}).get("hit_rate"),
            "batched_qps": (qps.get("batched", {}) or {}).get("qps"),
            "unbatched_qps": (qps.get("unbatched", {}) or {}).get("qps"),
            "batch_speedup": qps.get("batch_speedup"),
            "hedged_p99_ms": (tail.get("hedged", {}) or {}).get("p99_ms"),
            "unhedged_p99_ms": (tail.get("unhedged", {}) or {}).get("p99_ms"),
            "hedge_rate": tail.get("hedge_rate"),
            "scan_bound_rows_per_sec": scan_b.get("rows_per_sec"),
            "scan_bound_roofline_pct": scan_b.get("roofline_pct"),
            "agg_bound_rows_per_sec": agg_b.get("rows_per_sec"),
            "agg_bound_roofline_pct": agg_b.get("roofline_pct"),
            "ws_sweep_1x_rows_per_sec": (ws.get("legs", {}).get("1x", {}) or {}).get(
                "rows_per_sec"
            ),
            "ws_sweep_4x_rows_per_sec": (ws.get("legs", {}).get("4x", {}) or {}).get(
                "rows_per_sec"
            ),
            "ws_prefetch_hit_rate": (ws.get("legs", {}).get("4x", {}) or {}).get(
                "prefetch_hit_rate"
            ),
            "failover_blackout_ms": fo.get("blackout_ms"),
            "failover_replay_ms": fo.get("replay_to_tip_ms"),
            "failover_data_plane_success_rate": (fo.get("data_plane", {}) or {}).get(
                "success_rate"
            ),
            "mesh_shard_speedup": ms.get("mesh_shard_speedup"),
            "mesh_replica_qps_scale": ms.get("mesh_replica_qps_scale"),
            "mesh_2x4_rows_per_sec": ((ms.get("topologies", {}) or {}).get("2x4", {}) or {}).get(
                "rows_per_sec"
            ),
            "autopilot_admitted_p99_ms": (ap.get("autopilot", {}) or {}).get(
                "admitted_p99_ms"
            ),
            "autopilot_vs_best_static": ap.get("autopilot_vs_best_static"),
            "autopilot_knob_changes": (ap.get("autopilot", {}) or {}).get("knob_changes"),
        },
        "noise": {"run_variance": report.get("run_variance", 0.0)},
    }


def append_bench_history(path: str, record: Dict[str, Any]) -> None:
    with open(path, "a", encoding="utf-8") as f:
        f.write(json.dumps(record, sort_keys=True) + "\n")


def load_bench_history(path: str) -> List[Dict[str, Any]]:
    """All parseable history lines, oldest first; corrupt lines skipped (a
    torn append must not wedge the gate)."""
    out: List[Dict[str, Any]] = []
    if not os.path.exists(path):
        return out
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict):
                out.append(rec)
    return out


def regression_allowance(*records: Dict[str, Any]) -> float:
    """Noise-aware allowed fractional drop, from the worst run-variance
    spread among the compared records (bench.py's (max-min)/median over
    marginal-slope pairs), scaled and clamped to [15%, 19%]."""
    spread = 0.0
    for rec in records:
        rv = (rec.get("noise", {}) or {}).get("run_variance", 0.0)
        try:
            rv = float(rv)
        except (TypeError, ValueError):
            rv = 0.0
        if math.isfinite(rv) and rv > spread:
            spread = rv
    return min(_MAX_ALLOWED_DROP, max(_MIN_ALLOWED_DROP, _NOISE_MULT * spread))


def check_regression(
    latest: Dict[str, Any],
    baseline: Dict[str, Any],
    threshold: Optional[float] = None,
) -> Dict[str, Any]:
    """Compare the latest bench record against the pinned baseline.

    Returns {ok, allowed_drop, checks: [...], reasons: [...]}.  Fails when
    any gated throughput metric drops more than the allowance, when the two
    records ran different benches/backends (incomparable), or when no gated
    metric exists in both (a silent empty comparison must not pass)."""
    reasons: List[str] = []
    for key in ("bench", "backend", "rows"):
        a, b = latest.get(key), baseline.get(key)
        if a is not None and b is not None and a != b:
            reasons.append(f"incomparable: {key} changed {b!r} -> {a!r}")
    allowed = threshold if threshold is not None else regression_allowance(latest, baseline)
    lm = latest.get("metrics", {}) or {}
    bm = baseline.get("metrics", {}) or {}
    checks: List[Dict[str, Any]] = []
    for m in GATE_METRICS + GATE_METRICS_LOWER:
        lv, bv = _finite(lm.get(m)), _finite(bm.get(m))
        if lv is None or bv is None or bv == 0:
            continue
        # lower-is-better series invert the sign: a latency RISE is the
        # regression, so drop = (lv - bv) / bv
        drop = (lv - bv) / bv if m in GATE_METRICS_LOWER else (bv - lv) / bv
        ok = drop <= allowed
        checks.append(
            {
                "metric": m,
                "baseline": bv,
                "latest": lv,
                "drop_pct": round(drop * 100.0, 2),
                "ok": ok,
            }
        )
        if not ok:
            reasons.append(
                f"{m} regressed {drop * 100.0:.1f}% "
                f"({bv:g} -> {lv:g}; allowed {allowed * 100.0:.1f}%)"
            )
    if not checks:
        reasons.append("no gated metrics present in both records")
    return {
        "ok": not reasons,
        "allowed_drop": round(allowed, 4),
        "checks": checks,
        "reasons": reasons,
    }
