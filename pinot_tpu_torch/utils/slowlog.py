"""Broker-side slow-query log: bounded ring buffer of recent queries.

Reference parity: Pinot's broker query log (BaseSingleStageBrokerRequestHandler
logs requestId/SQL/timing per request, rate-limited) + the druid-style
/debug surface.  Re-design: an in-memory deque (`QueryEngine.slow_queries`,
`Broker.slow_queries`; `snapshot()` newest first; the REST and CLI views
come with a later slice); queries over `slow_ms` additionally keep their
full span tree, so the tail that matters arrives with its own flame graph
attached.

Entries are plain dicts (JSON-ready); SQL text is stored verbatim but
NEVER used as a metric/span name, and the plan fingerprint is stored as a
short digest — full fingerprints embed literal values.

Copy of pinot_tpu/utils/slowlog.py (host-only) with the same entry keys:
the broker's result cache, partial results, kill records, hedging and
brownout entries included.  The cost keys carry the analytic model
(costSource "analytic"); there is no compile step, so compileMs is the
plan-cache miss's host ms where an engine reports one.
"""
from __future__ import annotations

import hashlib
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from pinot_tpu_torch.utils.metrics import METRICS


def _fp_digest(fingerprint: str) -> str:
    return hashlib.sha1(fingerprint.encode("utf-8", "replace")).hexdigest()[:12]


class SlowQueryLog:
    """Ring buffer of the last `capacity` queries; `snapshot()` is newest
    first.  `slow_ms` gates trace retention (and the slowQueries counter),
    not admission — every query lands in the ring so /debug/queries doubles
    as a recent-query log."""

    def __init__(self, capacity: Optional[int] = None, slow_ms: Optional[float] = None):
        if capacity is None:
            capacity = int(os.environ.get("PINOT_TPU_SLOW_LOG_CAPACITY", "128"))
        if slow_ms is None:
            slow_ms = float(os.environ.get("PINOT_TPU_SLOW_QUERY_MS", "250"))
        self.capacity = max(1, capacity)
        self.slow_ms = slow_ms
        self._entries: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()

    def record(
        self,
        sql: str,
        fingerprint: str,
        result=None,
        query_id: Optional[str] = None,
        error: Optional[str] = None,
        shape_fingerprint: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Log one finished (or failed) query; returns the entry dict."""
        stats = getattr(result, "stats", None)
        time_ms = float(stats.time_ms) if stats is not None else 0.0
        entry: Dict[str, Any] = {
            # epoch stamp for display only — never used in elapsed math
            "timestamp": time.time(),
            "queryId": query_id if query_id is not None else (stats.query_id if stats else None),
            "sql": sql,
            "planFingerprint": _fp_digest(fingerprint),
            # literal-canonical shape digest: every member of a parameterized
            # plan-cache family shares this value (query/shape.py)
            "shapeFingerprint": _fp_digest(shape_fingerprint)
            if shape_fingerprint is not None
            else None,
            # "hit" | "miss" when the broker result cache was consulted
            "resultCache": getattr(stats, "result_cache", None) if stats else None,
            "timeMs": round(time_ms, 3),
            "rows": len(result.rows) if result is not None else 0,
            "numDocsScanned": stats.num_docs_scanned if stats else 0,
            "numSegmentsProcessed": stats.num_segments_processed if stats else 0,
            "partialResult": bool(stats.partial_result) if stats else False,
            "numExceptions": len(stats.exceptions) if stats else 0,
        }
        # kernel cost accounting (utils/perf.py): the analytic bytes/flops
        # the scans streamed and the achieved roofline % — slow queries
        # annotated with whether the device or the host made them slow
        if stats is not None and getattr(stats, "kernel_bytes", 0):
            from pinot_tpu_torch.utils.perf import roofline_pct

            entry["kernelBytes"] = round(stats.kernel_bytes, 1)
            entry["kernelFlops"] = round(stats.kernel_flops, 1)
            entry["costSource"] = stats.kernel_cost_source
            entry["compileMs"] = round(stats.compile_ms, 3)
            denom_s = (stats.device_ms or time_ms) / 1000.0
            roof = roofline_pct(stats.kernel_bytes, denom_s)
            if roof is not None:
                entry["rooflinePct"] = round(roof, 2)
            if time_ms > 0:
                entry["rowsPerSec"] = round(stats.num_docs_scanned / (time_ms / 1000.0), 1)
        if error is not None:
            entry["error"] = error
        # watchdog kill record: a killed-but-partial query carries its
        # QUERY_KILLED exception entry (query id, reason, server) — surface
        # it top-level so /debug/queries and the CLI show kills at a glance
        if stats is not None:
            for exc in stats.exceptions:
                if isinstance(exc, dict) and exc.get("errorCode") == "QUERY_KILLED":
                    entry["kill"] = exc
                    break
        # tail-tolerance decisions: hedged scatter calls and brownout
        # transitions surface top-level, so /debug/queries and EXPLAIN
        # ANALYZE show WHY a tail query came back fast (or didn't)
        if stats is not None and getattr(stats, "hedged", 0):
            entry["hedge"] = {
                "hedged": stats.hedged,
                "winner": stats.hedge_winner,
                "cancelledMs": round(stats.hedge_cancelled_ms, 3),
            }
        if stats is not None and getattr(stats, "brownout_events", None):
            entry["brownout"] = list(stats.brownout_events)
        if time_ms >= self.slow_ms or error is not None or "kill" in entry:
            METRICS.counter("broker.slowQueries").inc()
            if stats is not None and stats.trace is not None:
                entry["trace"] = stats.trace
        with self._lock:
            self._entries.append(entry)
        return entry

    def snapshot(self, limit: Optional[int] = None) -> List[Dict[str, Any]]:
        with self._lock:
            out = list(self._entries)
        out.reverse()  # newest first
        return out[:limit] if limit else out

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
