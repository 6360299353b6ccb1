"""Query safety rails: deadlines, admission control, memory accounting.

Reference parity (SURVEY.md 5.2): Pinot's query-killing memory accountant
(PerQueryCPUMemAccountantFactory / ResourceManager heap protection), query
timeouts (ServerQueryExecutorV1Impl timeout checks between operator calls),
and scheduler admission (ResourceManager semaphores).

Copy of pinot_tpu/query/safety.py (host-only).  The unit of work between
checks is one SEGMENT LAUNCH, so the deadline is tested between segment
launches and between collects — the granularity the reference gets between
operator `nextBlock` calls.  Memory admission is an up-front estimate of
device bytes the plan will touch (columns shipped + group tables), charged
against a process-wide budget while the query runs — an estimate-ahead
variant of the reference's sampling accountant.  The estimate is the JAX
package's byte for byte (the same host arrays), so one budget admits the
same queries in both packages.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from pinot_tpu_torch.query.ir import QueryContext


class QueryTimeoutError(RuntimeError):
    pass


class AdmissionError(RuntimeError):
    pass


class Deadline:
    __slots__ = ("expires_at", "timeout_ms")

    def __init__(self, timeout_ms: Optional[float]):
        self.timeout_ms = timeout_ms
        # `timeout_ms == 0` is an ALREADY-EXPIRED deadline, not "no deadline"
        # (a truthiness check here used to silently disable it)
        self.expires_at = (
            time.perf_counter() + timeout_ms / 1000 if timeout_ms is not None else None
        )

    @staticmethod
    def from_ctx(ctx: QueryContext) -> "Deadline":
        t = ctx.options.get("timeoutMs")
        return Deadline(float(t) if t is not None else None)

    def check(self, what: str = "query") -> None:
        if self.expired():
            raise QueryTimeoutError(f"{what} exceeded timeoutMs={self.timeout_ms:g}")

    def expired(self) -> bool:
        return self.expires_at is not None and time.perf_counter() >= self.expires_at

    def remaining_ms(self) -> Optional[float]:
        """Budget left, in ms; None = unbounded."""
        if self.expires_at is None:
            return None
        return max(0.0, (self.expires_at - time.perf_counter()) * 1000)

    def bounded(self, timeout_ms: Optional[float]) -> "Deadline":
        """A child deadline capped at min(this deadline, timeout_ms) — the
        per-server budget the broker hands each scatter call."""
        rem = self.remaining_ms()
        if timeout_ms is None:
            return self if rem is None else Deadline(rem)
        return Deadline(min(rem, float(timeout_ms)) if rem is not None else float(timeout_ms))


def estimate_segment_bytes(ctx: QueryContext, segment, needed_columns: Optional[List[str]] = None) -> int:
    """Device bytes one segment's kernel will touch: shipped column arrays
    plus the group-table output (the two allocations that scale)."""
    total = 0
    names = needed_columns if needed_columns is not None else segment.column_names
    for name in names:
        if name not in segment.columns:
            continue
        c = segment.columns[name]
        arr = c.codes if c.codes is not None else c.values
        if arr is not None:
            total += arr.nbytes
        if c.nulls is not None:
            total += c.nulls.nbytes // 8
    if ctx.group_by:
        total += int(ctx.num_groups_limit) * 16 * max(1, len(ctx.aggregations))
    return total


class WorkloadScheduler:
    """Two-tier workload isolation (BinaryWorkloadScheduler analog,
    pinot-core/.../core/query/scheduler/BinaryWorkloadScheduler.java).

    PRIMARY (interactive) queries are never queued.  SECONDARY queries —
    marked with the `isSecondaryWorkload` query option, the reference's
    contract for misbehaving/batch traffic — compete for a small semaphore
    and wait at most their remaining deadline (default 1s) for a slot, so
    a batch scan burst cannot starve interactive latency."""

    def __init__(self, secondary_slots: int = 2):
        self.secondary_slots = secondary_slots
        self._sem = threading.BoundedSemaphore(secondary_slots)

    @staticmethod
    def is_secondary(ctx: QueryContext) -> bool:
        v = ctx.options.get("isSecondaryWorkload")
        return str(v).lower() in ("1", "true", "yes") if v is not None else False

    def acquire(self, ctx: QueryContext, deadline: Optional["Deadline"] = None):
        """Returns a release callable (no-op for primary workloads)."""
        if not self.is_secondary(ctx):
            return lambda: None
        wait_s = 1.0
        if deadline is not None and deadline.expires_at is not None:
            wait_s = max(0.0, deadline.expires_at - time.perf_counter())
        if not self._sem.acquire(timeout=wait_s):
            raise AdmissionError(
                f"secondary workload queue full ({self.secondary_slots} slots); "
                "retry later or run without isSecondaryWorkload"
            )
        return self._sem.release


class MemoryAccountant:
    """Process-wide device-memory admission (budget in bytes).

    acquire() admits a query's estimate or raises AdmissionError — queries
    never start work they can't finish (the reference instead kills the
    largest query under heap pressure; with static shapes we can refuse
    up front)."""

    def __init__(self, budget_bytes: int = 8 << 30):
        self.budget = budget_bytes
        self.in_use = 0
        self._lock = threading.Lock()
        self._by_query: Dict[int, int] = {}
        self._next_id = 0

    def acquire(self, nbytes: int, what: str = "query") -> int:
        with self._lock:
            if self.in_use + nbytes > self.budget:
                raise AdmissionError(
                    f"{what} needs ~{nbytes / 1e6:.1f} MB device memory; "
                    f"{(self.budget - self.in_use) / 1e6:.1f} MB of {self.budget / 1e6:.1f} MB available "
                    "(raise the accountant budget or lower numGroupsLimit/query width)"
                )
            self._next_id += 1
            qid = self._next_id
            self._by_query[qid] = nbytes
            self.in_use += nbytes
            return qid

    def release(self, qid: int) -> None:
        with self._lock:
            n = self._by_query.pop(qid, 0)
            self.in_use -= n
