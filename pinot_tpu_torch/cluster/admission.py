"""Resource governance for the serving tier: admission control, memory
reservations, runaway-query kills, graceful degradation.

Copy of pinot_tpu/cluster/admission.py (host-only).  "HBM" below is the
card's device memory; the pressure cut of the macro-batch pipeline depth is
read by parallel/engine.py, and the server (cluster/server.py) reserves
its working sets from `ResourceBudget`.

Reference parity (SURVEY.md 5.2): Pinot's resource-accounted query scheduler
(ResourceManager / PriorityScheduler admission), the OOM-protecting query
killer (QueryMonitor + PerQueryCPUMemAccountantFactory picks the most
expensive query under heap pressure and interrupts it), and broker-side
request throttling (QueryQuotaManager, but per-cost rather than per-count).

Re-design for the TPU serving tier:

  * COST is estimated up front from broker-side segment metadata (rows the
    plan will scan, HBM bytes the kernels will touch, a group-by
    cardinality bound) instead of sampled mid-flight — static shapes make
    the working set predictable before launch.
  * ADMISSION is a token bucket denominated in cost units with a BOUNDED
    wait queue: a query over budget either waits (bounded, deadline-capped)
    or is shed immediately with a structured 429 — never queued unboundedly.
  * RESERVATIONS: every scatter call reserves its working-set estimate
    against the target server's HBM budget BEFORE launching and releases on
    completion/cancel, so concurrent queries cannot collectively overcommit
    device memory; caches (broker results, compiled plans) charge the SAME
    host-side ledger the admission controller tracks.
  * KILLS ride the existing cooperative between-kernel cancellation:
    the watchdog marks a query dead (deadline/runaway/pressure), the server
    observes the mark between segment kernels and abandons still-pending
    launches uncollected — no device sync on the warm path (DrJAX
    static-control framing: admission decisions are host control flow).
  * DEGRADATION under sustained pressure is progressive and observable:
    result cache off, macro-batch pipeline depth shrunk, low-priority
    queries shed first — all published as gauges + span annotations.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from pinot_tpu_torch.query.ir import QueryContext
from pinot_tpu_torch.query.safety import AdmissionError, Deadline
from pinot_tpu_torch.utils import threads
from pinot_tpu_torch.utils.metrics import METRICS


class TooManyRequestsError(RuntimeError):
    """Admission shed: the serving tier is over its rate budget and this
    query was rejected up front (REST 429 TOO_MANY_REQUESTS_ERROR).
    Carries the minted query id so throttled clients can correlate."""

    def __init__(self, message: str, query_id: Optional[str] = None):
        super().__init__(message)
        self.query_id = query_id


class ReservationError(AdmissionError):
    """A working-set reservation could not be acquired — the HBM or host
    budget is committed to other in-flight work (REST 503
    SERVER_OUT_OF_CAPACITY; retryable, capacity returns as queries drain)."""

    def __init__(self, message: str, query_id: Optional[str] = None):
        super().__init__(message)
        self.query_id = query_id


class QueryKilledError(RuntimeError):
    """The watchdog killed this query mid-flight (deadline overrun, runaway
    runtime, or global memory pressure); pending kernel launches were
    abandoned uncollected (cooperative cancellation)."""

    def __init__(self, message: str, query_id: Optional[str] = None, reason: str = ""):
        super().__init__(message)
        self.query_id = query_id
        self.reason = reason or message


# ---------------------------------------------------------------------------
# cost estimation
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class QueryCost:
    """Up-front cost estimate for one query: what the admission bucket is
    charged (units) and what the reservations will pin (bytes)."""

    rows: int  # rows the scatter will scan (post broker-side metadata)
    hbm_bytes: int  # device bytes the segment kernels touch
    group_cardinality: int  # group-table bound (num_groups_limit)
    host_bytes: int  # host-side reduce/merge footprint charged to the host ledger

    # one unit ~ a small interactive query; wide scans/aggregations cost more
    ROWS_PER_UNIT = 5_000_000
    BYTES_PER_UNIT = 256 << 20
    GROUPS_PER_UNIT = 200_000

    @property
    def units(self) -> float:
        return (
            1.0
            + self.rows / self.ROWS_PER_UNIT
            + self.hbm_bytes / self.BYTES_PER_UNIT
            + self.group_cardinality / self.GROUPS_PER_UNIT
        )


def estimate_query_cost(ctx: QueryContext, segment_metas) -> QueryCost:
    """Broker-side cost estimate from segment metadata (coordinator
    TableMeta.segment_meta values): rows scanned is the doc total of the
    candidate segments, HBM bytes their host-array residency (the kernels
    ship a subset of it), and the group-by bound is the plan's
    numGroupsLimit — the same three axes the reference's accountant samples,
    computed before launch instead."""
    rows = 0
    hbm = 0
    for sm in segment_metas:
        if not isinstance(sm, dict):
            continue
        docs = int(sm.get("numDocs", 0) or 0)
        rows += docs
        b = sm.get("bytes")
        hbm += int(b) if b is not None else docs * 16  # ~2 narrow columns fallback
    groups = int(ctx.num_groups_limit) if ctx.group_by else 0
    n_aggs = max(1, len(ctx.aggregations))
    host = groups * 16 * n_aggs + (64 << 10)  # group tables + fixed reduce slack
    return QueryCost(rows=rows, hbm_bytes=hbm, group_cardinality=groups, host_bytes=host)


# ---------------------------------------------------------------------------
# token-bucket admission with a bounded wait queue
# ---------------------------------------------------------------------------
class AdmissionController:
    """Cost-denominated token bucket (refill `rate` units/s, burst capacity
    `burst`) with a BOUNDED wait queue: when tokens are short a normal-
    priority query may wait (at most `max_queue` waiters, each capped by
    min(max_wait_ms, its remaining deadline)); a low-priority query, or any
    query once the queue is full, is shed immediately with a structured
    TooManyRequestsError.  rate <= 0 disables admission entirely (the
    default — governance is opt-in per deployment)."""

    def __init__(
        self,
        rate_units_per_s: float = 0.0,
        burst_units: Optional[float] = None,
        max_queue: int = 8,
        max_wait_ms: float = 500.0,
        knob: Optional[str] = None,
    ):
        self.rate = float(rate_units_per_s)
        # when `knob` names an autopilot KnobRegistry entry (the governor
        # passes "admission_rate"), the refill rate is read from the
        # registry per decision — a controller write takes effect on the
        # next refill without rebuilding; burst/queue stay static ceilings
        self.knob = knob
        self.burst = float(burst_units) if burst_units is not None else max(1.0, self.rate)
        self.max_queue = int(max_queue)
        self.max_wait_ms = float(max_wait_ms)
        self.clock = time.monotonic  # injectable for deterministic tests
        # Condition wraps the bucket lock: waiters re-check on wake, and the
        # refill/charge sequence is a read-modify-write (same race class as
        # the broker's token bucket)
        self._lock = threads.Condition()
        self._tokens = self.burst
        self._last_refill: Optional[float] = None
        self._waiting = 0

    def _rate_now(self) -> float:
        """Effective refill rate for THIS decision: the KnobRegistry value
        when knob-managed (clamped to the static env ceiling by the
        registry), else the construction-time rate."""
        if self.knob is None:
            return self.rate
        from pinot_tpu_torch.cluster import autopilot

        return float(autopilot.knobs().get(self.knob))

    def _refill_locked(self, now: float) -> None:
        if self._last_refill is None:
            self._last_refill = now
        self._tokens = min(
            self.burst, self._tokens + self._rate_now() * (now - self._last_refill)
        )
        self._last_refill = now

    def tokens(self) -> float:
        with self._lock:
            self._refill_locked(self.clock())
            return self._tokens

    def deficit(self) -> float:
        """Bucket exhaustion in [0, 1]: 0 = full burst available, 1 = dry.
        One input to the degradation controller's pressure signal."""
        if self._rate_now() <= 0:
            return 0.0
        with self._lock:
            self._refill_locked(self.clock())
            return max(0.0, 1.0 - self._tokens / self.burst)

    def _shed(self, query_id: Optional[str], detail: str) -> None:
        METRICS.counter("admission.shed").inc()
        raise TooManyRequestsError(
            f"query {query_id}: admission shed ({detail}); back off and retry",
            query_id=query_id,
        )

    def admit(
        self,
        query_id: Optional[str],
        units: float = 1.0,
        priority: int = 0,
        deadline: Optional[Deadline] = None,
    ) -> None:
        """Charge `units` or raise TooManyRequestsError.  Tokens are repaid
        by time, not by completion — the bucket bounds offered RATE; the
        reservation ledgers bound concurrent FOOTPRINT."""
        if self._rate_now() <= 0:
            return
        # a single query costlier than the whole burst must still be servable
        units = min(float(units), self.burst)
        with self._lock:
            self._refill_locked(self.clock())
            if self._tokens >= units:
                self._tokens -= units
                METRICS.counter("admission.admitted").inc()
                return
            if priority < 0:
                self._shed(query_id, "low-priority query under load")
            if self.max_queue <= 0 or self._waiting >= self.max_queue:
                self._shed(query_id, f"wait queue full ({self.max_queue} slots)")
            budget_ms = self.max_wait_ms
            if deadline is not None:
                rem = deadline.remaining_ms()
                if rem is not None:
                    budget_ms = min(budget_ms, rem)
            start = self.clock()
            self._waiting += 1
            METRICS.gauge("admission.queuedQueries").set(float(self._waiting))
            try:
                while True:
                    now = self.clock()
                    self._refill_locked(now)
                    if self._tokens >= units:
                        self._tokens -= units
                        METRICS.counter("admission.admitted").inc()
                        METRICS.counter("admission.admittedAfterWait").inc()
                        return
                    waited_ms = (now - start) * 1000
                    if waited_ms >= budget_ms:
                        self._shed(query_id, f"queued {waited_ms:.0f} ms without a token")
                    need_s = (units - self._tokens) / max(self._rate_now(), 1e-9)
                    self._lock.wait(timeout=min(need_s, (budget_ms - waited_ms) / 1000))
            finally:
                self._waiting -= 1
                METRICS.gauge("admission.queuedQueries").set(float(self._waiting))

    def try_charge(self, units: float = 1.0) -> bool:
        """Non-blocking charge for OPTIONAL work (hedged backups): take
        `units` only if available right now, never queue, never shed.  Under
        token scarcity this returns False while admit() can still queue —
        exactly the ordering that throttles hedges before primaries."""
        if self._rate_now() <= 0:
            return True
        units = min(float(units), self.burst)
        with self._lock:
            self._refill_locked(self.clock())
            if self._tokens >= units:
                self._tokens -= units
                return True
            return False

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            self._refill_locked(self.clock())
            return {
                "rate": self._rate_now(),
                "staticRate": self.rate,
                "burst": self.burst,
                "tokens": round(self._tokens, 3),
                "waiting": self._waiting,
                "maxQueue": self.max_queue,
            }


# ---------------------------------------------------------------------------
# byte reservations (HBM per server, host memory process-wide)
# ---------------------------------------------------------------------------
class ResourceBudget:
    """Thread-safe byte ledger with two clients on ONE budget:

      * queries `reserve()` their working-set estimate before launch and
        `release()` on completion/cancel (raises ReservationError when the
        budget is committed — REST 503 SERVER_OUT_OF_CAPACITY);
      * caches `try_charge()` / `uncharge()` bytes they retain (never raise
        — a full budget just means the cache evicts instead of growing).

    Because both ride the same ledger, cached bytes and in-flight working
    sets cannot jointly overcommit (the caches no longer bound themselves
    independently).  `gauge` names the published METRICS
    gauge; `peak` is the high-water mark the overload tests assert against
    the configured budget."""

    def __init__(self, budget_bytes: int, gauge: Optional[str] = None):
        self.budget_bytes = int(budget_bytes)
        self.gauge = gauge
        self.clock = time.monotonic  # injectable for deterministic tests
        # Condition, not a bare Lock: reserve_or_wait() parks staged
        # fetches on it until release()/uncharge() frees bytes.
        self._lock = threads.Condition()
        self._by_ticket: Dict[int, int] = {}
        self._ticket_seq = itertools.count(1)
        self._in_use = 0
        self._peak = 0
        self._waiters = 0

    def _publish_locked(self) -> None:
        if self.gauge is not None:
            METRICS.gauge(self.gauge).set(float(self._in_use))

    @property
    def in_use(self) -> int:
        with self._lock:
            return self._in_use

    @property
    def peak(self) -> int:
        """High-water mark of concurrent bytes — never exceeds budget_bytes
        by construction (the overload acceptance assertion)."""
        with self._lock:
            return self._peak

    def available(self) -> int:
        with self._lock:
            return max(0, self.budget_bytes - self._in_use)

    def occupancy(self) -> float:
        with self._lock:
            return self._in_use / self.budget_bytes if self.budget_bytes > 0 else 0.0

    def reserve(self, nbytes: int, what: str = "query", query_id: Optional[str] = None) -> int:
        """Admit `nbytes` or raise ReservationError; returns a ticket for
        release().  All-or-nothing: a partial reservation would deadlock
        against other partial holders."""
        n = max(0, int(nbytes))
        with self._lock:
            if self._in_use + n > self.budget_bytes:
                METRICS.counter("admission.reservationRejected").inc()
                raise ReservationError(
                    f"{what} needs ~{n / 1e6:.1f} MB but only "
                    f"{(self.budget_bytes - self._in_use) / 1e6:.1f} MB of "
                    f"{self.budget_bytes / 1e6:.1f} MB remain reserved-free",
                    query_id=query_id,
                )
            return self._reserve_locked(n)

    def reserve_or_wait(
        self,
        nbytes: int,
        what: str = "query",
        query_id: Optional[str] = None,
        deadline: Optional[Deadline] = None,
        max_wait_ms: Optional[float] = None,
        queue_limit: int = 8,
    ) -> int:
        """Tiered-storage admission: a working set that exceeds
        the *currently free* budget but fits the TOTAL budget is a staged
        fetch — park (bounded, deadline-capped) until running queries
        release bytes, instead of 503ing.  ReservationError still raises
        immediately when the working set cannot fit even transiently
        (nbytes > budget_bytes) or the staged-fetch queue is full, and on
        wait timeout — those remain SERVER_OUT_OF_CAPACITY."""
        n = max(0, int(nbytes))
        if max_wait_ms is None:
            max_wait_ms = float(os.environ.get("PINOT_TPU_STAGED_FETCH_MS", "250"))
        with self._lock:
            if n > self.budget_bytes:
                METRICS.counter("admission.reservationRejected").inc()
                raise ReservationError(
                    f"{what} needs ~{n / 1e6:.1f} MB but the whole budget is "
                    f"{self.budget_bytes / 1e6:.1f} MB — cannot fit even "
                    "transiently",
                    query_id=query_id,
                )
            if self._in_use + n <= self.budget_bytes:
                return self._reserve_locked(n)
            if self._waiters >= queue_limit:
                METRICS.counter("admission.stagedFetchRejected").inc()
                raise ReservationError(
                    f"{what} staged-fetch queue full ({queue_limit} waiting)",
                    query_id=query_id,
                )
            budget_ms = max_wait_ms
            if deadline is not None:
                budget_ms = min(budget_ms, deadline.remaining_ms())
            give_up = self.clock() + max(0.0, budget_ms) / 1000.0
            METRICS.counter("admission.stagedFetchQueued").inc()
            self._waiters += 1
            try:
                while self._in_use + n > self.budget_bytes:
                    left = give_up - self.clock()
                    if left <= 0 or not self._lock.wait(timeout=left):
                        METRICS.counter("admission.stagedFetchTimeouts").inc()
                        raise ReservationError(
                            f"{what} needs ~{n / 1e6:.1f} MB; still only "
                            f"{(self.budget_bytes - self._in_use) / 1e6:.1f} MB "
                            f"free after {budget_ms:.0f} ms staged wait",
                            query_id=query_id,
                        )
            finally:
                self._waiters -= 1
            METRICS.counter("admission.stagedFetchServed").inc()
            return self._reserve_locked(n)

    def _reserve_locked(self, n: int) -> int:
        # callers hold self._lock (the _locked suffix contract)
        ticket = next(self._ticket_seq)
        self._by_ticket[ticket] = n
        self._in_use += n
        self._peak = max(self._peak, self._in_use)
        self._publish_locked()
        return ticket

    def release(self, ticket: int) -> int:
        with self._lock:
            n = self._by_ticket.pop(ticket, 0)
            self._in_use -= n
            self._publish_locked()
            self._lock.notify_all()
            return n

    def try_charge(self, nbytes: int) -> bool:
        """Cache-side charge: False when it would overcommit (caller evicts
        or drops the entry instead of growing)."""
        n = max(0, int(nbytes))
        with self._lock:
            if self._in_use + n > self.budget_bytes:
                return False
            self._in_use += n
            self._peak = max(self._peak, self._in_use)
            self._publish_locked()
            return True

    def uncharge(self, nbytes: int) -> None:
        n = max(0, int(nbytes))
        with self._lock:
            self._in_use = max(0, self._in_use - n)
            self._publish_locked()
            self._lock.notify_all()

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "budgetBytes": self.budget_bytes,
                "inUseBytes": self._in_use,
                "peakBytes": self._peak,
                "reservations": len(self._by_ticket),
            }


# ---------------------------------------------------------------------------
# runaway-query watchdog
# ---------------------------------------------------------------------------
@dataclass
class KillRecord:
    """What the watchdog knew at kill time — shipped to the slow log, the
    trace tree, and the bounded kill ring behind /debug/admission."""

    query_id: str
    reason: str
    reserved_bytes: int
    elapsed_ms: float
    priority: int

    def to_dict(self) -> Dict[str, Any]:
        return {
            "queryId": self.query_id,
            "reason": self.reason,
            "reservedBytes": self.reserved_bytes,
            "elapsedMs": round(self.elapsed_ms, 3),
            "priority": self.priority,
        }


class QueryWatchdog:
    """Marks in-flight queries dead; servers observe the mark between
    segment kernels (the cooperative-cancellation check) and abandon
    still-pending launches uncollected.  Kill triggers:

      * runaway runtime — a registered query past its `runaway_ms` ceiling
        is marked on the next between-kernel probe (lazy, no patrol thread);
      * explicit `kill()` (operator / deadline escalation);
      * global pressure — `patrol(occupancy)` past `pressure_kill_at` picks
        a victim (lowest priority, then largest reservation), mirroring the
        reference QueryMonitor's kill-the-most-expensive heuristic.

    Everything here is host-side control flow: probes read a dict under a
    lock, never a device value."""

    def __init__(self, runaway_ms: float = 0.0, pressure_kill_at: float = 0.0):
        self.runaway_ms = float(runaway_ms)  # 0 = no runtime ceiling
        self.pressure_kill_at = float(pressure_kill_at)  # 0 = pressure kills off
        self.clock = time.monotonic  # injectable for deterministic tests
        self._lock = threading.Lock()
        self._active: Dict[str, Dict[str, Any]] = {}
        self._killed: Dict[str, str] = {}
        self.kill_log: deque = deque(maxlen=64)  # bounded ring of KillRecords

    def register(
        self,
        query_id: str,
        reserved_bytes: int = 0,
        priority: int = 0,
        runaway_ms: Optional[float] = None,
    ) -> None:
        with self._lock:
            self._active[query_id] = {
                "started": self.clock(),
                "reserved": int(reserved_bytes),
                "priority": int(priority),
                "runaway_ms": self.runaway_ms if runaway_ms is None else float(runaway_ms),
            }
            METRICS.gauge("admission.activeQueries").set(float(len(self._active)))

    def deregister(self, query_id: str) -> None:
        with self._lock:
            self._active.pop(query_id, None)
            self._killed.pop(query_id, None)
            METRICS.gauge("admission.activeQueries").set(float(len(self._active)))

    def _kill_locked(self, query_id: str, reason: str) -> Optional[KillRecord]:
        reg = self._active.get(query_id)
        if reg is None or query_id in self._killed:
            return None
        self._killed[query_id] = reason
        rec = KillRecord(
            query_id=query_id,
            reason=reason,
            reserved_bytes=reg["reserved"],
            elapsed_ms=(self.clock() - reg["started"]) * 1000,
            priority=reg["priority"],
        )
        self.kill_log.append(rec)
        METRICS.counter("admission.queriesKilled").inc()
        return rec

    def kill(self, query_id: str, reason: str) -> bool:
        with self._lock:
            return self._kill_locked(query_id, reason) is not None

    def kill_reason(self, query_id: str) -> Optional[str]:
        """The between-kernel probe: a killed query's reason, marking lazy
        runaway overruns on the way (no patrol thread needed — the query
        polls its own death sentence between launches)."""
        now = self.clock()
        with self._lock:
            reason = self._killed.get(query_id)
            if reason is not None:
                return reason
            reg = self._active.get(query_id)
            if reg is None:
                return None
            ceiling = reg["runaway_ms"]
            if ceiling and ceiling > 0 and (now - reg["started"]) * 1000 > ceiling:
                rec = self._kill_locked(
                    query_id, f"runaway: exceeded maxRuntimeMs={ceiling:g}"
                )
                return rec.reason if rec is not None else self._killed.get(query_id)
            return None

    def cancel_probe(self, query_id: str) -> Callable[[], Optional[str]]:
        """Closure the broker threads through to ServerInstance.execute —
        checked between kernels, host-side only."""
        return lambda: self.kill_reason(query_id)

    def patrol(self, occupancy: float) -> Optional[KillRecord]:
        """Pressure-triggered victim selection: above the kill threshold,
        mark the lowest-priority / largest-reservation live query."""
        if self.pressure_kill_at <= 0 or occupancy < self.pressure_kill_at:
            return None
        with self._lock:
            live = [
                (qid, reg)
                for qid, reg in self._active.items()
                if qid not in self._killed
            ]
            if not live:
                return None
            qid, _reg = max(live, key=lambda kv: (-kv[1]["priority"], kv[1]["reserved"]))
            return self._kill_locked(
                qid, f"memory pressure: reservations at {occupancy:.0%} of budget"
            )

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "activeQueries": len(self._active),
                "kills": [r.to_dict() for r in self.kill_log],
            }


# ---------------------------------------------------------------------------
# graceful degradation
# ---------------------------------------------------------------------------
# process-wide pressure level: the serving broker's degradation controller
# publishes here so engine-layer consumers (macro-batch pipeline depth in
# parallel/engine.py) can react without holding a reference to the governor
_PRESSURE_LEVEL = 0
_PRESSURE_LOCK = threading.Lock()


def _set_process_pressure(level: int) -> None:
    global _PRESSURE_LEVEL
    with _PRESSURE_LOCK:
        _PRESSURE_LEVEL = int(level)


def current_pressure_level() -> int:
    with _PRESSURE_LOCK:
        return _PRESSURE_LEVEL


def pipeline_depth_under_pressure(depth: int, level: Optional[int] = None) -> int:
    """Macro-batch pipeline depth under pressure: every level past 1 drops
    one in-flight launch (floor 1), and level 3 serializes outright — each
    launch holds a capture copy of its batch inputs, so shrinking depth
    directly sheds resident HBM."""
    lvl = current_pressure_level() if level is None else int(level)
    if lvl >= 3:
        return 1
    return max(1, int(depth) - max(0, lvl - 1))


class DegradationController:
    """Progressive load shedding driven by one occupancy signal in [0, 1]
    (max of reservation occupancy and admission-bucket deficit):

      level 1 (>= 0.70): broker result cache disabled (stop retaining
              bytes), low-priority queries shed immediately;
      level 2 (>= 0.85): macro-batch pipeline depth shrinks by one
              (one less in-flight capture copy in HBM);
      level 3 (>= 0.95): pipeline fully serialized; the watchdog's
              pressure patrol may start killing.

    Published as the admission.pressureLevel gauge and (when > 0) a span
    annotation on every served query's plan span."""

    THRESHOLDS = ((0.70, 1), (0.85, 2), (0.95, 3))

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._level = 0

    @property
    def level(self) -> int:
        with self._lock:
            return self._level

    def update(self, occupancy: float) -> int:
        lvl = 0
        for threshold, candidate in self.THRESHOLDS:
            if occupancy >= threshold:
                lvl = candidate
        # the autopilot's degrade_level knob is a FLOOR: on sustained SLO
        # breach the controller can hold the ladder up even when memory
        # occupancy alone would not (breach-driven degradation)
        from pinot_tpu_torch.cluster import autopilot

        lvl = max(lvl, int(autopilot.knobs().get("degrade_level")))
        with self._lock:
            self._level = lvl
        METRICS.gauge("admission.pressureLevel").set(float(lvl))
        _set_process_pressure(lvl)
        return lvl

    def result_cache_enabled(self) -> bool:
        return self.level < 1

    def shed_low_priority(self) -> bool:
        return self.level >= 1

    def pipeline_depth(self, depth: int) -> int:
        return pipeline_depth_under_pressure(depth, self.level)


# ---------------------------------------------------------------------------
# process-wide host-memory ledger (caches + in-flight queries, one budget)
# ---------------------------------------------------------------------------
_HOST_BUDGET: Optional[ResourceBudget] = None
_HOST_BUDGET_LOCK = threading.Lock()


def process_host_budget() -> ResourceBudget:
    """The one host-memory ledger per process: broker result caches,
    compiled-plan caches, and in-flight query working sets all charge it
    (PINOT_TPU_HOST_BUDGET_BYTES, default 1 GiB), so caches and queries
    cannot jointly overcommit host memory."""
    global _HOST_BUDGET
    with _HOST_BUDGET_LOCK:
        if _HOST_BUDGET is None:
            _HOST_BUDGET = ResourceBudget(
                int(os.environ.get("PINOT_TPU_HOST_BUDGET_BYTES", str(1 << 30))),
                gauge="admission.hostReservedBytes",
            )
        return _HOST_BUDGET


def default_server_hbm_budget() -> int:
    """Per-server HBM reservation budget (0 disables reservation tracking)."""
    return int(os.environ.get("PINOT_TPU_SERVER_HBM_BUDGET_BYTES", str(8 << 30)))


# ---------------------------------------------------------------------------
# governor facade
# ---------------------------------------------------------------------------
class AdmissionGrant:
    """Handle for one admitted query's resources: close() releases the host
    reservation and deregisters from the watchdog (idempotent — exception
    paths and the happy path both land here)."""

    __slots__ = ("_governor", "query_id", "_ticket", "_closed")

    def __init__(self, governor: "ResourceGovernor", query_id: str, ticket: Optional[int]):
        self._governor = governor
        self.query_id = query_id
        self._ticket = ticket
        self._closed = False

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._governor._finish(self.query_id, self._ticket)


class ResourceGovernor:
    """One serving broker's resource-governance stack: token-bucket
    admission + host-memory ledger + watchdog + degradation, composed so a
    single admit()/close() pair brackets every served query.  Defaults are
    permissive (admission off, ample budgets) — deployments opt in via the
    PINOT_TPU_ADMISSION_* / *_BUDGET_BYTES environment knobs or by
    constructing the parts explicitly."""

    def __init__(
        self,
        admission: Optional[AdmissionController] = None,
        host_budget: Optional[ResourceBudget] = None,
        watchdog: Optional[QueryWatchdog] = None,
        degrade: Optional[DegradationController] = None,
    ):
        if admission is None:
            admission = AdmissionController(
                rate_units_per_s=float(os.environ.get("PINOT_TPU_ADMISSION_RATE", "0")),
                burst_units=(
                    float(os.environ["PINOT_TPU_ADMISSION_BURST"])
                    if "PINOT_TPU_ADMISSION_BURST" in os.environ
                    else None
                ),
                max_queue=int(os.environ.get("PINOT_TPU_ADMISSION_QUEUE", "8")),
                knob="admission_rate",
            )
        if watchdog is None:
            watchdog = QueryWatchdog(
                runaway_ms=float(os.environ.get("PINOT_TPU_RUNAWAY_MS", "0")),
                pressure_kill_at=float(os.environ.get("PINOT_TPU_PRESSURE_KILL_AT", "0")),
            )
        self.admission = admission
        self.host_budget = host_budget if host_budget is not None else process_host_budget()
        self.watchdog = watchdog
        self.degrade = degrade if degrade is not None else DegradationController()

    @staticmethod
    def priority_of(ctx: QueryContext) -> int:
        """queryPriority option (int; negative = sheddable) with the
        isSecondaryWorkload contract folded in as the low tier."""
        v = ctx.options.get("queryPriority")
        if v is not None:
            try:
                return int(v)
            except (TypeError, ValueError):
                METRICS.counter("admission.badPriorityOption").inc()
                return 0
        sec = ctx.options.get("isSecondaryWorkload")
        return -1 if str(sec).lower() in ("1", "true", "yes") else 0

    def _occupancy(self) -> float:
        return max(self.host_budget.occupancy(), self.admission.deficit())

    def admit(
        self,
        query_id: str,
        ctx: QueryContext,
        cost: QueryCost,
        deadline: Optional[Deadline] = None,
    ) -> AdmissionGrant:
        """Full admission for one query: degradation update, priority shed,
        token charge, host reservation, watchdog registration, pressure
        patrol.  Raises TooManyRequestsError (shed) or ReservationError
        (no capacity) — both carry the query id."""
        priority = self.priority_of(ctx)
        self.degrade.update(self._occupancy())
        if priority < 0 and self.degrade.shed_low_priority():
            METRICS.counter("admission.shed").inc()
            raise TooManyRequestsError(
                f"query {query_id}: low-priority query shed under pressure "
                f"(level {self.degrade.level})",
                query_id=query_id,
            )
        self.admission.admit(query_id, units=cost.units, priority=priority, deadline=deadline)
        ticket = self.host_budget.reserve(
            cost.host_bytes, what="query working set", query_id=query_id
        )
        try:
            runaway = ctx.options.get("maxRuntimeMs")
            self.watchdog.register(
                query_id,
                reserved_bytes=cost.host_bytes + cost.hbm_bytes,
                priority=priority,
                runaway_ms=float(runaway) if runaway is not None else None,
            )
            level = self.degrade.update(self._occupancy())
            if level >= 3:
                self.watchdog.patrol(self.host_budget.occupancy())
            return AdmissionGrant(self, query_id, ticket)
        except BaseException:
            # unwind the half-built grant: an exception past the reserve
            # would otherwise leak the host-budget ticket and (after
            # register) a phantom watchdog entry; deregister is idempotent
            self._finish(query_id, ticket)
            raise

    def _finish(self, query_id: str, ticket: Optional[int]) -> None:
        if ticket is not None:
            self.host_budget.release(ticket)
        self.watchdog.deregister(query_id)
        self.degrade.update(self._occupancy())

    def cancel_probe(self, query_id: str) -> Callable[[], Optional[str]]:
        return self.watchdog.cancel_probe(query_id)

    def try_charge_hedge(self, units: float = 1.0) -> bool:
        """Non-blocking token charge for a hedged backup launch.  A hedge is
        strictly optional work, so it may only take tokens that are free
        RIGHT NOW — it never queues, never sheds, and under pressure loses
        to primaries (which can still wait for refill)."""
        return self.admission.try_charge(units)

    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready state behind GET /debug/admission + `cli admission`."""
        return {
            "pressureLevel": self.degrade.level,
            "admission": self.admission.snapshot(),
            "hostBudget": self.host_budget.snapshot(),
            "watchdog": self.watchdog.snapshot(),
        }
