"""Broker: routing tables, instance selection, segment pruning, reduce.

Reference parity: BrokerRoutingManager (pinot-broker/.../routing/manager/
BrokerRoutingManager.java:33) building per-table segment->server maps from
the external view; instance selectors (BalancedInstanceSelector,
ReplicaGroupInstanceSelector); segment pruners (.../routing/segmentpruner/ —
SinglePartitionColumnSegmentPruner, TimeSegmentPruner); and the
scatter-gather + reduce of BaseSingleStageBrokerRequestHandler.handleRequest
(:342).

Re-design: scatter is a direct method call per server (the in-process data
plane; cross-host would ride the mesh collectives instead, SURVEY §2.6);
everything else — routing consistency, pruning, one-replica-per-segment
selection — matches the reference contracts.

Port of pinot_tpu/cluster/broker.py.  Scatter lands in
ServerInstance.execute (one fused-scan launch a segment on the card) and
the micro-batch tier in ServerInstance.execute_batch (the member-axis
launch).  The realtime part and EXPLAIN run on the device of the servers
(`_device`): the broker holds none of its own.
"""
from __future__ import annotations

import itertools
import queue
import random
import statistics
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Set, Tuple

from pinot_tpu_torch.cluster.admission import (
    QueryKilledError,
    ReservationError,
    ResourceGovernor,
    estimate_query_cost,
)
from pinot_tpu_torch.query import reduce as reduce_mod
from pinot_tpu_torch.query.ir import FilterNode, FilterOp, PredicateType, QueryContext
from pinot_tpu_torch.query.result import ExecutionStats, ResultTable
from pinot_tpu_torch.query.safety import Deadline, QueryTimeoutError
from pinot_tpu_torch.utils import threads
from pinot_tpu_torch.utils.hashing import partition_of
from pinot_tpu_torch.utils.metrics import METRICS, Trace
from pinot_tpu_torch.utils.slowlog import SlowQueryLog


class QuotaExceededError(RuntimeError):
    """Per-table QPS quota hit (the reference returns 429 with
    BrokerErrorCode QUERY_QUOTA_EXCEEDED)."""


class NoReplicaAvailableError(RuntimeError):
    """A segment has no live replica left to route to (after exclusions)."""


class ScatterGatherError(RuntimeError):
    """A scatter call failed on every tried replica and the query did not
    opt into allowPartialResults; carries the per-server exception list."""

    def __init__(self, message: str, exceptions: Optional[List[Dict]] = None):
        super().__init__(message)
        self.exceptions = list(exceptions or [])


class QueryQuotaManager:
    """Per-table query rate limiting (HelixExternalViewBasedQueryQuotaManager,
    pinot-broker/.../broker/queryquota/).  Token bucket per table against
    TableConfig quota.maxQueriesPerSecond — refill rate q, burst capacity
    max(1, q), so fractional quotas (q=0.5 -> one query per 2s) throttle
    correctly.  The reference divides the table quota across online
    brokers — single broker here, so the full quota applies (documented)."""

    def __init__(self) -> None:
        # table -> [tokens, last_refill_monotonic]
        self._buckets: Dict[str, List[float]] = {}
        self.clock = time.monotonic  # injectable for deterministic tests
        # the refill/charge sequence is a read-modify-write: concurrent REST
        # handler threads would over-admit past the bucket (a read-modify-write race)
        self._lock = threading.Lock()

    def check(self, table: str, max_qps: float, now: Optional[float] = None) -> None:
        if max_qps <= 0:
            return
        t = self.clock() if now is None else now
        cap = max(1.0, float(max_qps))
        with self._lock:
            b = self._buckets.get(table)
            if b is None:
                b = self._buckets[table] = [cap, t]
            tokens = min(cap, b[0] + max_qps * (t - b[1]))
            b[1] = t
            if tokens < 1.0:
                b[0] = tokens
                raise QuotaExceededError(
                    f"table {table!r} exceeded maxQueriesPerSecond={max_qps:g}"
                )
            b[0] = tokens - 1.0


class AdaptiveServerStats:
    """Latency-biased replica scoring (pinot-broker/.../routing/
    adaptiveserverselector/ — NumInFlightReqSelector + LatencySelector
    hybrid): servers rank by EWMA latency scaled by (1 + in-flight), so
    slow or busy replicas shed load to their peers."""

    ALPHA = 0.3

    def __init__(self) -> None:
        self.ewma_ms: Dict[str, float] = {}
        self.in_flight: Dict[str, int] = {}
        # begin/end race from concurrent scatter threads: unlocked, two
        # begins could both read in_flight=0 and a decay update could be
        # lost entirely (the same race class)
        self._lock = threading.Lock()

    def begin(self, server: str) -> None:
        with self._lock:
            self.in_flight[server] = self.in_flight.get(server, 0) + 1

    def end(self, server: str, latency_ms: float) -> None:
        with self._lock:
            self.in_flight[server] = max(0, self.in_flight.get(server, 1) - 1)
            prev = self.ewma_ms.get(server)
            self.ewma_ms[server] = (
                latency_ms if prev is None else prev + self.ALPHA * (latency_ms - prev)
            )

    def score(self, server: str) -> float:
        # unseen servers score best (explore), matching the reference's
        # default-to-fallback behavior for servers without stats; snapshot
        # under the lock so a concurrent end() can't tear lat/in_flight
        with self._lock:
            lat = self.ewma_ms.get(server, 0.0)
            in_flight = self.in_flight.get(server, 0)
        return lat * (1.0 + in_flight)

    def punish(self, server: str, factor: float = 2.0, floor_ms: float = 50.0) -> None:
        """Failure feedback from the circuit-breaker path: a failed scatter
        call counts as a slow response, so the adaptive selector sheds
        traffic from flaky replicas BEFORE they trip quarantine."""
        with self._lock:
            prev = self.ewma_ms.get(server, 0.0)
            self.ewma_ms[server] = max(prev * factor, floor_ms)


class ServerHealth:
    """Consecutive-failure circuit breaker over scatter targets
    (the AdaptiveServerSelector "unhealthy server" shedding +
    SERVER_NOT_RESPONDING handling collapsed into one explicit breaker).

    States per server: CLOSED (healthy) -> OPEN after `failure_threshold`
    consecutive scatter failures (quarantined: receives no routes while a
    healthy replica exists) -> HALF_OPEN once `cooldown_s` elapses on the
    monotonic clock (at most ONE in-flight probe query is allowed through;
    success closes the breaker, failure re-opens it with a fresh cooldown).

    Quarantine is advisory, never availability-destroying: when every
    replica of a segment is quarantined the router still uses them (serving
    a maybe-flaky replica beats failing the query outright).

    Orthogonal to the breaker, a BROWNOUT state tracks gray failure (slow
    but alive — the breaker never sees an error): each server keeps a
    rolling window of observed scatter latencies, and a server whose window
    median is `brownout_factor`x the median of its peers' medians enters
    brownout.  Browned servers stay available() — the router only WEIGHTS
    them away (prefers non-browned candidates), so availability never
    drops.  Recovery mirrors the half-open probe: once `brownout_cooldown_s`
    elapses the deprioritization lifts, probe traffic flows, and the next
    latency evaluation either clears the brownout or re-stamps it."""

    def __init__(self, failure_threshold: int = 3, cooldown_s: float = 30.0):
        import os

        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self.clock = time.monotonic  # injectable for deterministic tests
        self._lock = threads.Lock()
        self._consecutive: Dict[str, int] = {}
        self._opened_at: Dict[str, float] = {}  # server -> quarantine start
        self._probing: Set[str] = set()  # half-open probes in flight
        # -- gray-failure (brownout) detection --------------------------------
        self.brownout_factor = float(os.environ.get("PINOT_TPU_BROWNOUT_FACTOR", "3.0"))
        self.brownout_min_samples = int(os.environ.get("PINOT_TPU_BROWNOUT_MIN_SAMPLES", "8"))
        self.brownout_cooldown_s = float(
            os.environ.get("PINOT_TPU_BROWNOUT_COOLDOWN_S", str(cooldown_s))
        )
        # absolute floor: sub-floor medians never brown a server, so noise on
        # microsecond-scale test queries can't trigger spurious routing shifts
        self.brownout_min_ms = float(os.environ.get("PINOT_TPU_BROWNOUT_MIN_MS", "2.0"))
        self._latency: Dict[str, "deque"] = {}  # rolling per-server windows
        self._browned: Dict[str, float] = {}  # server -> brownout start

    def record_failure(self, server: str) -> None:
        with self._lock:
            n = self._consecutive.get(server, 0) + 1
            self._consecutive[server] = n
            was_open = server in self._opened_at
            self._probing.discard(server)
            if n >= self.failure_threshold or was_open:
                # threshold hit, or a half-open probe failed: (re-)quarantine
                self._opened_at[server] = self.clock()
                if not was_open:
                    METRICS.counter("broker.serversQuarantined").inc()
            self._publish_gauges_locked(server)

    def record_success(self, server: str) -> None:
        with self._lock:
            self._consecutive[server] = 0
            if self._opened_at.pop(server, None) is not None:
                METRICS.counter("broker.serversRecovered").inc()
            self._probing.discard(server)
            self._publish_gauges_locked(server)

    def _publish_gauges_locked(self, server: str) -> None:
        """Breaker-state gauges (caller holds self._lock): total open
        breakers plus a per-server 0/1 flag for alerting on one replica."""
        METRICS.gauge("broker.openBreakers").set(len(self._opened_at))
        METRICS.gauge(f"broker.breakerOpen.{server}").set(
            1.0 if server in self._opened_at else 0.0
        )
        METRICS.gauge("broker.brownouts").set(len(self._browned))
        METRICS.gauge(f"broker.brownout.{server}").set(
            1.0 if server in self._browned else 0.0
        )

    def note_latency(self, server: str, latency_ms: float) -> Optional[str]:
        """Feed one observed scatter latency and re-evaluate brownout for the
        server.  Returns "enter"/"exit" on a brownout transition, else None.
        This is the ONLY path that moves brownout state — record_failure /
        record_success never touch it, keeping breaker and brownout fully
        independent (a browned server can trip its breaker and vice versa)."""
        with self._lock:
            win = self._latency.get(server)
            if win is None:
                win = self._latency[server] = deque(maxlen=32)
            win.append(float(latency_ms))
            return self._evaluate_brownout_locked(server)

    def _evaluate_brownout_locked(self, server: str) -> Optional[str]:
        win = self._latency.get(server)
        if win is None or len(win) < self.brownout_min_samples:
            return None
        peer_medians = [
            statistics.median(w)
            for s, w in self._latency.items()
            if s != server and len(w) >= self.brownout_min_samples
        ]
        if not peer_medians:
            return None  # outlier-vs-peers needs at least one mature peer
        own = statistics.median(win)
        peers = statistics.median(peer_medians)
        browned_at = self._browned.get(server)
        is_outlier = own >= self.brownout_min_ms and own > self.brownout_factor * peers
        now = self.clock()
        if is_outlier:
            if browned_at is None:
                self._browned[server] = now
                METRICS.counter("broker.serversBrownedOut").inc()
                self._publish_gauges_locked(server)
                return "enter"
            if now - browned_at >= self.brownout_cooldown_s:
                # the half-open-style probe still looks slow: re-stamp the
                # cooldown, exactly like a failed breaker probe re-opens
                self._browned[server] = now
            return None
        if browned_at is not None and now - browned_at >= self.brownout_cooldown_s:
            # probe traffic after the cooldown came back at peer speed
            del self._browned[server]
            METRICS.counter("broker.brownoutRecoveries").inc()
            self._publish_gauges_locked(server)
            return "exit"
        return None

    def in_brownout(self, server: str) -> bool:
        with self._lock:
            return server in self._browned

    def brownout_deprioritized(self, server: str) -> bool:
        """Should the router weight this server away right now?  True while
        browned and inside the cooldown; after the cooldown the server takes
        normal traffic again (the probe window) until note_latency clears or
        re-stamps the brownout."""
        with self._lock:
            t = self._browned.get(server)
            return t is not None and self.clock() - t < self.brownout_cooldown_s

    def latency_window(self, server: str) -> List[float]:
        with self._lock:
            return list(self._latency.get(server, ()))

    def state(self, server: str) -> str:
        with self._lock:
            t = self._opened_at.get(server)
            if t is None:
                return "brownout" if server in self._browned else "closed"
            return "half_open" if self.clock() - t >= self.cooldown_s else "open"

    def available(self, server: str) -> bool:
        """Routable right now?  CLOSED: yes.  OPEN: no.  HALF_OPEN: yes,
        unless another probe is already in flight."""
        with self._lock:
            t = self._opened_at.get(server)
            if t is None:
                return True
            if self.clock() - t < self.cooldown_s:
                return False
            return server not in self._probing

    def begin_probe(self, server: str) -> None:
        """Mark a routed call as the half-open probe (single-flight)."""
        with self._lock:
            if server in self._opened_at:
                self._probing.add(server)

    def consecutive_failures(self, server: str) -> int:
        with self._lock:
            return self._consecutive.get(server, 0)

    def reset(self, server: str) -> None:
        """Fresh slate on a coordinator live-set recovery (mark_up): the
        re-registered server is a new Helix session, not the flaky old one."""
        with self._lock:
            self._consecutive.pop(server, None)
            self._opened_at.pop(server, None)
            self._probing.discard(server)
            self._browned.pop(server, None)
            self._latency.pop(server, None)
            self._publish_gauges_locked(server)


def _p95(values) -> float:
    xs = sorted(values)
    return xs[min(len(xs) - 1, int(round(0.95 * (len(xs) - 1))))]


class HedgeController:
    """Policy + bookkeeping for hedged scatter calls (the tail-tolerance
    half of "The Tail at Scale"): per-(table, server) rolling latency
    windows derive the hedge delay (a multiple of the PEER replicas' p95 —
    a chronically slow primary must not inflate its own trigger), and a
    launch budget caps hedges at `budget_pct`% of primary launches so
    hedging can never amplify an overload.  Hedging is opt-in: the
    PINOT_TPU_HEDGE env toggle or the per-query `hedge` option.

    Env knobs: PINOT_TPU_HEDGE (enable), PINOT_TPU_HEDGE_DELAY_MS (flat
    delay override, skips the quantile derivation), PINOT_TPU_HEDGE_BUDGET_PCT
    (default 10), PINOT_TPU_HEDGE_MIN_SAMPLES (default 8),
    PINOT_TPU_HEDGE_QUANTILE_MULT (default 1.0), PINOT_TPU_HEDGE_MIN_DELAY_MS
    (default 1.0).  Query options `hedge`, `hedgeDelayMs`, `hedgeBudgetPct`
    override per query."""

    WINDOW = 64

    def __init__(self) -> None:
        import os

        env = os.environ
        self.enabled_default = env.get("PINOT_TPU_HEDGE", "0").lower() in ("1", "true", "yes")
        d = env.get("PINOT_TPU_HEDGE_DELAY_MS")
        self.env_delay_ms: Optional[float] = float(d) if d else None
        # budget_pct / quantile_mult read the autopilot KnobRegistry per
        # decision (env vars are the registry's initial values); a direct
        # assignment (tests, bench legs) pins the value via the override
        self._budget_pct_override: Optional[float] = None
        self._quantile_mult_override: Optional[float] = None
        self.min_samples = int(env.get("PINOT_TPU_HEDGE_MIN_SAMPLES", "8"))
        self.min_delay_ms = float(env.get("PINOT_TPU_HEDGE_MIN_DELAY_MS", "1.0"))
        self._lock = threading.Lock()
        self._windows: Dict[Tuple[str, str], deque] = {}
        self._primaries = 0
        self._hedges = 0

    @property
    def budget_pct(self) -> float:
        if self._budget_pct_override is not None:
            return self._budget_pct_override
        from pinot_tpu_torch.cluster import autopilot

        return float(autopilot.knobs().get("hedge_budget_pct"))

    @budget_pct.setter
    def budget_pct(self, value: float) -> None:
        self._budget_pct_override = float(value)

    @property
    def quantile_mult(self) -> float:
        if self._quantile_mult_override is not None:
            return self._quantile_mult_override
        from pinot_tpu_torch.cluster import autopilot

        return float(autopilot.knobs().get("hedge_delay_mult"))

    @quantile_mult.setter
    def quantile_mult(self, value: float) -> None:
        self._quantile_mult_override = float(value)

    def enabled(self, opts: Optional[Dict] = None) -> bool:
        if opts is not None and "hedge" in opts:
            return str(opts.get("hedge", "")).lower() in ("1", "true", "yes")
        return self.enabled_default

    def observe(self, table: str, server: str, latency_ms: float) -> None:
        with self._lock:
            key = (table, server)
            win = self._windows.get(key)
            if win is None:
                win = self._windows[key] = deque(maxlen=self.WINDOW)
            win.append(float(latency_ms))

    def delay_ms(self, table: str, primary: str, opts: Optional[Dict] = None) -> Optional[float]:
        """Hedge trigger delay for a call routed to `primary`, or None when
        there is not yet enough signal to hedge safely (cold start)."""
        if opts is not None and opts.get("hedgeDelayMs") is not None:
            return float(opts["hedgeDelayMs"])
        if self.env_delay_ms is not None:
            return self.env_delay_ms
        with self._lock:
            peer_p95s = [
                _p95(win)
                for (t, s), win in self._windows.items()
                if t == table and s != primary and len(win) >= self.min_samples
            ]
        if not peer_p95s:
            return None
        return max(self.min_delay_ms, self.quantile_mult * statistics.median(peer_p95s))

    def note_primary(self) -> None:
        with self._lock:
            self._primaries += 1

    def try_fire(self, opts: Optional[Dict] = None) -> bool:
        """Claim one hedge launch against the budget; False when the next
        hedge would push the hedge:primary ratio past budget_pct%."""
        pct = self.budget_pct
        if opts is not None and opts.get("hedgeBudgetPct") is not None:
            pct = float(opts["hedgeBudgetPct"])
        with self._lock:
            if (self._hedges + 1) > pct / 100.0 * self._primaries:
                return False
            self._hedges += 1
            return True

    def unfire(self) -> None:
        """Return a claimed launch (admission refused the charge)."""
        with self._lock:
            self._hedges = max(0, self._hedges - 1)

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "primaries": self._primaries,
                "hedges": self._hedges,
                "budgetPct": self.budget_pct,
                "windows": len(self._windows),
            }


class _BatchMember:
    """One pre-admitted query riding the micro-batcher: the submit-time
    bracket (query id, trace root, deadline, governor grant + kill probe,
    cache key) plus the plan/prune products filled in by _plan_member."""

    __slots__ = (
        "ctx", "sql", "fp", "sfp", "qid", "trace", "deadline", "t0",
        "grant", "cancel", "ckey", "offline_ctx", "realtime_ctx",
        "seg_names", "pruned",
    )

    def __init__(self, ctx, sql, fp, sfp, qid, trace, deadline, t0, grant, cancel, ckey):
        self.ctx = ctx
        self.sql = sql
        self.fp = fp
        self.sfp = sfp
        self.qid = qid
        self.trace = trace
        self.deadline = deadline
        self.t0 = t0
        self.grant = grant
        self.cancel = cancel
        self.ckey = ckey
        self.offline_ctx = ctx
        self.realtime_ctx = ctx
        self.seg_names: List[str] = []
        self.pruned = 0


def _has_subquery(node: Optional[FilterNode]) -> bool:
    """IN (SELECT ...) anywhere in a filter tree — such queries keep the
    synchronous path (their subqueries recurse through execute())."""
    if node is None:
        return False
    from pinot_tpu_torch.query.ir import Subquery

    if node.op is FilterOp.PRED:
        p = node.predicate
        return bool(p is not None and p.values and isinstance(p.values[0], Subquery))
    return any(_has_subquery(c) for c in (node.children or ()))


class Broker:
    def __init__(self, coordinator, selector: str = "balanced"):
        # coordinator HA: the broker never holds a raw Coordinator —
        # everything routes through a CoordinatorHandle that re-resolves
        # leadership on NotLeaderError and keeps data-plane reads serving
        # off the last versioned routing view during a failover.  wrap() is
        # idempotent, so callers may pass a Coordinator OR a handle over a
        # leader + standbys.
        from pinot_tpu_torch.cluster.election import CoordinatorHandle

        self.coordinator = CoordinatorHandle.wrap(coordinator)
        self.selector = selector  # "balanced" | "replicagroup" | "adaptive"
        self._rr = 0  # round-robin cursor
        self._rr_lock = threading.Lock()  # cursor bump is an RMW across handler threads
        # mesh-replica batch routing: whole same-fingerprint batches land on
        # one replica row each (replica group ≅ mesh replica row), rotated
        # per BATCH so concurrent batches spread across rows while every
        # member of a batch shares its row's compiled kernel + staged copy
        self._batch_rr = 0
        self.quota = QueryQuotaManager()
        self.server_stats = AdaptiveServerStats()
        self.health = ServerHealth()
        # failover backoff: injectable sleep + seeded jitter so fault tests
        # are deterministic and never wall-clock sensitive
        self.retry_rng = random.Random(0x5CA77E12)
        self._sleep = time.sleep
        # tail tolerance: hedged-scatter policy + live loser threads (each
        # loser is cooperatively cancelled via the cancel-probe path and
        # tracked here until it unwinds — hedge_drain() proves no leaks)
        self.hedge = HedgeController()
        self._hedge_threads: Set[threading.Thread] = set()
        self._hedge_lock = threading.Lock()
        # query-id mint: itertools.count is atomic under the GIL, so handler
        # threads never need a lock for the sequence (lock-free by design)
        self._qid_seq = itertools.count(1)
        self._broker_id = f"{random.getrandbits(32):08x}"
        # recent-query ring buffer behind GET /debug/queries + cli slow-queries
        self.slow_queries = SlowQueryLog()
        # broker result cache: bytes-bounded LRU + TTL, keyed on the resolved
        # query fingerprint + a table version token (segment set + realtime
        # doc count), so segment churn or realtime appends miss naturally.
        # Serving from it is opt-in: the useResultCache query option or the
        # PINOT_TPU_RESULT_CACHE env toggle (off by default — repeated
        # execution semantics stay untouched unless asked for).
        import os

        from pinot_tpu_torch.utils.cache import LruCache

        # resource governor (cluster/admission.py): token-bucket admission,
        # host-memory ledger, runaway watchdog, degradation controller.
        # The result cache charges the SAME host ledger the governor reserves
        # query working sets from, so cached bytes + in-flight queries can
        # never jointly overcommit host memory.
        self.governor: Optional[ResourceGovernor] = ResourceGovernor()
        self.result_cache = LruCache(
            max_bytes=max(1, int(os.environ.get("PINOT_TPU_RESULT_CACHE_BYTES", str(64 << 20)))),
            ttl_s=float(os.environ.get("PINOT_TPU_RESULT_CACHE_TTL_S", "60")),
            name="broker.resultCache",
            budget=self.governor.host_budget,
        )
        # the SSE plan cache (servers compile through it) charges the same
        # ledger — idempotent for the shared process budget
        from pinot_tpu_torch.query.planner import attach_plan_cache_budget

        attach_plan_cache_budget(self.governor.host_budget)
        # cross-query micro-batcher (cluster/batcher.py): built lazily on the
        # first submit() so brokers that never use the async tier never start
        # its worker.  Tests inject a fake clock via batch_clock BEFORE the
        # first submit and drive flushes deterministically with pump().
        self.batch_clock = None
        self._query_batcher = None
        self._batcher_lock = threading.Lock()
        # SLO autopilot (cluster/autopilot.py): the feedback controller that
        # tunes the KnobRegistry the batcher/hedge/admission/engine/residency
        # paths read per decision.  Off by default — with PINOT_TPU_AUTOPILOT
        # unset no controller thread exists, no knob override is ever written,
        # and every consumer reads its env default: pre-autopilot behavior
        # bit-exactly.  attach_autopilot() wires one explicitly (benches,
        # tests drive tick() by hand with a fake clock).
        from pinot_tpu_torch.cluster import autopilot as autopilot_mod

        self.autopilot: Optional[autopilot_mod.Autopilot] = None
        if autopilot_mod.autopilot_enabled():
            self.attach_autopilot(start=True)
        # subscribe via the handle so the subscription is RECORDED and
        # re-registered on every newly adopted leader (breaker heal keeps
        # working across a failover)
        self.coordinator.on_live_change(self._on_live_change)

    @staticmethod
    def _result_cache_enabled(ctx: QueryContext) -> bool:
        import os

        opt = ctx.options.get("useResultCache")
        if opt is not None:
            return str(opt).lower() in ("1", "true", "yes")
        return os.environ.get("PINOT_TPU_RESULT_CACHE", "0").lower() in ("1", "true", "yes")

    def _table_version(self, table: str) -> Tuple:
        """Version token invalidating cached results on table churn: the
        offline segment set plus the realtime view's (segments, docs)."""
        meta = self.coordinator.tables.get(table)
        ideal = tuple(sorted(meta.ideal)) if meta is not None else ()
        rt = self.coordinator.realtime.get(table)
        rtv: Tuple = ()
        if rt is not None:
            segs = list(rt.query_segments())
            rtv = (len(segs), sum(s.num_docs for s in segs))
        return (ideal, rtv)

    def invalidate_results(self, table: str) -> int:
        """Explicitly drop every cached result for one table (segment
        reload / config change hook)."""
        return self.result_cache.invalidate_where(lambda k: k[0] == table)

    def _on_live_change(self, name: str, up: bool) -> None:
        """Coordinator live-set transition: a recovered server gets a fresh
        breaker (a new Helix session is not the old flaky process)."""
        if up:
            self.health.reset(name)

    def election_snapshot(self) -> Dict:
        """Leadership view for GET /debug/election: current leader plus
        per-candidate lease/epoch/role state."""
        return self.coordinator.election_snapshot()

    def attach_autopilot(self, controller=None, start: bool = False):
        """Wire an SLO autopilot to this broker (replacing any previous
        one).  Default construction feeds it the process PerfLedger and this
        broker's governor; `start` launches the fixed-tick thread."""
        from pinot_tpu_torch.cluster import autopilot as autopilot_mod

        old = self.autopilot
        if old is not None:
            old.stop()
        if controller is None:
            controller = autopilot_mod.Autopilot(governor=self.governor)
        self.autopilot = controller
        if start:
            controller.start()
        return controller

    def autopilot_snapshot(self) -> Dict:
        """Knob values vs clamp bounds plus controller state for
        GET /debug/autopilot + `cli autopilot` — available with the
        controller detached too (registry-only view)."""
        from pinot_tpu_torch.cluster import autopilot as autopilot_mod

        ap = self.autopilot
        if ap is not None:
            return ap.snapshot()
        return {"enabled": False, **autopilot_mod.knobs().snapshot()}

    # -- routing table (built per query from the external view) -----------
    def _route(
        self,
        table: str,
        seg_names: List[str],
        exclude: frozenset = frozenset(),
        partial_ok: bool = False,
        prefer_group: Optional[int] = None,
    ):
        """segment list -> {server: [segments]} picking ONE live replica per
        segment (InstanceSelector contract).

        `exclude`: servers that already failed this query (failover
        re-selection never retries them).  Quarantined servers (ServerHealth
        OPEN) are skipped while a healthy replica exists; when a segment's
        every replica is quarantined, availability wins and they serve.
        With partial_ok, returns (assign, unroutable_segments) instead of
        raising on a replica-less segment.  `prefer_group` (replicagroup
        selector only) starts the group rotation at that replica group —
        the batched scatter path uses it to pin a whole batch to one mesh
        replica row; a dead/partial preferred group still falls through the
        rotation, so it's a preference, never an availability constraint."""
        view = self.coordinator.external_view(table)
        healthy = {
            s for s in self.coordinator.live if s not in exclude and self.health.available(s)
        }
        usable = {s for s in self.coordinator.live if s not in exclude}
        with self._rr_lock:
            self._rr += 1
            rr = self._rr  # routing decisions below use this stable local
        if self.selector == "replicagroup":
            # strict replica-group: pick ONE group serving ALL segments
            groups: Dict[int, Set[str]] = {}
            for s in healthy:
                groups.setdefault(self.coordinator.replica_group[s], set()).add(s)
            order = sorted(groups)
            for gi in range(len(order)):
                if prefer_group is not None:
                    g = order[(prefer_group + gi) % len(order)]
                else:
                    g = order[(rr + gi) % len(order)]
                members = groups[g]
                assign: Dict[str, List[str]] = {}
                ok = True
                for seg in seg_names:
                    srv = sorted(view.get(seg, ()) & members)
                    if not srv:
                        ok = False
                        break
                    assign.setdefault(srv[0], []).append(seg)
                if ok:
                    return (assign, []) if partial_ok else assign
            # no single group covers everything: fall through to balanced
        assign = {}
        unroutable: List[str] = []
        for i, seg in enumerate(seg_names):
            replicas = view.get(seg, set())
            candidates = sorted(replicas & healthy) or sorted(replicas & usable)
            if not candidates:
                if partial_ok:
                    unroutable.append(seg)
                    continue
                raise NoReplicaAvailableError(f"segment {table}/{seg} has no live replica")
            # gray-failure weighting: prefer non-browned replicas, but a
            # fully-browned candidate set still serves (availability wins,
            # exactly like breaker quarantine above)
            bright = [c for c in candidates if not self.health.brownout_deprioritized(c)]
            if bright:
                candidates = bright
            if self.selector == "adaptive":
                # latency-biased: best (lowest) score wins; round-robin
                # breaks exact ties so cold starts still spread
                srv = min(
                    candidates,
                    key=lambda s, i=i: (self.server_stats.score(s), (rr + i + candidates.index(s)) % len(candidates)),
                )
            else:
                srv = candidates[(rr + i) % len(candidates)]
            assign.setdefault(srv, []).append(seg)
        return (assign, unroutable) if partial_ok else assign

    # -- segment pruners ---------------------------------------------------
    def _prune(self, ctx: QueryContext, table: str) -> Tuple[List[str], int]:
        """Partition + time pruning on broker-side segment metadata."""
        meta = self.coordinator.tables[table]
        names = list(meta.ideal)
        pruned = 0
        eq_values = _eq_values_by_column(ctx.filter)
        cfg = meta.config
        out = []
        for seg in names:
            sm = meta.segment_meta.get(seg, {})
            # partition pruner (SinglePartitionColumnSegmentPruner)
            part = sm.get("partition")
            if part is not None and part[0] in eq_values:
                col, pid, n = part
                if all(partition_of(v, n) != pid for v in eq_values[col]):
                    pruned += 1
                    continue
            # time pruner (TimeSegmentPruner)
            tc = cfg.segments.time_column
            tr = sm.get("timeRange")
            if tc and tr is not None and tr[0] is not None:
                lo, hi = _range_for_column(ctx.filter, tc)
                if (hi is not None and tr[0] is not None and tr[0] > hi) or (
                    lo is not None and tr[1] is not None and tr[1] < lo
                ):
                    pruned += 1
                    continue
            out.append(seg)
        return out, pruned

    # -- request handling --------------------------------------------------
    def query(self, sql: str) -> ResultTable:
        from pinot_tpu_torch.sql.parser import parse_query

        ctx = parse_query(sql)
        if ctx.options.get("__explain__"):
            return self.execute(ctx)  # plan-only: not a served query
        fp = ctx.fingerprint()
        sfp = ctx.shape_fingerprint()
        try:
            out = self.execute(ctx)
        except Exception as e:
            self.slow_queries.record(
                sql, fp, None, error=f"{type(e).__name__}: {e}", shape_fingerprint=sfp
            )
            raise
        self.slow_queries.record(sql, fp, out, shape_fingerprint=sfp)
        return out

    def execute(self, ctx: QueryContext, _charged: frozenset = frozenset()) -> ResultTable:
        from pinot_tpu_torch.query.engine import apply_set_ops, resolve_subqueries
        from pinot_tpu_torch.spi.env import apply_env_defaults

        apply_env_defaults(ctx.options)
        if ctx.options.get("__explain__"):
            return self._explain(ctx)
        if ctx.options.get("__analyze__"):
            return self._explain_analyze(ctx)
        # quota charges ONCE per client request PER TABLE — set-op operands
        # and subqueries recurse with their outer tables pre-paid, but a
        # different table inside the request still pays its own quota
        # (inner tables must not bypass their limits)
        if ctx.table not in _charged and ctx.table in self.coordinator.tables:
            self.quota.check(
                ctx.table, self.coordinator.tables[ctx.table].config.max_queries_per_second
            )
        charged = _charged | {ctx.table}
        _sub = lambda c: self.execute(c, _charged=charged)
        resolve_subqueries(ctx, _sub)
        if ctx.set_ops:
            return apply_set_ops(ctx, _sub)
        t0 = time.perf_counter()
        deadline = Deadline.from_ctx(ctx)
        if ctx.joins:
            raise NotImplementedError("broker routes single-table queries; joins ride the MSE engine")
        table = ctx.table
        if table not in self.coordinator.tables:
            raise KeyError(f"table {table!r} not found")
        # root span: the broker mints the query id; every server subtree
        # grafts under this one tree (RequestContext analog)
        qid = f"{self._broker_id}_{next(self._qid_seq)}"
        trace = Trace(bool(ctx.options.get("trace", False)), query_id=qid)
        METRICS.counter("broker.queries").inc()
        # admission bracket: root client requests only (subquery/set-op
        # recursion rides the parent's grant).  Sheds (429) and capacity
        # rejections (503) raise HERE, after the qid mint, so every
        # structured rejection carries the query id; the grant's host
        # reservation + watchdog registration release in the finally on
        # every exit path (success, timeout, kill, server fault).
        grant = None
        cancel = None
        gov = self.governor
        if gov is not None and not _charged:
            cost = estimate_query_cost(ctx, self.coordinator.tables[table].segment_meta.values())
            grant = gov.admit(qid, ctx, cost, deadline)
            cancel = gov.cancel_probe(qid)
        try:
            return self._serve(ctx, table, qid, trace, deadline, t0, cancel)
        finally:
            if grant is not None:
                grant.close()

    def _serve(
        self,
        ctx: QueryContext,
        table: str,
        qid: str,
        trace: Trace,
        deadline: Deadline,
        t0: float,
        cancel=None,
    ) -> ResultTable:
        """One admitted query's serve path: execute() holds the admission
        grant around this call; `cancel` is the watchdog's kill probe,
        threaded through scatter into every server's between-kernel check."""
        gov = self.governor
        ckey, hit = self._cache_probe(ctx, table, qid, t0)
        if hit is not None:
            return hit
        # schema-aware static validation before scatter: a malformed plan
        # fails ONCE at the broker with a structured error instead of
        # failing per-server inside planning
        from pinot_tpu_torch.analysis.plan_check import check_plan

        with trace.span("plan") as bsp:
            check_plan(ctx, self.coordinator.tables[table].schema)
            self._inject_global_ranges(ctx, table)
            if bsp is not None:
                from pinot_tpu_torch.query.shape import shape_digest

                bsp.annotate(
                    shapeFp=shape_digest(ctx.shape_fingerprint()),
                    resultCache="bypass" if ckey is None else "miss",
                )
                if gov is not None and gov.degrade.level > 0:
                    bsp.annotate(pressure=gov.degrade.level)
        offline_ctx, realtime_ctx = self._split_hybrid(ctx, table)
        meta = self.coordinator.tables[table]
        with trace.span("prune", table=table) as psp:
            seg_names, pruned = self._prune(offline_ctx, table)
        if psp is not None:
            psp.annotate(segments=len(seg_names), pruned=pruned)
        return self._serve_tail(
            ctx, offline_ctx, realtime_ctx, table, meta, seg_names, pruned,
            qid, trace, deadline, t0, cancel, ckey,
        )

    def _serve_tail(
        self,
        ctx: QueryContext,
        offline_ctx: QueryContext,
        realtime_ctx: QueryContext,
        table: str,
        meta,
        seg_names: List[str],
        pruned: int,
        qid: str,
        trace: Trace,
        deadline: Deadline,
        t0: float,
        cancel,
        ckey,
    ) -> ResultTable:
        """Post-prune serve: scatter with full failover, realtime part,
        reduce, finish.  Shared by the sync path, singleton batch members,
        and the per-member fallback when a batched scatter hits a fault."""
        stats = ExecutionStats(num_segments_pruned=pruned)
        results = []
        if seg_names:
            METRICS.gauge("broker.inFlightScatters").add(1)
            try:
                with trace.span("scatter", segments=len(seg_names)):
                    results.extend(
                        self._scatter(
                            offline_ctx, table, seg_names, meta, deadline, stats, trace,
                            cancel=cancel, qid=qid,
                        )
                    )
            finally:
                METRICS.gauge("broker.inFlightScatters").add(-1)
        if any(e.get("errorCode") == "QUERY_KILLED" for e in stats.exceptions):
            # the kill already degraded this query to a partial result —
            # further probes must not re-raise and destroy what survived
            cancel = None
        self._serve_realtime(realtime_ctx, table, qid, cancel, deadline, stats, results, trace)
        return self._finish_result(ctx, table, qid, t0, trace, ckey, results, stats)

    def _cache_probe(self, ctx: QueryContext, table: str, qid: str, t0: float):
        """Result cache lookup: key on the post-resolution fingerprint +
        table version token, BEFORE plan-time option injection mutates
        ctx.  Traced queries bypass it (a cached result carries no spans);
        under memory pressure (degradation level >= 1) the cache is
        bypassed entirely — stop retaining bytes, stop serving stale ones.
        Returns (ckey, hit): ckey is None when caching doesn't apply, hit
        is the stamped cached ResultTable or None."""
        gov = self.governor
        if (
            self._result_cache_enabled(ctx)
            and not ctx.options.get("trace", False)
            and (gov is None or gov.degrade.result_cache_enabled())
        ):
            ckey = (table, ctx.fingerprint(), self._table_version(table))
            hit = self.result_cache.get(ckey)
            if hit is not None:
                import copy

                out = copy.deepcopy(hit)
                out.stats.time_ms = (time.perf_counter() - t0) * 1000
                out.stats.query_id = qid
                out.stats.result_cache = "hit"
                METRICS.histogram("broker.queryLatency").update(out.stats.time_ms)
                return ckey, out
            return ckey, None
        return None, None

    def _split_hybrid(self, ctx: QueryContext, table: str):
        """Hybrid tables (offline segments + a realtime manager under ONE
        name): a TIME BOUNDARY splits the parts — offline answers
        ts <= boundary, realtime answers ts > boundary (TimeBoundaryManager
        analog; late events below the boundary are excluded from the
        realtime part, matching the reference)."""
        offline_ctx, realtime_ctx = ctx, ctx
        meta = self.coordinator.tables[table]
        rt = self.coordinator.realtime.get(table)
        tc = meta.config.segments.time_column
        if rt is not None and meta.ideal and tc:
            ends = [
                sm["timeRange"][1]
                for sm in meta.segment_meta.values()
                if isinstance(sm, dict) and sm.get("timeRange") is not None
            ]
            if ends:
                boundary = max(ends)
                offline_ctx = _with_time_bound(ctx, tc, upper=boundary)
                realtime_ctx = _with_time_bound(ctx, tc, lower_exclusive=boundary)
        return offline_ctx, realtime_ctx

    def _serve_realtime(
        self,
        realtime_ctx: QueryContext,
        table: str,
        qid: str,
        cancel,
        deadline: Deadline,
        stats: ExecutionStats,
        results: List,
        trace: Trace,
    ) -> None:
        """Realtime tables: sealed + consuming segments served from the
        coordinator-owned manager (the RealtimeTableDataManager view).
        Shared by the sync serve path and each batched member (the realtime
        part always executes per member — it is never coalesced)."""
        rt = self.coordinator.realtime.get(table)
        if rt is None:
            return
        from pinot_tpu_torch.query import executor as sse_executor

        with trace.span("realtime") as rsp:
            rt_docs = 0
            for seg in rt.query_segments():
                deadline.check(f"query on {table}")
                if cancel is not None:
                    reason = cancel()
                    if reason:
                        raise QueryKilledError(
                            f"query {qid} killed between realtime segments ({reason})",
                            query_id=qid,
                            reason=reason,
                        )
                stats.num_segments_queried += 1
                stats.total_docs += seg.num_docs
                if sse_executor.prune_segment(realtime_ctx, seg):
                    stats.num_segments_pruned += 1
                    continue
                res, sstats = sse_executor.execute_segment(realtime_ctx, seg, self._device())
                stats.num_segments_processed += 1
                stats.num_docs_scanned += sstats.num_docs_scanned
                rt_docs += sstats.num_docs_scanned
                stats.add_index_uses(sstats.filter_index_uses)
                stats.add_kernel_cost(sstats)
                results.append(res)
            if rsp is not None:
                rsp.annotate(docs=rt_docs)

    def _finish_result(
        self,
        ctx: QueryContext,
        table: str,
        qid: str,
        t0: float,
        trace: Trace,
        ckey,
        results: List,
        stats: ExecutionStats,
    ) -> ResultTable:
        """Reduce + response stamping + result-cache populate + latency and
        PerfLedger accounting — the tail every served query (sync or batch
        member) runs through."""
        with trace.span("reduce"):
            out = reduce_mod.reduce_results(ctx, results, stats)
        out.stats.time_ms = (time.perf_counter() - t0) * 1000
        out.stats.query_id = qid
        tr = trace.finish()
        if tr is not None:
            out.stats.trace = tr
        if ckey is not None:
            out.stats.result_cache = "miss"
            # complete answers only: degraded or exception-bearing results
            # must re-execute, never replay
            if not out.stats.partial_result and not out.stats.exceptions:
                import copy

                self.result_cache.put(ckey, copy.deepcopy(out))
        METRICS.histogram("broker.queryLatency").update(out.stats.time_ms)
        from pinot_tpu_torch.query.shape import shape_digest
        from pinot_tpu_torch.utils import perf

        perf.PERF_LEDGER.record(
            table,
            shape_digest(ctx.shape_fingerprint()),
            rows=out.stats.num_docs_scanned,
            time_ms=out.stats.time_ms,
            kernel_bytes=out.stats.kernel_bytes,
            compile_ms=out.stats.compile_ms,
            cache_hit=out.stats.compile_ms == 0.0,
            engine="broker",
        )
        return out

    # -- concurrent serving tier: async submit + cross-query batching ------
    def submit(self, sql: str):
        """Async entry point: returns a concurrent.futures.Future resolving
        to the query's ResultTable (or raising its error).

        Batchable queries (single table, no set-ops/joins/subqueries, not
        EXPLAIN) pay their admission bracket — QPS quota, governor admit +
        watchdog registration, result-cache probe — at submit time, then
        wait up to PINOT_TPU_BATCH_WAIT_MS in the micro-batcher for
        same-shape peers; a coalesced group executes as ONE vmapped launch
        per segment.  Everything else (and every query when the wait window
        is 0) takes the synchronous query() path and comes back as an
        already-completed future, so semantics never change — batching is
        purely an execution strategy."""
        from concurrent.futures import Future

        from pinot_tpu_torch.sql.parser import parse_query
        from pinot_tpu_torch.spi.env import apply_env_defaults

        fut = Future()
        try:
            ctx = parse_query(sql)
            apply_env_defaults(ctx.options)
        except Exception as e:
            fut.set_exception(e)
            return fut
        if not self._batchable(ctx):
            try:
                fut.set_result(self.query(sql))
            except Exception as e:
                fut.set_exception(e)
            return fut
        fp = ctx.fingerprint()
        # literal canonicalization needs column metadata: fingerprint against
        # a representative segment so `v < 5` and `v < 6` share one slot
        # (the same provider plan_segment keys its compile cache with)
        sfp = ctx.shape_fingerprint(self._column_info(ctx.table))
        try:
            member = self._admit_member(ctx, sql, fp, sfp)
        except Exception as e:
            self.slow_queries.record(
                sql, fp, None, error=f"{type(e).__name__}: {e}", shape_fingerprint=sfp
            )
            fut.set_exception(e)
            return fut
        if isinstance(member, ResultTable):  # result-cache hit at submit
            self.slow_queries.record(sql, fp, member, shape_fingerprint=sfp)
            fut.set_result(member)
            return fut
        from pinot_tpu_torch.query.shape import shape_digest

        # the batch key IS the shape fingerprint (digested) — literals
        # differ freely (they ride the stacked launch params), but options
        # like trace are part of the shape, so traced and untraced queries
        # never coalesce
        return self._batcher().submit((ctx.table, shape_digest(sfp)), member)

    def query_many(self, sqls: List[str]) -> List[ResultTable]:
        """Submit a batch of queries concurrently, flush, and gather —
        errors re-raise in submission order."""
        futs = [self.submit(s) for s in sqls]
        self.drain_batches()
        return [f.result() for f in futs]

    def drain_batches(self) -> int:
        """Flush every pending micro-batch immediately (tests, shutdown,
        synchronous gather)."""
        with self._batcher_lock:
            batcher = self._query_batcher
        if batcher is None:
            return 0
        return batcher.flush()

    def _batcher(self):
        with self._batcher_lock:
            if self._query_batcher is None:
                from pinot_tpu_torch.cluster.batcher import MicroBatcher

                self._query_batcher = MicroBatcher(
                    self._run_batch, clock=self.batch_clock
                )
            return self._query_batcher

    def _column_info(self, table: str):
        """Column-shape provider from any live replica's copy of any
        segment — the audit input shape_fingerprint canonicalizes literals
        with.  None (empty table / nothing routable) keeps literals baked,
        which only means less coalescing, never wrong results."""
        from pinot_tpu_torch.query.shape import column_info_from

        view = self.coordinator.external_view(table)
        for seg, servers in view.items():
            for s in servers:
                srv = self.coordinator.servers.get(s)
                seg_obj = srv.get_segment(table, seg) if srv is not None else None
                if seg_obj is not None:
                    return column_info_from(seg_obj)
        return None

    def _batchable(self, ctx: QueryContext) -> bool:
        """Only plain single-table scans coalesce; compound shapes keep the
        recursive synchronous path (their sub-plans pay their own quota and
        admission there)."""
        if ctx.options.get("__explain__") or ctx.options.get("__analyze__"):
            return False
        if ctx.set_ops or ctx.joins:
            return False
        if ctx.table not in self.coordinator.tables:
            return False
        return not _has_subquery(ctx.filter) and not _has_subquery(
            getattr(ctx, "having", None)
        )

    def _admit_member(self, ctx: QueryContext, sql: str, fp: str, sfp: str):
        """The pre-batch slice of execute(): quota, query id, trace root,
        deadline, governor admission, cache probe.  Returns a cached
        ResultTable on a hit, else a _BatchMember holding the live grant
        (closed by _member_done on every completion path)."""
        table = ctx.table
        self.quota.check(
            table, self.coordinator.tables[table].config.max_queries_per_second
        )
        t0 = time.perf_counter()
        deadline = Deadline.from_ctx(ctx)
        qid = f"{self._broker_id}_{next(self._qid_seq)}"
        trace = Trace(bool(ctx.options.get("trace", False)), query_id=qid)
        METRICS.counter("broker.queries").inc()
        grant = None
        cancel = None
        gov = self.governor
        if gov is not None:
            cost = estimate_query_cost(
                ctx, self.coordinator.tables[table].segment_meta.values()
            )
            grant = gov.admit(qid, ctx, cost, deadline)
            cancel = gov.cancel_probe(qid)
        try:
            ckey, hit = self._cache_probe(ctx, table, qid, t0)
        except Exception:
            if grant is not None:
                grant.close()
            raise
        if hit is not None:
            if grant is not None:
                grant.close()
            return hit
        return _BatchMember(
            ctx=ctx, sql=sql, fp=fp, sfp=sfp, qid=qid, trace=trace,
            deadline=deadline, t0=t0, grant=grant, cancel=cancel, ckey=ckey,
        )

    def _run_batch(self, entries) -> None:
        """MicroBatcher runner: one coalesced group of same-shape members.
        Owns completion — every entry's future resolves here."""
        if len(entries) == 1:
            m = entries[0].payload
            self._member_done(entries[0], self._serve_member(m))
            return
        members = [e.payload for e in entries]
        try:
            outcomes = self._serve_batch(members)
        except Exception as exc:  # orchestration safety net: never hang a future
            outcomes = [exc] * len(members)
        for entry, out in zip(entries, outcomes):
            self._member_done(entry, out)

    def _member_done(self, entry, outcome) -> None:
        """Deliver one member's outcome: slow-log entry, future resolution,
        admission grant release."""
        m = entry.payload
        try:
            if isinstance(outcome, BaseException):
                self.slow_queries.record(
                    m.sql, m.fp, None,
                    error=f"{type(outcome).__name__}: {outcome}",
                    shape_fingerprint=m.sfp,
                )
                entry.future.set_exception(outcome)
            else:
                self.slow_queries.record(m.sql, m.fp, outcome, shape_fingerprint=m.sfp)
                entry.future.set_result(outcome)
        finally:
            if m.grant is not None:
                m.grant.close()

    def _serve_member(self, m) -> object:
        """Plan + prune + serve ONE pre-admitted member through the standard
        failover path (singleton flushes and post-fault fallbacks).  Returns
        the ResultTable or the exception — never raises."""
        table = m.ctx.table
        try:
            meta = self.coordinator.tables[table]
            self._plan_member(m, table, meta)
            return self._serve_tail(
                m.ctx, m.offline_ctx, m.realtime_ctx, table, meta,
                m.seg_names, m.pruned, m.qid, m.trace, m.deadline, m.t0,
                m.cancel, m.ckey,
            )
        except Exception as e:
            # outcome, not a swallow: _member_done slow-logs it and fails
            # the submitter's future
            METRICS.counter("broker.memberServeErrors").inc()
            return e

    def _plan_member(self, m, table: str, meta) -> None:
        """The plan-span + hybrid-split + prune slice of _serve, recorded on
        the member's own trace."""
        from pinot_tpu_torch.analysis.plan_check import check_plan

        gov = self.governor
        with m.trace.span("plan") as bsp:
            check_plan(m.ctx, meta.schema)
            self._inject_global_ranges(m.ctx, table)
            if bsp is not None:
                from pinot_tpu_torch.query.shape import shape_digest

                bsp.annotate(
                    shapeFp=shape_digest(m.ctx.shape_fingerprint()),
                    resultCache="bypass" if m.ckey is None else "miss",
                )
                if gov is not None and gov.degrade.level > 0:
                    bsp.annotate(pressure=gov.degrade.level)
        m.offline_ctx, m.realtime_ctx = self._split_hybrid(m.ctx, table)
        with m.trace.span("prune", table=table) as psp:
            m.seg_names, m.pruned = self._prune(m.offline_ctx, table)
        if psp is not None:
            psp.annotate(segments=len(m.seg_names), pruned=m.pruned)

    def _serve_batch(self, members: List) -> List:
        """Serve one coalesced same-shape group: per-member plan/prune, then
        sub-group by IDENTICAL pruned segment list (prune divergence never
        mis-attributes work), one batched scatter per sub-group, and the
        per-member realtime/reduce/finish tail.  Returns one outcome
        (ResultTable or Exception) per member; a transport-level fault in a
        batched scatter falls the affected sub-group back to the standard
        per-member failover path instead of failing anyone."""
        table = members[0].ctx.table
        meta = self.coordinator.tables[table]
        batch_id = f"b{self._broker_id}_{next(self._qid_seq)}"
        outcomes: List = [None] * len(members)
        groups: Dict[Tuple, List[int]] = {}
        for i, m in enumerate(members):
            try:
                self._plan_member(m, table, meta)
                m.trace.annotate(batchId=batch_id, batchSize=len(members))
                groups.setdefault(tuple(m.seg_names), []).append(i)
            except Exception as e:
                # recorded as the member's outcome; _member_done slow-logs it
                METRICS.counter("broker.memberServeErrors").inc()
                outcomes[i] = e
        METRICS.counter("broker.batches").inc()
        METRICS.histogram("broker.batchSize").update(len(members))
        for segs, idxs in groups.items():
            group = [members[i] for i in idxs]
            if len(idxs) == 1 or not segs:
                # lone segment-list (or pure-realtime query): nothing to
                # coalesce at the kernel layer — standard path
                for i in idxs:
                    outcomes[i] = self._serve_member(members[i])
                continue
            try:
                res_lists, stats_list, errs = self._scatter_batch(
                    group, table, list(segs), meta, batch_id
                )
            except Exception:
                # batch-level fault (server crash, capacity, routing): the
                # whole sub-group re-executes individually with the full
                # failover machinery — batching is bypassed on faults
                METRICS.counter("broker.batchFallbacks").inc()
                for i in idxs:
                    outcomes[i] = self._serve_member(members[i])
                continue
            for i, m, results, stats, err in zip(
                idxs, group, res_lists, stats_list, errs
            ):
                outcomes[i] = self._finish_batch_member(
                    m, table, results, stats, err
                )
        return outcomes

    def _finish_batch_member(self, m, table, results, stats, err):
        """Realtime part + reduce + finish for one batched member, honoring
        the kill/timeout taxonomy: a detached member degrades to a partial
        result when it opted in, else its error is its outcome."""
        allow_partial = str(m.ctx.options.get("allowPartialResults", "")).lower() in (
            "1", "true", "yes",
        )
        try:
            cancel = m.cancel
            if err is not None:
                if isinstance(err, QueryKilledError):
                    METRICS.counter("broker.queriesKilled").inc()
                if not allow_partial:
                    return err
                stats.partial_result = True
                stats.exceptions.append(
                    {
                        "errorCode": "QUERY_KILLED"
                        if isinstance(err, QueryKilledError)
                        else "EXECUTION_TIMEOUT_ERROR",
                        "message": str(err),
                    }
                )
                METRICS.counter("broker.partialResults").inc()
                cancel = None  # the kill already degraded this member
            self._serve_realtime(
                m.realtime_ctx, table, m.qid, cancel, m.deadline, stats,
                results, m.trace,
            )
            return self._finish_result(
                m.ctx, table, m.qid, m.t0, m.trace, m.ckey, results, stats
            )
        except Exception as e:
            # outcome, not a swallow: the caller fails this member's future
            METRICS.counter("broker.memberServeErrors").inc()
            return e

    # -- hedged execution (tail tolerance) ---------------------------------
    @staticmethod
    def _compose_cancel(base, lost_evt):
        """Per-attempt cancel probe for a hedged call: the outer watchdog
        probe (if any) keeps priority; once the sibling attempt wins, the
        probe returns "hedge_lost" and the loser abandons its pending
        launches through the SAME cooperative path a watchdog kill uses
        (ServerInstance._check_budget between kernels)."""

        def probe():
            if base is not None:
                r = base()
                if r:
                    return r
            if lost_evt.is_set():
                return "hedge_lost"
            return None

        return probe

    def _hedge_target(
        self, table: str, segs: List[str], primary: str, exclude: frozenset
    ) -> Optional[str]:
        """Best alternative replica serving ALL of the primary's segments:
        live, breaker-available, not the primary, not excluded this scatter.
        Non-browned closed-breaker replicas rank first, then adaptive score —
        hedging onto a gray server would just move the tail."""
        view = self.coordinator.external_view(table)
        candidates: Optional[Set[str]] = None
        for seg in segs:
            replicas = view.get(seg, set())
            candidates = set(replicas) if candidates is None else (candidates & replicas)
            if not candidates:
                return None
        if not candidates:
            return None
        candidates = {
            s
            for s in candidates
            if s != primary
            and s not in exclude
            and s in self.coordinator.live
            and self.health.available(s)
        }
        if not candidates:
            return None
        return min(
            candidates,
            key=lambda s: (
                self.health.brownout_deprioritized(s),
                self.health.state(s) != "closed",
                self.server_stats.score(s),
                s,
            ),
        )

    def hedge_drain(self, timeout_s: float = 5.0) -> int:
        """Join every outstanding hedge attempt thread; returns how many are
        STILL alive after the timeout (tests assert 0 — no leaked launches)."""
        with self._hedge_lock:
            threads = list(self._hedge_threads)
        dl = time.monotonic() + timeout_s
        alive = 0
        for t in threads:
            t.join(timeout=max(0.0, dl - time.monotonic()))
            if t.is_alive():
                alive += 1
        return alive

    def _account_loser(
        self, name: str, ok: bool, out, ms: float, table: str, stats, batch: bool = False
    ) -> None:
        """Settle the attempt that did NOT win a hedged call — accounting
        happens here EXACTLY once (the winner path never sees the loser).
        Runs on the loser's own thread (or the caller's, for a failure that
        arrived before the winner)."""
        if ok and batch:
            # a losing execute_batch returns normally with each member
            # detached via its probe: all-members hedge_lost == cancelled
            errs = out[2]
            if errs and all(
                isinstance(e, QueryKilledError) and getattr(e, "reason", None) == "hedge_lost"
                for e in errs
            ):
                METRICS.counter("broker.hedgesCancelled").inc()
                METRICS.timer("broker.hedgeCancelMs").update(ms)
                return
        if ok:
            # the loser finished anyway (too late to matter): its latency is
            # real signal, its work is the hedge's waste
            self.health.record_success(name)
            self.health.note_latency(name, ms)
            self.hedge.observe(table, name, ms)
            METRICS.timer("broker.hedgeWastedMs").update(ms)
            return
        e = out
        if isinstance(e, QueryKilledError) and e.reason == "hedge_lost":
            # cooperative cancel landed: not a failure — no punish, breaker
            # untouched (mirrors the watchdog-kill taxonomy in _scatter)
            METRICS.counter("broker.hedgesCancelled").inc()
            METRICS.timer("broker.hedgeCancelMs").update(ms)
            if stats is not None:
                stats.hedge_cancelled_ms = ms  # best-effort slowlog surface
            return
        if isinstance(e, QueryKilledError):
            return  # outer watchdog kill: canonical accounting rides the winner path
        if isinstance(e, ReservationError):
            METRICS.counter("broker.scatterCapacityRejections").inc()
            return
        # genuine fault on the losing attempt: punish/breaker exactly once,
        # here (its segments were served by the winner — no failover needed)
        self.server_stats.punish(name)
        self.health.record_failure(name)
        METRICS.counter("broker.scatterServerFailures").inc()

    def _hedged_call(
        self,
        table: str,
        primary: str,
        run,
        *,
        opts: Optional[Dict] = None,
        segs: List[str] = (),
        exclude: frozenset = frozenset(),
        stats=None,
        batch: bool = False,
    ):
        """Run ``run(server, lost_event)`` on `primary`, hedging a backup
        replica when the quantile-derived delay elapses without a reply.
        Returns ``(winner, payload, winner_ms, info)``.

        Engagement is decided up front: hedging must be enabled (env/option),
        a delay must be derivable (enough peer samples or an override), a
        spare replica must cover the segments, and firing must clear both
        the hedge budget and a non-blocking admission charge — otherwise the
        call runs inline on the caller's thread exactly like the unhedged
        scatter path (no threads, no behavior change).

        First SUCCESS wins; the loser is cancelled through its cancel probe
        and settles itself via _account_loser.  A failure that arrives while
        the sibling is still in flight is held: if the sibling succeeds it
        becomes the winner (the failure is side-accounted exactly once); if
        both fail the PRIMARY's error propagates so the outer failover arms
        attribute it to the routed server exactly as before."""
        hc = self.hedge
        hc.note_primary()
        info: Dict = {"hedged": False, "winner": None, "delay_ms": None, "hedge_server": None}
        delay = None
        target = None
        if hc.enabled(opts):
            delay = hc.delay_ms(table, primary, opts)
            if delay is not None:
                target = self._hedge_target(table, segs, primary, exclude)
        if delay is None or target is None:
            # inline fast path: identical to the pre-hedge scatter call
            self.server_stats.begin(primary)
            st0 = time.perf_counter()
            try:
                payload = run(primary, None)
            except Exception:
                self.server_stats.end(primary, (time.perf_counter() - st0) * 1000)
                raise
            ms = (time.perf_counter() - st0) * 1000
            self.server_stats.end(primary, ms)
            hc.observe(table, primary, ms)
            return primary, payload, ms, info

        result_q: "queue.Queue" = queue.Queue()
        slock = threading.Lock()
        state: Dict[str, Optional[str]] = {"winner": None}
        lost = {primary: threading.Event(), target: threading.Event()}

        def attempt(name: str) -> None:
            try:
                self.server_stats.begin(name)
                st0 = time.perf_counter()
                try:
                    out, ok = run(name, lost[name]), True
                # not swallowed: the captured exception is triaged by the
                # consumer (winner path raises it, loser path accounts it)
                except Exception as e:  # pinot-lint: disable=W006
                    out, ok = e, False
                ms = (time.perf_counter() - st0) * 1000
                self.server_stats.end(name, ms)
                with slock:
                    if state["winner"] is None:
                        if ok:
                            state["winner"] = name
                        result_q.put((name, ok, out, ms))
                        return
                # a sibling already won: this attempt lost — settle off-path
                self._account_loser(name, ok, out, ms, table, stats, batch=batch)
            finally:
                with self._hedge_lock:
                    self._hedge_threads.discard(threading.current_thread())

        def spawn(name: str, role: str) -> None:
            t = threading.Thread(
                target=attempt, args=(name,), daemon=True, name=f"hedge-{role}-{name}"
            )
            with self._hedge_lock:
                self._hedge_threads.add(t)
            t.start()

        spawn(primary, "primary")
        hedge_fired = False
        try:
            first = result_q.get(timeout=delay / 1000.0)
        except queue.Empty:
            first = None
            # primary is past the derived delay: fire the backup if the
            # hedge budget AND a non-blocking admission charge both clear
            denied = None
            if not hc.try_fire(opts):
                denied = "budget"
            elif self.governor is not None and not self.governor.try_charge_hedge(1.0):
                hc.unfire()
                denied = "admission"
            if denied is None:
                hedge_fired = True
                info.update(hedged=True, delay_ms=delay, hedge_server=target)
                METRICS.counter("broker.hedgesLaunched").inc()
                spawn(target, "backup")
            else:
                info["denied"] = denied
                METRICS.counter("broker.hedgesDenied").inc()
        if first is None:
            first = result_q.get()
        name, ok, out, ms = first
        if not ok and hedge_fired:
            # one attempt failed while its sibling is still running: the
            # sibling IS the retry — hold the error until it reports
            name2, ok2, out2, ms2 = result_q.get()
            if ok2:
                self._account_loser(name, False, out, ms, table, stats, batch=batch)
                name, ok, out, ms = name2, True, out2, ms2
            else:
                # both failed: side-account the backup, raise the primary's
                # error so the outer taxonomy keys on the routed server
                prim_err, hedge_err = (out, out2) if name == primary else (out2, out)
                hedge_ms = ms2 if name == primary else ms
                self._account_loser(target, False, hedge_err, hedge_ms, table, stats, batch=batch)
                raise prim_err
        if not ok:
            raise out  # no hedge in flight: identical to the inline path
        winner = name
        for other, evt in lost.items():
            if other != winner:
                evt.set()
        info["winner"] = winner
        hc.observe(table, winner, ms)
        if hedge_fired and winner == target:
            METRICS.counter("broker.hedgeWins").inc()
        return winner, out, ms, info

    def _scatter_batch(self, group: List, table: str, seg_names: List[str], meta, batch_id: str):
        """Failover-free batched scatter: route ONCE for the whole
        sub-group, run server.execute_batch per routed server (one vmapped
        launch per segment), and accumulate per-member stats.  Per-member
        kill/deadline errors come back in the errors list (siblings keep
        their exact results); any transport-level fault raises so the
        caller falls the sub-group back to the standard path — after
        recording it on the breaker, so the retry routes around the bad
        server."""
        n = len(group)
        # whole-batch replica-row pinning: every member of a same-fingerprint
        # batch routes to ONE replica group (mesh replica row), and batches
        # round-robin across rows — concurrent QPS scales with row count
        # while each row serves its batch from one staged copy
        with self._rr_lock:
            prefer = self._batch_rr
            self._batch_rr += 1
        assign = self._route(table, seg_names, prefer_group=prefer)
        trace_on = any(m.trace.enabled for m in group)
        results: List[list] = [[] for _ in range(n)]
        stats = [ExecutionStats(num_segments_pruned=m.pruned) for m in group]
        member_errs: List[Optional[Exception]] = [None] * n
        per_call = []
        for m in group:
            sto = m.ctx.options.get("serverTimeoutMs")
            per_call.append(
                m.deadline.bounded(float(sto) if sto is not None else None)
            )
        queried = 0
        responded = 0
        METRICS.gauge("broker.inFlightScatters").add(1)
        try:
            for server_name, segs in assign.items():
                queried += 1

                def run_batch(name, lost_evt, _segs=segs):
                    srv = self.coordinator.servers[name]
                    # per-member isolation survives hedging: each member's own
                    # watchdog probe keeps priority inside the composed probe
                    comp = (
                        [m.cancel for m in group]
                        if lost_evt is None
                        else [self._compose_cancel(m.cancel, lost_evt) for m in group]
                    )
                    return srv.execute_batch(
                        [m.offline_ctx for m in group],
                        _segs,
                        table_schema=meta.schema,
                        deadlines=per_call,
                        cancels=comp,
                        batch_id=batch_id,
                        trace_enabled=trace_on,
                    )

                try:
                    winner, _payload, win_ms, hinfo = self._hedged_call(
                        table, server_name, run_batch,
                        opts=group[0].ctx.options, segs=segs, batch=True,
                    )
                    res, sstats, errs, btrace = _payload
                except Exception as e:
                    if not isinstance(e, ReservationError):
                        # genuine fault: breaker + adaptive stats learn it so
                        # the per-member fallback routes around this server
                        self.server_stats.punish(server_name)
                        self.health.record_failure(server_name)
                        METRICS.counter("broker.scatterServerFailures").inc()
                    else:
                        METRICS.counter("broker.scatterCapacityRejections").inc()
                    raise
                self.health.record_success(winner)
                transition = self.health.note_latency(winner, win_ms)
                if hinfo["hedged"] or transition is not None:
                    for st in stats:
                        if hinfo["hedged"]:
                            st.hedged += 1
                            st.hedge_winner = winner
                        if transition is not None:
                            st.brownout_events.append(f"{transition}:{winner}")
                if hinfo["hedged"]:
                    queried += 1
                responded += 1
                for i in range(n):
                    if errs[i] is not None:
                        if member_errs[i] is None:
                            member_errs[i] = errs[i]
                        continue
                    results[i].extend(res[i])
                    stats[i].num_segments_queried += sstats[i].num_segments_queried
                    stats[i].num_segments_processed += sstats[i].num_segments_processed
                    stats[i].num_segments_pruned += sstats[i].num_segments_pruned
                    stats[i].num_docs_scanned += sstats[i].num_docs_scanned
                    stats[i].total_docs += sstats[i].total_docs
                    stats[i].add_index_uses(sstats[i].filter_index_uses)
                    stats[i].add_kernel_cost(sstats[i])
                if btrace is not None:
                    import copy

                    for k, m in enumerate(group):
                        if m.trace.enabled:
                            m.trace.graft(copy.deepcopy(btrace))
        finally:
            METRICS.gauge("broker.inFlightScatters").add(-1)
            for i in range(n):
                stats[i].num_servers_queried = queried
                stats[i].num_servers_responded = responded
        return results, stats, member_errs

    # -- fault-tolerant scatter-gather ------------------------------------
    def _scatter(
        self,
        ctx: QueryContext,
        table: str,
        seg_names: List[str],
        meta,
        deadline: Deadline,
        stats: ExecutionStats,
        trace: Optional[Trace] = None,
        cancel=None,
        qid: Optional[str] = None,
    ) -> List:
        """Deadline-budgeted scatter with replica failover (the
        QueryRouter.submitQuery + BaseSingleStageBrokerRequestHandler retry
        contract, in-process).

        Each routed server gets the query's remaining budget, optionally
        capped by the serverTimeoutMs option.  A failed or timed-out server
        is excluded, trips the circuit breaker one notch, and its segments
        re-route to surviving replicas (bounded rounds, jittered backoff).
        When a segment has no replica left: with allowPartialResults=true
        the response degrades (partialResult=true + exception entries +
        numServersResponded < numServersQueried); otherwise the query fails
        with the collected per-server exceptions.

        Tracing: each failover round gets a `round:N` span; each routed call
        a `server_execute` span (server, round, probe, error, breaker state)
        with the server's own finished subtree grafted beneath it — the
        retry/breaker machinery is visible in ONE tree per query.

        Governance faults are NOT server faults: a ReservationError (server
        at HBM capacity) fails the segments over to another replica without
        punishing the adaptive stats or tripping the breaker — capacity
        returns when queries drain, quarantine would amplify the overload;
        when EVERY replica is out of capacity the query fails structured
        503 SERVER_OUT_OF_CAPACITY.  A QueryKilledError (watchdog) punishes
        the adaptive stats exactly once, leaves the breaker untouched, and
        either degrades to a partial result (allowPartialResults) or
        re-raises as a structured QUERY_KILLED failure."""
        if trace is None:
            trace = Trace(False)
        opts = ctx.options
        allow_partial = str(opts.get("allowPartialResults", "")).lower() in ("1", "true", "yes")
        max_retries = int(opts.get("maxScatterRetries", 2))
        backoff_ms = float(opts.get("scatterBackoffMs", 2.0))
        server_timeout_ms = opts.get("serverTimeoutMs")
        results: List = []
        excluded: Set[str] = set()
        queried: Set[str] = set()
        responded: Set[str] = set()
        pending = list(seg_names)
        rounds = 0
        killed = False  # watchdog kill absorbed as a partial result
        capacity_rejections = 0  # ReservationError count this scatter
        non_capacity_failure = False  # any genuine server fault seen
        try:
            while pending:
                with trace.span(f"round:{rounds}", segments=len(pending)):
                    assign, unroutable = self._route(
                        table, pending, exclude=frozenset(excluded), partial_ok=True
                    )
                    if unroutable:
                        if capacity_rejections and not non_capacity_failure and not allow_partial:
                            # every replica was excluded for CAPACITY, not
                            # faults: surface the overload signal (503
                            # SERVER_OUT_OF_CAPACITY), not "no live replica"
                            raise ReservationError(
                                f"segment(s) {sorted(unroutable)} of table {table!r}: "
                                f"every replica out of capacity",
                                query_id=qid,
                            )
                        self._absorb_unroutable(table, unroutable, excluded, allow_partial, stats)
                    failed: List[str] = []
                    for server_name, segs in assign.items():
                        deadline.check(f"query on {table}")
                        queried.add(server_name)
                        probe = self.health.state(server_name) == "half_open"
                        self.health.begin_probe(server_name)  # no-op unless half-open
                        per_call = deadline.bounded(
                            float(server_timeout_ms) if server_timeout_ms is not None else None
                        )

                        def run_one(name, lost_evt, _segs=segs, _per_call=per_call):
                            srv = self.coordinator.servers[name]
                            comp = (
                                cancel if lost_evt is None
                                else self._compose_cancel(cancel, lost_evt)
                            )
                            return srv.execute(
                                ctx, _segs, table_schema=meta.schema,
                                deadline=_per_call, cancel=comp,
                            )

                        with trace.span(
                            "server_execute", server=server_name, segments=len(segs),
                            round=rounds, probe=probe,
                        ) as ssp:
                            try:
                                winner, payload, win_ms, hinfo = self._hedged_call(
                                    table, server_name, run_one, opts=opts, segs=segs,
                                    exclude=frozenset(excluded), stats=stats,
                                )
                                res, sstats = payload
                            except Exception as e:  # noqa: BLE001 — every fault is recorded below
                                if isinstance(e, QueryTimeoutError) and deadline.expired():
                                    raise  # the QUERY is out of budget, not just this server
                                if isinstance(e, QueryKilledError):
                                    # watchdog kill: punish the adaptive stats
                                    # EXACTLY once (the killed query consumed
                                    # this server's time), breaker untouched
                                    # (the server is healthy — the query died)
                                    self.server_stats.punish(server_name)
                                    METRICS.counter("broker.queriesKilled").inc()
                                    stats.exceptions.append(
                                        {
                                            "errorCode": "QUERY_KILLED",
                                            "message": f"server {server_name}: {e}",
                                            "server": server_name,
                                            "reason": e.reason,
                                        }
                                    )
                                    if ssp is not None:
                                        ssp.annotate(killed=e.reason)
                                    if allow_partial:
                                        stats.partial_result = True
                                        METRICS.counter("broker.partialResults").inc()
                                        killed = True
                                        break  # surviving results ship as-is
                                    e.query_id = qid
                                    raise
                                if isinstance(e, ReservationError):
                                    # capacity, not a fault: fail the segments
                                    # over without punishing or opening the
                                    # breaker (quarantining a full server
                                    # would amplify the overload)
                                    excluded.add(server_name)
                                    failed.extend(segs)
                                    capacity_rejections += 1
                                    stats.exceptions.append(
                                        {
                                            "errorCode": "SERVER_OUT_OF_CAPACITY",
                                            "message": f"server {server_name}: {e}",
                                            "server": server_name,
                                        }
                                    )
                                    METRICS.counter("broker.scatterCapacityRejections").inc()
                                    if ssp is not None:
                                        ssp.annotate(capacity="rejected")
                                    continue
                                non_capacity_failure = True
                                self.server_stats.punish(server_name)
                                self.health.record_failure(server_name)
                                excluded.add(server_name)
                                failed.extend(segs)
                                stats.exceptions.append(
                                    {
                                        "errorCode": "EXECUTION_TIMEOUT_ERROR"
                                        if isinstance(e, QueryTimeoutError)
                                        else "SERVER_SCATTER_ERROR",
                                        "message": f"server {server_name}: {type(e).__name__}: {e}",
                                        "server": server_name,
                                    }
                                )
                                METRICS.counter("broker.scatterServerFailures").inc()
                                if ssp is not None:
                                    ssp.annotate(
                                        error=f"{type(e).__name__}: {e}",
                                        breaker=self.health.state(server_name),
                                    )
                                continue
                            # the winner may be the hedged backup, not the
                            # routed primary: success accounting keys on it
                            self.health.record_success(winner)
                            transition = self.health.note_latency(winner, win_ms)
                            if transition is not None:
                                stats.brownout_events.append(f"{transition}:{winner}")
                                if ssp is not None:
                                    ssp.annotate(brownout=f"{transition}:{winner}")
                            if hinfo["hedged"]:
                                stats.hedged += 1
                                stats.hedge_winner = winner
                                queried.add(hinfo["hedge_server"])
                                if ssp is not None:
                                    ssp.annotate(
                                        hedged=True,
                                        winner=winner,
                                        hedgeDelayMs=round(hinfo["delay_ms"], 3),
                                    )
                            responded.add(winner)
                            results.extend(res)
                            stats.num_segments_queried += sstats.num_segments_queried
                            stats.num_segments_processed += sstats.num_segments_processed
                            stats.num_segments_pruned += sstats.num_segments_pruned
                            stats.num_docs_scanned += sstats.num_docs_scanned
                            stats.total_docs += sstats.total_docs
                            stats.add_index_uses(sstats.filter_index_uses)
                            stats.add_kernel_cost(sstats)
                            trace.graft(sstats.trace)
                            if ssp is not None:
                                ssp.annotate(docs=sstats.num_docs_scanned)
                pending = failed
                if killed:
                    break  # partial-result kill: no failover for what's left
                if pending:
                    rounds += 1
                    if rounds > max_retries:
                        msg = (
                            f"segments {sorted(pending)} of table {table!r} failed on every "
                            f"tried replica after {max_retries} failover round(s)"
                        )
                        if not allow_partial:
                            if capacity_rejections and not non_capacity_failure:
                                # every tried replica was at capacity: this is
                                # an overload rejection, not a scatter fault
                                raise ReservationError(
                                    f"{msg}: every replica out of capacity",
                                    query_id=qid,
                                )
                            raise ScatterGatherError(msg, stats.exceptions)
                        stats.partial_result = True
                        stats.exceptions.append(
                            {"errorCode": "PARTIAL_RESPONSE", "message": msg}
                        )
                        METRICS.counter("broker.partialResults").inc()
                        break
                    deadline.check(f"query on {table}")
                    if backoff_ms > 0:
                        # exponential backoff with full jitter (seeded rng)
                        self._sleep(
                            backoff_ms
                            * (2 ** (rounds - 1))
                            * (0.5 + self.retry_rng.random() / 2)
                            / 1000.0
                        )
        finally:
            stats.num_servers_queried = len(queried)
            stats.num_servers_responded = len(responded)
        return results

    def _absorb_unroutable(
        self,
        table: str,
        unroutable: List[str],
        excluded: Set[str],
        allow_partial: bool,
        stats: ExecutionStats,
    ) -> None:
        """Segments with no routable replica: degrade to a partial result
        when the query opted in, else fail with the routing detail."""
        detail = f" (failed/excluded servers: {sorted(excluded)})" if excluded else ""
        msg = (
            f"segment(s) {sorted(unroutable)} of table {table!r} have no live replica{detail}"
        )
        if not allow_partial:
            raise NoReplicaAvailableError(msg)
        stats.partial_result = True
        stats.exceptions.append({"errorCode": "NO_REPLICA_AVAILABLE", "message": msg})
        METRICS.counter("broker.partialResults").inc()

    # -- cluster metric federation ---------------------------------------
    def federated_registries(self):
        """name -> per-server MetricsRegistry for every registered server —
        the scrape set the broker federates (BrokerMetrics pulling
        ServerMetrics; here a method call instead of an HTTP scrape)."""
        return {
            name: srv.metrics
            for name, srv in self.coordinator.servers.items()
            if getattr(srv, "metrics", None) is not None
        }

    def federated_prometheus(self) -> str:
        """Cluster-wide Prometheus exposition: this broker process's own
        registry (unlabeled, as before) plus every server's registry as
        `{server="..."}`-labeled series and `pinot_cluster_*` merged
        aggregates — `GET /metrics?format=prometheus` describes the
        cluster, not one process."""
        from pinot_tpu_torch.utils.metrics import federate_prometheus

        return METRICS.to_prometheus() + federate_prometheus(self.federated_registries())

    def federated_snapshot(self):
        """JSON twin of federated_prometheus: per-server snapshots plus the
        merged cluster view (sum/max/last semantics per metric type)."""
        from pinot_tpu_torch.utils.metrics import merge_registry_snapshots

        regs = self.federated_registries()
        return {
            "perServer": {name: reg.snapshot() for name, reg in regs.items()},
            "cluster": merge_registry_snapshots(regs),
        }

    def perf_snapshot(self):
        """Per-table/per-shape perf ledger view (GET /debug/perf), plus the
        live named-cache occupancy (plan caches, result cache)."""
        from pinot_tpu_torch.utils.cache import named_cache_stats
        from pinot_tpu_torch.utils.perf import PERF_LEDGER

        snap = PERF_LEDGER.snapshot()
        snap["caches"] = named_cache_stats()
        return snap

    def _device(self):
        """The device the broker's own segment work runs on (the realtime
        part, EXPLAIN's plan): that of the first registered server, else
        the card (`resolve_device(None)`, which raises without one)."""
        from pinot_tpu_torch.device import resolve_device

        names = sorted(self.coordinator.servers)
        return self.coordinator.servers[names[0]].device if names else resolve_device(None)

    def _explain(self, ctx: QueryContext) -> ResultTable:
        """EXPLAIN PLAN FOR through the broker: reuse the engine explain
        against one representative segment (no execution)."""
        from pinot_tpu_torch.query.engine import QueryEngine

        meta = self.coordinator.tables[ctx.table]
        segs = []
        for name in meta.ideal:  # first segment with a LIVE replica
            obj = self.coordinator._find_segment_object(ctx.table, name, self.coordinator.live)
            if obj is not None:
                segs.append(obj)
                break
        if not segs:
            rt = self.coordinator.realtime.get(ctx.table)
            if rt is not None:
                segs = rt.query_segments()[:1]
        shim = QueryEngine(device=self._device())
        shim.register_table(meta.schema, meta.config)
        return shim._explain(ctx, segs)

    def _explain_analyze(self, ctx: QueryContext) -> ResultTable:
        """EXPLAIN ANALYZE: run the query with tracing forced, then join the
        static operator tree with the measured span tree (query.analyze)."""
        from pinot_tpu_torch.query.analyze import analyze_result

        ctx.options.pop("__analyze__", None)
        ctx.options["trace"] = True
        for _op, _all, rhs in ctx.set_ops:
            rhs.options.pop("__analyze__", None)
            rhs.options["trace"] = True
        executed = self.execute(ctx)
        return analyze_result(self._explain(ctx), executed)

    def _inject_global_ranges(self, ctx: QueryContext, table: str) -> None:
        """Table-global sketch constants from broker-side metadata (the
        QueryEngine does the same from segment objects)."""
        from pinot_tpu_torch.query.functions import for_spec

        meta = self.coordinator.tables[table]
        for spec in ctx.aggregations:
            if spec.expr is None or not spec.expr.is_column:
                continue
            if not for_spec(spec).needs_binding:
                continue
            col = spec.expr.op
            rkey, fkey = f"__range__{col}", f"__dictfp__{col}"
            if rkey in ctx.options and fkey in ctx.options:
                continue
            mins, maxs, fps = [], [], set()
            for sm in meta.segment_meta.values():
                cs = sm.get("colStats", {}).get(col)
                if cs is None:
                    continue
                fps.add(cs["dictFp"])
                if cs["min"] is not None and not isinstance(cs["min"], str):
                    mins.append(cs["min"])
                    maxs.append(cs["max"])
            if mins:
                ctx.options.setdefault(rkey, (min(mins), max(maxs)))
            if fps:
                only = next(iter(fps)) if len(fps) == 1 else None
                ctx.options.setdefault(fkey, "MIXED" if len(fps) > 1 else (only or ""))


def _with_time_bound(ctx: QueryContext, time_column: str, upper=None, lower_exclusive=None) -> QueryContext:
    """ctx with an extra AND bound on the time column (hybrid-table split)."""
    import dataclasses

    from pinot_tpu_torch.query.ir import Expr, Predicate

    if upper is not None:
        pred = Predicate(PredicateType.RANGE, Expr.col(time_column), upper=upper)
    else:
        pred = Predicate(
            PredicateType.RANGE, Expr.col(time_column), lower=lower_exclusive, lower_inclusive=False
        )
    node = FilterNode.pred(pred)
    f = node if ctx.filter is None else FilterNode.and_(ctx.filter, node)
    return dataclasses.replace(ctx, filter=f)


# ---------------------------------------------------------------------------
# filter-shape helpers for pruners
# ---------------------------------------------------------------------------
def _eq_values_by_column(node: Optional[FilterNode]) -> Dict[str, List]:
    """Top-level AND-path EQ/IN values per column (conservative: OR subtrees
    are ignored — pruning must never drop a segment that could match)."""
    out: Dict[str, List] = {}

    def walk(n: Optional[FilterNode]) -> None:
        if n is None:
            return
        if n.op is FilterOp.AND:
            for c in n.children:
                walk(c)
        elif n.op is FilterOp.PRED and n.predicate is not None:
            p = n.predicate
            if p.lhs.is_column and p.ptype in (PredicateType.EQ, PredicateType.IN):
                out.setdefault(p.lhs.op, []).extend(p.values)

    walk(node)
    return out


def _range_for_column(node: Optional[FilterNode], col: str) -> Tuple[Optional[float], Optional[float]]:
    """Top-level AND-path [lo, hi] bound for one column, None = unbounded."""
    lo = hi = None

    def walk(n: Optional[FilterNode]) -> None:
        nonlocal lo, hi
        if n is None:
            return
        if n.op is FilterOp.AND:
            for c in n.children:
                walk(c)
        elif n.op is FilterOp.PRED and n.predicate is not None:
            p = n.predicate
            if not (p.lhs.is_column and p.lhs.op == col):
                return
            if p.ptype is PredicateType.EQ:
                lo = hi = p.values[0]
            elif p.ptype is PredicateType.RANGE:
                if p.lower is not None:
                    lo = p.lower if lo is None else max(lo, p.lower)
                if p.upper is not None:
                    hi = p.upper if hi is None else min(hi, p.upper)

    walk(node)
    return lo, hi
