"""Tiered segment storage: device memory as a cost-aware cache over host RAM.

Copy of pinot_tpu/segment/residency.py.  Reference parity: Pinot's tiered
storage / off-heap memory manager — local disk is a cache over the deep
store and segments are mmap-loaded on demand.  The mapping here:

  host RAM (mmap'd segments / stacked arrays)
      ->  device memory, managed HERE as a byte-budgeted cache.

`ResidencyManager` owns the device-cache byte budget (a `ResourceBudget`
ledger, cluster/admission.py, shared with query working-set reservations
so cache bytes and in-flight reservations can never jointly overcommit), a
cost-aware eviction policy fed by the `PERF_LEDGER` (hot tables — high
bytes/s — survive; within a table, least-recently-used first), and the
single-worker *staging stream*: the one thread that issues the
segment-sized host-to-device copies of the distributed engine's pipeline
(parallel/engine.py; on CUDA that thread copies on a stream of its own).

Residency state machine, per cache GROUP (a whole `ImmutableSegment` per
device, or one doc-slice of a `StackedTable` per device):

    HOST_ONLY ──begin_stage──> STAGING ──finish_stage──> RESIDENT
        ^                         │abort_stage              │
        └──────(event set)────────┘          begin_grow────>│ (back to
        ^                                                   │  STAGING)
        └───────────── EVICTING <──────evict────────────────┘

HOST_ONLY is represented by absence.  Every transition out of STAGING /
EVICTING sets the entry's event, so concurrent queries park on the event
instead of double-copying, and a query racing an eviction re-stages the
whole group — it can never observe half of a group's flavors (the raw and
`#packed` entries of one segment always live and die together).  A
mid-stage crash unwinds through `abort_stage`, which uncharges the pending
bytes — the crash-harness tests assert no ledger leak.

The budget counts host array bytes (what a group pins on the device); the
torch caching allocator may keep freed blocks reserved after an eviction.
"""
from __future__ import annotations

import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

from pinot_tpu_torch.utils import threads
from pinot_tpu_torch.utils.metrics import METRICS

HOST_ONLY = "host_only"
STAGING = "staging"
RESIDENT = "resident"
EVICTING = "evicting"

# Outcomes of begin_stage / begin_grow
OWN = "own"  # caller is the staging owner: charge, copy, publish
WAIT = "wait"  # another thread is staging/evicting: park on entry.event
HIT = "hit"  # group already resident
RETRY = "retry"  # state moved underneath the caller: re-plan from scratch


@dataclass
class _Entry:
    group: Tuple
    table: str
    evict_cb: Callable[[], None]
    state: str = STAGING
    nbytes: int = 0  # committed (RESIDENT) bytes
    pending: int = 0  # charged but not yet finish_stage'd bytes
    last_access: int = 0
    prefetched: bool = False
    event: Any = field(default_factory=threads.Event)


class ResidencyManager:
    """Byte-budgeted device cache of segment groups with cost-aware eviction
    and a single-worker async staging stream (the host->device copy engine
    that double-buffers the *next* macro-batch while the current one scans).

    Thread-safety: `_lock` guards the entry table and accounting; it is
    never held across a device copy (the owner stages with NO lock held —
    waiters park on per-entry events), and eviction callbacks run outside
    it too, so the manager lock never orders against a cache's own lock."""

    def __init__(
        self,
        budget,
        name: str = "residency",
        ledger=None,
        stall_timeout_s: float = 30.0,
    ):
        self.budget = budget  # cluster.admission.ResourceBudget
        self.name = name
        # perf ledger supplying the eviction cost signal (bytes/s per
        # table); None falls back to pure LRU
        self._ledger = ledger
        self.stall_timeout_s = float(stall_timeout_s)
        self._lock = threads.Lock()
        self._entries: Dict[Tuple, _Entry] = {}
        self._clock = 0  # logical access clock (recency, not wall time)
        self._resident_bytes = 0
        self._stream: Optional[ThreadPoolExecutor] = None

    # -- staging stream -------------------------------------------------
    def submit(self, fn: Callable, *args, **kwargs) -> Future:
        """Enqueue work on the staging stream (ONE worker: copies are
        serialized against each other, overlapped with device compute)."""
        with self._lock:
            if self._stream is None:
                self._stream = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix=f"{self.name}-stage"
                )
            stream = self._stream
        return stream.submit(fn, *args, **kwargs)

    def shutdown(self) -> None:
        with self._lock:
            stream, self._stream = self._stream, None
        if stream is not None:
            stream.shutdown(wait=True)

    # -- state machine --------------------------------------------------
    def begin_stage(
        self,
        group: Tuple,
        table: str,
        evict_cb: Callable[[], None],
        prefetch: bool = False,
    ) -> Tuple[str, Optional[_Entry]]:
        """Enter the state machine for one cache group.  Returns (status,
        entry): OWN means the caller must charge/copy/publish then
        finish_stage (or abort_stage on failure); WAIT means park on
        entry.event and retry; HIT means the group is resident."""
        with self._lock:
            e = self._entries.get(group)
            if e is None:
                e = _Entry(group=group, table=table, evict_cb=evict_cb)
                e.prefetched = prefetch
                self._clock += 1
                e.last_access = self._clock
                self._entries[group] = e
                if prefetch:
                    METRICS.counter(f"{self.name}.prefetchIssued").inc()
                else:
                    METRICS.counter(f"{self.name}.misses").inc()
                return OWN, e
            if e.state == RESIDENT:
                self._touch_locked(e, prefetch)
                return HIT, e
            # STAGING or EVICTING: a demand arrival overlapping an in-flight
            # prefetch still counts as a prefetch hit (the copy was issued
            # ahead of need); the residual wait is the staging stall.
            if not prefetch and e.state == STAGING and e.prefetched:
                e.prefetched = False
                METRICS.counter(f"{self.name}.prefetchHits").inc()
            return WAIT, e

    def begin_grow(self, group: Tuple) -> Tuple[str, Optional[_Entry]]:
        """Claim a RESIDENT group for incremental staging (a query needing
        columns/flavors the resident group does not hold yet)."""
        with self._lock:
            e = self._entries.get(group)
            if e is None:
                return RETRY, None  # evicted underneath us: re-plan
            if e.state == RESIDENT:
                e.state = STAGING
                e.event.clear()
                return OWN, e
            return WAIT, e

    def charge(self, group: Tuple, nbytes: int, query_id: Optional[str] = None) -> None:
        """Owner-side budget charge for the bytes about to be copied.  Evicts
        cost-ranked victims (never the group being staged) until the charge
        fits; raises ReservationError when even a fully-drained cache could
        not hold it — the caller unwinds via abort_stage."""
        n = max(0, int(nbytes))
        if n == 0:
            return
        with self._lock:
            e = self._entries[group]
            e.pending += n
        while not self.budget.try_charge(n):
            victim = None
            with self._lock:
                victim = self._select_victim_locked(exclude=group)
                if victim is not None:
                    victim.state = EVICTING
                    victim.event.clear()
            if victim is None:
                with self._lock:
                    e.pending -= n
                from pinot_tpu_torch.cluster.admission import ReservationError  # local import; avoids cycle

                METRICS.counter(f"{self.name}.stageRejected").inc()
                raise ReservationError(
                    f"staging {n / 1e6:.1f} MB into the {self.name} cache "
                    f"exceeds its {self.budget.budget_bytes / 1e6:.1f} MB budget "
                    "even after draining every evictable group",
                    query_id=query_id,
                )
            self._complete_eviction(victim)

    def finish_stage(self, group: Tuple) -> None:
        """Owner-side publish: pending bytes commit, waiters wake."""
        with self._lock:
            e = self._entries[group]
            e.nbytes += e.pending
            self._resident_bytes += e.pending
            e.pending = 0
            e.state = RESIDENT
            self._clock += 1
            e.last_access = self._clock
            self._publish_locked()
            e.event.set()

    def abort_stage(self, group: Tuple) -> None:
        """Owner-side unwind (copy failed, injected crash, ...): uncharge
        the pending bytes so a mid-stage kill leaves no ledger leak.  A
        failed GROW reverts to RESIDENT (the committed part is intact); a
        failed fresh stage removes the entry entirely."""
        pend = 0
        with self._lock:
            e = self._entries.get(group)
            if e is None:
                return
            pend, e.pending = e.pending, 0
            if e.nbytes > 0:
                e.state = RESIDENT
            else:
                del self._entries[group]
            e.event.set()
        if pend:
            self.budget.uncharge(pend)

    def wait(self, entry: _Entry, timeout_s: Optional[float] = None) -> bool:
        """Park until the entry's in-flight transition completes; the wall
        time spent here is the staging stall."""
        t0 = time.perf_counter()
        ok = entry.event.wait(timeout_s if timeout_s is not None else self.stall_timeout_s)
        METRICS.histogram(f"{self.name}.stagingStallMs").update(
            (time.perf_counter() - t0) * 1000.0
        )
        return ok

    def touch(self, group: Tuple) -> None:
        with self._lock:
            e = self._entries.get(group)
            if e is not None:
                self._touch_locked(e, prefetch=False)

    # -- eviction --------------------------------------------------------
    def evict(self, group: Tuple) -> bool:
        """Explicit eviction (segment drop, server crash, release_device):
        drops ALL device flavors of the group atomically via its callback."""
        with self._lock:
            e = self._entries.get(group)
            if e is None or e.state != RESIDENT:
                return False
            e.state = EVICTING
            e.event.clear()
        self._complete_eviction(e)
        return True

    def evict_matching(self, pred: Callable[[Tuple], bool]) -> int:
        """Evict every RESIDENT group whose key satisfies `pred` (all groups
        of one segment/table when it is dropped)."""
        n = 0
        while True:
            victim = None
            with self._lock:
                for e in self._entries.values():
                    if e.state == RESIDENT and pred(e.group):
                        e.state = EVICTING
                        e.event.clear()
                        victim = e
                        break
            if victim is None:
                return n
            self._complete_eviction(victim)
            n += 1

    def _complete_eviction(self, e: _Entry) -> None:
        # callback OUTSIDE the manager lock: it takes the owning cache's
        # _device_lock and clears every flavor of the group in one critical
        # section — a racing reader re-checks and re-stages, never mixing
        try:
            e.evict_cb()
        finally:
            self.budget.uncharge(e.nbytes)
            with self._lock:
                self._resident_bytes -= e.nbytes
                e.nbytes = 0
                self._entries.pop(e.group, None)
                METRICS.counter(f"{self.name}.evictions").inc()
                self._publish_locked()
                e.event.set()

    def _select_victim_locked(self, exclude: Tuple) -> Optional[_Entry]:
        """Cost-ranked victim: coldest table first (PERF_LEDGER bytes/s — a
        hot table's groups are the expensive ones to refetch), then least
        recently used within a heat class.  The JAX package ranks the most
        over-share table first when its autopilot publishes per-table
        residency splits; the port has no autopilot yet (cluster slice), so
        none are published and this is that policy with no splits."""
        candidates = [
            e
            for e in self._entries.values()
            if e.state == RESIDENT and e.group != exclude and e.nbytes > 0
        ]
        if not candidates:
            return None
        heat = self._table_heat({e.table for e in candidates})
        return min(candidates, key=lambda e: (heat.get(e.table, 0.0), e.last_access))

    def _table_heat(self, tables: Iterable[str]) -> Dict[str, float]:
        if self._ledger is None:
            return {}
        try:
            snap = self._ledger.snapshot()
        except Exception:  # noqa: BLE001 — eviction must not die on telemetry
            return {}
        out: Dict[str, float] = {}
        for t in tables:
            rec = snap.get("tables", {}).get(t)
            if not rec:
                continue
            bps = 0.0
            for shape in rec.get("shapes", {}).values():
                v = shape.get("bytesPerSec", {}).get("mean")
                if v:
                    bps = max(bps, float(v))
            out[t] = bps
        return out

    # -- internals -------------------------------------------------------
    def _touch_locked(self, e: _Entry, prefetch: bool) -> None:
        self._clock += 1
        e.last_access = self._clock
        if not prefetch:
            METRICS.counter(f"{self.name}.hits").inc()
            if e.prefetched:
                e.prefetched = False
                METRICS.counter(f"{self.name}.prefetchHits").inc()

    def _publish_locked(self) -> None:
        METRICS.gauge(f"{self.name}.residentBytes").set(float(self._resident_bytes))

    # -- observability ---------------------------------------------------
    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return self._resident_bytes

    def state_of(self, group: Tuple) -> str:
        with self._lock:
            e = self._entries.get(group)
            return e.state if e is not None else HOST_ONLY

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            by_state: Dict[str, int] = {}
            for e in self._entries.values():
                by_state[e.state] = by_state.get(e.state, 0) + 1
            return {
                "groups": len(self._entries),
                "byState": by_state,
                "residentBytes": self._resident_bytes,
                "budgetBytes": self.budget.budget_bytes,
                "hits": METRICS.counter(f"{self.name}.hits").value,
                "misses": METRICS.counter(f"{self.name}.misses").value,
                "evictions": METRICS.counter(f"{self.name}.evictions").value,
                "prefetchIssued": METRICS.counter(f"{self.name}.prefetchIssued").value,
                "prefetchHits": METRICS.counter(f"{self.name}.prefetchHits").value,
            }


def default_residency(budget=None, name: str = "residency"):
    """Process-default residency manager factory: budget from
    PINOT_TPU_HBM_CACHE_BYTES (0 disables tiering — every to_device call
    behaves as the legacy pin-everything path), else the server HBM default;
    eviction heat from the process PERF_LEDGER."""
    import os

    from pinot_tpu_torch.utils import perf

    if budget is None:
        from pinot_tpu_torch.cluster.admission import ResourceBudget, default_server_hbm_budget

        nbytes = int(
            os.environ.get("PINOT_TPU_HBM_CACHE_BYTES", str(default_server_hbm_budget()))
        )
        if nbytes <= 0:
            return None
        budget = ResourceBudget(nbytes, gauge=f"{name}.reservedBytes")
    return ResidencyManager(budget, name=name, ledger=perf.PERF_LEDGER)


def row_residency(num_rows: int, row: int, total_bytes=None, name: str = "residency"):
    """Per-mesh-row residency manager: one replica row's even share of the
    device cache budget (the JAX package's ReplicatedEngine uses it; the
    port's multi-device slice will).

    A replica axis multiplies QPS only if staging and eviction stay
    row-local: each row holds its own full data copy on its own device set,
    charged against its OWN budget/ledger, so one hot row's working set can
    never evict another row's resident slices.  total_bytes defaults to
    PINOT_TPU_HBM_CACHE_BYTES (the whole-mesh cache size); 0 disables
    tiering for every row, like default_residency."""
    import os

    from pinot_tpu_torch.utils import perf

    if total_bytes is None:
        from pinot_tpu_torch.cluster.admission import default_server_hbm_budget

        total_bytes = int(
            os.environ.get("PINOT_TPU_HBM_CACHE_BYTES", str(default_server_hbm_budget()))
        )
    share = int(total_bytes) // max(1, int(num_rows))
    if share <= 0:
        return None
    from pinot_tpu_torch.cluster.admission import ResourceBudget

    row_name = f"{name}.row{row}"
    budget = ResourceBudget(share, gauge=f"{row_name}.reservedBytes")
    return ResidencyManager(budget, name=row_name, ledger=perf.PERF_LEDGER)
