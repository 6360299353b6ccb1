"""Byte budgets for the serving tier: the device-memory ledger that
residency caches and query reservations share.

Trimmed copy of pinot_tpu/cluster/admission.py: `ResourceBudget` (with
`reserve` / `release` / `try_charge` / `uncharge` / `reserve_or_wait`,
`peak`, and `ReservationError`) and `default_server_hbm_budget`.  The
admission controller, the governor, the watchdog and the degradation
controller come with the cluster slice of the port.
"""
from __future__ import annotations

import itertools
import os
import time
from typing import Dict, Optional

from pinot_tpu_torch.utils import threads
from pinot_tpu_torch.utils.metrics import METRICS


class AdmissionError(RuntimeError):
    """A query could not be admitted (pinot_tpu/query/safety.py)."""


class ReservationError(AdmissionError):
    """A working-set reservation could not be acquired — the HBM or host
    budget is committed to other in-flight work (REST 503
    SERVER_OUT_OF_CAPACITY; retryable, capacity returns as queries drain)."""

    def __init__(self, message: str, query_id: Optional[str] = None):
        super().__init__(message)
        self.query_id = query_id


class ResourceBudget:
    """Thread-safe byte ledger with two clients on ONE budget:

      * queries `reserve()` their working-set estimate before launch and
        `release()` on completion/cancel (raises ReservationError when the
        budget is committed — REST 503 SERVER_OUT_OF_CAPACITY);
      * caches `try_charge()` / `uncharge()` bytes they retain (never raise
        — a full budget just means the cache evicts instead of growing).

    Because both ride the same ledger, cached bytes and in-flight working
    sets cannot jointly overcommit.  `gauge` names the published METRICS
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
        deadline=None,
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


def default_server_hbm_budget() -> int:
    """Per-server HBM reservation budget (0 disables reservation tracking)."""
    return int(os.environ.get("PINOT_TPU_SERVER_HBM_BUDGET_BYTES", str(8 << 30)))
