"""Cross-query micro-batcher: the broker-side coalescing stage of the
concurrent serving tier.

In-flight queries that share a batch key (the broker keys on
``(table, shape_fingerprint digest)``) wait up to a bounded window —
``PINOT_TPU_BATCH_WAIT_MS``, default 2 ms — for same-shape peers, then the
whole group executes as ONE batched plan launch (query/executor.py
``launch_segment_batch``: torch.func.vmap of the shared closure, the fused
scan's member-axis launch).  Copy of pinot_tpu/cluster/batcher.py
(host-only); the broker (cluster/broker.py ``submit`` / ``query_many``)
submits to it.  A group also flushes immediately when it reaches
``PINOT_TPU_BATCH_MAX`` members, so saturated load never waits.

Time is injectable: tests construct the batcher with a fake ``clock`` and
drive flushes deterministically through ``pump(now)`` — no real sleeps in
tier-1.  With the default wall clock a lazily started daemon worker wakes
on a condition variable at the earliest group deadline.  The worker/pump
path deliberately contains no blocking calls (no sleeps, no device fences,
no socket I/O): the runner launches and collects device work,
but blocking ``Future.result()`` waits happen only in the submitting
caller threads.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple

from pinot_tpu_torch.utils import threads


def batch_wait_ms() -> float:
    """Bounded coalescing window; 0 disables batching (submit runs the
    query immediately as a singleton group).  Routed through the autopilot
    KnobRegistry: the env var is the initial value / clamp anchor, and a
    registry write takes effect on the next submit without rebuilding."""
    from pinot_tpu_torch.cluster import autopilot

    return float(autopilot.knobs().get("batch_wait_ms"))


def batch_max() -> int:
    """Flush threshold — kept equal to the executor's vmap lane width so a
    full group maps 1:1 onto one batched launch."""
    return max(1, int(os.environ.get("PINOT_TPU_BATCH_MAX", "8")))


class BatchEntry:
    """One in-flight query waiting in a group: opaque broker payload plus
    the Future handed back to the submitter."""

    __slots__ = ("payload", "future")

    def __init__(self, payload: Any):
        self.payload = payload
        self.future: Future = threads.Future()


class _Group:
    __slots__ = ("entries", "deadline")

    def __init__(self, deadline: float):
        self.entries: List[BatchEntry] = []
        self.deadline = deadline


class MicroBatcher:
    """Coalesces submissions per key for a bounded wait, then hands the
    group to ``runner(entries)``.  The runner OWNS completion: it must
    resolve every entry's future (a runner that raises fails the whole
    group's futures as a safety net, so no submitter hangs)."""

    def __init__(
        self,
        runner: Callable[[List[BatchEntry]], None],
        wait_ms: Optional[float] = None,
        max_batch: Optional[int] = None,
        clock: Optional[Callable[[], float]] = None,
    ):
        self.runner = runner
        # None => consult the KnobRegistry per submit (live-tunable);
        # an explicit ctor value pins the window (tests, embedded uses)
        self._wait_ms_override: Optional[float] = (
            None if wait_ms is None else float(wait_ms)
        )
        self.max_batch = batch_max() if max_batch is None else int(max_batch)
        # injected clock => manual pump() (deterministic tests); the real
        # monotonic clock => lazy daemon worker wakes groups on deadline
        self._auto = clock is None
        self.clock = clock or time.monotonic
        self._cv = threads.Condition()
        self._groups: Dict[Hashable, _Group] = {}
        self._worker: Optional[Any] = None
        self._closed = False

    @property
    def wait_ms(self) -> float:
        """Coalescing window, read per decision (KnobRegistry-backed when
        not pinned at construction or by direct assignment)."""
        if self._wait_ms_override is not None:
            return self._wait_ms_override
        return batch_wait_ms()

    @wait_ms.setter
    def wait_ms(self, value: float) -> None:
        self._wait_ms_override = float(value)

    # -- submission ---------------------------------------------------------

    def submit(self, key: Hashable, payload: Any) -> Future:
        """Enqueue one query under its batch key; returns its Future.  Runs
        the group inline (in this caller's thread) when it fills to
        max_batch or when the wait window is 0."""
        entry = BatchEntry(payload)
        wait_ms = self.wait_ms  # one knob read per decision (coherent)
        if wait_ms <= 0 or self.max_batch <= 1:
            self._run([entry])
            return entry.future
        full: Optional[List[BatchEntry]] = None
        with self._cv:
            group = self._groups.get(key)
            if group is None:
                group = _Group(self.clock() + wait_ms / 1000.0)
                self._groups[key] = group
            group.entries.append(entry)
            if len(group.entries) >= self.max_batch:
                self._groups.pop(key, None)
                full = group.entries
            else:
                if self._auto and not self._closed:
                    self._ensure_worker()
                self._cv.notify_all()
        if full is not None:
            self._run(full)
        return entry.future

    # -- flushing -----------------------------------------------------------

    def pump(self, now: Optional[float] = None) -> int:
        """Flush every group whose wait window has expired as of ``now``
        (defaults to the clock).  Returns the number of groups run.  This
        is the deterministic test entry point and the worker's tick."""
        if now is None:
            now = self.clock()
        due: List[List[BatchEntry]] = []
        with self._cv:
            for key in [k for k, g in self._groups.items() if now >= g.deadline]:
                due.append(self._groups.pop(key).entries)
        for entries in due:
            self._run(entries)
        return len(due)

    def flush(self) -> int:
        """Flush every pending group regardless of deadline."""
        return self.pump(now=float("inf"))

    def pending(self) -> int:
        with self._cv:
            return sum(len(g.entries) for g in self._groups.values())

    def close(self) -> None:
        """Stop the worker and flush whatever is queued."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self.flush()

    # -- internals ----------------------------------------------------------

    def _run(self, entries: List[BatchEntry]) -> None:
        try:
            self.runner(entries)
        except BaseException as exc:  # pragma: no cover - runner safety net
            for entry in entries:
                if not entry.future.done():
                    entry.future.set_exception(exc)

    def _ensure_worker(self) -> None:
        # caller holds the condition lock
        if self._worker is None or not self._worker.is_alive():
            self._worker = threads.Thread(
                target=self._worker_main, name="query-batcher", daemon=True
            )
            self._worker.start()

    def _worker_main(self) -> None:
        while True:
            with self._cv:
                if self._closed:
                    return
                if not self._groups:
                    self._cv.wait(timeout=0.5)
                    if not self._groups:
                        return  # idle — lazily restarted by the next submit
                    continue
                earliest = min(g.deadline for g in self._groups.values())
                delay = earliest - self.clock()
                if delay > 0:
                    self._cv.wait(timeout=delay)
                    continue
            self.pump()
