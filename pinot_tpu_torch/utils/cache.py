"""Bounded caches for the serving path: entry- and bytes-bounded LRU + TTL.

Copy of pinot_tpu/utils/cache.py (host-only).  `estimate_size` sizes a
torch tensor as numel * element_size, where the JAX package sizes an
array by its nbytes; on every other object the two estimates are equal.

Reference parity: Pinot's broker/server caches (query result cache,
segment-level plan reuse) are all bounded maps with eviction metrics —
never bare dicts.  Re-design: one thread-safe LRU primitive serving two
consumers:

  * plan caches (query/planner.py, parallel/engine.py, mse/engine.py):
    entry-bounded — a planned closure holds no data of its own, so
    counting entries is the honest bound;
  * the broker result cache (cluster/broker.py): bytes-bounded with TTL +
    version-token invalidation — results are data, so bytes are the bound.

Metrics contract: a named cache exports `{name}.hits` / `{name}.misses` /
`{name}.evictions` counters and `{name}.cacheSize` / `{name}.cacheBytes`
gauges through the process METRICS registry (Prometheus exposition rides
the existing to_prometheus()).  Eviction order is strict LRU on get/put;
TTL expiry is checked lazily on get (monotonic clock — wall-clock steps
must never mass-expire a cache, the same contract as deadlines).
"""
from __future__ import annotations

import sys
import threading
import time
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, Hashable, Optional, Tuple

import torch

from pinot_tpu_torch.utils.metrics import METRICS

# named caches register here (weakly — short-lived test caches vanish with
# their last reference) so the perf observatory (/debug/perf, cli perf) can
# report plan/result-cache occupancy alongside the ledger
_NAMED_CACHES: "weakref.WeakValueDictionary[str, LruCache]" = weakref.WeakValueDictionary()


def named_cache_stats() -> Dict[str, Dict[str, Any]]:
    """entries/bytes per live named cache (compile.sse, compile.dist,
    compile.mse, broker.resultCache, ...) — the /debug/perf cache view."""
    return {name: cache.stats() for name, cache in sorted(_NAMED_CACHES.items())}


def estimate_size(obj: Any, _depth: int = 0) -> int:
    """Cheap recursive byte estimate for cache accounting (NOT exact):
    sys.getsizeof on the spine, one level of recursion into containers,
    sampled for long sequences so a million-row result costs O(1) to
    estimate.  Good to a small factor, which is all an eviction bound
    needs."""
    n = sys.getsizeof(obj, 64)
    if _depth >= 4:
        return n
    if isinstance(obj, dict):
        items = list(obj.items())
        if len(items) > 32:  # sample + extrapolate
            step = len(items) // 32
            sampled = items[::step]
            scale = len(items) / max(1, len(sampled))
            return n + int(scale * sum(
                estimate_size(k, _depth + 1) + estimate_size(v, _depth + 1) for k, v in sampled
            ))
        return n + sum(
            estimate_size(k, _depth + 1) + estimate_size(v, _depth + 1) for k, v in items
        )
    if isinstance(obj, (list, tuple, set, frozenset)):
        seq = list(obj)
        if len(seq) > 32:
            step = len(seq) // 32
            sampled = seq[::step]
            scale = len(seq) / max(1, len(sampled))
            return n + int(scale * sum(estimate_size(x, _depth + 1) for x in sampled))
        return n + sum(estimate_size(x, _depth + 1) for x in seq)
    if isinstance(obj, torch.Tensor):
        return n + obj.numel() * obj.element_size()
    nbytes = getattr(obj, "nbytes", None)  # numpy arrays
    if isinstance(nbytes, int):
        return n + nbytes
    return n


class LruCache:
    """Thread-safe LRU bounded by entries and/or bytes, with optional TTL.

    `name` wires the hit/miss/eviction counters and size gauges into the
    METRICS registry; anonymous caches skip metrics entirely (zero
    registry churn from short-lived instances in tests)."""

    def __init__(
        self,
        max_entries: Optional[int] = None,
        max_bytes: Optional[int] = None,
        ttl_s: Optional[float] = None,
        name: Optional[str] = None,
        sizeof: Callable[[Any], int] = estimate_size,
        budget=None,
    ) -> None:
        if max_entries is None and max_bytes is None:
            raise ValueError("LruCache needs max_entries and/or max_bytes")
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        self.ttl_s = ttl_s
        self.name = name
        self._sizeof = sizeof
        # optional shared byte ledger (cluster.admission.ResourceBudget):
        # retained bytes charge the SAME budget the admission controller
        # reserves query working sets from, so caches + in-flight queries
        # can never jointly overcommit host memory.  Lock order is always
        # cache lock -> budget lock (the budget never calls back into us).
        self.budget = budget
        self.clock = time.monotonic  # injectable for deterministic TTL tests
        self._lock = threading.Lock()
        # key -> (value, nbytes, inserted_at_monotonic)
        self._entries: "OrderedDict[Hashable, Tuple[Any, int, float]]" = OrderedDict()
        self._bytes = 0
        if name is not None:
            _NAMED_CACHES[name] = self  # latest same-named cache wins

    def _charge(self, nbytes: int) -> bool:
        """Charge the shared budget (True when admitted or no budget)."""
        if self.budget is None or nbytes <= 0:
            return True
        ok = self.budget.try_charge(nbytes)
        if not ok:
            self._count("budgetRejected")
        return ok

    def _uncharge(self, nbytes: int) -> None:
        if self.budget is not None and nbytes > 0:
            self.budget.uncharge(nbytes)

    # -- metrics -----------------------------------------------------------
    def _count(self, event: str, n: int = 1) -> None:
        if self.name is not None:
            METRICS.counter(f"{self.name}.{event}").inc(n)

    def _publish_size_locked(self) -> None:
        if self.name is not None:
            METRICS.gauge(f"{self.name}.cacheSize").set(len(self._entries))
            METRICS.gauge(f"{self.name}.cacheBytes").set(self._bytes)

    # -- core --------------------------------------------------------------
    def get(self, key: Hashable, default: Any = None) -> Any:
        now = self.clock()
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and self.ttl_s is not None and now - entry[2] > self.ttl_s:
                self._entries.pop(key)
                self._bytes -= entry[1]
                self._uncharge(entry[1])
                self._publish_size_locked()
                entry = None
            if entry is None:
                self._count("misses")
                return default
            self._entries.move_to_end(key)
            self._count("hits")
            return entry[0]

    def put(self, key: Hashable, value: Any, nbytes: Optional[int] = None) -> None:
        track = self.max_bytes is not None or self.budget is not None
        size = self._sizeof(value) if (nbytes is None and track) else (nbytes or 0)
        if self.max_bytes is not None and size > self.max_bytes:
            return  # an entry larger than the whole cache never admits
        evicted = 0
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
                self._uncharge(old[1])
            # shared-budget admission: evict our own LRU tail to make room
            # before giving up — the cache yields to in-flight queries, the
            # budget never yields to the cache
            admitted = self._charge(size)
            while not admitted and self._entries:
                _k, (_v, sz, _t) = self._entries.popitem(last=False)
                self._bytes -= sz
                self._uncharge(sz)
                evicted += 1
                admitted = self._charge(size)
            if admitted:
                self._entries[key] = (value, size, self.clock())
                self._bytes += size
                while (self.max_entries is not None and len(self._entries) > self.max_entries) or (
                    self.max_bytes is not None and self._bytes > self.max_bytes
                ):
                    _k, (_v, sz, _t) = self._entries.popitem(last=False)
                    self._bytes -= sz
                    self._uncharge(sz)
                    evicted += 1
            self._publish_size_locked()
        if evicted:
            self._count("evictions", evicted)

    def invalidate(self, key: Hashable) -> bool:
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is not None:
                self._bytes -= entry[1]
                self._uncharge(entry[1])
                self._publish_size_locked()
            return entry is not None

    def invalidate_where(self, pred: Callable[[Hashable], bool]) -> int:
        """Drop every entry whose KEY matches `pred` (version-token
        invalidation: the broker drops a table's results on segment churn
        by matching the table component of the key)."""
        with self._lock:
            doomed = [k for k in self._entries if pred(k)]
            for k in doomed:
                _v, sz, _t = self._entries.pop(k)
                self._bytes -= sz
                self._uncharge(sz)
            self._publish_size_locked()
            return len(doomed)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._uncharge(self._bytes)
            self._bytes = 0
            self._publish_size_locked()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: Hashable) -> bool:
        with self._lock:
            return key in self._entries

    @property
    def bytes(self) -> int:
        with self._lock:
            return self._bytes

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"entries": len(self._entries), "bytes": self._bytes}
