"""Recompilation guard: fingerprint -> compile-event audit for plan caches.

Copy of pinot_tpu/analysis/compile_audit.py (host-only).  Every engine
caches planned closures by (query fingerprint, layout signature); here a
"compile" is one planned closure built (a plan-cache miss).  A cache whose
signature churns — segments with drifting shapes, per-query closure
constants leaking into the key — re-plans the same query shape over and
over, and the warm path degrades to planning.  The audit records one event
per cache miss, exports counters through utils.metrics, and flags the
same fingerprint compiling more than `threshold` times: warn by default,
raise RecompilationStormError when PINOT_TPU_RECOMPILE_STRICT=1.
"""
from __future__ import annotations

import os
import threading
import warnings
from typing import Any, Dict, Optional

from pinot_tpu_torch.utils.metrics import METRICS

_DEFAULT_THRESHOLD = 32  # distinct segment layouts per query shape is legit; storms are 100s


class RecompilationStormError(RuntimeError):
    """Same query fingerprint recompiled more than the audit threshold."""


class CompileAudit:
    """Per-cache compile/hit recorder (one instance per kernel cache)."""

    def __init__(self, name: str, threshold: Optional[int] = None, strict: Optional[bool] = None):
        self.name = name
        self.threshold = (
            threshold
            if threshold is not None
            else int(os.environ.get("PINOT_TPU_RECOMPILE_LIMIT", _DEFAULT_THRESHOLD))
        )
        self.strict = (
            strict
            if strict is not None
            else os.environ.get("PINOT_TPU_RECOMPILE_STRICT", "0") not in ("0", "", "false")
        )
        self._lock = threading.Lock()
        self._compiles: Dict[str, int] = {}
        self._hits = 0

    def record_compile(self, fingerprint: str) -> None:
        """Record one cache-miss compile of `fingerprint` (call at plan time)."""
        with self._lock:
            n = self._compiles.get(fingerprint, 0) + 1
            self._compiles[fingerprint] = n
        METRICS.counter(f"compile.{self.name}.compiles").inc()
        if n > self.threshold:
            msg = (
                f"query shape recompiled {n}x in cache {self.name!r} "
                f"(threshold {self.threshold}): likely a recompilation storm — "
                f"per-segment constants leaking into the plan key? fp={fingerprint[:80]}"
            )
            METRICS.counter(f"compile.{self.name}.storms").inc()
            if self.strict:
                raise RecompilationStormError(msg)
            warnings.warn(msg, RuntimeWarning, stacklevel=3)

    def record_hit(self, fingerprint: str) -> None:
        with self._lock:
            self._hits += 1
        METRICS.counter(f"compile.{self.name}.hits").inc()

    def compile_count(self, fingerprint: str) -> int:
        with self._lock:
            return self._compiles.get(fingerprint, 0)

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._compiles)

    def hit_count(self) -> int:
        with self._lock:
            return self._hits

    def summary(self) -> Dict[str, Any]:
        """Plan-cache effectiveness snapshot since the last reset():
        cold_compiles = distinct shapes traced for the first time,
        warm_recompiles = re-traces of an already-seen shape (structure
        mismatch or cache eviction — the expensive kind a literal leak
        causes), hits = warm-path cache hits, hit_rate over all lookups."""
        with self._lock:
            total = sum(self._compiles.values())
            cold = len(self._compiles)
            hits = self._hits
        lookups = hits + total
        return {
            "hits": hits,
            "compiles_total": total,
            "cold_compiles": cold,
            "warm_recompiles": total - cold,
            "hit_rate": (hits / lookups) if lookups else 0.0,
        }

    def reset(self) -> None:
        with self._lock:
            self._compiles.clear()
            self._hits = 0


# one audit per plan cache: the SSE per-segment plan cache
# (query/planner.py), the distributed-combine cache (parallel/engine.py)
# and the multi-stage join cache (mse/engine.py)
SSE_AUDIT = CompileAudit("sse")
DIST_AUDIT = CompileAudit("dist")
MSE_AUDIT = CompileAudit("mse")


def reset_all() -> None:
    for a in (SSE_AUDIT, DIST_AUDIT, MSE_AUDIT):
        a.reset()
