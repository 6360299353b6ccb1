"""Named kill-points: deterministic crash injection between commit steps.

Copy of pinot_tpu/utils/crashpoints.py.  Every multi-step commit path of the
port (segment write, realtime seal and checkpoint, deep-store upload and
download, journal append and snapshot compaction, lease acquire and renew,
the coordinator's add_segment, rebalance moves, residency staging) calls `crash_point("<path>.<step>")`
between its write/rename/swap steps.  Production cost is one dict lookup
against an empty registry; a test arms a point with `arm` and the Nth hit
raises InjectedCrash, the process-death stand-in.  The test then rebuilds
the component from disk (or re-runs the stage) and asserts the atomicity
invariant held: the old committed segment or none, no budget leak.

Determinism contract: hits are counted per point name under a lock, so the
same plan against the same call sequence crashes at the same step.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple


class InjectedCrash(RuntimeError):
    """A kill-point fired: the component 'died' between two commit steps.

    Deliberately a RuntimeError: serving-path handlers treat it like any
    process fault (the broker's failover sees a dead server), while harness
    code catches it explicitly to simulate the restart."""

    def __init__(self, point: str, hit: int):
        super().__init__(f"injected crash at kill-point {point!r} (hit {hit})")
        self.point = point
        self.hit = hit


_lock = threading.Lock()
# point -> hit number (1-based) that fires; None entry means never armed
_armed: Dict[str, int] = {}
# point -> calls seen since arming (only counted while something is armed)
_hits: Dict[str, int] = {}
# every fired crash, for harness assertions: (point, hit)
fired: List[Tuple[str, int]] = []


def arm(point: str, hit: int = 1) -> None:
    """Arm `point` to raise InjectedCrash on its `hit`-th call (1-based)."""
    with _lock:
        _armed[point] = max(1, int(hit))
        _hits.setdefault(point, 0)


def disarm(point: str) -> None:
    with _lock:
        _armed.pop(point, None)
        _hits.pop(point, None)


def reset() -> None:
    """Clear every armed point, hit counter, and the fired ledger."""
    with _lock:
        _armed.clear()
        _hits.clear()
        del fired[:]


def armed() -> Dict[str, int]:
    with _lock:
        return dict(_armed)


def crash_point(point: str) -> None:
    """Commit paths call this between their write/rename/swap steps.

    No-op (one dict lookup) unless a harness armed the point; the armed hit
    raises InjectedCrash and DISARMS the point, so the post-restart re-run
    of the same path commits normally."""
    if not _armed:  # fast path: nothing armed anywhere (production)
        return
    with _lock:
        target: Optional[int] = _armed.get(point)
        if target is None:
            return
        n = _hits[point] = _hits.get(point, 0) + 1
        if n < target:
            return
        _armed.pop(point, None)
        _hits.pop(point, None)
        fired.append((point, n))
    raise InjectedCrash(point, n)
