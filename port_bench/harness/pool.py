"""Worker processes for the set-up and the reference: spawned (never
forked), before the serving process touches the card, and always ended
and waited for."""
from __future__ import annotations

import multiprocessing as mp
import os
from typing import Callable, Iterable, List


def workers() -> int:
    """One worker a core, at most 8 (the card's host has 8 cores a chip)."""
    return max(1, min(8, os.cpu_count() or 1))


def run(fn: Callable, tasks: Iterable, processes: int = 0, timeout_s: float = 900.0) -> List:
    """fn over tasks in spawned workers, results in task order.  The pool is
    closed and joined before this returns, on every path; a pool whose
    workers cannot start (they are respawned for ever) fails at the
    timeout."""
    tasks = list(tasks)
    ctx = mp.get_context("spawn")
    pool = ctx.Pool(processes or min(workers(), len(tasks)))
    try:
        out = pool.map_async(fn, tasks, chunksize=1).get(timeout_s)
        pool.close()
    except BaseException:
        pool.terminate()
        raise
    finally:
        pool.join()
    return out
