"""Closed-loop clients: each sends its next query when the last one has
returned.  Every client cycles the cell's queries in the query file's
order, each from its own starting place: the places are spread evenly
over the queries (3 over 13 in mix_c3), turned together by a shift, and
handed to the clients in an order, both drawn from the run's seed (spawn
key (2,)).  So every seed offers the same
mix at every moment, in another order; a seeded permutation per client
would change the work a window completes from seed to seed (its clients
finish about two passes of their permutations in 30 s)."""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np


@dataclass
class Record:
    client: int
    qid: str
    sent: float  # host clock, seconds
    done: float
    error: Optional[str]
    rows: Optional[tuple]  # the canonical rows (harness.compare.canonical)
    trace: Optional[dict] = None  # the program's trace of a traced query


def orders(qids: List[str], clients: int, seed: int) -> List[List[str]]:
    """Each client's cycle: the queries from its starting place on."""
    n = len(qids)
    rng = np.random.default_rng(np.random.SeedSequence(entropy=int(seed), spawn_key=(2,)))
    shift = int(rng.integers(n))
    starts = [(c * n // clients + shift) % n for c in range(clients)]
    return [qids[s:] + qids[:s] for s in (starts[i] for i in rng.permutation(clients))]


def closed_loop(query: Callable, keep: Callable, queries: Dict[str, str], clients: int, seed: int,
                seconds: float, prefix: str = "", during: Optional[Callable[[float], None]] = None,
                grace_s: float = 120.0):
    """Run the clients for `seconds` from a common start; queries in flight
    at the close run to their end.  during(t0), if given, runs on this
    thread once the clients have started.  keep(result) -> (rows, trace).
    Returns (records, t0, t_end)."""
    plan = orders(list(queries), clients, seed)
    records: List[Record] = []
    lock = threading.Lock()
    start = threading.Barrier(clients + 1)
    box = {}

    def client(c: int) -> None:
        start.wait()
        t_end = box["t_end"]
        i = 0
        while True:
            sent = time.perf_counter()
            if sent >= t_end:
                return
            qid = plan[c][i % len(plan[c])]
            i += 1
            err, rows, trace = None, None, None
            try:
                out = query(prefix + queries[qid])
                done = time.perf_counter()
                rows, trace = keep(out)
            except Exception as e:  # a failed query is counted, not fatal
                done = time.perf_counter()
                err = f"{type(e).__name__}: {e}"
            with lock:
                records.append(Record(c, qid, sent, done, err, rows, trace))

    threads = [threading.Thread(target=client, args=(c,), name=f"client{c}", daemon=True) for c in range(clients)]
    for t in threads:
        t.start()
    t0 = time.perf_counter()
    box["t_end"] = t0 + seconds
    start.wait()
    if during is not None:
        during(t0)
    time.sleep(max(0.0, box["t_end"] - time.perf_counter()))
    for t in threads:
        t.join(timeout=max(1.0, box["t_end"] + grace_s - time.perf_counter()))
    stuck = [t.name for t in threads if t.is_alive()]
    if stuck:
        raise RuntimeError(f"clients {stuck} still waiting {grace_s} s after the window closed")
    return records, t0, box["t_end"]
