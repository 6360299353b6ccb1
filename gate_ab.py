#!/usr/bin/env python3
"""BASELINE config 2 on the segment engine of two checkouts, timed in turns on one card.

    python3 gate_ab.py --other DIR [--seed 42] [--runs 20]

DIR is another checkout of this repository (an older commit unpacked with
`git archive`, say).  The script runs itself as a child process for DIR,
this checkout, this checkout and DIR, in that order; each child imports
pinot_tpu_torch from its checkout, builds that checkout's kernels there,
builds chip_smoke.py phase 4's table (8 segments of 2^23 SSB lineorder
rows from --seed, a range index on lo_quantity) into its QueryEngine() and
times query (a), `SELECT lo_orderdate, SUM(lo_revenue), COUNT(*) ...
WHERE lo_quantity < 25 GROUP BY lo_orderdate`: three warm-up runs, then
--runs runs, each ended by torch.cuda.synchronize().  A child whose engine
has the front door's gates (env defaults, the admission estimate, the
workload scheduler and the memory accountant) also times those gates alone
on the host, 200 times.  Each child prints one JSON line (the median, the
quartiles and every run, and a digest of the rows); the parent prints the
card's nvidia-smi line, each child's line and a summary, and fails when the
checkouts' rows differ.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def _smoke():
    """This checkout's chip_smoke.py (the table generator and config 2),
    loaded by path: a child's sys.path leads to the other checkout."""
    spec = importlib.util.spec_from_file_location("gate_ab_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _gates_ms(engine, sql: str) -> float:
    """Host ms of the admission gates alone for one query: env defaults, the
    deadline, the byte estimate over every segment, the scheduler's slot
    and the accountant's charge and release (median of 200)."""
    from pinot_tpu_torch.query import planner
    from pinot_tpu_torch.query.safety import Deadline, estimate_segment_bytes
    from pinot_tpu_torch.spi.env import apply_env_defaults
    from pinot_tpu_torch.sql.parser import parse_query

    segs = engine.table("lineorder").segments
    ms = []
    for _ in range(200):
        ctx = parse_query(sql)
        t0 = time.perf_counter()
        apply_env_defaults(ctx.options)
        deadline = Deadline.from_ctx(ctx)
        est = sum(estimate_segment_bytes(ctx, s, planner._needed_columns(ctx, s)) for s in segs)
        release = engine.scheduler.acquire(ctx, deadline)
        engine.accountant.release(engine.accountant.acquire(est))
        release()
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms)


def child(root: str, seed: int, runs: int) -> int:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from pinot_tpu_torch.query.engine import QueryEngine
    from pinot_tpu_torch.segment.builder import build_segment
    from pinot_tpu_torch.spi.config import IndexingConfig, TableConfig
    from pinot_tpu_torch.spi.schema import DataType, FieldRole, FieldSpec, Schema

    if not torch.cuda.is_available():
        print("gate_ab: no CUDA device", file=sys.stderr)
        return 2
    cs = _smoke()
    rng = np.random.default_rng(seed)
    schema = Schema("lineorder", [
        FieldSpec("lo_orderdate", DataType.INT),
        FieldSpec("lo_quantity", DataType.INT),
        FieldSpec("lo_discount", DataType.INT),
        FieldSpec("lo_revenue", DataType.LONG, role=FieldRole.METRIC),
    ])
    cfg = TableConfig("lineorder", indexing=IndexingConfig(range_index_columns=["lo_quantity"]))
    engine = QueryEngine()
    engine.register_table(schema, cfg)
    for i in range(8):
        engine.add_segment("lineorder", build_segment(schema, cs.lineorder_segment(rng, 1 << 23),
                                                      f"lineorder_{i}", table_config=cfg))
    rows = None
    for _ in range(3):
        rows = engine.query(cs.CONFIG2).rows
    torch.cuda.synchronize()
    ms = []
    for _ in range(runs):
        t0 = time.perf_counter()
        engine.query(cs.CONFIG2)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    q = statistics.quantiles(ms, n=4)
    out = {"checkout": root, "median_ms": statistics.median(ms), "q1_ms": q[0], "q3_ms": q[2], "runs_ms": ms,
           "rows_digest": hashlib.sha1(repr(sorted(rows)).encode()).hexdigest()[:16],
           "gates_ms": _gates_ms(engine, cs.CONFIG2) if hasattr(engine, "accountant") else "no gates"}
    print(json.dumps(out), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--other", help="another checkout of this repository")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.child, args.seed, args.runs)
    if not args.other:
        ap.error("--other DIR is required")
    other = os.path.abspath(args.other)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    results = []
    for root in (other, HERE, HERE, other):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root, "--seed", str(args.seed),
                               "--runs", str(args.runs)], cwd=root, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        results.append(json.loads(line))
    if len({r["rows_digest"] for r in results}) != 1:
        print("gate_ab: the checkouts' rows differ", file=sys.stderr)
        return 1
    print(json.dumps({"summary": {
        "other_median_ms": [results[0]["median_ms"], results[3]["median_ms"]],
        "this_median_ms": [results[1]["median_ms"], results[2]["median_ms"]],
        "this_gates_ms": [results[1]["gates_ms"], results[2]["gates_ms"]], "card": smi}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
