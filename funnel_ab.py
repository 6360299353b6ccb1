#!/usr/bin/env python3
"""The ordered funnel (ops/funnel_scan.py) of two checkouts, timed in turns on one card.

    python3 funnel_ab.py --other DIR [--seed 42]

DIR is another checkout of this repository (an older commit unpacked with
`git archive`, say).  The script runs itself as a child process for DIR,
this checkout, this checkout and DIR, in that order; each child imports
pinot_tpu_torch from its checkout, builds that checkout's kernels there,
and times its funnel at two shapes of query (n) of chip_smoke.py
(FUNNELCOUNT over lo_revenue by lo_orderdate with three steps and a
400-day window): the stacked table's 2^27 rows from --seed (the data of
chip_smoke.py phase 4b, same generator and seed) and one segment's 2^23
rows.  Per shape a child prints one JSON line: prepare alone, the scan
wrapper (kernel_ms, L2 flushed before each call), its kernels' device time
(scan_ms), the whole function funnel_reach (prepare + scan) by CUDA events
and its device time, the rows and runs the scan got, and a digest of the
reach table.  The parent prints the card's nvidia-smi line, each child's
lines and a summary, and fails when the checkouts' reach tables differ.
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

HERE = os.path.dirname(os.path.abspath(__file__))
SHAPES = (("n_stacked", 1 << 27), ("segment", 1 << 23))


def _smoke():
    """This checkout's chip_smoke.py (its timing helpers and query (n)'s
    inputs), loaded by path: a child's sys.path leads to the other one."""
    spec = importlib.util.spec_from_file_location("funnel_ab_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def child(root: str, seed: int) -> int:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from pinot_tpu_torch.ops import funnel_scan

    if not torch.cuda.is_available():
        print("funnel_ab: no CUDA device", file=sys.stderr)
        return 2
    cs = _smoke()
    dev = torch.device("cuda")
    flush = cs._flushes(dev)["write"]
    window = cs.FUNNEL_WINDOW
    for name, n in SHAPES:
        rng = np.random.default_rng(seed)
        d = {  # the column order of chip_smoke.py phase 4b's generator
            "lo_orderdate": (19920101 + rng.integers(0, 2406, n)).astype(np.int32),
            "lo_quantity": rng.integers(1, 51, n).astype(np.int32),
            "lo_discount": rng.integers(0, 11, n).astype(np.int32),
            "lo_revenue": rng.integers(100, 1_000_000, n).astype(np.int64),
        }
        inputs = cs._funnel_query_inputs(d, dev)
        del d
        cells, num_steps = inputs[4], len(inputs[1])
        prep = funnel_scan.prepare(*inputs)
        table = funnel_scan.scan_runs(*prep, num_steps, cells, window)
        out = {
            "root": root, "shape": name, "rows": int(inputs[0].shape[0]),
            "scan_rows": int(prep[1].shape[0]), "runs": int(prep[0].shape[0]), "cells": cells,
            "digest": hashlib.sha256(table.cpu().numpy().tobytes()).hexdigest()[:16],
            "prepare_ms": cs._time_cuda(lambda: funnel_scan.prepare(*inputs), flush, iters=10),
            "kernel_ms": cs._time_cuda(lambda: funnel_scan.scan_runs(*prep, num_steps, cells, window), flush),
            "whole_ms": cs._time_cuda(lambda: funnel_scan.funnel_reach(*inputs, window), flush, iters=10),
        }
        out["scan_ms"] = cs._funnel_scan_ms(lambda: funnel_scan.scan_runs(*prep, num_steps, cells, window),
                                            flush)["scan_ms"]
        whole = cs._busy_ms(lambda: funnel_scan.funnel_reach(*inputs, window))
        out.update(whole_device_ms=whole["device_ms"], whole_top_device_ops=whole["top_device_ops"])
        print(json.dumps(out), flush=True)
        del prep, table, inputs
        torch.cuda.empty_cache()
    return 0


def parent(other: str, seed: int) -> int:
    here, other = HERE, os.path.abspath(other)
    print(_smoke().nvidia_smi_line(), flush=True)
    results = []
    for root in (other, here, here, other):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--time", root, "--seed", str(seed)],
                              stdout=subprocess.PIPE, text=True)
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            print(f"funnel_ab: the child for {root} exited {proc.returncode}", file=sys.stderr)
            return 1
        results += [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    summary = {}
    for name, _n in SHAPES:
        rows = [r for r in results if r["shape"] == name]
        if len({r["digest"] for r in rows}) != 1:
            print(f"funnel_ab: the reach tables differ at {name}: {[r['digest'] for r in rows]}", file=sys.stderr)
            return 1
        summary[name] = {
            label: {k: statistics.mean(r[k] for r in rows if r["root"] == root)
                    for k in ("prepare_ms", "kernel_ms", "scan_ms", "whole_ms", "whole_device_ms")
                    if all(isinstance(r[k], float) for r in rows if r["root"] == root)}
            for label, root in (("other", other), ("this", here))}
    print(json.dumps({"funnel_ab": summary, "other": other, "this": here}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--other", help="the other checkout's root")
    ap.add_argument("--time", metavar="ROOT", help=argparse.SUPPRESS)
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args()
    if args.time:
        return child(args.time, args.seed)
    if not args.other:
        ap.error("--other DIR is required")
    return parent(args.other, args.seed)


if __name__ == "__main__":
    sys.exit(main())
