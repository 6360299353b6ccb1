#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (pinot_tpu_torch) on one NVIDIA card.

Run from the repository root, with no arguments:  python3 chip_smoke.py

Phases, in order; any failure raises and the process exits non-zero:
  1. device   - CUDA present; the card's name and power limit; TF32 off.
  2. build    - ops/csrc/*.cu compiled with nvcc for sm_90a into
                build/torch_kernels/ (first use) and loaded.
  3. kernels  - every kernel held EXACTLY against its plain PyTorch version on
                CUDA tensors, over the CPU tests' grid plus the main-path shape
                (2^23 rows, packed 16-bit key, 2406 groups, count + int_sum)
                and the shared-memory limits (8192 groups); then the
                main-path shape timed with CUDA events (median of 20
                launches, L2 flushed before each): kernel, plain version,
                and one torch.Tensor.index_add_ per entry as the library
                yardstick (never called by the port).
  4. main path - SSB lineorder, --segments x --rows-per-segment rows (default
                8 x 2^23 = 67,108,864, just above SSB scale factor 10) from
                --seed, registered in QueryEngine() on CUDA; three queries
                checked EXACTLY against numpy golden results, with the
                kernels' launch counts read around that one run; then each
                query's warm median wall time over 5 runs.
  5. summary  - one {"kernels": [...]} JSON line, the card's nvidia-smi line,
                and last the {"ok": true, "device": {...}} line.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, and the non-tensor-core
# rate used for the scan's integer adds (no integer rate is published)
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
# CUDA-event-timed launches per kernel measurement, after warm-up
TIMED_ITERS = 20

CONFIG2 = (
    "SELECT lo_orderdate, SUM(lo_revenue), COUNT(*) FROM lineorder "
    "WHERE lo_quantity < 25 GROUP BY lo_orderdate LIMIT 2500"
)
QUERY_B = (
    "SELECT SUM(lo_revenue), COUNT(*) FROM lineorder "
    "WHERE lo_discount BETWEEN 1 AND 3 AND lo_quantity < 25"
)
QUERY_C = (
    "SELECT lo_discount, lo_quantity, COUNT(*), SUM(lo_revenue), MIN(lo_revenue), MAX(lo_revenue) "
    "FROM lineorder GROUP BY lo_discount, lo_quantity ORDER BY SUM(lo_revenue) DESC LIMIT 10"
)


def log(phase: str, **kv) -> None:
    print(json.dumps({"phase": phase, **kv}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3: kernel vs plain version
# ---------------------------------------------------------------------------
def _pack(codes: np.ndarray, bits: int) -> np.ndarray:
    f = 32 // bits
    pad = (-len(codes)) % f
    lanes = np.concatenate([codes.astype(np.uint32), np.zeros(pad, np.uint32)]).reshape(-1, f)
    return np.bitwise_or.reduce(lanes << (np.arange(f, dtype=np.uint32) * np.uint32(bits)), axis=1).astype(np.uint32)


def _variants(rng):
    """(label, entries, codes, num_groups, kwargs) in numpy; entries are
    (kind, values, mask, limb_plan)."""
    def entries(n, kinds=("count", "i8", "i32", "i64")):
        m = lambda: rng.random(n) < 0.8  # noqa: E731
        make = {
            "count": lambda: ("count", None, m(), None),
            "i8": lambda: ("int_sum", rng.integers(-120, 120, n).astype(np.int8), m(), (1, True)),
            "i32": lambda: ("int_sum", rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32), m(), (4, True)),
            "i64": lambda: ("int64_sum", rng.integers(-(2**39), 2**39, n).astype(np.int64), m(), None),
            "u32": lambda: ("int_sum", rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32), m(), None),
        }
        return [make[k]() for k in kinds]

    out = []
    for n in (32, 4096, 4096 * 2 + 32, 1000):
        for g in (1, 7, 300):
            out.append((f"grid n={n} G={g}", entries(n), rng.integers(0, g, n).astype(np.int32), g, {}))
    n = 4096 * 3 + 32
    codes = rng.integers(0, 50, n).astype(np.int32)
    words = np.packbits((rng.random(n) < 0.5).reshape(-1, 32), axis=1, bitorder="little").view(np.uint32).reshape(-1)
    out.append(("mask_words+code_pred", entries(n), codes, 50,
                {"mask_words": words, "code_pred": (codes.astype(np.uint8), 10, 40)}))
    for bits in (4, 8, 16):
        n = 4096 + 32
        g = min(1 << bits, 300)
        c = rng.integers(0, g, n).astype(np.int32)
        out.append((f"packed {bits}-bit key", entries(n), c, g, {"codes_packed": (_pack(c, bits), bits)}))
    out.append(("uint32 int_sum, default plan", entries(1000, ("count", "u32")),
                rng.integers(0, 7, 1000).astype(np.int32), 7, {}))
    out.append(("G=8192, 3 entries (shared-memory limit)", entries(1 << 20, ("count", "i8", "i32")),
                rng.integers(0, 8192, 1 << 20).astype(np.int32), 8192, {}))
    out.append(("G=8192, 4 entries (global-atomic path)", entries(1 << 20),
                rng.integers(0, 8192, 1 << 20).astype(np.int32), 8192, {}))
    return out


def _to_cuda(entries, codes, kwargs, dev):
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    ents = [(k, None if v is None else t(v), t(m), lp) for k, v, m, lp in entries]
    kw = {}
    if "mask_words" in kwargs:
        kw["mask_words"] = torch.from_numpy(kwargs["mask_words"].view(np.int32)).to(dev)
    if "code_pred" in kwargs:
        pc, lo, hi = kwargs["code_pred"]
        kw["code_pred"] = (t(pc), lo, hi)
    if "codes_packed" in kwargs:
        w, bits = kwargs["codes_packed"]
        kw["codes_packed"] = (torch.from_numpy(w.view(np.int32)).to(dev), bits)
    return ents, t(codes), kw


def _max_abs_err(got, ref) -> float:
    return max(float((a - b).abs().max()) for a, b in zip(got, ref)) if got else 0.0


def _time_cuda(fn, flush: torch.Tensor) -> float:
    """Median ms of TIMED_ITERS calls, each bracketed by its own CUDA events,
    with the L2 cache flushed (a 256 MiB write) before each call."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(TIMED_ITERS):
        flush.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_kernels(rng, dev):
    from pinot_tpu_torch.ops import fused_scan, segmented

    worst = 0.0
    for label, entries, codes, g, kwargs in _variants(rng):
        ents, c, kw = _to_cuda(entries, codes, kwargs, dev)
        key = None if "codes_packed" in kw else c
        got = fused_scan.fused_group_tables(ents, key, g, **kw)
        torch.cuda.synchronize()
        ref = fused_scan.fused_group_tables_reference(ents, key, g, **kw)
        err = _max_abs_err(got, ref)
        worst = max(worst, err)
        log("kernel_check", variant=label, max_abs_err=err)
        if err != 0.0:
            raise AssertionError(f"fused scan differs from its plain version on {label}: {err}")

    # main-path shape: 2^23 rows, packed 16-bit key, 2406 groups, the shared
    # presence/COUNT(*) entry and SUM over int32 revenue (plan from stats)
    n, g = 1 << 23, 2406
    od = rng.integers(0, g, n).astype(np.int32)
    mask = torch.from_numpy(rng.random(n) < 0.48).to(dev)
    rev_np = rng.integers(100, 1_000_000, n).astype(np.int32)
    rev = torch.from_numpy(rev_np).to(dev)
    words = torch.from_numpy(_pack(od, 16).view(np.int32)).to(dev)
    plan = segmented.sum_limb_plan(100, 999_999)
    ents = [("count", None, mask, None), ("int_sum", rev, mask, plan)]
    got = fused_scan.fused_group_tables(ents, None, g, codes_packed=(words, 16))
    ref = fused_scan.fused_group_tables_reference(ents, None, g, codes_packed=(words, 16))
    err = _max_abs_err(got, ref)
    worst = max(worst, err)
    log("kernel_check", variant="main path n=2^23 G=2406 packed16 count+int_sum", max_abs_err=err)
    if err != 0.0:
        raise AssertionError(f"fused scan differs from its plain version at the main-path shape: {err}")

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    key64 = fused_scan.lane_unpack(words, 16, n).to(torch.int64)
    count_v = mask.to(torch.int64)
    sum_v = torch.where(mask, rev.to(torch.int64), torch.zeros((), dtype=torch.int64, device=dev))

    def library():
        torch.zeros(g, dtype=torch.int64, device=dev).index_add_(0, key64, count_v)
        torch.zeros(g, dtype=torch.int64, device=dev).index_add_(0, key64, sum_v)

    before = fused_scan.LAUNCHES
    kernel_ms = _time_cuda(lambda: fused_scan.fused_group_tables(ents, None, g, codes_packed=(words, 16)), flush)
    timing_launches = fused_scan.LAUNCHES - before
    plain_ms = _time_cuda(lambda: fused_scan.fused_group_tables_reference(ents, None, g, codes_packed=(words, 16)), flush)
    library_ms = _time_cuda(library, flush)
    # least time for the same work: each input byte read once (key words,
    # the shared mask, revenue where the mask holds), each output written once
    n_true = int(mask.sum())
    read_bytes = words.numel() * 4 + n + n_true * 4
    write_bytes = len(ents) * g * 8
    bytes_ms = (read_bytes + write_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = (n + n_true) / SCALAR_OPS_PER_S * 1e3  # one int64 add per counted row and entry
    timing = {
        "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes_moved": read_bytes + write_bytes, "timing_launches": timing_launches,
    }
    log("kernel_timing", shape="n=2^23 packed16 G=2406 E=2", iters=TIMED_ITERS,
        bound_divisor=f"{HBM_BYTES_PER_S:.3g} B/s (H100 SXM HBM3 peak)", **timing)
    return worst, timing


# ---------------------------------------------------------------------------
# phase 4: the main path at a real size
# ---------------------------------------------------------------------------
def lineorder_segment(rng, n: int):
    return {
        "lo_orderdate": (19920101 + rng.integers(0, 2406, n)).astype(np.int32),
        "lo_quantity": rng.integers(1, 51, n).astype(np.int32),
        "lo_discount": rng.integers(0, 11, n).astype(np.int32),
        "lo_revenue": rng.integers(100, 1_000_000, n).astype(np.int64),
    }


def golden(datas):
    """Exact int64 numpy results of the three queries."""
    a_sum = np.zeros(2406, np.int64)
    a_cnt = np.zeros(2406, np.int64)
    b_sum = b_cnt = 0
    c_cnt = np.zeros(11 * 50, np.int64)
    c_sum = np.zeros(11 * 50, np.int64)
    c_min = np.full(11 * 50, np.iinfo(np.int64).max)
    c_max = np.full(11 * 50, np.iinfo(np.int64).min)
    for d in datas:
        od, q, disc, rev = d["lo_orderdate"] - 19920101, d["lo_quantity"], d["lo_discount"], d["lo_revenue"]
        m = q < 25
        np.add.at(a_sum, od[m], rev[m])
        a_cnt += np.bincount(od[m], minlength=2406)
        mb = m & (disc >= 1) & (disc <= 3)
        b_sum += int(rev[mb].sum())
        b_cnt += int(mb.sum())
        k = disc * 50 + (q - 1)
        c_cnt += np.bincount(k, minlength=550)
        np.add.at(c_sum, k, rev)
        np.minimum.at(c_min, k, rev)
        np.maximum.at(c_max, k, rev)
    rows_a = sorted((19920101 + i, float(a_sum[i]), int(a_cnt[i])) for i in np.nonzero(a_cnt)[0])
    rows_b = [(float(b_sum), b_cnt)]
    order = sorted(np.nonzero(c_cnt)[0], key=lambda i: -c_sum[i])[:10]
    rows_c = [(int(i // 50), int(i % 50 + 1), int(c_cnt[i]), float(c_sum[i]), float(c_min[i]), float(c_max[i]))
              for i in order]
    return rows_a, rows_b, rows_c


def phase_main_path(args, dev):
    from pinot_tpu_torch.ops import fused_scan
    from pinot_tpu_torch.query.engine import QueryEngine
    from pinot_tpu_torch.segment.builder import build_segment
    from pinot_tpu_torch.spi.config import IndexingConfig, TableConfig
    from pinot_tpu_torch.spi.schema import DataType, FieldRole, FieldSpec, Schema

    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed)
    schema = Schema(
        "lineorder",
        [
            FieldSpec("lo_orderdate", DataType.INT),
            FieldSpec("lo_quantity", DataType.INT),
            FieldSpec("lo_discount", DataType.INT),
            FieldSpec("lo_revenue", DataType.LONG, role=FieldRole.METRIC),
        ],
    )
    cfg = TableConfig("lineorder", indexing=IndexingConfig(range_index_columns=["lo_quantity"]))
    engine = QueryEngine()  # device None: CUDA, raising without it
    datas = []
    for i in range(args.segments):
        d = lineorder_segment(rng, args.rows_per_segment)
        datas.append(d)
        if i == 0:
            engine.register_table(schema, cfg)
        engine.add_segment("lineorder", build_segment(schema, dict(d), f"lineorder_{i}", table_config=cfg))
    total_rows = args.segments * args.rows_per_segment
    build_s = time.perf_counter() - t0
    want_a, want_b, want_c = golden(datas)
    log("main_path_setup", segments=args.segments, rows=total_rows, build_and_golden_s=time.perf_counter() - t0,
        segment_build_s=build_s)

    # the counted run: counts set to 0 just before, read just after
    fused_scan.LAUNCHES = 0
    res_a = engine.query(CONFIG2)
    launches_a = fused_scan.LAUNCHES
    res_b = engine.query(QUERY_B)
    launches_b = fused_scan.LAUNCHES - launches_a
    res_c = engine.query(QUERY_C)
    launches_c = fused_scan.LAUNCHES - launches_a - launches_b
    torch.cuda.synchronize()
    main_launches = fused_scan.LAUNCHES

    if sorted(res_a.rows) != want_a:
        raise AssertionError("query (a) differs from the numpy golden")
    if res_a.stats.filter_index_uses != (("lo_quantity", "range"),):
        raise AssertionError(f"query (a) did not ride the range index: {res_a.stats.filter_index_uses}")
    if res_b.rows != want_b:
        raise AssertionError(f"query (b) differs from the numpy golden: {res_b.rows} vs {want_b}")
    if res_c.rows != want_c:
        raise AssertionError(f"query (c) differs from the numpy golden: {res_c.rows} vs {want_c}")
    if launches_a < args.segments or launches_c < args.segments:
        raise AssertionError(
            f"the fused scan did not run on every segment: (a) {launches_a}, (c) {launches_c} launches"
        )
    log("main_path_check", exact=True, launches_a=launches_a, launches_b=launches_b, launches_c=launches_c,
        groups_a=len(res_a.rows))

    torch.cuda.reset_peak_memory_stats()
    timings = {}
    for name, sql in (("a_config2", CONFIG2), ("b_filtered_agg", QUERY_B), ("c_two_dim_groupby", QUERY_C)):
        ms = []
        for _ in range(5):
            s = time.perf_counter()
            engine.query(sql)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - s) * 1e3)
        med = statistics.median(ms)
        timings[name] = {"median_ms": med, "rows_per_s": total_rows / (med / 1e3), "runs_ms": ms}
    log("main_path_timing", rows=total_rows, max_memory_allocated=torch.cuda.max_memory_allocated(), **timings)
    for name, sql in (("a_config2", CONFIG2), ("b_filtered_agg", QUERY_B), ("c_two_dim_groupby", QUERY_C)):
        log("main_path_profile", query=name, **profile_query(engine, sql))
    return main_launches


def profile_query(engine, sql: str) -> dict:
    """One warm run under torch.profiler: device time by kernel and the
    device's busy share of the (profiled) wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.query(sql)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        rows.append((us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    if not rows:
        return {"profiled_wall_ms": wall_ms, "device_busy_ms": "not measured"}
    return {
        "profiled_wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "top_device_ops": [{"ms": ms, "calls": n, "name": k[:90]} for ms, n, k in rows[:8]],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--segments", type=int, default=8)
    ap.add_argument("--rows-per-segment", type=int, default=1 << 23)
    args = ap.parse_args()

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    from pinot_tpu_torch.ops import _build

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    log("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda, tf32="off (matmul and cudnn)")

    # 2. build
    t0 = time.perf_counter()
    _build.load()
    log("build", library=f"build/torch_kernels/{_build.LIB_NAME}", nvcc_s=_build.last_build_seconds,
        build_and_load_s=time.perf_counter() - t0)

    # 3. kernels vs plain versions
    rng = np.random.default_rng(args.seed)
    worst, timing = phase_kernels(rng, dev)

    # 4. main path
    main_launches = phase_main_path(args, dev)

    # 5. summary
    kernels = [{
        "name": "fused_scan",
        "route": "cuda",
        "source": "pinot_tpu_torch/ops/csrc/fused_scan.cu",
        "replaces": "pinot_tpu/ops/pallas_scan.py:146",
        "replaces_function": "fused_group_tables_pallas",
        "exact": worst == 0.0,
        "launches": main_launches,
        "launches_on_main_path": main_launches,
        "max_abs_err": worst,
        "ms": timing["kernel_ms"],
        "kernel_ms": timing["kernel_ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
