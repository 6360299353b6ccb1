#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (pinot_tpu_torch) on one NVIDIA card.

Run from the repository root, with no arguments:  python3 chip_smoke.py

Phases, in order; any failure raises and the process exits non-zero:
  1. device   - CUDA present; the card's name and power limit; TF32 off.
  2. build    - ops/csrc/*.cu compiled with nvcc for sm_90a into
                build/torch_kernels/ (first use) and loaded.
  3. kernels  - every kernel held EXACTLY against its plain PyTorch version on
                CUDA tensors: the CPU tests' grid, every instantiation (the
                two specialised ones, the generic one, the global-atomic
                path), unaligned
                views, shared and distinct masks, E = 16 and 17, G = 1 and
                8, out-of-table codes; then 6 shapes timed with CUDA events
                (median of 20 calls, L2 flushed before each): the
                distributed main path's launch (2^27 rows, packed 16-bit
                key, mask_words, an all-true entry mask, 2406 groups, count
                + int_sum), the segment main path's (2^23 rows, one mask),
                query (c)'s raw computed key (550 groups), G = 8, G = 8192
                with 4 sums (global path), and the distributed FILTER launch
                of query (e) (2^27 rows, packed key, mask_words, two
                distinct masks, count + two int32 sums).  Each: the wrapper call,
                the plain version, and one torch.Tensor.index_add_ per entry
                as the library yardstick (never called by the port).  Also
                printed: ptxas's registers/shared memory/spills of each
                instantiation and the atomic instructions in the SASS.
  4. main path - SSB lineorder, --segments x --rows-per-segment rows (default
                8 x 2^23 = 67,108,864, just above SSB scale factor 10) from
                --seed, registered in QueryEngine() on CUDA; three queries
                checked EXACTLY against numpy golden results, with the
                kernels' launch counts read around that one run; then each
                query's warm median wall time over 5 runs and a profile.
 4b. dist_main_path - bench.py main()'s table: 2^27 = 134,217,728 rows from
                --seed in StackedTable.build(num_shards=1) with a range index
                on lo_quantity, queried through DistributedEngine() on CUDA
                at one launch and at three (launch_bytes 384 MiB): (a) the
                bench query (word-fused: the range-index words go to the
                fused scan as mask_words), (b) a two-predicate scalar
                aggregation, (c) a dense group-by with MIN/MAX (the words
                unpacked), (d) a sparse group-by over 1,323,300 keys with
                the device merge.  Every result EXACTLY equal to a numpy
                golden at both batchings, the route of each query checked
                from the counters around one counted run per engine; the
                20-literal sweep plans once; warm medians of 5, the host ms
                of the words and their copy, then a profile of each query.
 4c. transform_path - on the tables of phases 4 and 4b (no second build):
                (e) a FILTER (WHERE ...) group-by, (f) SSB Q1.1's
                SUM(lo_revenue * lo_discount), (g) a GROUP BY MOD(...) key
                with a CASE sum, (h) a top-100 selection, on both engines
                (the distributed one at one launch and at three); (i) an
                expression selection with OFFSET and (j) RANK / SUM OVER
                windows on the segment engine only (the distributed engine
                refuses them, as the JAX package's does).  Each query once
                counted (scan launches by instantiation, with mask_words, and
                the distinct masks of each launch) and held against a numpy
                golden, (e) and (g) required to launch the fused scan; then
                warm medians of 5.  The profiles of phases 4-4c run after all
                their wall timings; then one transform_path line per query
                and engine: wall, device busy and idle share, launches,
                masks, bytes of doc ids copied home, exact.
  5. profile  - after the main paths (a profiler session leaves tracing set
                up in the process): each timed shape's kernel device time
                (scan_ms, torch.profiler); at the segment main path's and
                query (c)'s shapes the same for the generic instantiation; at
                the segment main path's shape, after a write flush and after
                a read flush, scan_ms beside a float32 sum and a device copy
                of the same input bytes.
  6. summary  - one {"kernels": [...]} JSON line, the card's nvidia-smi line,
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
# profiled launches per scan_ms measurement
PROFILED_ITERS = 10

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
    (kind, values, mask, limb_plan).  kwargs may hold "offsets": the element
    offset at which each kind of operand ("key", "mask", "values") starts
    inside a larger buffer, so that the kernel sees unaligned views."""
    def entries(n, kinds=("count", "i8", "i32", "i64"), shared_mask=False):
        one = rng.random(n) < 0.8
        m = (lambda: one) if shared_mask else (lambda: rng.random(n) < 0.8)  # noqa: E731
        make = {
            "count": lambda: ("count", None, m(), None),
            "i8": lambda: ("int_sum", rng.integers(-120, 120, n).astype(np.int8), m(), (1, True)),
            "i16": lambda: ("int_sum", rng.integers(-30000, 30000, n).astype(np.int16), m(), (2, True)),
            "u16": lambda: ("int_sum", rng.integers(0, 65536, n).astype(np.uint16), m(), (2, False)),
            "i32": lambda: ("int_sum", rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32), m(), (4, True)),
            "i64": lambda: ("int64_sum", rng.integers(-(2**39), 2**39, n).astype(np.int64), m(), None),
            "i64p5": lambda: ("int64_sum", rng.integers(-(2**39), 2**39, n).astype(np.int64), m(), 5),
            "u32": lambda: ("int_sum", rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32), m(), None),
        }
        return [make[k]() for k in kinds]

    def words(n):
        return np.packbits((rng.random(n) < 0.5).reshape(-1, 32), axis=1, bitorder="little").view(np.uint32).reshape(-1)

    out = []
    for n in (32, 4096, 4096 * 2 + 32, 1000):
        for g in (1, 7, 300):
            out.append((f"grid n={n} G={g}", entries(n), rng.integers(0, g, n).astype(np.int32), g, {}))
    n = 4096 * 3 + 32
    codes = rng.integers(0, 50, n).astype(np.int32)
    out.append(("mask_words+code_pred", entries(n), codes, 50,
                {"mask_words": words(n), "code_pred": (codes.astype(np.uint8), 10, 40)}))
    for bits in (4, 8, 16):
        n = 4096 + 32
        g = min(1 << bits, 300)
        c = rng.integers(0, g, n).astype(np.int32)
        out.append((f"packed {bits}-bit key", entries(n), c, g, {"codes_packed": (_pack(c, bits), bits)}))
    out.append(("uint32 int_sum, default plan", entries(1000, ("count", "u32")),
                rng.integers(0, 7, 1000).astype(np.int32), 7, {}))
    out.append(("G=8192, 3 entries (shared-memory limit)", entries(1 << 20, ("count", "i8", "i32")),
                rng.integers(0, 8192, 1 << 20).astype(np.int32), 8192, {}))
    out.append(("G=8192, count + 3 sums (224 KB of shared tables)", entries(1 << 20),
                rng.integers(0, 8192, 1 << 20).astype(np.int32), 8192, {}))
    out.append(("G=8192, 4 sums (global-atomic path)", entries(1 << 20, ("i8", "i32", "i64", "i16")),
                rng.integers(0, 8192, 1 << 20).astype(np.int32), 8192, {}))

    # every instantiation: key mode x value mode, with negative and >= G
    # codes where the key can hold them, on row counts that leave a tail
    # after the vector tiles (packed keys need whole words)
    value_sets = {"i32": ("count", "i32", "u32"), "i64": ("count", "i64", "i64p5"),
                  "any": ("count", "i8", "i16", "u16", "i32", "i64")}
    n_raw, n_packed = 512 * 5 + 37, 512 * 5 + 48
    for vm, kinds in value_sets.items():
        c = rng.integers(-3, 303, n_raw).astype(np.int32)
        out.append((f"int32 key, {vm} values, codes in [-3, 303) of G=300", entries(n_raw, kinds), c, 300, {}))
        c = np.where(rng.random(n_raw) < 0.9, rng.integers(0, 300, n_raw),
                     rng.integers(-(2**40), 2**40, n_raw)).astype(np.int64)
        out.append((f"int64 key (generic), {vm} values, wide codes", entries(n_raw, kinds), c, 300, {}))
        for bits in (4, 8, 16):
            g = {4: 12, 8: 200, 16: 2406}[bits]
            c = rng.integers(0, min(1 << bits, g + 40), n_packed).astype(np.int32)  # lanes >= G drop
            out.append((f"packed {bits}-bit key, {vm} values, G={g}", entries(n_packed, kinds), c, g,
                        {"codes_packed": (_pack(c, bits), bits)}))
    c = rng.integers(-128, 128, n_raw).astype(np.int8)
    out.append(("int8 key (generic), negative codes", entries(n_raw, ("count", "i32")), c, 100, {}))
    c = rng.integers(0, 4, n_packed).astype(np.int32)
    out.append(("packed 2-bit key (generic)", entries(n_packed, ("count", "i32")), c, 3,
                {"codes_packed": (_pack(c, 2), 2)}))

    # unaligned views, masks shared or not, chunked entry lists, hot slots
    n = 512 * 4 + 64
    c = rng.integers(0, 300, n).astype(np.int32)
    out.append(("views at offset 1 (common aligned head), mask_words+code_pred",
                entries(n, ("count", "i8", "i32", "i64")), c, 300,
                {"offsets": {"key": 1, "mask": 1, "values": 1}, "mask_words": words(n),
                 "code_pred": (c.astype(np.int16), 20, 250)}))
    for off in ((1, 2, 3), (3, 1, 2), (2, 3, 1)):
        out.append((f"views at offsets key/mask/values {off} (no common head: scalar loads)",
                    entries(n + 13, ("count", "i32", "i64")), rng.integers(0, 300, n + 13).astype(np.int32), 300,
                    {"offsets": dict(zip(("key", "mask", "values"), off))}))
    c = rng.integers(0, 2406, n).astype(np.int32)
    out.append(("packed 16-bit key, views at offsets 1 word / 2 / 2 (head of 2 rows)", entries(n, ("count", "i32")),
                c, 2406, {"codes_packed": (_pack(c, 16), 16), "offsets": {"key": 1, "mask": 2, "values": 2}}))
    out.append(("one mask shared by 4 entries", entries(n, ("count", "i8", "i32", "i64"), shared_mask=True),
                rng.integers(0, 300, n).astype(np.int32), 300, {}))
    out.append(("E=16 (one launch)", entries(n, ("count", "i32", "i64", "i8") * 4),
                rng.integers(0, 50, n).astype(np.int32), 50, {}))
    out.append(("E=17 (two launches)", entries(n, ("count", "i32", "i64", "i8") * 4 + ("count",)),
                rng.integers(0, 50, n).astype(np.int32), 50, {}))
    for g in (1, 8):
        out.append((f"G={g} hot slots, n=2^20", entries(1 << 20, ("count", "i32"), shared_mask=True),
                    rng.integers(0, g, 1 << 20).astype(np.int32), g, {}))
    return out


def _to_cuda(entries, codes, kwargs, dev):
    """CUDA copies; a numpy array used twice (a shared mask) stays one
    tensor, and kwargs["offsets"] places operands inside larger buffers."""
    offsets = kwargs.get("offsets", {})
    memo = {}  # id -> (array, tensor): the array stays alive, so ids stay unique

    def t(a, kind):
        if id(a) not in memo:
            off = offsets.get(kind, 0)
            buf = torch.zeros(len(a) + off, dtype=torch.from_numpy(a[:0]).dtype, device=dev)
            buf[off:] = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            memo[id(a)] = (a, buf[off:])
        return memo[id(a)][1]

    ents = [(k, None if v is None else t(v, "values"), t(m, "mask"), lp) for k, v, m, lp in entries]
    kw = {}
    if "mask_words" in kwargs:
        kw["mask_words"] = torch.from_numpy(kwargs["mask_words"].view(np.int32)).to(dev)
    if "code_pred" in kwargs:
        pc, lo, hi = kwargs["code_pred"]
        kw["code_pred"] = (t(pc, "pred"), lo, hi)
    if "codes_packed" in kwargs:
        w, bits = kwargs["codes_packed"]
        kw["codes_packed"] = (t(w.view(np.int32), "key"), bits)
    return ents, t(codes, "key"), kw


def _max_abs_err(got, ref) -> float:
    return max(float((a - b).abs().max()) for a, b in zip(got, ref)) if got else 0.0


def _flushes(dev):
    """Two ways to evict the L2 cache before a timed call: a 256 MiB write
    (the default; it leaves the L2 full of dirty lines, which the next
    kernel's reads first write back) and a 256 MiB read (clean lines)."""
    buf = torch.zeros(64 << 20, dtype=torch.float32, device=dev)
    return {"write": buf.zero_, "read": buf.sum}


def _time_cuda(fn, flush) -> float:
    """Median ms of TIMED_ITERS calls, each bracketed by its own CUDA events,
    with flush() called before each (a write flush, unless said)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(TIMED_ITERS):
        flush()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _device_ms(fn, flush, kernel: str):
    """Mean device ms of one launch of the kernels whose name holds
    `kernel`, over PROFILED_ITERS calls (one launch each) under
    torch.profiler (flush() before each)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_ITERS):
            flush()
            fn()
        torch.cuda.synchronize()
    total_us, calls = 0.0, 0
    for e in prof.key_averages():
        if kernel in e.key:
            us = getattr(e, "self_device_time_total", None)
            total_us += us if us is not None else getattr(e, "self_cuda_time_total", 0.0)
            calls += e.count
    # per launch captured: a session can lose events (see profile_query)
    return total_us / calls / 1e3 if calls else "not measured"


def _effective_masks(ents, kw):
    """Each entry's mask ANDed with the filter words where the call has them
    (the rows the entry really counts)."""
    from pinot_tpu_torch.ops import fused_scan

    if "mask_words" not in kw:
        return [m for _k, _v, m, _lp in ents]
    words = fused_scan.lane_unpack(kw["mask_words"], 1, int(ents[0][2].shape[0])) != 0
    return [m & words for _k, _v, m, _lp in ents]


def _bound(ents, key_in, g, kw):
    """Least time for the same work: each input byte read once (the key,
    the filter words, each distinct mask, the values where their row is
    counted), each table written once; one 64-bit add per counted row and
    entry.  bound_ms_no_true_mask leaves out the bytes of masks that are
    all true (a kernel told "all rows" would not read them)."""
    masks = list({m.data_ptr(): m for _k, _v, m, _lp in ents}.values())
    counted = [int(m.sum()) for m in _effective_masks(ents, kw)]
    words = kw["mask_words"].numel() * 4 if "mask_words" in kw else 0
    read_bytes = key_in.numel() * key_in.element_size() + words + sum(m.numel() for m in masks) + sum(
        c * v.element_size() for (_k, v, _m, _lp), c in zip(ents, counted) if v is not None)
    true_mask_bytes = sum(m.numel() for m in masks if bool(m.all()))
    write_bytes = len(ents) * g * 8
    bytes_ms = (read_bytes + write_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = sum(counted) / SCALAR_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes_moved": read_bytes + write_bytes,
            "bound_ms_no_true_mask": max((read_bytes - true_mask_bytes + write_bytes) / HBM_BYTES_PER_S * 1e3,
                                         ops_ms)}


def _key_input(ents, key, kw):
    """The key tensor the kernel reads, and its codes as int64."""
    from pinot_tpu_torch.ops import fused_scan

    if "codes_packed" in kw:
        words, bits = kw["codes_packed"]
        return words, fused_scan.lane_unpack(words, bits, int(ents[0][2].shape[0])).to(torch.int64)
    return key, key.to(torch.int64)


def _timed_shape(label, ents, key, g, kw, flush):
    """kernel_ms (the wrapper call), plain_ms, library_ms (one index_add_ per
    entry on pre-masked int64 values, never called by the port), all with
    CUDA events; host_ms (the host time of a wrapper call, from the idle
    device to its return) and the bound."""
    from pinot_tpu_torch.ops import fused_scan

    before = dict(fused_scan.VARIANT_LAUNCHES)
    kernel_ms = _time_cuda(lambda: fused_scan.fused_group_tables(ents, key, g, **kw), flush)
    variants = sorted(k for k, v in fused_scan.VARIANT_LAUNCHES.items() if v != before.get(k, 0))
    host = []
    for _ in range(TIMED_ITERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fused_scan.fused_group_tables(ents, key, g, **kw)
        host.append((time.perf_counter() - t0) * 1e3)
    host_ms = statistics.median(host)
    plain_ms = _time_cuda(lambda: fused_scan.fused_group_tables_reference(ents, key, g, **kw), flush)
    key_in, key64 = _key_input(ents, key, kw)
    zero = torch.zeros((), dtype=torch.int64, device=key64.device)
    adds = [torch.where(m, m.to(torch.int64) if k == "count" else fused_scan._entry_values(k, v, lp), zero)
            for (k, v, _m, lp), m in zip(ents, _effective_masks(ents, kw))]

    def library():
        for a in adds:
            torch.zeros(g, dtype=torch.int64, device=key64.device).index_add_(0, key64, a)

    library_ms = _time_cuda(library, flush)
    timing = {"shape": label, "variant": variants, "kernel_ms": kernel_ms, "host_ms": host_ms, "plain_ms": plain_ms,
              "library_ms": library_ms, **_bound(ents, key_in, g, kw)}
    log("kernel_timing", iters=TIMED_ITERS, bound_divisor=f"{HBM_BYTES_PER_S:.3g} B/s (H100 SXM HBM3 peak)", **timing)
    if not (kernel_ms <= library_ms):
        raise AssertionError(f"fused scan slower than its index_add_ yardstick at {label}: {timing}")
    return timing


def _timed_shapes(seed: int, dev):
    """The 6 timed shapes, each held exactly against the plain version and
    timed with CUDA events."""
    from pinot_tpu_torch.ops import fused_scan

    worst, timings = 0.0, []
    flush = _flushes(dev)["write"]
    for label, ents, key, g, kw in _shapes(seed, dev):
        got = fused_scan.fused_group_tables(ents, key, g, **kw)
        ref = fused_scan.fused_group_tables_reference(ents, key, g, **kw)
        err = _max_abs_err(got, ref)
        worst = max(worst, err)
        log("kernel_check", variant=label, max_abs_err=err)
        if err != 0.0:
            raise AssertionError(f"fused scan differs from its plain version at {label}: {err}")
        timings.append(_timed_shape(label, ents, key, g, kw, flush))
    return worst, timings


def _generic_scan(ents, key, g, kw):
    """The shape's scan through the generic shared instantiation: the
    wrapper's launch parameters with the key and value modes set to "any",
    launched straight through the library.  A comparison launch: no counter
    moves."""
    import ctypes

    from pinot_tpu_torch.ops import fused_scan

    lib = fused_scan._library()
    key_t, bits = kw["codes_packed"] if "codes_packed" in kw else (key, 0)
    p, order, _variant = fused_scan.build_params(
        ents, key_t, bits, int(ents[0][2].shape[0]), g, None, None,
        fused_scan._smem_optin(lib, torch.cuda.current_device()))
    p.key_mode = p.val_mode = 0
    out = torch.zeros((len(ents), g), dtype=torch.int64, device=key_t.device)
    err = lib.pinot_fused_scan(ctypes.byref(p), out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"generic fused scan launch failed: {lib.pinot_cuda_error_string(err).decode()}")
    return [out[j].to(torch.float64) for j in sorted(range(len(order)), key=order.__getitem__)]


def phase_kernel_profile(seed: int, dev, timings):
    """Device times from torch.profiler, after the main path (a profiler
    session leaves tracing set up in the process, which would tax the main
    path's launches): for each timed shape, rebuilt from the same seed,
    scan_ms (the kernel's own device time); the specialised instantiation
    against the generic one at the two shapes the SQL path launches; and,
    at the main path's shape, what a write flush and a read flush each
    leave a streaming read of the inputs' bytes."""
    from pinot_tpu_torch.ops import fused_scan

    flushes = _flushes(dev)
    shapes = _shapes(seed, dev)
    for timing, (label, ents, key, g, kw) in zip(timings, shapes):
        timing["scan_ms"] = _device_ms(lambda: fused_scan.fused_group_tables(ents, key, g, **kw),
                                       flushes["write"], "fused_scan_kernel")
        log("kernel_profile", shape=label, scan_ms=timing["scan_ms"], iters=PROFILED_ITERS)

    generic = {}
    for timing, (label, ents, key, g, kw) in zip(timings[1:3], shapes[1:3]):
        err = _max_abs_err(_generic_scan(ents, key, g, kw), fused_scan.fused_group_tables_reference(ents, key, g, **kw))
        if err != 0.0:
            raise AssertionError(f"the generic instantiation differs from the plain version at {label}: {err}")
        generic[label] = {"specialised": timing["variant"], "scan_ms": timing["scan_ms"], "generic_max_abs_err": err,
                          "generic_scan_ms": _device_ms(lambda: _generic_scan(ents, key, g, kw), flushes["write"],
                                                        "fused_scan_kernel")}
    log("specialised_vs_generic", iters=PROFILED_ITERS, shapes=generic)

    # the main path's inputs, read in full (every revenue sector holds a
    # masked-in row), as one buffer of the same bytes: a float32 sum reads
    # it, a device copy reads and writes it
    label, ents, key, g, kw = shapes[1]
    key_in, _ = _key_input(ents, key, kw)
    nbytes = key_in.numel() * key_in.element_size() + sum(
        x.numel() * x.element_size() for x in [ents[0][2], *[v for _k, v, _m, _lp in ents if v is not None]])
    blob = torch.zeros(nbytes // 4, dtype=torch.float32, device=dev)
    dst = torch.empty_like(blob)
    check = {"shape": label, "input_bytes": nbytes}
    for name, flush in flushes.items():
        scan_ms = _device_ms(lambda: fused_scan.fused_group_tables(ents, key, g, **kw), flush, "fused_scan_kernel")
        sum_ms = _time_cuda(blob.sum, flush)
        copy_ms = _time_cuda(lambda: dst.copy_(blob), flush)
        check[f"{name}_flush"] = {
            "scan_ms": scan_ms, "sum_ms": sum_ms, "copy_ms": copy_ms,
            "scan_TBps": nbytes / scan_ms / 1e9 if isinstance(scan_ms, float) else "not measured",
            "sum_TBps": nbytes / sum_ms / 1e9, "copy_TBps": 2 * nbytes / copy_ms / 1e9,
        }
    log("flush_check", **check)
    return generic, check


def _compile_report():
    """ptxas's registers, shared memory and spills of each instantiation, and
    the atomic instructions in the compiled kernels (cuobjdump -sass)."""
    import re
    from pathlib import Path

    from pinot_tpu_torch.ops import _build, fused_scan

    rows = []
    for r in _build.ptxas_report():
        m = re.search(r"ILi(\d+)ELi(\d+)ELb(\d)E", r["kernel"])
        name = (f"{fused_scan.KEY_MODES[int(m.group(1))]}/{fused_scan.VALUE_MODES[int(m.group(2))]}/"
                f"{'shared' if m.group(3) == '1' else 'global'}") if m else r["kernel"]
        rows.append({"variant": name, **{k: v for k, v in r.items() if k != "kernel"}})
    log("ptxas", kernels=rows)
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    objs = sorted(_build.BUILD_DIR.glob("*.o"))
    if not cuobjdump.exists() or not objs:
        log("sass_atomics", atomics="not measured (no cuobjdump or object file)")
        return
    counts = {}
    for o in objs:
        sass = subprocess.run([str(cuobjdump), "-sass", str(o)], capture_output=True, text=True, check=True).stdout
        for op in re.findall(r"\b((?:ATOMS|ATOMG|ATOM|REDG|RED)(?:\.[A-Z0-9_]+)*)", sass):
            counts[op] = counts.get(op, 0) + 1
    log("sass_atomics", atomics=counts)


def _shapes(seed: int, dev):
    """(label, entries, key, num_groups, kwargs) of the 6 timed shapes, on
    the card, made from the seed."""
    from pinot_tpu_torch.ops import segmented

    rng = np.random.default_rng(seed)
    # main-path shape: 2^23 rows, packed 16-bit key, 2406 groups, the shared
    # presence/COUNT(*) entry and SUM over int32 revenue (plan from stats)
    n, g = 1 << 23, 2406
    od = rng.integers(0, g, n).astype(np.int32)
    mask = torch.from_numpy(rng.random(n) < 0.48).to(dev)
    rev = torch.from_numpy(rng.integers(100, 1_000_000, n).astype(np.int32)).to(dev)
    words = torch.from_numpy(_pack(od, 16).view(np.int32)).to(dev)
    plan = segmented.sum_limb_plan(100, 999_999)
    main = [("count", None, mask, None), ("int_sum", rev, mask, plan)]
    # query (c)'s shape: the computed key discount * 50 + quantity - 1 as raw
    # int32 codes, 550 groups, no filter (one all-true mask)
    kc = torch.from_numpy((rng.integers(0, 11, n) * 50 + rng.integers(0, 50, n)).astype(np.int32)).to(dev)
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    qc = [("count", None, ones, None), ("int_sum", rev, ones, plan)]
    k8 = torch.from_numpy(rng.integers(0, 8, n).astype(np.int32)).to(dev)
    k8192 = torch.from_numpy(rng.integers(0, 8192, n).astype(np.int32)).to(dev)

    def col(a):
        return torch.from_numpy(a).to(dev)

    e4 = [
        ("int_sum", col(rng.integers(-120, 120, n).astype(np.int8)), col(rng.random(n) < 0.8), (1, True)),
        ("int_sum", col(rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32)), col(rng.random(n) < 0.8), (4, True)),
        ("int64_sum", col(rng.integers(-(2**39), 2**39, n).astype(np.int64)), col(rng.random(n) < 0.8), None),
        ("int_sum", col(rng.integers(100, 1_000_000, n).astype(np.int32)), col(rng.random(n) < 0.8), plan),
    ]
    # the distributed main path's launch: 2^27 rows, the packed 16-bit key,
    # the range-index words of lo_quantity < 25 (48% of rows) as mask_words,
    # the all-true entry mask (no padding, one batch) and int32 revenue
    n2 = 1 << 27
    words2 = torch.from_numpy(_pack(rng.integers(0, g, n2).astype(np.int32), 16).view(np.int32)).to(dev)
    qbits = np.packbits((rng.random(n2) < 0.48).reshape(-1, 32), axis=1, bitorder="little").view(np.int32)
    ones2 = torch.ones(n2, dtype=torch.bool, device=dev)
    rev2 = torch.from_numpy(rng.integers(100, 1_000_000, n2).astype(np.int32)).to(dev)
    dist = [("count", None, ones2, None), ("int_sum", rev2, ones2, plan)]
    # the distributed FILTER launch of query (e): the same key and words, a
    # second mask (lo_discount BETWEEN 1 AND 3) for the FILTERed SUM, and
    # SUM(lo_revenue * lo_discount) over int32 products with no range bound
    disc2 = rng.integers(0, 11, n2).astype(np.int32)
    fmask = torch.from_numpy((disc2 >= 1) & (disc2 <= 3)).to(dev)
    revdisc = rev2 * torch.from_numpy(disc2).to(dev)
    filt = [("count", None, ones2, None), ("int_sum", rev2, fmask, plan), ("int_sum", revdisc, ones2, (4, True))]
    return [
        ("dist main path: n=2^27 packed16 G=2406 E=2, mask_words, all-true mask", dist, None, g,
         {"codes_packed": (words2, 16), "mask_words": torch.from_numpy(qbits.reshape(-1)).to(dev)}),
        ("main path: n=2^23 packed16 G=2406 E=2, shared mask", main, None, g, {"codes_packed": (words, 16)}),
        ("query (c): n=2^23 int32 key G=550 E=2, all-true mask", qc, kc, 550, {}),
        ("hot slots: n=2^23 int32 key G=8 E=2, shared mask", main, k8, 8, {}),
        ("global path: n=2^23 int32 key G=8192 E=4 sums", e4, k8192, 8192, {}),
        ("dist FILTER launch: n=2^27 packed16 G=2406 E=3, mask_words, 2 masks (all-true, discount)", filt, None, g,
         {"codes_packed": (words2, 16), "mask_words": torch.from_numpy(qbits.reshape(-1)).to(dev)}),
    ]


def phase_kernels(rng, dev):
    """The variant grid, each case held exactly against the plain version;
    the worst error."""
    from pinot_tpu_torch.ops import fused_scan

    worst = 0.0
    fused_scan.VARIANT_LAUNCHES.clear()
    for label, entries, codes, g, kwargs in _variants(rng):
        ents, c, kw = _to_cuda(entries, codes, kwargs, dev)
        key = None if "codes_packed" in kw else c
        before, seen = fused_scan.LAUNCHES, dict(fused_scan.VARIANT_LAUNCHES)
        got = fused_scan.fused_group_tables(ents, key, g, **kw)
        torch.cuda.synchronize()
        launches = fused_scan.LAUNCHES - before
        ref = fused_scan.fused_group_tables_reference(ents, key, g, **kw)
        err = _max_abs_err(got, ref)
        worst = max(worst, err)
        ran = sorted(k for k, v in fused_scan.VARIANT_LAUNCHES.items() if v != seen.get(k, 0))
        log("kernel_check", variant=label, max_abs_err=err, launches=launches, instantiations=ran)
        if err != 0.0:
            raise AssertionError(f"fused scan differs from its plain version on {label}: {err}")
        if launches != -(-len(ents) // fused_scan.MAX_ENTRIES):
            raise AssertionError(f"{label}: {launches} launches for {len(ents)} entries")
    missing = set(fused_scan.INSTANTIATIONS) - set(fused_scan.VARIANT_LAUNCHES)
    if missing:
        raise AssertionError(f"the variant grid reached no launch of {sorted(missing)}")
    return worst


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
    fused_scan.VARIANT_LAUNCHES.clear()
    res_a = engine.query(CONFIG2)
    launches_a = fused_scan.LAUNCHES
    res_b = engine.query(QUERY_B)
    launches_b = fused_scan.LAUNCHES - launches_a
    res_c = engine.query(QUERY_C)
    launches_c = fused_scan.LAUNCHES - launches_a - launches_b
    torch.cuda.synchronize()
    main_launches = fused_scan.LAUNCHES
    main_variants = dict(fused_scan.VARIANT_LAUNCHES)

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
        groups_a=len(res_a.rows), instantiations=main_variants)

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
    profiles = [("main_path_profile", {"query": name}, engine, sql) for name, sql in (
        ("a_config2", CONFIG2), ("b_filtered_agg", QUERY_B), ("c_two_dim_groupby", QUERY_C))]
    return {"launches": main_launches, "variants": main_variants, "engine": engine, "datas": datas,
            "profiles": profiles}


def _profile_once(engine, sql: str) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pinot_tpu_torch.ops import fused_scan

    torch.cuda.synchronize()
    before = fused_scan.LAUNCHES
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
    out = {
        "profiled_wall_ms": wall_ms,
        "device_busy_ms": sum(r[0] for r in rows) if rows else "not measured",
        "scan_launches": {"made": fused_scan.LAUNCHES - before,
                          "captured": sum(n for _ms, n, k in rows if "fused_scan_kernel" in k)},
        "top_device_ops": [{"ms": ms, "calls": n, "name": k[:90]} for ms, n, k in rows[:8]],
    }
    if rows:
        out["device_idle_share"] = 1.0 - out["device_busy_ms"] / wall_ms
    return out


def profile_query(engine, sql: str, sessions: int = 3) -> dict:
    """Warm runs under torch.profiler, one session each: device time by
    kernel and the device's busy share of the (profiled) wall time.  On the
    card a session can lose device events (pageable host-to-device copies
    most often; after the earlier phases kernels too), never invent them.
    A session whose captured fused-scan launches fall short of the launches
    the query made is incomplete; the complete session with the most device
    time is reported, beside every session's.  With none complete, busy
    and idle are "not measured" and the most device time seen is a lower
    bound."""
    runs = [_profile_once(engine, sql) for _ in range(sessions)]
    busy = [r["device_busy_ms"] for r in runs]
    measured = [r for r in runs if isinstance(r["device_busy_ms"], float)]
    complete = [r for r in measured if r["scan_launches"]["captured"] >= r["scan_launches"]["made"]]
    if complete:
        best = max(complete, key=lambda r: r["device_busy_ms"])
        return {**best, "device_busy_ms_of_sessions": busy}
    best = max(measured, key=lambda r: r["device_busy_ms"]) if measured else runs[0]
    return {**best, "device_busy_ms": "not measured", "device_idle_share": "not measured",
            "device_busy_ms_lower_bound": best["device_busy_ms"], "device_busy_ms_of_sessions": busy}


# ---------------------------------------------------------------------------
# phase 4b: the distributed engine's main path (bench.py main()) at full size
# ---------------------------------------------------------------------------
DIST_QUERIES = {
    "a_bench": (
        "SELECT lo_orderdate, SUM(lo_revenue) FROM lineorder "
        "WHERE lo_quantity < 25 GROUP BY lo_orderdate LIMIT 2500"
    ),
    "b_filtered_agg": QUERY_B,
    "c_min_max_groupby": (
        "SELECT lo_discount, lo_quantity, COUNT(*), SUM(lo_revenue), MIN(lo_revenue), MAX(lo_revenue) "
        "FROM lineorder WHERE lo_quantity < 25 GROUP BY lo_discount, lo_quantity "
        "ORDER BY SUM(lo_revenue) DESC LIMIT 10"
    ),
    "d_sparse_groupby": (
        "SET numGroupsLimit = 2000000; SELECT lo_orderdate, lo_quantity, lo_discount, SUM(lo_revenue), "
        "COUNT(*) FROM lineorder WHERE lo_quantity < 25 GROUP BY lo_orderdate, lo_quantity, lo_discount "
        "ORDER BY SUM(lo_revenue) DESC LIMIT 100"
    ),
}
# bench.py's table size (N_ROWS = 2^27, about SSB scale factor 22), and the
# launch budget that splits it into three launches (7.5 B a row packed)
DIST_ROWS = 1 << 27
DIST_THREE_BATCH_BYTES = 384 << 20


def dist_golden(d):
    """Exact numpy results of the four distributed queries.  Group sums use
    np.bincount's float64 weights: every partial sum is an integer below
    2^53 (at most ~2.8e10 a group here), so they are exact int64 values."""
    od, q, disc, rev = d["lo_orderdate"] - 19920101, d["lo_quantity"], d["lo_discount"], d["lo_revenue"]
    m = q < 25
    odm, qm, dm, rm = od[m], q[m], disc[m], rev[m]
    a_sum = np.bincount(odm, weights=rm, minlength=2406)
    a_cnt = np.bincount(odm, minlength=2406)
    rows_a = sorted((19920101 + int(i), float(a_sum[i])) for i in np.nonzero(a_cnt)[0])
    mb = m & (disc >= 1) & (disc <= 3)
    rows_b = [(float(rev[mb].sum()), int(mb.sum()))]
    k = dm * 50 + (qm - 1)
    order_k = np.argsort(k.astype(np.int16), kind="stable")  # radix sort: k < 550
    ks, rs = k[order_k], rm[order_k]
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    groups = ks[starts]
    c_cnt = np.diff(np.r_[starts, len(ks)])
    c_sum = np.add.reduceat(rs, starts)
    c_min, c_max = np.minimum.reduceat(rs, starts), np.maximum.reduceat(rs, starts)
    top = sorted(range(len(groups)), key=lambda i: -c_sum[i])[:10]
    rows_c = [(int(groups[i] // 50), int(groups[i] % 50 + 1), int(c_cnt[i]), float(c_sum[i]), float(c_min[i]),
               float(c_max[i])) for i in top]
    key = odm.astype(np.int64) * 550 + (qm - 1) * 11 + dm
    d_sum = np.bincount(key, weights=rm, minlength=2406 * 550)
    d_cnt = np.bincount(key, minlength=2406 * 550)
    live = np.nonzero(d_cnt)[0]
    top_d = live[np.lexsort((live, -d_sum[live]))][:100]
    rows_d = [(19920101 + int(i // 550), int(i // 11 % 50 + 1), int(i % 11), float(d_sum[i]), int(d_cnt[i]))
              for i in top_d]
    return {"a_bench": rows_a, "b_filtered_agg": rows_b, "c_min_max_groupby": rows_c,
            "d_sparse_groupby": rows_d}, int(len(live))


def _dist_counted_run(engine, stacked, golden_rows):
    """The four queries once, with the counters set to 0 just before and
    read just after; checks of the rows and of the route each took."""
    from pinot_tpu_torch.ops import fused_scan, sparse_merge
    from pinot_tpu_torch.sql.parser import parse_query

    plans = {name: engine._plan(parse_query(sql), stacked) for name, sql in DIST_QUERIES.items()}
    fused_scan.LAUNCHES = fused_scan.MASK_WORDS_LAUNCHES = sparse_merge.MERGES = 0
    fused_scan.VARIANT_LAUNCHES.clear()
    per_query, rows = {}, {}
    for name, sql in DIST_QUERIES.items():
        before = (fused_scan.LAUNCHES, fused_scan.MASK_WORDS_LAUNCHES, sparse_merge.MERGES,
                  dict(fused_scan.VARIANT_LAUNCHES))
        res = engine.query(sql)
        rows[name] = res.rows
        per_query[name] = {
            "launches": fused_scan.LAUNCHES - before[0],
            "mask_words_launches": fused_scan.MASK_WORDS_LAUNCHES - before[1],
            "device_merges": sparse_merge.MERGES - before[2],
            "instantiations": {k: v - before[3].get(k, 0) for k, v in fused_scan.VARIANT_LAUNCHES.items()
                               if v != before[3].get(k, 0)},
            "batches": len(plans[name].batch_offsets),
            "kind": plans[name].kind,
            "index_uses": list(res.stats.filter_index_uses),
            "groups": res.stats.num_groups,
        }
    torch.cuda.synchronize()
    launches, variants = fused_scan.LAUNCHES, dict(fused_scan.VARIANT_LAUNCHES)

    for name, want in golden_rows.items():
        got = sorted(rows[name]) if name == "a_bench" else rows[name]
        if got != want:
            raise AssertionError(f"dist query {name} differs from the numpy golden: {got[:3]} vs {want[:3]}")
    nb = len(plans["a_bench"].batch_offsets)
    pa, pd = per_query["a_bench"], per_query["d_sparse_groupby"]
    if not (plans["a_bench"].row_sharded_params and plans["a_bench"].word_fused):
        raise AssertionError("query (a) did not take the word-fused route")
    if pa["launches"] != nb or pa["mask_words_launches"] != nb or pa["instantiations"] != {"p16/i32/shared": nb}:
        raise AssertionError(f"query (a) did not launch the fused scan once a batch with mask_words: {pa}")
    if plans["c_min_max_groupby"].word_fused or per_query["c_min_max_groupby"]["launches"] != nb:
        raise AssertionError(f"query (c) did not take the unpacked-words route: {per_query['c_min_max_groupby']}")
    if pd["kind"] != "groupby_sparse" or pd["device_merges"] != 1:
        raise AssertionError(f"query (d) did not run the device sparse merge: {pd}")
    return launches, variants, per_query, rows


def _dist_host_costs(engine, stacked, dev):
    """Host ms of the range-index words of query (a) (prefix[hi] &
    ~prefix[lo] over the flat doc space), of one plan (a plan-cache hit,
    words included), and of the words' per-batch slice and pageable copy
    to the card; medians of 5."""
    from pinot_tpu_torch.query import executor
    from pinot_tpu_torch.sql.parser import parse_query

    idx = stacked.indexes["range"]["lo_quantity"]
    hi = int(np.searchsorted(stacked.column("lo_quantity").dictionary.values, 25, side="left"))

    def med(fn):
        ts = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts)

    ctx = parse_query(DIST_QUERIES["a_bench"])
    plan = engine._plan(ctx, stacked)
    (key,) = plan.row_sharded_params
    off, fresh = plan.batch_offsets[0]
    host = engine.batch_params(plan, off, fresh)[key]
    return {
        "words_host_ms": med(lambda: idx.range_bitmap(0, hi)),
        "plan_ms": med(lambda: engine._plan(ctx, stacked)),
        "slice_ms": med(lambda: engine.batch_params(plan, off, fresh)),
        "copy_ms": med(lambda: executor._param_tensor(host, dev)),
        "words_bytes_per_batch": int(host.nbytes),
    }


def phase_dist_main_path(args, dev):
    """StackedTable.build over 2^27 rows, DistributedEngine() at one launch
    and at three; exact against numpy; the literal sweep; wall times.  The
    profiles run later (run_profiles); the table, its host data and the
    engines stay for phase transform_path."""
    from pinot_tpu_torch.parallel.engine import DistributedEngine
    from pinot_tpu_torch.parallel.stacked import StackedTable
    from pinot_tpu_torch.spi.config import IndexingConfig, TableConfig
    from pinot_tpu_torch.spi.schema import DataType, FieldRole, FieldSpec, Schema

    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed)
    n = DIST_ROWS
    data = {
        "lo_orderdate": (19920101 + rng.integers(0, 2406, n)).astype(np.int32),
        "lo_quantity": rng.integers(1, 51, n).astype(np.int32),
        "lo_discount": rng.integers(0, 11, n).astype(np.int32),
        "lo_revenue": rng.integers(100, 1_000_000, n).astype(np.int64),
    }
    schema = Schema("lineorder", [
        FieldSpec("lo_orderdate", DataType.INT),
        FieldSpec("lo_quantity", DataType.INT),
        FieldSpec("lo_discount", DataType.INT),
        FieldSpec("lo_revenue", DataType.LONG, role=FieldRole.METRIC),
    ])
    cfg = TableConfig("lineorder", indexing=IndexingConfig(range_index_columns=["lo_quantity"]))
    t1 = time.perf_counter()
    stacked = StackedTable.build(schema, data, num_shards=1, table_config=cfg)
    build_s = time.perf_counter() - t1
    want, live_groups = dist_golden(data)
    engines = {"one_batch": DistributedEngine(),
               "three_batches": DistributedEngine(launch_bytes=DIST_THREE_BATCH_BYTES)}
    for e in engines.values():
        e.register_table("lineorder", stacked)
    log("dist_setup", rows=n, docs_per_shard=stacked.docs_per_shard, build_s=build_s,
        setup_s=time.perf_counter() - t0, sparse_live_groups=live_groups)

    launches, variants, checks, rows = 0, {}, {}, {}
    for label, e in engines.items():
        nl, nv, per_query, rows[label] = _dist_counted_run(e, stacked, want)
        launches += nl
        for k, v in nv.items():
            variants[k] = variants.get(k, 0) + v
        checks[label] = per_query
    if rows["one_batch"] != rows["three_batches"]:
        raise AssertionError("the three-launch rows differ from the one-launch rows")
    nb3 = checks["three_batches"]["a_bench"]["batches"]
    if checks["one_batch"]["a_bench"]["batches"] != 1 or nb3 != 3:
        raise AssertionError(f"batches: {checks['one_batch']['a_bench']['batches']} and {nb3}, want 1 and 3")
    log("dist_check", exact=True, launches=launches, instantiations=variants, per_query=checks)

    # the literal sweep of bench.py: one plan, 19 cache hits
    sweep = DistributedEngine()
    sweep.register_table("lineorder", stacked)
    for i in range(20):
        sweep.query("SELECT lo_orderdate, SUM(lo_revenue) FROM lineorder "
                    f"WHERE lo_quantity < {5 + (i % 40)} GROUP BY lo_orderdate LIMIT 2500")
    if (sweep.plan_misses, sweep.plan_hits) != (1, 19):
        raise AssertionError(f"literal sweep planned {sweep.plan_misses} times ({sweep.plan_hits} hits)")
    log("dist_sweep", queries=20, plan_misses=sweep.plan_misses, plan_hits=sweep.plan_hits)

    torch.cuda.reset_peak_memory_stats()
    timings = {}
    for label, e in engines.items():
        for name, sql in DIST_QUERIES.items():
            ms = []
            for _ in range(5):
                s = time.perf_counter()
                e.query(sql)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - s) * 1e3)
            med = statistics.median(ms)
            timings[f"{label}/{name}"] = {"median_ms": med, "rows_per_s": n / (med / 1e3), "runs_ms": ms}
    log("dist_timing", rows=n, max_memory_allocated=torch.cuda.max_memory_allocated(), **timings)
    log("dist_host_costs", **_dist_host_costs(engines["one_batch"], stacked, dev))
    profiles = [("dist_profile", {"engine": label, "query": name}, e, sql)
                for label, e in engines.items() for name, sql in DIST_QUERIES.items()]
    return {"launches": launches, "variants": variants, "engines": engines, "stacked": stacked, "data": data,
            "profiles": profiles}


# ---------------------------------------------------------------------------
# phase 4c: transforms, FILTER (WHERE ...), CASE, selections and windows on
# the tables phases 4 and 4b built
# ---------------------------------------------------------------------------
TRANSFORM_QUERIES = {
    "e_filter_groupby": (
        "SELECT lo_orderdate, COUNT(*), SUM(lo_revenue) FILTER (WHERE lo_discount BETWEEN 1 AND 3), "
        "SUM(lo_revenue * lo_discount) FROM lineorder WHERE lo_quantity < 25 GROUP BY lo_orderdate LIMIT 2500"
    ),
    # SSB Q1.1 on this flat table (it has no lo_extendedprice)
    "f_q1_1_analog": (
        "SELECT SUM(lo_revenue * lo_discount) FROM lineorder "
        "WHERE lo_discount BETWEEN 1 AND 3 AND lo_quantity < 25"
    ),
    "g_computed_key": (
        "SELECT MOD(lo_orderdate, 100), COUNT(*), SUM(CASE WHEN lo_discount > 5 THEN lo_revenue ELSE 0 END) "
        "FROM lineorder WHERE lo_quantity < 25 GROUP BY MOD(lo_orderdate, 100) "
        "ORDER BY MOD(lo_orderdate, 100) LIMIT 100"
    ),
    "h_selection_top": (
        "SELECT lo_orderdate, lo_quantity, lo_discount, lo_revenue FROM lineorder "
        "WHERE lo_quantity = 1 AND lo_discount = 0 ORDER BY lo_revenue DESC, lo_orderdate LIMIT 100"
    ),
    "i_selection_expr": (
        "SELECT lo_orderdate, lo_revenue * lo_discount FROM lineorder WHERE lo_quantity = 1 "
        "ORDER BY lo_orderdate, lo_revenue LIMIT 50 OFFSET 10"
    ),
    "j_windows": (
        "SELECT lo_orderdate, lo_revenue, RANK() OVER (PARTITION BY lo_orderdate ORDER BY lo_revenue DESC), "
        "SUM(lo_revenue) OVER (PARTITION BY lo_orderdate) FROM lineorder "
        "WHERE lo_quantity = 1 AND lo_discount = 0 AND lo_revenue > 990000 LIMIT 5000"
    ),
}
# the distributed engine refuses these, as the JAX package's does
TRANSFORM_SEGMENT_ONLY = ("i_selection_expr", "j_windows")
# (instantiation, distinct masks) of every scan launch a query must make
TRANSFORM_SCANS = {"e_filter_groupby": ("p16/i32/shared", 2), "g_computed_key": ("i32/i32/shared", 1)}


def _ordered_expect(keys: np.ndarray, rows: list, offset: int, limit: int):
    """The golden of an ORDER BY ... LIMIT/OFFSET selection whose order key
    may tie: (the window's keys, {key: Counter of every matched row with
    that key}).  keys: [n, k] sort keys of every matched row in the golden's
    stable order; rows the output rows in the same order."""
    from collections import Counter

    lo, hi = offset, min(offset + limit, len(rows))
    if hi <= lo:
        return [], {}
    first, last = lo, hi - 1
    while first > 0 and (keys[first - 1] == keys[lo]).all():
        first -= 1
    while last + 1 < len(rows) and (keys[last + 1] == keys[hi - 1]).all():
        last += 1
    cand = {}
    for j in range(first, last + 1):
        cand.setdefault(tuple(keys[j].tolist()), Counter())[rows[j]] += 1
    return [tuple(keys[j].tolist()) for j in range(lo, hi)], cand


def _ordered_exact(got: list, expect) -> bool:
    """Rows in ORDER BY order: each run of the golden's tied keys holds, in
    the port's rows at those positions, a sub-multiset of the matched rows
    with that key (the rows of the last tie group compare as a set)."""
    from collections import Counter

    window, cand = expect
    if len(got) != len(window):
        return False
    groups = {}
    for pos, key in enumerate(window):
        groups.setdefault(key, []).append(pos)
    for key, positions in groups.items():
        have = Counter(got[p] for p in positions)
        if any(n > cand[key][r] for r, n in have.items()):
            return False
    return True


def transform_golden(d, segment_only: bool):
    """Numpy goldens of TRANSFORM_QUERIES over the host columns `d` (rows in
    the engine's doc order).  Group sums use np.bincount's float64 weights:
    every partial sum is an integer below 2^53 (at most ~3e11 a group
    here), so they are exact; the scalar sum is int64."""
    od, q, disc, rev = (np.asarray(d[k]) for k in ("lo_orderdate", "lo_quantity", "lo_discount", "lo_revenue"))
    rev = rev.astype(np.int64)
    disc64 = disc.astype(np.int64)
    out = {}
    m = q < 25
    k = (od[m] - 19920101).astype(np.int64)
    rm, dm = rev[m], disc64[m]
    cnt = np.bincount(k, minlength=2406)
    fm = (dm >= 1) & (dm <= 3)
    fcnt = np.bincount(k[fm], minlength=2406)  # a SUM over no FILTER rows is NULL
    s1 = np.bincount(k, weights=np.where(fm, rm, 0), minlength=2406)
    s2 = np.bincount(k, weights=rm * dm, minlength=2406)
    out["e_filter_groupby"] = sorted(
        (19920101 + int(i), int(cnt[i]), float(s1[i]) if fcnt[i] else None, float(s2[i]))
        for i in np.nonzero(cnt)[0])
    mb = m & (disc64 >= 1) & (disc64 <= 3)
    out["f_q1_1_analog"] = [(float(int((rev[mb] * disc64[mb]).sum())),)]
    km = od[m].astype(np.int64) % 100
    gc = np.bincount(km, minlength=100)
    gs = np.bincount(km, weights=np.where(dm > 5, rm, 0), minlength=100)
    out["g_computed_key"] = [(int(i), int(gc[i]), float(gs[i])) for i in range(100) if gc[i]]
    ih = np.nonzero((q == 1) & (disc64 == 0))[0]
    oh = ih[np.lexsort((od[ih], -rev[ih]))][: 100 + 4096]  # every row a tie at the end can reach
    out["h_selection_top"] = _ordered_expect(
        np.stack([-rev[oh], od[oh].astype(np.int64)], 1),
        [(int(a), 1, 0, int(b)) for a, b in zip(od[oh], rev[oh])], 0, 100)
    if segment_only:
        ii = np.nonzero(q == 1)[0]
        oi = ii[np.lexsort((rev[ii], od[ii]))]
        head = oi[: 60 + 4096]  # every row a tie at the window's end can reach
        out["i_selection_expr"] = _ordered_expect(
            np.stack([od[head].astype(np.int64), rev[head]], 1),
            [(int(a), int(b) * int(c)) for a, b, c in zip(od[head], rev[head], disc64[head])], 10, 50)
        ij = np.nonzero((q == 1) & (disc64 == 0) & (rev > 990000))[0]
        by_date = {}
        for j in ij:
            by_date.setdefault(int(od[j]), []).append(int(rev[j]))
        out["j_windows"] = [
            (int(od[j]), int(rev[j]), 1 + sum(r > int(rev[j]) for r in by_date[int(od[j])]),
             float(sum(by_date[int(od[j])])))
            for j in ij
        ][:5000]
    return out


def _transform_exact(name: str, got_rows, want) -> bool:
    if name in ("h_selection_top", "i_selection_expr"):
        return _ordered_exact(list(got_rows), want)
    if name == "e_filter_groupby":
        return sorted(got_rows) == want
    return list(got_rows) == want


def _transform_counted_run(engine, names, golden, kind: str, plans=None):
    """Each query once, with the scan counters set to 0 just before and read
    just after the run (a spy on fused_scan.build_params, which only a
    launch calls on the SQL path, records each launch's distinct masks);
    the rows held against the golden and the route checked."""
    from pinot_tpu_torch.ops import fused_scan

    real = fused_scan.build_params
    seen = []

    def spy(*a, **k):
        p, order, variant = real(*a, **k)
        seen.append((variant, int(p.num_masks), bool(p.mask_words)))
        return p, order, variant

    fused_scan.build_params = spy
    try:
        fused_scan.LAUNCHES = fused_scan.MASK_WORDS_LAUNCHES = 0
        fused_scan.VARIANT_LAUNCHES.clear()
        out = {}
        for name in names:
            before = (fused_scan.LAUNCHES, fused_scan.MASK_WORDS_LAUNCHES, len(seen),
                      dict(fused_scan.VARIANT_LAUNCHES))
            res = engine.query(TRANSFORM_QUERIES[name])
            torch.cuda.synchronize()
            launched = seen[before[2]:]
            out[name] = {
                "launches": fused_scan.LAUNCHES - before[0],
                "mask_words_launches": fused_scan.MASK_WORDS_LAUNCHES - before[1],
                "instantiations": {k: v - before[3].get(k, 0) for k, v in fused_scan.VARIANT_LAUNCHES.items()
                                   if v != before[3].get(k, 0)},
                "masks_per_launch": [m for _v, m, _w in launched],
                "bytes_to_host": res.stats.bytes_to_host,
                "rows": len(res.rows),
                "exact": _transform_exact(name, res.rows, golden[name]),
            }
        launches, variants = fused_scan.LAUNCHES, dict(fused_scan.VARIANT_LAUNCHES)
    finally:
        fused_scan.build_params = real
    for name, r in out.items():
        if not r["exact"]:
            raise AssertionError(f"{kind} query {name} differs from the numpy golden")
        expected = TRANSFORM_SCANS.get(name)
        per_launch = len(plans[name].batch_offsets) if plans is not None else len(engine.tables["lineorder"].segments)
        want_launches = per_launch if expected else 0
        if r["launches"] != want_launches:
            raise AssertionError(f"{kind} query {name}: {r['launches']} scan launches, want {want_launches}: {r}")
        if expected and (r["instantiations"] != {expected[0]: want_launches}
                         or set(r["masks_per_launch"]) != {expected[1]}):
            raise AssertionError(f"{kind} query {name} did not launch {expected}: {r}")
        if expected and plans is not None and (not plans[name].word_fused or r["mask_words_launches"] != want_launches):
            raise AssertionError(f"{kind} query {name} did not read the filter words in every launch: {r}")
        if name.startswith(("h_", "i_")) and not r["bytes_to_host"]:
            raise AssertionError(f"{kind} selection {name} copied no doc ids home: {r}")
    return launches, variants, out


def _wall_ms(engine, sql: str) -> dict:
    ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        engine.query(sql)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"median_ms": statistics.median(ms), "runs_ms": ms}


def phase_transform_path(seg, dist):
    """(e)-(j) on the segment engine's 8 x 2^23 rows and (e)-(h) on the
    distributed engine's 2^27-row table at one launch and at three: each
    query once counted and held against its numpy golden, then warm wall
    times.  Returns the launches, the instantiations, each query's record
    and the profiles to run."""
    from pinot_tpu_torch.sql.parser import parse_query

    t0 = time.perf_counter()
    seg_cols = {k: np.concatenate([d[k] for d in seg["datas"]]) for k in seg["datas"][0]}
    seg_golden = transform_golden(seg_cols, segment_only=True)
    del seg_cols
    dist_golden_rows = transform_golden(dist["data"], segment_only=False)
    log("transform_setup", golden_s=time.perf_counter() - t0)

    records, launches, by_path, variants, profiles = {}, 0, {}, {}, []
    runs = [("segment_engine", seg["engine"], list(TRANSFORM_QUERIES), seg_golden, None)]
    for label, e in dist["engines"].items():
        names = [n for n in TRANSFORM_QUERIES if n not in TRANSFORM_SEGMENT_ONLY]
        plans = {n: e._plan(parse_query(TRANSFORM_QUERIES[n]), dist["stacked"]) for n in names}
        runs.append((f"dist_{label}", e, names, dist_golden_rows, plans))
        for n in TRANSFORM_SEGMENT_ONLY:
            try:
                e.query(TRANSFORM_QUERIES[n])
            except NotImplementedError as err:
                records[f"dist_{label}/{n}"] = {"refused": str(err)}
            else:
                raise AssertionError(f"the distributed engine answered {n}, which the JAX package refuses")
    for label, e, names, golden_rows, plans in runs:
        nl, nv, per_query = _transform_counted_run(e, names, golden_rows, label, plans)
        launches += nl
        by_path[label] = nl
        for k, v in nv.items():
            variants[k] = variants.get(k, 0) + v
        for name, r in per_query.items():
            if plans is not None:
                r["batches"] = len(plans[name].batch_offsets)
            records[f"{label}/{name}"] = r
    for label, e, names, _g, _p in runs:
        for name in names:
            records[f"{label}/{name}"].update(_wall_ms(e, TRANSFORM_QUERIES[name]))
            profiles.append(("transform_profile", {"engine": label, "query": name}, e, TRANSFORM_QUERIES[name]))
    log("transform_check", exact=True, launches=launches, launches_by_engine=by_path, instantiations=variants)
    return {"launches": launches, "variants": variants, "records": records, "profiles": profiles}


def run_profiles(tasks) -> dict:
    """Every profile the query phases asked for, after all their wall
    timings (a torch.profiler session leaves tracing set up in the process);
    one log line each, and the results by (phase, engine, query)."""
    out = {}
    for phase, labels, engine, sql in tasks:
        prof = profile_query(engine, sql)
        log(phase, **labels, **prof)
        out[(phase, labels.get("engine"), labels["query"])] = prof
    return out



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
    _compile_report()

    # 3. kernels vs plain versions
    worst = phase_kernels(np.random.default_rng(args.seed), dev)
    shape_worst, timings = _timed_shapes(args.seed + 1, dev)
    worst = max(worst, shape_worst)
    timing = timings[0]  # the distributed main path's shape
    seg_timing = timings[1]  # the segment main path's shape (the single numbers up to slice 2)

    # 4. main paths: the segment engine's, the distributed engine's, then
    # the transform path over the tables they built; their profiles after
    # all their wall timings
    seg = phase_main_path(args, dev)
    dist = phase_dist_main_path(args, dev)
    transform = phase_transform_path(seg, dist)
    main_variants = dict(seg["variants"])
    for part in (dist, transform):
        for k, v in part["variants"].items():
            main_variants[k] = main_variants.get(k, 0) + v
    sse_launches, dist_launches, transform_launches = seg["launches"], dist["launches"], transform["launches"]
    main_launches = sse_launches + dist_launches + transform_launches
    profiles = run_profiles(seg["profiles"] + dist["profiles"] + transform["profiles"])
    for key, rec in transform["records"].items():
        engine, _, query = key.partition("/")
        prof = profiles.get(("transform_profile", engine, query), {})
        log("transform_path", engine=engine, query=query, **rec,
            device_busy_ms=prof.get("device_busy_ms", "not run"), device_idle_share=prof.get("device_idle_share",
                                                                                             "not run"))
    dist["stacked"].release_device()
    del seg, dist, transform
    torch.cuda.empty_cache()

    # 5. profile
    generic, flush_check = phase_kernel_profile(args.seed + 1, dev, timings)

    # 6. summary
    kernels = [{
        "name": "fused_scan",
        "route": "cuda",
        "source": "pinot_tpu_torch/ops/csrc/fused_scan.cu",
        "replaces": "pinot_tpu/ops/pallas_scan.py:146",
        "replaces_function": "fused_group_tables_pallas",
        "exact": worst == 0.0,
        "launches": main_launches,
        "launches_on_main_path": main_launches,
        "launches_by_path": {"segment_engine": sse_launches, "distributed_engine": dist_launches,
                             "transform_path": transform_launches},
        "max_abs_err": worst,
        "shape": timing["shape"],
        "ms": timing["kernel_ms"],
        "kernel_ms": timing["kernel_ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
        "scan_ms": timing["scan_ms"],
        "segment_path_shape": {k: seg_timing[k] for k in (
            "shape", "kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "scan_ms")},
        "filter_launch_shape": {k: timings[5][k] for k in (
            "shape", "kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "scan_ms")},
        "instantiations_on_main_path": main_variants,
        "shapes": timings,
        "specialised_vs_generic": generic,
        "flush_check": flush_check,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
