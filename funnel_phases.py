#!/usr/bin/env python3
"""Where the ordered funnel's row scan spends its time, phase by phase, on one card.

    python3 funnel_phases.py [--seed 42]

Builds a copy of ops/csrc/funnel_scan.cu into build/funnel_phases/ with one
clock read by each block's first thread at every barrier between the
kernel's phases (stage the span, find the runs, rank the rows, move them,
walk the short runs, walk the runs ordered by prepare), summed over the
blocks with atomics.  It launches the copy on the operands prepare gives for
query (n) of chip_smoke.py over the stacked table's 2^27 rows and over one
segment's 2^23 rows (the same generator and seed), checks its table against
the kernel's, and prints one JSON line a shape: each phase's share of the
block cycles and the mean cycles a block.  The clock reads and the atomics
cost a little; the shares, not the times, are the result.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "pinot_tpu_torch" / "ops" / "csrc" / "funnel_scan.cu"
OUT = ROOT / "build" / "funnel_phases"
PHASES = ("stage", "runs", "rank", "move", "walk", "long")


def instrumented_source() -> str:
    """funnel_scan.cu with a clock sum at each phase boundary."""
    s = SRC.read_text()

    def swap(marker: str, new: str) -> None:
        nonlocal s
        if s.count(marker) != 1:
            raise RuntimeError(f"funnel_scan.cu no longer has one {marker!r}: update funnel_phases.py")
        s = s.replace(marker, new)

    swap("namespace {\n", "__device__ unsigned long long g_phase_cycles[8];\nnamespace {\n")
    swap("  if (tid == 0) n_long = 0;\n",
         "  if (tid == 0) n_long = 0;\n  long long t_clk = clock64();\n"
         "#define PHASE(k) if (tid == 0) { const long long t_ = clock64(); "
         "atomicAdd(&g_phase_cycles[k], (unsigned long long)(t_ - t_clk)); t_clk = t_; }\n")
    keyed = "  const bool keyed = __syncthreads_and(whole) && hi_t - lo_t < FUNNEL_KEY_SPAN;\n"
    swap(keyed, keyed + "  PHASE(0)\n")
    for k, step in ((1, "3"), (2, "4"), (3, "5")):
        swap(f"  __syncthreads();\n\n  // {step}.", f"  __syncthreads();\n  PHASE({k})\n\n  // {step}.")
    six = "  // 6. the runs the wrapper ordered"
    swap(six, "  __syncthreads();\n  PHASE(4)\n" + six)
    end = "    if (tid == 0) out[run_keys[r]] = track ? best : w.live();\n  }\n}"
    swap(end, end[:-1] + "  PHASE(5)\n}")
    return s + """
extern "C" int pinot_funnel_phase_cycles(unsigned long long* host, int reset) {
  if (reset) {
    unsigned long long zero[8] = {0};
    return (int)cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
  }
  return (int)cudaMemcpyFromSymbol(host, g_phase_cycles, sizeof(unsigned long long) * 8);
}
"""


def build():
    from pinot_tpu_torch.ops import _build

    OUT.mkdir(parents=True, exist_ok=True)
    src, lib = OUT / "funnel_phases.cu", OUT / "libfunnel_phases.so"
    src.write_text(instrumented_source())
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", str(src), "-o", str(lib)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}")
    so = ctypes.CDLL(str(lib))
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    so.pinot_funnel_scan.argtypes = [vp, vp, vp, vp, vp, ll, ll, ll, ctypes.c_int, ll, ctypes.c_double, vp, vp, vp]
    so.pinot_funnel_scan.restype = ctypes.c_int
    so.pinot_funnel_window_rows.restype = ll
    so.pinot_funnel_phase_cycles.argtypes = [vp, ctypes.c_int]
    so.pinot_funnel_phase_cycles.restype = ctypes.c_int
    return so


def phases(so, label: str, inputs, window: float) -> dict:
    from pinot_tpu_torch.ops import funnel_scan

    prep = funnel_scan.prepare(*inputs)
    run_keys, ts_k, flags_k, starts, counts, ordered_above = prep
    num_steps, cells = len(inputs[1]), inputs[4]
    dev = ts_k.device
    out = torch.zeros(cells, dtype=torch.int32, device=dev)
    rows = int(ts_k.shape[0])
    tiles = -(-rows // int(so.pinot_funnel_window_rows()))
    tile_first = torch.empty(tiles + 1, dtype=torch.int64, device=dev)
    so.pinot_funnel_phase_cycles(None, 1)
    torch.cuda.synchronize()
    err = so.pinot_funnel_scan(run_keys.data_ptr(), ts_k.data_ptr(), flags_k.data_ptr(), starts.data_ptr(),
                               counts.data_ptr(), int(starts.shape[0]), rows, ordered_above, num_steps, cells,
                               window, tile_first.data_ptr(), out.data_ptr(),
                               torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    if err:
        raise RuntimeError(f"the instrumented scan failed: error {err}")
    cycles = (ctypes.c_ulonglong * 8)()
    so.pinot_funnel_phase_cycles(ctypes.cast(cycles, ctypes.c_void_p), 0)
    want = funnel_scan.scan_runs(*prep, num_steps, cells, window)
    if not bool(torch.equal(out, want)):
        raise AssertionError(f"the instrumented scan differs from the kernel at {label}")
    total = sum(cycles[: len(PHASES)])
    return {"shape": label, "rows": rows, "runs": int(starts.shape[0]), "tiles": tiles,
            "cycles_a_block": total / tiles, "share": {p: cycles[i] / total for i, p in enumerate(PHASES)}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("funnel_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    dev = torch.device("cuda")
    print(cs.nvidia_smi_line(), flush=True)
    so = build()
    for label, n in (("query (n) on the stacked table", 1 << 27), ("query (n) on one segment", 1 << 23)):
        rng = np.random.default_rng(args.seed)
        d = {  # the column order of chip_smoke.py phase 4b's generator
            "lo_orderdate": (19920101 + rng.integers(0, 2406, n)).astype(np.int32),
            "lo_quantity": rng.integers(1, 51, n).astype(np.int32),
            "lo_discount": rng.integers(0, 11, n).astype(np.int32),
            "lo_revenue": rng.integers(100, 1_000_000, n).astype(np.int64),
        }
        print(json.dumps(phases(so, label, cs._funnel_query_inputs(d, dev), cs.FUNNEL_WINDOW)), flush=True)
        del d
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
