#!/usr/bin/env python3
"""Where the fused scan's member-axis launch spends its time, on one card.

    python3 member_phases.py [--seed 47]

Builds a copy of ops/csrc/fused_scan.cu into build/member_phases/ with one
clock read by each block's first thread at the barriers of a member group's
scan (its tables zeroed, its rows scanned, its tables flushed into the
global ones), summed over the blocks with atomics.  Then, on the member-axis
shapes of chip_smoke.py phase 3 (the same generator and seed):

- the member-axis variant grid and each shape's vmapped call, exact against
  the plain version member by member, and timed as phase 3 times them;
- each shape's device ms (torch.profiler, a launch's own events; and CUDA
  events around a bare launch of the vmap rule's own ScanBatch), the copy's
  tables equal to the kernel's, each phase's share of the block cycles and
  the flush's ms (its share of the bare launch);
- what binds once the shared streams are read once: the code-range and
  (q4) shapes with their first W = 1, 2, 4, 8 members in one launch (one
  group), a bare launch's ms beside the bytes those members need and the
  shared-memory adds they make.  Time that grows with W at a fixed number
  of shared bytes is the adds';
- what an add costs: copies of the kernel whose member path adds a sum's
  low word without reading the returned value (no carries), or makes no
  adds at all (each add folded into a register kept live), timed on the
  W = 8 shapes beside the kernel.  Their tables are wrong by design; they
  only split the time.

Prints one JSON line a result.  The clock reads and their atomics cost a
little; the shares, not the copy's times, are the result.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "pinot_tpu_torch" / "ops" / "csrc" / "fused_scan.cu"
OUT = ROOT / "build" / "member_phases"
PHASES = ("zero", "scan", "flush")
SWEEP_WIDTHS = (1, 2, 4, 8)
# the member path's three add sites, and what each timing-only variant puts there
_COUNT_ADD = "          for (int i = 0; i < PINOT_HALF; ++i) red_shared_if(t + c4[i], 1u, bits & (1u << i));\n"
_LOW_ADD = ("        for (int i = 0; i < PINOT_HALF; ++i) old[i] = atom_shared_if(lo + c4[i], vlo[i], "
            "bits & (1u << i));\n")
_HIGH_ADD = "            red_shared_if(hi + c4[i], h, (bits >> i) & 1u & (uint32_t)(h != 0u));\n"
VARIANTS = {
    "sums_without_returns": {_LOW_ADD: _LOW_ADD.replace("old[i] = atom_shared_if(", "old[i] = 0u, red_shared_if(")},
    "no_adds": {_COUNT_ADD: "          for (int i = 0; i < PINOT_HALF; ++i) sink += c4[i] & (0u - ((bits >> i) & 1u));\n",
                _LOW_ADD: ("        for (int i = 0; i < PINOT_HALF; ++i) old[i] = 0u, sink += vlo[i] & "
                           "(0u - ((bits >> i) & 1u));\n"),
                _HIGH_ADD: "            sink += h;\n"},
}


def instrumented_source() -> str:
    """fused_scan.cu with a clock sum at each barrier of scan_rows_members."""
    s = SRC.read_text()

    def swap(marker: str, new: str) -> None:
        nonlocal s
        if s.count(marker) != 1:
            raise RuntimeError(f"fused_scan.cu no longer has one {marker!r}: update member_phases.py")
        s = s.replace(marker, new)

    zero = "  for (int i = threadIdx.x; i < ng * stride; i += blockDim.x) smem[i] = 0u;\n  __syncthreads();\n"
    swap(zero, "  long long t_clk = clock64();\n"
         "#define PHASE(k) if (threadIdx.x == 0) { const long long t_ = clock64(); "
         "atomicAdd(&g_phase_cycles[k], (unsigned long long)(t_ - t_clk)); t_clk = t_; }\n"
         + zero + "  PHASE(0)\n")
    swap("  __syncthreads();\n  const int G = p0.num_groups;\n  const int EG",
         "  __syncthreads();\n  PHASE(1)\n  const int G = p0.num_groups;\n  const int EG")
    end = "    if (v != 0ull) atomicAdd(out + (int64_t)(w0 + w) * out_stride + (int64_t)e * G + g, (unsigned long long)v);\n  }\n}"
    swap(end, end[:-1] + "  __syncthreads();\n  PHASE(2)\n  if (threadIdx.x == 0) atomicAdd(&g_phase_cycles[7], 1ull);\n}")
    swap("struct BatchHeader {", "__device__ unsigned long long g_phase_cycles[8];\n\nstruct BatchHeader {")
    return s + """
extern "C" int pinot_member_phase_cycles(unsigned long long* host, int reset) {
  if (reset) {
    unsigned long long zero[8] = {0};
    return (int)cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
  }
  return (int)cudaMemcpyFromSymbol(host, g_phase_cycles, sizeof(unsigned long long) * 8);
}
"""


def variant_source(name: str) -> str:
    """The clocked copy with one timing-only change at the member path's adds."""
    s = instrumented_source()
    if name == "no_adds":
        head = "  const ScanParams& p0 = b.m[w0];\n  const uint32_t sh = b.h.shared;\n  // 1. each member's words"
        tail = "      }\n    }\n  }\n}\n\n// a tile's two half tiles"
        for marker in (head, tail):
            if s.count(marker) != 1:
                raise RuntimeError(f"fused_scan.cu no longer has one {marker!r}: update member_phases.py")
        s = s.replace(head, "  uint32_t sink = 0;\n" + head)
        s = s.replace(tail, tail.replace("  }\n}\n\n//", "  }\n  if (sink == 0xFFFFFFFFu) smem[0] = sink;\n}\n\n//"))
    for old, new in VARIANTS[name].items():  # whole lines
        if s.count("\n" + old) != 1:
            raise RuntimeError(f"fused_scan.cu no longer has one {old!r}: update member_phases.py")
        s = s.replace("\n" + old, "\n" + new)
    return s


class Build:
    """The copy's nvcc, started at once and waited for at load()."""

    def __init__(self, name: str = "member_phases", source=None):
        from pinot_tpu_torch.ops import _build

        OUT.mkdir(parents=True, exist_ok=True)
        self.src, self.lib = OUT / f"{name}.cu", OUT / f"lib{name}.so"
        self.src.write_text(source if source is not None else instrumented_source())
        self.proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", str(self.src), "-o",
                                      str(self.lib)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.so = None

    def load(self):
        if self.so is None:
            out, _ = self.proc.communicate()
            if self.proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on the clocked copy:\n{out}")
            so = ctypes.CDLL(str(self.lib))
            vp = ctypes.c_void_p
            so.pinot_fused_scan_batch.argtypes = [vp, vp, vp]
            so.pinot_fused_scan_batch.restype = ctypes.c_int
            so.pinot_member_phase_cycles.argtypes = [vp, ctypes.c_int]
            so.pinot_member_phase_cycles.restype = ctypes.c_int
            self.so = so
        return self.so


def clock_phases(so, batch, shape, device) -> dict:
    """One launch of the clocked copy on a ScanBatch (fused_scan.vmap_batch):
    its int64 tables and each phase's share of the block cycles."""
    out = torch.zeros(shape, dtype=torch.int64, device=device)
    torch.cuda.synchronize()
    if so.pinot_member_phase_cycles(None, 1):
        raise RuntimeError("could not reset the phase clocks")
    err = so.pinot_fused_scan_batch(ctypes.byref(batch), out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    if err:
        raise RuntimeError(f"the clocked member-axis launch failed: error {err}")
    cycles = (ctypes.c_ulonglong * 8)()
    so.pinot_member_phase_cycles(ctypes.cast(cycles, ctypes.c_void_p), 0)
    total = sum(cycles[: len(PHASES)])
    blocks = cycles[7]
    return {"tables": out, "blocks": blocks, "cycles_a_block": total / blocks if blocks else "not measured",
            "share": {p: cycles[i] / total if total else "not measured" for i, p in enumerate(PHASES)}}


def flush_shares(cs, shapes, dev, timings, so) -> None:
    """Each shape's clocked launch on the vmap rule's ScanBatch: its tables
    equal to the kernel's, each phase's share of the block cycles, and
    flush_ms, the flush's share of the bare launch's launch_ms."""
    for timing, (label, _W, _g, _members, batched, _layout) in zip(timings, shapes):
        launch, out, _layout = cs._bare_member_launch(batched)
        launch()
        ph = clock_phases(so, launch.batch, tuple(out.shape), dev)
        if not bool(torch.equal(ph["tables"], out)):
            raise AssertionError(f"the clocked copy's tables differ from the kernel's at {label}")
        timing["phase_share"], timing["cycles_a_block"] = ph["share"], ph["cycles_a_block"]
        timing["flush_ms"] = (ph["share"]["flush"] * timing["launch_ms"]
                              if isinstance(ph["share"]["flush"], float) else "not measured")


def sweep(cs, shapes, dev) -> list:
    """The code-range and (q4) shapes with their first W members in one
    launch: a bare launch's ms (CUDA events, L2 flushed) beside the bytes
    and the adds of those W members."""
    flush = cs._flushes(dev)["write"]
    rows = []
    for label, _W, g, members, batched, _layout in shapes:
        if not label.startswith("dist batch"):
            continue
        for W in SWEEP_WIDTHS:
            launch, _out, layout = cs._bare_member_launch(batched, W)
            ms = cs._time_cuda(launch, flush)
            bound = cs._member_bound(W, g, members)
            rows.append({"shape": label, "members": W, "group": layout.group, "launch_ms": ms,
                         "bytes": bound["bytes_moved"], "adds": bound["adds"], "bound_ms": bound["bound_ms"],
                         "bytes_rate_TBps": bound["bytes_moved"] / ms / 1e9,
                         "adds_a_ns": bound["adds"] / ms / 1e6})
            print(json.dumps({"member_sweep": rows[-1]}), flush=True)
    return rows


def variants(cs, shapes, dev, builds) -> list:
    """Each W = 8 shape's bare launch through the kernel and each
    timing-only variant, in turns (kernel, variants, variants, kernel)."""
    flush = cs._flushes(dev)["write"]
    rows = []
    for label, W, _g, _members, batched, _layout in shapes:
        libs = {"kernel": None, **{n: b.load() for n, b in builds.items()}}
        launches = {n: cs._bare_member_launch(batched, lib=so)[0] for n, so in libs.items()}
        ms = {n: [] for n in libs}
        for order in (list(libs), list(libs)[::-1]):
            for n in order:
                ms[n].append(cs._time_cuda(launches[n], flush))
        rows.append({"shape": label, "members": W, **{f"{n}_ms": sum(v) / len(v) for n, v in ms.items()}})
        print(json.dumps({"member_variants": rows[-1]}), flush=True)
    return rows


def sass(kernel_substring: str) -> None:
    """The SASS of the member-axis kernels whose name holds the substring,
    into build/member_phases/ (cuobjdump), and its atomics and local-memory
    instructions counted."""
    import re

    from pinot_tpu_torch.ops import _build

    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    obj = _build.BUILD_DIR / "fused_scan.o"
    if not cuobjdump.exists() or not obj.exists():
        print(json.dumps({"sass": "not measured (no cuobjdump or object file)"}), flush=True)
        return
    text = subprocess.run([str(cuobjdump), "-sass", str(obj)], capture_output=True, text=True, check=True).stdout
    funcs = re.split(r"\n\s*Function : ", text)
    keep = [f for f in funcs if kernel_substring in f.split("\n", 1)[0]]
    out = OUT / "member_sass.txt"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("\n\nFunction : ".join(keep))
    for f in keep:
        ops = {}
        for op in re.findall(r"\b((?:ATOMS|ATOM|RED|LDL|STL|LDS|STS|BRA|BSSY|BSYNC)(?:\.[A-Z0-9_]+)*)", f):
            ops[op] = ops.get(op, 0) + 1
        print(json.dumps({"sass_ops": f.split("\n", 1)[0].strip()[:80], "counts": ops}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seed", type=int, default=47)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("member_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from pinot_tpu_torch.ops import _build

    dev = torch.device("cuda")
    print(cs.nvidia_smi_line(), flush=True)
    clock = Build()
    builds = {n: Build(n, variant_source(n)) for n in VARIANTS}
    _build.load()
    sass("fused_scan_batch_kernelILi2ELi1ELb1E")
    print(json.dumps({"ptxas": [r for r in _build.ptxas_report() if "batch" in r["kernel"]]}), flush=True)
    print(json.dumps({"member_grid_max_abs_err": cs.phase_member_grid(args.seed, dev)}), flush=True)
    shapes = cs._member_shapes(args.seed, dev)
    _worst, timings = cs._timed_member_shapes(shapes, dev)
    cs._member_scan_ms(shapes, dev, timings)
    flush_shares(cs, shapes, dev, timings, clock.load())
    for t in timings:
        print(json.dumps({"member_shape": t}), flush=True)
    sweep(cs, shapes, dev)
    variants(cs, shapes, dev, {"clocked": clock, **builds})
    return 0


if __name__ == "__main__":
    sys.exit(main())
