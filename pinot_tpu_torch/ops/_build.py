"""Build and load the port's CUDA kernels (plain C interface, ctypes).

Every ``*.cu`` source under ``ops/csrc/`` compiles with ``nvcc`` for
``sm_90a`` into one shared library, ``build/torch_kernels/
libpinot_torch_kernels.so`` at the repository root (listed in
``.gitignore``).  The build runs at first use, from the sources in the
checkout only; a content hash of the sources beside the library decides
whether a later run rebuilds.  Each source compiles in its own ``nvcc``
process, all started together, and one link step joins the objects.

Nothing here runs at import time: the CPU tests import every module of
the package on a machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import List, Optional

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
LIB_NAME = "libpinot_torch_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# what ptxas said of each kernel (registers, shared memory, spills), kept
# beside the library; ptxas_report() reads it
PTXAS_LOG = "ptxas.log"

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
# seconds the last nvcc build in this process took (0.0 while the library
# found on disk was current); chip_smoke.py prints it
last_build_seconds = 0.0


def _sources() -> List[Path]:
    return sorted(_CSRC.glob("*.cu"))


def _digest(sources: List[Path]) -> str:
    h = hashlib.sha256()
    for f in sources + sorted(_CSRC.glob("*.cuh")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit (set CUDA_HOME)")


def build() -> Path:
    """Compile the kernel library if it is missing or stale; returns its path."""
    global last_build_seconds
    sources = _sources()
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = _digest(sources)
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs = [BUILD_DIR / (s.stem + ".o") for s in sources]
    procs = [
        (s, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
        for s, o in zip(sources, objs)
    ]
    failed, logs = [], []
    for s, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{s.name}:\n{out}")
        logs.append(out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    (BUILD_DIR / PTXAS_LOG).write_text("\n".join(logs))
    tmp = BUILD_DIR / f".{LIB_NAME}.{os.getpid()}.tmp"
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib)
    stamp.write_text(digest)
    last_build_seconds = time.perf_counter() - t0
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with every entry
    point's argtypes/restype declared."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            lib.pinot_fused_scan.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
            lib.pinot_fused_scan.restype = ctypes.c_int
            lib.pinot_fused_scan_batch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
            lib.pinot_fused_scan_batch.restype = ctypes.c_int
            lib.pinot_fused_scan_max_members.argtypes = []
            lib.pinot_fused_scan_max_members.restype = ctypes.c_int
            lib.pinot_device_smem_optin.argtypes = [ctypes.c_void_p]
            lib.pinot_device_smem_optin.restype = ctypes.c_int
            lib.pinot_fused_scan_params_size.argtypes = []
            lib.pinot_fused_scan_params_size.restype = ctypes.c_int
            lib.pinot_fused_scan_batch_size.argtypes = []
            lib.pinot_fused_scan_batch_size.restype = ctypes.c_int
            vp = ctypes.c_void_p
            ll = ctypes.c_longlong
            lib.pinot_funnel_scan.argtypes = [
                vp, vp, vp, vp, vp, ll, ll, ll, ctypes.c_int, ll, ctypes.c_double, vp, vp, vp,
            ]
            lib.pinot_funnel_scan.restype = ctypes.c_int
            for fn in (lib.pinot_funnel_window_rows, lib.pinot_funnel_run_cap):
                fn.argtypes = []
                fn.restype = ll
            lib.pinot_cuda_error_string.argtypes = [ctypes.c_int]
            lib.pinot_cuda_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def ptxas_report() -> List[dict]:
    """Per kernel of the last build: its mangled name, registers, shared
    memory (bytes, static), stack frame and spill bytes, from ptxas -v."""
    path = BUILD_DIR / PTXAS_LOG
    if not path.exists():
        return []
    out: List[dict] = []
    cur: Optional[dict] = None
    for line in path.read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"kernel": m.group(1)}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(s.group(1)) if s else 0
    return out
