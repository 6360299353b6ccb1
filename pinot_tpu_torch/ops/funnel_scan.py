"""The ordered funnel's per-key sorted row scan: the hand-written CUDA kernel.

Port of ``pinot_tpu/query/aggs_stats.py:_ordered_funnel_reach`` (489-536),
which the JAX package runs as one ``lax.scan`` over every sorted row.  It
is not a Pallas kernel there, but torch has no counterpart of a sequential
scan and a Python loop cannot walk 2^27 rows, so the scan is
``ops/csrc/funnel_scan.cu``, built for ``sm_90a`` by ``ops/_build.py`` and
called through ctypes.

The function: the deepest ORDERED funnel step each correlate key reached.
Rows sort by (key, ts); per key, S chain-start timestamps carry in f64:
carry[s] is the LATEST start of any chain that has reached step s+1 (a
later start never has less window slack, so the max is exact); an event
extends step s from the PRE-update carry[s-1] (one row never serves two
consecutive steps), within `window` of the chain's start.  The key's reach
is the count of live carries, maxed over its rows, into an int32 [cells]
table; masked rows take the sentinel key `cells` and drop.

The port splits it in two:
  * ``prepare``: torch ops.  A stable sort by ts, then a stable sort by key
    (torch has no two-key sort, and an int32 key with an f64 ts does not
    pack into one int64); the S step flags packed as one uint8 bitmask a
    row; the runs of equal keys from ``torch.unique_consecutive``, each
    with its key, start and length, the masked rows' sentinel run dropped.
  * ``scan_runs``: the kernel.  One thread walks one key's run with the S
    carries in registers and writes that key's reach straight into the
    table: one key has one owner, so no atomics.  The JAX loop is
    sequential over all N rows; the kernel is parallel across keys and
    sequential within a key: the same function, not a copy of the loop.

What bounds it on an H100: the bytes of the sorted ts (8) and flags (1) a
row and of each run's key, start and length (20), read once, plus the
table, against 3.35 TB/s.  A thread's
walk is a dependent chain of loads over its run, and neighbouring threads
read addresses a run apart, so the loads do not coalesce; a
warp-cooperative walk is the step after this simple one.

Ties: ``lax.sort`` is not stable, so rows with equal (key, ts) have no
defined order in the JAX package, and the reach can depend on it (a step-0
and a step-1 event at the same ts).  The port sorts stably in row order.

``scan_runs_reference`` is the plain PyTorch version of the kernel (a loop
over the position within the runs, vectorized across runs), so
``funnel_reach`` on CPU tensors is the plain version of the whole function.
``scan_runs`` takes the plain version only for tensors on the CPU; on a
CUDA tensor it launches the kernel or raises.  ``LAUNCHES`` counts kernel
launches and nothing else.
"""
from __future__ import annotations

import contextlib
from typing import Sequence, Tuple

import torch

# the step flags are one uint8 bitmask a row (FUNNEL_MAX_STEPS in the .cu)
MAX_STEPS = 8
# the "no chain" carry, as the JAX package's NEG
NEG = -float(2 ** 62)

# kernel launches since the last reset (chip_smoke.py reads and resets it)
LAUNCHES = 0

Prepared = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def prepare(codes: torch.Tensor, steps: Sequence[torch.Tensor], ts: torch.Tensor, mask: torch.Tensor,
            cells: int) -> Prepared:
    """(run keys int32, ts_s f64, flags_s uint8, run starts int64, run
    counts int64): rows sorted by (key, ts) with masked rows on the
    sentinel key `cells`, and the runs of the keys below `cells`."""
    num_steps = len(steps)
    if not 1 <= num_steps <= MAX_STEPS:
        raise NotImplementedError(f"ordered funnels take 1 to {MAX_STEPS} STEPS, got {num_steps}")
    dev = mask.device
    key = torch.where(mask, codes.to(torch.int32), torch.full((), cells, dtype=torch.int32, device=dev))
    tsv = ts.to(torch.float64)
    flags = torch.zeros(key.shape, dtype=torch.int32, device=dev)
    for s, st in enumerate(steps):
        flags = flags | (st.to(torch.bool).to(torch.int32) << s)
    perm = torch.sort(tsv, stable=True).indices
    perm = perm[torch.sort(key[perm], stable=True).indices]
    ts_s = tsv[perm].contiguous()
    flags_s = flags[perm].to(torch.uint8).contiguous()
    uniq, counts = torch.unique_consecutive(key[perm], return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    live = (uniq >= 0) & (uniq < cells)
    return uniq[live].contiguous(), ts_s, flags_s, starts[live].contiguous(), counts[live].contiguous()


def scan_runs_reference(run_keys, ts_s, flags_s, starts, counts, num_steps: int, cells: int,
                        window: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel: int32 [cells] reach table.
    Loops over the position within the runs; each step is vectorized
    across every run."""
    dev = ts_s.device
    out = torch.zeros(cells, dtype=torch.int32, device=dev)
    runs = int(starts.shape[0])
    if runs == 0:
        return out
    f64 = torch.float64
    neg = torch.full((), NEG, dtype=f64, device=dev)
    prev = torch.full((runs, num_steps), NEG, dtype=f64, device=dev)
    best = torch.zeros(runs, dtype=torch.int32, device=dev)
    for j in range(int(counts.max())):
        act = counts > j
        idx = torch.where(act, starts + j, starts)
        t = ts_s[idx]
        f = flags_s[idx].to(torch.int32)
        new = prev.clone()
        for s in range(1, num_steps):
            ext = act & (((f >> s) & 1) == 1) & (prev[:, s - 1] > neg) & (t - prev[:, s - 1] <= window)
            new[:, s] = torch.where(ext, torch.maximum(prev[:, s], prev[:, s - 1]), prev[:, s])
        new[:, 0] = torch.where(act & ((f & 1) == 1), t, prev[:, 0])
        prev = new
        reach = (prev > neg).sum(dim=1, dtype=torch.int32)
        best = torch.where(act, torch.maximum(best, reach), best)
    out[run_keys.to(torch.int64)] = best
    return out


def _check(run_keys, ts_s, flags_s, starts, counts, num_steps: int) -> None:
    for t, dt, what in ((run_keys, torch.int32, "run_keys"), (ts_s, torch.float64, "ts_s"),
                        (flags_s, torch.uint8, "flags_s"), (starts, torch.int64, "starts"),
                        (counts, torch.int64, "counts")):
        if t.dtype != dt or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{what} must be a contiguous 1-D {dt} tensor, got {t.dtype} {tuple(t.shape)}")
        if t.device != ts_s.device:
            raise ValueError(f"{what} is on {t.device}, the rows on {ts_s.device}")
    if flags_s.shape != ts_s.shape or starts.shape != counts.shape or run_keys.shape != starts.shape:
        raise ValueError("funnel scan operands disagree in length")
    if not 1 <= num_steps <= MAX_STEPS:
        raise ValueError(f"funnel scan takes 1 to {MAX_STEPS} steps, got {num_steps}")


def _library():
    from pinot_tpu_torch.ops import _build

    return _build.load()


def scan_runs(run_keys, ts_s, flags_s, starts, counts, num_steps: int, cells: int, window: float) -> torch.Tensor:
    """int32 [cells]: each key's deepest ordered step over its sorted run.
    CPU tensors take the plain version; CUDA tensors launch the kernel;
    anything else raises."""
    global LAUNCHES
    _check(run_keys, ts_s, flags_s, starts, counts, num_steps)
    dev = ts_s.device
    if dev.type == "cpu":
        return scan_runs_reference(run_keys, ts_s, flags_s, starts, counts, num_steps, cells, window)
    if dev.type != "cuda":
        raise ValueError(f"funnel scan runs on CUDA or CPU tensors, not {dev}")
    lib = _library()
    out = torch.zeros(cells, dtype=torch.int32, device=dev)
    runs = int(starts.shape[0])
    current = torch.cuda.current_device()
    with torch.cuda.device(dev) if dev.index not in (None, current) else contextlib.nullcontext():
        err = lib.pinot_funnel_scan(
            run_keys.data_ptr(), ts_s.data_ptr(), flags_s.data_ptr(), starts.data_ptr(), counts.data_ptr(),
            runs, int(num_steps), int(cells), float(window), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"funnel scan launch failed: {lib.pinot_cuda_error_string(err).decode()}")
    LAUNCHES += 1
    return out


def funnel_reach(codes, steps, ts, mask, cells: int, window: float) -> torch.Tensor:
    """The ordered funnel's reach table (int32 [cells]) through the kernel
    on CUDA tensors, the plain version on CPU tensors."""
    return scan_runs(*prepare(codes, steps, ts, mask, cells), len(steps), cells, window)
