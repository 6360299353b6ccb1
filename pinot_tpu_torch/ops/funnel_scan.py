"""The ordered funnel's per-key row scan: the hand-written CUDA kernel.

Port of ``pinot_tpu/query/aggs_stats.py:_ordered_funnel_reach`` (489-536),
which the JAX package runs as one ``lax.sort`` by (key, ts) and one
``lax.scan`` over every sorted row.  It is not a Pallas kernel there, but
torch has no counterpart of a sequential scan and a Python loop cannot walk
2^27 rows, so the scan is ``ops/csrc/funnel_scan.cu``, built for ``sm_90a``
by ``ops/_build.py`` and called through ctypes.

The function: the deepest ORDERED funnel step each correlate key reached.
Per key, rows in (ts, row) order; S chain-start timestamps carry in f64:
carry[s] is the LATEST start of any chain that has reached step s+1 (a
later start never has less window slack, so the max is exact); an event
extends step s from the PRE-update carry[s-1] (one row never serves two
consecutive steps), within `window` of the chain's start.  The key's reach
is the count of live carries, maxed over its rows, into an int32 [cells]
table; masked rows take the sentinel key `cells` and drop, and so do rows
with no step flag, which change no carry.

The port splits it in two:
  * ``prepare``: torch ops.  ONE stable sort, of the int32 key; the ts and
    the S step flags (packed as one uint8 bitmask a row) gathered into key
    order for the live rows only; the runs of equal keys from
    ``torch.unique_consecutive``, each with its key, start and length.  A
    run's rows stay in row order, which after a stable sort by key is the
    tie order of equal timestamps.  Runs longer than ``RUN_CAP`` rows (more
    than a block of the kernel holds) are ordered by (ts, row) here, with
    two stable sorts over those runs' rows only, written back in place;
    ``RUN_CAP`` travels with the prepared runs as ``ordered_above``.
  * ``scan_runs``: the kernel.  A block stages the rows of the runs that
    start in its window into shared memory with coalesced loads, orders
    each run by (ts, row) there (a counting rank within the run), and one
    thread walks each run with the S carries in registers, writing that
    key's reach straight into the table: one key has one owner, so no
    atomics.  Runs longer than ``ordered_above`` are walked as they come,
    staged a tile at a time.  The JAX loop is sequential over all N rows;
    the kernel is parallel across keys and sequential within a key: the
    same function, not a copy of the loop.

What bounds the kernel on an H100: the bytes of the key-ordered ts (8) and
flags (1) a row and of each run's key, start and length (20), read once,
plus the table, against 3.35 TB/s; the in-tile ordering adds a run's length
in shared-memory compares a row, so long runs cost compute, and one huge
key's walk is sequential.

Ties: ``lax.sort`` is not stable, so rows with equal (key, ts) have no
defined order in the JAX package, and the reach can depend on it (a step-0
and a step-1 event at the same ts).  The port orders ties by row.

``scan_runs_reference`` is the plain PyTorch version of the kernel (the
runs of at most ``ordered_above`` rows ordered with torch stable sorts, then
a loop over the position within the runs, vectorized across runs), so
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
# the longest run the kernel orders in shared memory (FUNNEL_RUN_CAP in the
# .cu): prepare orders the longer ones itself
RUN_CAP = 1024

# kernel launches since the last reset (chip_smoke.py reads and resets it)
LAUNCHES = 0

# (run keys int32, ts f64, flags uint8, run starts int64, run counts int64, ordered_above)
Prepared = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, int]


def _order_runs(ts: torch.Tensor, flags: torch.Tensor, starts: torch.Tensor, counts: torch.Tensor) -> None:
    """Orders the rows of the given runs (disjoint spans of the rows) by
    (ts, row), in place: a stable sort by ts, then a stable sort by run."""
    total = int(counts.sum())
    if total == 0:
        return
    dev = ts.device
    run = torch.repeat_interleave(torch.arange(counts.shape[0], device=dev), counts, output_size=total)
    first = torch.cumsum(counts, 0) - counts
    rows = starts[run] + torch.arange(total, device=dev) - first[run]
    order = torch.sort(ts[rows], stable=True).indices
    order = order[torch.sort(run[order], stable=True).indices]
    src = rows[order]
    ts[rows] = ts[src]
    flags[rows] = flags[src]


def prepare(codes: torch.Tensor, steps: Sequence[torch.Tensor], ts: torch.Tensor, mask: torch.Tensor,
            cells: int) -> Prepared:
    """The kernel's operands: the live rows (masked in, some step flag set,
    key in [0, cells)) in key order, each run's rows in row order except the
    runs longer than RUN_CAP, which are ordered by (ts, row); the runs' keys,
    starts and lengths; and RUN_CAP as ordered_above."""
    num_steps = len(steps)
    if not 1 <= num_steps <= MAX_STEPS:
        raise NotImplementedError(f"ordered funnels take 1 to {MAX_STEPS} STEPS, got {num_steps}")
    cap = RUN_CAP
    dev = mask.device
    flags = torch.zeros(mask.shape, dtype=torch.uint8, device=dev)
    for s, st in enumerate(steps):
        flags |= st.to(torch.bool).to(torch.uint8) << s
    live = mask & (flags != 0)
    key = torch.where(live, codes.to(torch.int32), torch.full((), cells, dtype=torch.int32, device=dev))
    key_s, perm = torch.sort(key, stable=True)
    lo, hi = torch.searchsorted(key_s, torch.tensor([0, cells], dtype=torch.int32, device=dev)).tolist()
    perm = perm[lo:hi]
    ts_k = ts[perm].to(torch.float64)
    flags_k = flags[perm]
    run_keys, counts = torch.unique_consecutive(key_s[lo:hi], return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    longer = counts > cap
    if bool(longer.any()):
        _order_runs(ts_k, flags_k, starts[longer], counts[longer])
    return run_keys.contiguous(), ts_k.contiguous(), flags_k.contiguous(), starts, counts, cap


def scan_runs_reference(run_keys, ts_k, flags_k, starts, counts, ordered_above: int, num_steps: int, cells: int,
                        window: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel: int32 [cells] reach table.
    Orders the runs of at most ordered_above rows by (ts, row) with torch
    stable sorts, then loops over the position within the runs; each step
    is vectorized across every run."""
    dev = ts_k.device
    out = torch.zeros(cells, dtype=torch.int32, device=dev)
    runs = int(starts.shape[0])
    if runs == 0:
        return out
    short = counts <= ordered_above
    ts_k, flags_k = ts_k.clone(), flags_k.clone()
    _order_runs(ts_k, flags_k, starts[short], counts[short])
    f64 = torch.float64
    neg = torch.full((), NEG, dtype=f64, device=dev)
    prev = torch.full((runs, num_steps), NEG, dtype=f64, device=dev)
    best = torch.zeros(runs, dtype=torch.int32, device=dev)
    for j in range(int(counts.max())):
        act = counts > j
        idx = torch.where(act, starts + j, starts)
        t = ts_k[idx]
        f = flags_k[idx].to(torch.int32)
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


def _check(run_keys, ts_k, flags_k, starts, counts, ordered_above, num_steps: int) -> None:
    for t, dt, what in ((run_keys, torch.int32, "run_keys"), (ts_k, torch.float64, "ts_k"),
                        (flags_k, torch.uint8, "flags_k"), (starts, torch.int64, "starts"),
                        (counts, torch.int64, "counts")):
        if t.dtype != dt or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{what} must be a contiguous 1-D {dt} tensor, got {t.dtype} {tuple(t.shape)}")
        if t.device != ts_k.device:
            raise ValueError(f"{what} is on {t.device}, the rows on {ts_k.device}")
    if flags_k.shape != ts_k.shape or starts.shape != counts.shape or run_keys.shape != starts.shape:
        raise ValueError("funnel scan operands disagree in length")
    if isinstance(ordered_above, bool) or not isinstance(ordered_above, int) or \
            not 0 <= ordered_above <= RUN_CAP:
        raise ValueError(f"ordered_above must be an int in [0, {RUN_CAP}], got {ordered_above!r}")
    if not 1 <= num_steps <= MAX_STEPS:
        raise ValueError(f"funnel scan takes 1 to {MAX_STEPS} steps, got {num_steps}")


def _library():
    from pinot_tpu_torch.ops import _build

    return _build.load()


def scan_runs(run_keys, ts_k, flags_k, starts, counts, ordered_above: int, num_steps: int, cells: int,
              window: float) -> torch.Tensor:
    """int32 [cells]: each key's deepest ordered step over its run.  The
    rows are in key order; a run of more than ordered_above rows is already
    ordered by (ts, row), a shorter one is in row order.  CPU tensors take
    the plain version; CUDA tensors launch the kernel; anything else raises."""
    global LAUNCHES
    _check(run_keys, ts_k, flags_k, starts, counts, ordered_above, num_steps)
    dev = ts_k.device
    if dev.type == "cpu":
        return scan_runs_reference(run_keys, ts_k, flags_k, starts, counts, ordered_above, num_steps, cells, window)
    if dev.type != "cuda":
        raise ValueError(f"funnel scan runs on CUDA or CPU tensors, not {dev}")
    lib = _library()
    out = torch.zeros(cells, dtype=torch.int32, device=dev)
    runs, rows = int(starts.shape[0]), int(ts_k.shape[0])
    window_rows = int(lib.pinot_funnel_window_rows())
    tile_first = torch.empty(-(-rows // window_rows) + 1, dtype=torch.int64, device=dev)
    current = torch.cuda.current_device()
    with torch.cuda.device(dev) if dev.index not in (None, current) else contextlib.nullcontext():
        err = lib.pinot_funnel_scan(
            run_keys.data_ptr(), ts_k.data_ptr(), flags_k.data_ptr(), starts.data_ptr(), counts.data_ptr(),
            runs, rows, int(ordered_above), int(num_steps), int(cells), float(window), tile_first.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"funnel scan launch failed: {lib.pinot_cuda_error_string(err).decode()}")
    LAUNCHES += 1
    return out


def funnel_reach(codes, steps, ts, mask, cells: int, window: float) -> torch.Tensor:
    """The ordered funnel's reach table (int32 [cells]) through the kernel
    on CUDA tensors, the plain version on CPU tensors."""
    return scan_runs(*prepare(codes, steps, ts, mask, cells), len(steps), cells, window)
