"""The fused scan's launches, counted with the bytes each needs at least,
while the traced window records them.

The least bytes follow PERF.md section 6's bound_ms arithmetic (each input
byte read once, each group table written once as int64), with the work
that depends on the data counted as these inputs need it: the filter
words every row; the predicate codes every row, or only the rows the
words keep; each distinct mask on the rows the words and the predicate
keep; the key (its packed width, or its element) and each distinct values
stream on the rows some entry counts.  A kernel that skips tiles with no
counted row reads no less than this, so the share cannot pass 100%
unless the time leaves out part of the work.

The recorder wraps the program's launch function of single queries,
pinot_tpu_torch.ops.fused_scan._launch, whose kernel is the profile's
`fused_scan_kernel`; member-axis launches (`_launch_struct`, kernel
`fused_scan_batch_kernel`) are in neither the bytes nor the time.  While
it records it keeps each launch's masks, filter words and predicate codes
(references: the program writes no operand in place once launched), and
of the key and the values streams only their sizes; the rows are counted
with the benchmark's own copy of the unpacking once the window has
closed, so no kernel of the yardstick runs inside the profiled or the
measured window.  Keeping the masks holds their memory until then, which
shows in a traced run's memory peak."""
from __future__ import annotations

import threading
from typing import List


def lane_unpack(words, bits: int, n: int):
    """[n * bits / 32] uint32 words (held as int32) -> [n] int32 lanes; lane
    l of word i is row i * (32 // bits) + l (a copy of the program's
    fused_scan.lane_unpack, so that the program cannot move the yardstick)."""
    import torch

    f = 32 // bits
    w = words.view(torch.int32) if words.dtype == torch.uint32 else words.to(torch.int32)
    shifts = torch.arange(f, dtype=torch.int32, device=w.device) * bits
    lanes = (w.unsqueeze(-1) >> shifts) & ((1 << bits) - 1)
    return lanes.reshape(-1)[:n]


def _bytes_per_row(t, key_bits: int = 0) -> float:
    return key_bits / 8.0 if key_bits else float(t.element_size())


def launch_counts(entries, key, key_bits: int, n: int, mask_words, code_pred):
    """The row counts a launch's least bytes need, as 0-d tensors on the
    launch's device: (filtered rows or None, {mask: rows}, key rows,
    {values: rows})."""
    import torch

    filt = None
    if mask_words is not None:
        filt = lane_unpack(mask_words, 1, n) != 0
    if code_pred is not None and code_pred[0].numel() == n:
        pc, lo, hi = code_pred
        sel = (pc >= lo) & (pc < hi)
        filt = sel if filt is None else filt & sel
    rows = {}
    for _k, _v, m, _lp in entries:
        if m.data_ptr() not in rows:
            rows[m.data_ptr()] = (m != 0) if filt is None else (m != 0) & filt
    any_row = None
    for r in rows.values():
        any_row = r if any_row is None else any_row | r
    values = {}
    for _k, v, m, _lp in entries:
        if v is not None:
            values[v.data_ptr()] = rows[m.data_ptr()] if v.data_ptr() not in values else (
                values[v.data_ptr()] | rows[m.data_ptr()])
    count = torch.count_nonzero
    return (None if filt is None else count(filt), {p: count(r) for p, r in rows.items()}, count(any_row),
            {p: count(r) for p, r in values.items()})


def least_bytes(entries, key, key_bits: int, n: int, num_groups: int, mask_words, code_pred, counts) -> float:
    """The least bytes of one launch from its arguments and its row counts
    (launch_counts, read home as ints)."""
    filt_rows, mask_rows, key_rows, value_rows = counts
    b = 0.0
    if mask_words is not None:
        b += mask_words.numel() * mask_words.element_size()
    if code_pred is not None:
        b += (filt_rows if mask_words is not None and filt_rows is not None else n) * code_pred[0].element_size()
    b += len(mask_rows) * (n if filt_rows is None else filt_rows)  # a distinct mask, a byte a row the filter keeps
    b += key_rows * _bytes_per_row(key, key_bits)
    vals = {v.data_ptr(): v for _k, v, _m, _lp in entries if v is not None}
    b += sum(value_rows[p] * v.element_size() for p, v in vals.items())
    return b + len(entries) * int(num_groups) * 8


class LaunchRecorder:
    """Install while a traced run lasts: `recording` gates what is kept;
    total() counts the kept launches' rows once the window has closed."""

    def __init__(self):
        from pinot_tpu_torch.ops import fused_scan

        self._mod = fused_scan
        self._orig = fused_scan._launch
        self._lock = threading.Lock()
        self.recording = False
        self._launches: List[tuple] = []

        def launch(entries, key, key_bits, n, num_groups, mask_words, code_pred):
            if self.recording:  # the row counts need the masks, words and codes; key and values their sizes
                kept = ([(k, _Meta(v) if v is not None else None, m, lp) for k, v, m, lp in entries], _Meta(key),
                        key_bits, n, num_groups, mask_words, code_pred)
                with self._lock:
                    self._launches.append(kept)
            return self._orig(entries, key, key_bits, n, num_groups, mask_words, code_pred)

        fused_scan._launch = launch

    @property
    def launches(self) -> int:
        return len(self._launches)

    def total(self) -> float:
        """The kept launches' least bytes; drops the operands."""
        out = 0.0
        for entries, key, key_bits, n, num_groups, mask_words, code_pred in self._launches:
            f, masks, key_rows, vals = launch_counts(entries, key, key_bits, n, mask_words, code_pred)
            counts = (None if f is None else int(f), {p: int(c) for p, c in masks.items()}, int(key_rows),
                      {p: int(c) for p, c in vals.items()})
            out += least_bytes(entries, key, key_bits, n, num_groups, mask_words, code_pred, counts)
        self._launches.clear()
        return out

    def remove(self) -> None:
        self._mod._launch = self._orig


class _Meta:
    """What least_bytes reads of a key or values stream: its length, its
    element width and its identity, without holding the tensor."""

    __slots__ = ("_n", "_size", "_ptr")

    def __init__(self, t):
        self._n, self._size, self._ptr = int(t.numel()), int(t.element_size()), int(t.data_ptr())

    def numel(self) -> int:
        return self._n

    def element_size(self) -> int:
        return self._size

    def data_ptr(self) -> int:
        return self._ptr
