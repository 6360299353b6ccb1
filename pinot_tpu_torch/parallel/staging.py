"""Host-to-device staging on a CUDA stream of its own.

The distributed engine's tiered pipeline (parallel/engine.py) copies batch
k+1's table slices and range-index words while batch k scans.  On CUDA that
takes three things the JAX package gets from its runtime:

  * a copy stream: a copy issued on the compute stream orders behind every
    queued kernel, so the engine's staging thread issues its copies on a
    `torch.cuda.Stream` of the engine's own;
  * page-locked memory: a copy from pageable memory runs synchronously with
    the host.  Pinning every batch (cudaHostAlloc) costs more than the copy,
    so each host array goes through a small ring of pinned slots in
    slot-sized chunks (a host copy into the slot, then an async copy to the
    device), a slot reused only after its last copy's event has completed.
    A large chunk's host copy is torch's CPU copy, which splits it over the
    intra-op threads (several times numpy's single-threaded rate:
    chip_smoke.py phase 4d, `storage_copy_rates`); a small one is numpy's,
    as waking those threads from the staging thread costs more than a small
    copy;
  * an order for the consumer: `record()` marks everything issued so far;
    the consumer makes the compute stream wait on that event, and calls
    `record_stream(compute stream)` on every tensor it takes, so that the
    caching allocator does not hand a block evicted from the cache (freed
    while a scan still reads it) to the next copy.

Device tensors are allocated while the copy stream is current, so they
belong to its pool.  Nothing here falls back to a pageable copy: a CUDA
error raises in the staging thread and reaches the query through its
future.
"""
from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np
import torch

# pinned slots in the ring, and the bounds of one slot's size
RING_SLOTS = 4
MIN_SLOT_BYTES = 1 << 20
MAX_SLOT_BYTES = 64 << 20
# chunks from this size up take the multi-threaded host copy
PARALLEL_COPY_BYTES = 8 << 20


class CopyStream:
    """One engine's copy stream and its ring of pinned slots (allocated at
    the first copy)."""

    def __init__(self, device: torch.device, launch_bytes: int):
        self.device = device
        self.stream = torch.cuda.Stream(device=device)
        self.slot_bytes = int(min(MAX_SLOT_BYTES, max(MIN_SLOT_BYTES, launch_bytes // RING_SLOTS)))
        self._pinned: List[torch.Tensor] = []
        self._pinned_np: List[np.ndarray] = []
        self._done: List[Optional[torch.cuda.Event]] = []
        self._next = 0
        # one staging thread at a time in the ring (queries from several
        # threads on one engine)
        self._lock = threading.Lock()

    def _ring(self) -> None:
        for _ in range(RING_SLOTS):
            buf = torch.empty(self.slot_bytes, dtype=torch.uint8, pin_memory=True)
            self._pinned.append(buf)
            self._pinned_np.append(buf.numpy())
            self._done.append(None)

    def copy(self, a: np.ndarray) -> torch.Tensor:
        """`a` (C-contiguous; segment.tensor_source) as a device tensor of its
        dtype and shape.  Returns once every chunk is issued, before the
        device has finished the copies."""
        src = a.reshape(-1).view(np.uint8)
        src_t = torch.from_numpy(src)
        n = src.nbytes
        dtype = torch.from_numpy(np.empty(0, dtype=a.dtype)).dtype
        with self._lock, torch.cuda.stream(self.stream):
            if not self._pinned:
                self._ring()
            raw = torch.empty(n, dtype=torch.uint8, device=self.device)
            for off in range(0, n, self.slot_bytes):
                m = min(self.slot_bytes, n - off)
                i = self._next
                self._next = (i + 1) % RING_SLOTS
                if self._done[i] is not None:
                    self._done[i].synchronize()  # the slot's last copy has read it  # pinot-lint: disable=W002
                if m >= PARALLEL_COPY_BYTES:
                    self._pinned[i][:m].copy_(src_t[off: off + m])
                else:
                    self._pinned_np[i][:m] = src[off: off + m]
                raw[off: off + m].copy_(self._pinned[i][:m], non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(self.stream)
                self._done[i] = ev
        return raw.view(dtype).reshape(a.shape)

    def record(self) -> torch.cuda.Event:
        """An event after every copy issued so far on this stream."""
        ev = torch.cuda.Event()
        ev.record(self.stream)
        return ev
