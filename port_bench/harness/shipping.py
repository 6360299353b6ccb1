"""A built segment sent home from a worker in memory: its large numpy
arrays through shared memory (/dev/shm), the rest pickled.  A pipe moves
about 50 MB/s on the card's host (8 workers returning 320 MB each took
48 s there), shared memory as fast as a copy.  The serving process maps
each block, drops its name at once (nothing is left in /dev/shm, even if
the process dies) and keeps the mapping for as long as the arrays live."""
from __future__ import annotations

from multiprocessing import shared_memory
from typing import Any, Dict, List

import numpy as np

FIELDS = ("codes", "values", "nulls", "packed", "mv_lengths")
MIN_BYTES = 1 << 20


class _Block:
    """A numpy array's place in shared memory."""

    def __init__(self, name: str, shape, dtype: str):
        self.name, self.shape, self.dtype = name, shape, dtype


def pack(args: Dict[str, Any]) -> Dict[str, Any]:
    """In the worker: the segment's constructor arguments with every large
    plain array of its columns moved into a shared-memory block."""
    for col in args["columns"].values():
        for f in FIELDS:
            a = getattr(col, f, None)
            if isinstance(a, np.ndarray) and a.dtype != object and a.nbytes >= MIN_BYTES:
                shm = shared_memory.SharedMemory(create=True, size=a.nbytes)
                np.ndarray(a.shape, a.dtype, buffer=shm.buf)[...] = a
                setattr(col, f, _Block(shm.name, a.shape, a.dtype.str))
                shm.close()
    return args


def unpack(args: Dict[str, Any], keep: List) -> Dict[str, Any]:
    """In the serving process: each block mapped back as an array; the
    mappings go into `keep`, which has to outlive the arrays."""
    for col in args["columns"].values():
        for f in FIELDS:
            b = getattr(col, f, None)
            if isinstance(b, _Block):
                shm = shared_memory.SharedMemory(name=b.name)
                shm.unlink()
                keep.append(shm)
                setattr(col, f, np.ndarray(b.shape, np.dtype(b.dtype), buffer=shm.buf))
    return args
