"""Stable, process-independent hashing (the part the bloom filter uses).

Copy of canonical_bytes and hash2_64 from pinot_tpu/utils/hashing.py, so a
bloom filter either package writes answers the same in the other.  Python's
builtin hash() is seed-randomized for strings: never use it for anything
persisted.
"""
from __future__ import annotations

import hashlib
import math
from typing import Any, Tuple

import numpy as np


def canonical_bytes(value: Any) -> bytes:
    """Canonical byte encoding: numpy scalars and Python literals of the same
    logical value must encode identically (np.int64(2) == 2 == 2.0)."""
    if isinstance(value, np.generic):
        value = value.item()
    if isinstance(value, bool):
        return b"b1" if value else b"b0"
    if isinstance(value, float):
        if math.isfinite(value) and value == int(value):
            value = int(value)
        else:
            return b"f" + repr(value).encode("ascii")
    if isinstance(value, int):
        return b"i" + str(value).encode("ascii")
    if isinstance(value, bytes):
        return b"y" + value
    return b"s" + str(value).encode("utf-8")


def hash2_64(value: Any) -> Tuple[int, int]:
    """Two independent 64-bit hashes from one blake2b digest (C-speed)."""
    d = hashlib.blake2b(canonical_bytes(value), digest_size=16).digest()
    return int.from_bytes(d[:8], "little"), int.from_bytes(d[8:], "little")
