"""Stable, process-independent hashing.

Copy of pinot_tpu/utils/hashing.py: canonical_bytes and hash2_64 (the bloom
filter's hashes, so a bloom filter either package writes answers the same
in the other), and murmur2 / partition_of (the Kafka default partitioner's
hash, which routes a stream key to its partition: upsert needs a key to
land in the same partition in both packages).  The arithmetic is on Python
integers (torch has no uint32 shift on the CPU).  Python's builtin hash()
is seed-randomized for strings: never use it for anything persisted.
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


def murmur2(data: bytes, seed: int = 0x9747B28C) -> int:
    """Murmur2 32-bit over `data` (Kafka's default partitioner hash)."""
    m = 0x5BD1E995
    mask = 0xFFFFFFFF
    h = (seed ^ len(data)) & mask
    n = len(data) & ~3
    for i in range(0, n, 4):
        k = int.from_bytes(data[i: i + 4], "little")
        k = (k * m) & mask
        k ^= k >> 24
        k = (k * m) & mask
        h = (h * m) & mask
        h ^= k
    rem = data[n:]
    if rem:
        h ^= int.from_bytes(rem, "little")
        h = (h * m) & mask
    h ^= h >> 13
    h = (h * m) & mask
    h ^= h >> 15
    return h


def partition_of(value: Any, num_partitions: int) -> int:
    """Stable partition id of a key (the Murmur partition function)."""
    return (murmur2(canonical_bytes(value)) & 0x7FFFFFFF) % num_partitions
