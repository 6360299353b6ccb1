"""Bloom filter for host-side segment pruning on equality predicates.

Copy of pinot_tpu/indexes/bloom.py (same bits, hashes and persisted regions,
so a filter either package writes answers the same in the other).
Reference parity: BloomFilterReader + BloomFilterSegmentPruner.  Pruning is
host-side work done BEFORE any kernel launch, so this is plain numpy.
Dict-encoded columns rarely need it (the sorted dictionary answers
membership exactly); it earns its keep on raw (no-dict) columns.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from pinot_tpu_torch.utils.hashing import hash2_64 as _hash2


class BloomFilter:
    KIND = "bloom"

    def __init__(self, bits: np.ndarray, num_hashes: int):
        self.bits = bits  # uint64 words
        self.num_hashes = num_hashes

    @property
    def num_bits(self) -> int:
        return len(self.bits) * 64

    @staticmethod
    def build(values, fpp: float = 0.03) -> "BloomFilter":
        values = list(values)
        n = max(1, len(values))
        m = int(-n * np.log(fpp) / (np.log(2) ** 2))
        m = max(64, (m + 63) // 64 * 64)
        k = max(1, round(m / n * np.log(2)))
        bf = BloomFilter(np.zeros(m // 64, dtype=np.uint64), k)
        for v in values:
            bf._add(v)
        return bf

    def _positions(self, value):
        h1, h2 = _hash2(value)
        m = self.num_bits
        return [(int(h1) + i * int(h2)) % m for i in range(self.num_hashes)]

    def _add(self, value) -> None:
        for p in self._positions(value):
            self.bits[p >> 6] |= np.uint64(1 << (p & 63))

    def might_contain(self, value) -> bool:
        return all(self.bits[p >> 6] & np.uint64(1 << (p & 63)) for p in self._positions(value))

    def to_regions(self, prefix: str):
        yield f"{prefix}.bits", self.bits

    def meta(self) -> Dict[str, Any]:
        return {"numHashes": self.num_hashes}

    @staticmethod
    def from_regions(meta: Dict[str, Any], regions, prefix: str) -> "BloomFilter":
        return BloomFilter(np.asarray(regions[f"{prefix}.bits"]), meta["numHashes"])
