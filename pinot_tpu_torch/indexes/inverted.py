"""Inverted + range-encoded bitmap indexes (host side).

Copy of pinot_tpu/indexes/inverted.py.  Reference parity:
  * Inverted: dictId -> bitmap of docIds (BitmapInvertedIndexReader).
  * Range: prefix bitmaps answering >, <, BETWEEN (RangeIndexReader).

Both are 2-D uint32 bitmask arrays kept on the host: the filter compiler
resolves a predicate to ONE row of words (n/8 bytes) host-side and ships
only that row to the device as a query parameter.
  * InvertedIndex: rows = per-dictId doc bitmaps, shape (card, words).
  * RangeEncodedIndex: rows = PREFIX bitmaps, prefix[i] = docs with
    code < i, shape (card+1, words); range [lo, hi) = prefix[hi] & ~prefix[lo].
"""
from __future__ import annotations

import numpy as np

from pinot_tpu_torch.indexes.bitmap import num_words


def _bitmaps_from_codes(codes: np.ndarray, cardinality: int, num_docs: int) -> np.ndarray:
    """Build (cardinality, words) doc bitmaps from the code array in one
    vectorized pass (the off-heap creator analog)."""
    words = num_words(num_docs)
    out = np.zeros((cardinality, words), dtype=np.uint32)
    docs = np.arange(num_docs, dtype=np.int64)
    w = docs >> 5
    bit = np.uint32(1) << (docs & 31).astype(np.uint32)
    # scatter-OR per (code, word); np.bitwise_or.at handles duplicates.
    np.bitwise_or.at(out, (codes.astype(np.int64), w), bit)
    return out


class InvertedIndex:
    """Per-dictId doc bitmaps: shape (cardinality, words)."""

    def __init__(self, bitmaps: np.ndarray, num_docs: int):
        self.bitmaps = bitmaps
        self.num_docs = num_docs

    @staticmethod
    def build(codes: np.ndarray, cardinality: int, num_docs: int) -> "InvertedIndex":
        return InvertedIndex(_bitmaps_from_codes(codes, cardinality, num_docs), num_docs)

    @property
    def cardinality(self) -> int:
        return self.bitmaps.shape[0]

    @property
    def num_words(self) -> int:
        return self.bitmaps.shape[1]

    def doc_bitmap(self, dict_ids) -> np.ndarray:
        rows = self.bitmaps[np.asarray(dict_ids, dtype=np.int64)]
        return np.bitwise_or.reduce(rows, axis=0) if rows.ndim == 2 else rows


class CompressedInvertedIndex:
    """Sparse inverted index for high-cardinality columns: per-dictId
    posting lists, O(num_docs) total storage like the JAX package's
    compressed postings.  The postings are plain sorted uint32 doc ids here
    (the JAX package's roaring-style codec is host C++ outside this slice);
    EQ/IN decode only the requested rows into one dense word mask."""

    def __init__(self, postings: np.ndarray, offsets: np.ndarray, num_docs: int):
        self.postings = postings  # uint32 doc ids, grouped by code
        self.offsets = offsets  # int64[card+1]
        self.num_docs = num_docs

    @staticmethod
    def build(codes: np.ndarray, cardinality: int, num_docs: int) -> "CompressedInvertedIndex":
        order = np.argsort(codes, kind="stable")  # stable: doc ids ascend within a code
        offsets = np.searchsorted(codes[order], np.arange(cardinality + 1)).astype(np.int64)
        return CompressedInvertedIndex(order.astype(np.uint32), offsets, num_docs)

    @property
    def cardinality(self) -> int:
        return len(self.offsets) - 1

    @property
    def num_words(self) -> int:
        return num_words(self.num_docs)

    def doc_bitmap(self, dict_ids) -> np.ndarray:
        """OR of the requested posting rows as dense u32 words."""
        words = np.zeros(self.num_words, dtype=np.uint32)
        for c in np.atleast_1d(np.asarray(dict_ids, dtype=np.int64)):
            docs = self.postings[self.offsets[c]: self.offsets[c + 1]].astype(np.int64)
            np.bitwise_or.at(words, docs >> 5, np.uint32(1) << (docs & 31).astype(np.uint32))
        return words


class RangeEncodedIndex:
    """Prefix bitmaps: prefix[i] = docs with code < i; shape (card+1, words).

    range [lo, hi) = prefix[hi] & ~prefix[lo] (prefix[lo] subset of
    prefix[hi]), i.e. two row loads per range predicate."""

    def __init__(self, prefix: np.ndarray, num_docs: int):
        self.prefix = prefix
        self.num_docs = num_docs

    @staticmethod
    def build(codes: np.ndarray, cardinality: int, num_docs: int) -> "RangeEncodedIndex":
        per_value = _bitmaps_from_codes(codes, cardinality, num_docs)
        prefix = np.zeros((cardinality + 1, per_value.shape[1]), dtype=np.uint32)
        np.bitwise_or.accumulate(per_value, axis=0, out=per_value)
        prefix[1:] = per_value
        return RangeEncodedIndex(prefix, num_docs)

    @property
    def cardinality(self) -> int:
        return self.prefix.shape[0] - 1

    def range_bitmap(self, lo: int, hi: int) -> np.ndarray:
        """Docs with lo <= code < hi (host side)."""
        lo = max(0, min(lo, self.cardinality))
        hi = max(lo, min(hi, self.cardinality))
        return self.prefix[hi] & ~self.prefix[lo]
