"""Inverted + range-encoded bitmap indexes (host side).

Copy of pinot_tpu/indexes/inverted.py, with its persistence (`to_regions`,
`meta`, `from_regions`: the same regions and metadata).  Reference parity:
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

from typing import Any, Dict

import numpy as np

from pinot_tpu_torch.indexes.bitmap import num_words
from pinot_tpu_torch.utils import bitmaps


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

    KIND = "inverted"

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

    # serde
    def to_regions(self, prefix: str):
        yield f"{prefix}.bitmaps", self.bitmaps

    def meta(self) -> Dict[str, Any]:
        return {"numDocs": self.num_docs, "cardinality": int(self.bitmaps.shape[0])}

    @staticmethod
    def from_regions(meta: Dict[str, Any], regions, prefix: str) -> "InvertedIndex":
        return InvertedIndex(np.asarray(regions[f"{prefix}.bitmaps"]), meta["numDocs"])


class CompressedInvertedIndex:
    """Sparse inverted index for high-cardinality columns: per-dictId
    posting lists, O(num_docs) total storage like the JAX package's
    compressed postings.  In memory the postings are plain sorted uint32 doc
    ids; on disk each row is compressed in the JAX package's roaring-style
    format (utils/bitmaps.py), so the persisted regions are the same.
    EQ/IN decode only the requested rows into one dense word mask."""

    KIND = "cinverted"

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

    def to_regions(self, prefix: str):
        """Each posting row compressed (blobs) + int64 byte offsets per row."""
        blobs = [
            np.frombuffer(bitmaps.compress(self.postings[self.offsets[c]: self.offsets[c + 1]]), dtype=np.uint8)
            for c in range(self.cardinality)
        ]
        offsets = np.zeros(self.cardinality + 1, dtype=np.int64)
        np.cumsum([len(b) for b in blobs], out=offsets[1:])
        yield f"{prefix}.blobs", np.concatenate(blobs) if blobs else np.zeros(0, np.uint8)
        yield f"{prefix}.offsets", offsets

    def meta(self) -> Dict[str, Any]:
        return {"kind": self.KIND, "numDocs": self.num_docs}

    @staticmethod
    def from_regions(meta: Dict[str, Any], regions, prefix: str) -> "CompressedInvertedIndex":
        blobs = np.asarray(regions[f"{prefix}.blobs"])
        boffs = np.asarray(regions[f"{prefix}.offsets"])
        rows = [bitmaps.decompress_docs(blobs[boffs[c]: boffs[c + 1]].tobytes()) for c in range(len(boffs) - 1)]
        offsets = np.zeros(len(rows) + 1, dtype=np.int64)
        np.cumsum([len(r) for r in rows], out=offsets[1:])
        postings = np.concatenate(rows) if rows else np.zeros(0, np.uint32)
        return CompressedInvertedIndex(postings.astype(np.uint32), offsets, meta["numDocs"])


class RangeEncodedIndex:
    """Prefix bitmaps: prefix[i] = docs with code < i; shape (card+1, words).

    range [lo, hi) = prefix[hi] & ~prefix[lo] (prefix[lo] subset of
    prefix[hi]), i.e. two row loads per range predicate."""

    KIND = "range"

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

    def to_regions(self, prefix: str):
        yield f"{prefix}.prefix", self.prefix

    def meta(self) -> Dict[str, Any]:
        return {"numDocs": self.num_docs, "cardinality": int(self.prefix.shape[0] - 1)}

    @staticmethod
    def from_regions(meta: Dict[str, Any], regions, prefix: str) -> "RangeEncodedIndex":
        return RangeEncodedIndex(np.asarray(regions[f"{prefix}.prefix"]), meta["numDocs"])
