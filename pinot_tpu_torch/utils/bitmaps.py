"""Compressed doc-id bitmaps (RoaringBitmap analog), numpy only.

The byte format of pinot_tpu/utils/bitmaps.py (its numpy fallback, which is
byte-compatible with the JAX package's native codec): a uint32 container
count, then per container a uint32 key (doc >> 16), a type byte (0 = sorted
uint16 array of at most 4096 lows, 1 = 8192-byte bitmap) and a uint32
count, then the payload.  The port's CompressedInvertedIndex persists its
posting lists in this format so that either package loads the other's
segments.
"""
from __future__ import annotations

from typing import List

import numpy as np

_CHUNK = 65536
_ARRAY_MAX = 4096
_BITMAP_BYTES = 8192


def compress(docs: np.ndarray) -> bytes:
    """Sorted distinct doc ids -> compressed container bytes."""
    docs = np.ascontiguousarray(docs, dtype=np.uint32)
    parts: List[bytes] = []
    keys = docs >> 16
    i, n = 0, len(docs)
    while i < n:
        key = int(keys[i])
        j = int(np.searchsorted(keys, key, side="right"))
        lows = (docs[i:j] & 0xFFFF).astype(np.uint16)
        count = j - i
        head = np.uint32(key).tobytes() + bytes([0 if count <= _ARRAY_MAX else 1]) + np.uint32(count).tobytes()
        if count <= _ARRAY_MAX:
            parts.append(head + lows.tobytes())
        else:
            bits = np.zeros(_BITMAP_BYTES, dtype=np.uint8)
            np.bitwise_or.at(bits, lows >> 3, (1 << (lows & 7)).astype(np.uint8))
            parts.append(head + bits.tobytes())
        i = j
    return np.uint32(len(parts)).tobytes() + b"".join(parts)


def decompress_docs(buf: bytes) -> np.ndarray:
    """Compressed container bytes -> the ascending uint32 doc ids."""
    mv = memoryview(buf)
    nc = int(np.frombuffer(mv[:4], dtype=np.uint32)[0])
    pos = 4
    out: List[np.ndarray] = []
    for _ in range(nc):
        key = int(np.frombuffer(mv[pos: pos + 4], dtype=np.uint32)[0])
        ctype = mv[pos + 4]
        count = int(np.frombuffer(mv[pos + 5: pos + 9], dtype=np.uint32)[0])
        pos += 9
        if ctype == 0:
            lows = np.frombuffer(mv[pos: pos + count * 2], dtype=np.uint16).astype(np.int64)
            pos += count * 2
        else:
            bits = np.frombuffer(mv[pos: pos + _BITMAP_BYTES], dtype=np.uint8)
            pos += _BITMAP_BYTES
            lows = np.flatnonzero(np.unpackbits(bits, bitorder="little"))
            if len(lows) != count:
                raise ValueError("corrupt compressed bitmap: container count mismatch")
        out.append(key * _CHUNK + lows)
    if not out:
        return np.zeros(0, dtype=np.uint32)
    return np.concatenate(out).astype(np.uint32)


def decompress_into_words(buf: bytes, words: np.ndarray) -> int:
    """OR the compressed bitmap into dense uint32 words (bit j of word w is
    doc 32 w + j); returns its cardinality.  Raises ValueError on a doc past
    the words."""
    docs = decompress_docs(buf).astype(np.int64)
    if len(docs) and int(docs[-1]) >> 5 >= len(words):
        raise ValueError("corrupt compressed bitmap: docs past buffer")
    np.bitwise_or.at(words, docs >> 5, np.uint32(1) << (docs & 31).astype(np.uint32))
    return len(docs)


def cardinality(buf: bytes) -> int:
    """Doc count of compressed container bytes, from the container headers."""
    mv = memoryview(buf)
    nc = int(np.frombuffer(mv[:4], dtype=np.uint32)[0])
    pos = 4
    total = 0
    for _ in range(nc):
        ctype = mv[pos + 4]
        count = int(np.frombuffer(mv[pos + 5: pos + 9], dtype=np.uint32)[0])
        pos += 9 + (count * 2 if ctype == 0 else _BITMAP_BYTES)
        total += count
    return total
