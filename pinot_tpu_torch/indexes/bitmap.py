"""Dense bitmask layout (host side of pinot_tpu/indexes/bitmap.py).

Bit j of word w == doc (w*32 + j), LSB-first, in uint32 words.  The device
unpack of such words is ops/segmented.unpack_bitmap_words.
"""
from __future__ import annotations

WORD_BITS = 32


def num_words(num_docs: int) -> int:
    return (num_docs + WORD_BITS - 1) // WORD_BITS
