"""Dense bitmask utilities (port of pinot_tpu/indexes/bitmap.py).

Bit j of word w == doc (w*32 + j), LSB-first, in uint32 words.  On the host
the words are numpy uint32; on the device they are torch int32 views of the
same bits (torch has no >> on uint32), and every shift is masked.
"""
from __future__ import annotations

import numpy as np

WORD_BITS = 32


def num_words(num_docs: int) -> int:
    return (num_docs + WORD_BITS - 1) // WORD_BITS


def pack_mask(mask: np.ndarray) -> np.ndarray:
    """bool[n] -> uint32[ceil(n/32)] (host side, build time)."""
    bits = np.packbits(np.asarray(mask, dtype=bool), bitorder="little")
    pad = (-len(bits)) % 4
    if pad:
        bits = np.concatenate([bits, np.zeros(pad, dtype=np.uint8)])
    return bits.view(np.uint32).copy()


def unpack_mask(words: np.ndarray, n: int) -> np.ndarray:
    """uint32[w] -> bool[n] (host side)."""
    return np.unpackbits(np.asarray(words, dtype=np.uint32).view(np.uint8), bitorder="little", count=n).astype(bool)


def unpack_mask_device(words, n: int):
    """[w] words (int32 view, or uint32) tensor -> [n] bool tensor on the
    words' device."""
    from pinot_tpu_torch.ops.segmented import unpack_bitmap_words

    return unpack_bitmap_words(words, n)


def popcount_device(words):
    """Total set bits of a word tensor, as an int64 0-d tensor on its
    device: a SWAR popcount of each word widened to int64 (no sign bits to
    mask), summed."""
    import torch

    w = words.view(torch.int32) if words.dtype == torch.uint32 else words
    x = w.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24 & 0xFF).sum()
