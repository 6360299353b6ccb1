"""Bit-packed forward indexes: dictionary codes in 4/8/16-bit lanes.

Copy of pinot_tpu/segment/packing.py; ``unpack_codes_torch`` replaces its
``unpack_codes_jnp``.  Codes for a dictionary column with cardinality C need
only ceil(log2(C)) bits each; codes pack into little-endian lanes inside
uint32 words:

    factor f = 32 // bits          lanes per word
    word w, lane l                 covers row w * f + l
    code  = (word >> (bits * l)) & ((1 << bits) - 1)

The layout generalizes the range-index bitmap layout (bits=1: bit r of word
w covers row 32*w + r), so the fused scan kernel's lane unpack serves both.

Only power-of-two lane widths that divide 32 are used (4/8/16); a column
whose cardinality needs >16 bits stays unpacked (32 means "no packing").

On the torch side words are held as int32 views of the uint32 words: torch
has no ``>>`` on uint32 on the CPU, so shifts are arithmetic and every shift
is masked.
"""
from __future__ import annotations

import numpy as np
import torch

LANE_WIDTHS = (4, 8, 16)


def lane_bits(cardinality: int) -> int:
    """Narrowest supported lane width for a dictionary of this size.

    Returns 32 when the column does not benefit (codes would need more
    than 16 bits), meaning "store unpacked".
    """
    for bits in LANE_WIDTHS:
        if cardinality <= (1 << bits):
            return bits
    return 32


def pack_codes(codes: np.ndarray, bits: int) -> np.ndarray:
    """Pack int codes into uint32 words, `32 // bits` lanes per word.

    The tail word is zero-padded (zero is always a valid in-range lane,
    and consumers mask rows >= n).
    """
    if bits not in LANE_WIDTHS:
        raise ValueError(f"unsupported lane width: {bits}")
    factor = 32 // bits
    n = int(codes.shape[0])
    words = -(-n // factor)
    lanes = np.zeros(words * factor, dtype=np.uint32)
    lanes[:n] = codes.astype(np.uint32, copy=False)
    lanes = lanes.reshape(words, factor)
    shifts = (np.arange(factor, dtype=np.uint32) * np.uint32(bits))[None, :]
    return np.bitwise_or.reduce(lanes << shifts, axis=1).astype(np.uint32)


def unpack_codes(words: np.ndarray, bits: int, n: int, dtype=np.uint32) -> np.ndarray:
    """Numpy inverse of pack_codes: first n lanes as an unpacked array."""
    if bits not in LANE_WIDTHS:
        raise ValueError(f"unsupported lane width: {bits}")
    factor = 32 // bits
    shifts = (np.arange(factor, dtype=np.uint32) * np.uint32(bits))[None, :]
    mask = np.uint32((1 << bits) - 1)
    lanes = (words.astype(np.uint32, copy=False)[:, None] >> shifts) & mask
    return lanes.reshape(-1)[:n].astype(dtype, copy=False)


def word_view(words: np.ndarray) -> np.ndarray:
    """uint32 words as their contiguous int32 view (same bits): the host
    array a device tensor of the words is made from."""
    return np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)


def words_to_torch(words: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint32 words -> int32 tensor view on `device` (same bits); a
    read-only mmap is copied into writable memory first."""
    arr = word_view(words)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


def unpack_codes_torch(words: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """Torch twin of unpack_codes_jnp: [W] int32 word views -> [n] int32
    codes (the fused scan's lane unpack, on the words' device)."""
    from pinot_tpu_torch.ops.fused_scan import lane_unpack

    if bits not in LANE_WIDTHS:
        raise ValueError(f"unsupported lane width: {bits}")
    return lane_unpack(words, bits, n)
