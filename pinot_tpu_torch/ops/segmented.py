"""Segmented (grouped) and masked reductions — the aggregation hot path.

Port of pinot_tpu/ops/segmented.py.  The JAX package's TPU design (two-level
one-hot MXU matmuls over 8-bit limbs, int32 chunk tables) exists because
the TPU has no fast scatter and no 64-bit ALU.  The H100 has both, so the
port follows the JAX package's CPU "wide" policy (segmented.py:269-303):
native int64/f64 scatters with ``index_add_`` / ``scatter_reduce_``.

``fused_group_tables`` is the dense group-by's one scan over all additive
entries.  On CUDA, entry sets the kernel admits (integer kinds, 1 <= G <=
8192 — ``fused_scan.kernel_supported``) go to the hand-written kernel in
``ops/fused_scan.py``; float kinds and wider tables stay on the f64 torch
path, as the JAX package keeps them off Pallas.  On the CPU everything
takes the f64 torch path.

All functions take a boolean mask (filter and null handling folded in by
the caller) and return f64 (int64 for counts) outputs.
"""
from __future__ import annotations

from typing import Tuple

import torch

from pinot_tpu_torch.ops import fused_scan

_POS_INF = float("inf")
_NEG_INF = float("-inf")


def unpack_bitmap_words(words: torch.Tensor, n: int) -> torch.Tensor:
    """[n // 32] packed filter words (int32 views of uint32) -> [n] bool row
    mask; bit r of word w covers row 32 * w + r."""
    return fused_scan.lane_unpack(words, 1, n) != 0


def sum_limb_plan(vmin, vmax) -> Tuple[int, bool]:
    """(n_limbs, signed) for the exact two's-complement 8-bit limb
    decomposition of ints in [vmin, vmax] — the JAX package's plan, kept
    because it defines how the fused scan reads an int_sum value."""
    if vmin is None or vmax is None:
        return 4, True
    vmin, vmax = int(vmin), int(vmax)
    if vmin < -(1 << 31) or vmax > (1 << 31) - 1:
        return 4, True
    for k in (1, 2, 3, 4):
        if vmin >= 0 and vmax < (1 << (8 * k)):
            return k, False
        if -(1 << (8 * k - 1)) <= vmin and vmax < (1 << (8 * k - 1)):
            return k, True
    return 4, vmin < 0


def sum_limb_plan64(vmin, vmax) -> int:
    """Limb count of the signed-magnitude decomposition of int64 values in
    [vmin, vmax] (the "int64_sum" kind): ceil(bits(max |v|) / 8)."""
    if vmin is None or vmax is None:
        return 8
    m = max(abs(int(vmin)), abs(int(vmax)))
    for k in range(1, 8):
        if m < (1 << (8 * k)):
            return k
    return 8


# entry kinds understood by fused_group_tables
FUSED_KINDS = ("count", "int_sum", "int64_sum", "f32_sum", "f32_sumsq")


def _wide_tables(entries, codes, num_groups: int):
    """f64 torch path: one index_add_ per entry into f64 tables (exact for
    integer sums below 2^53, like the JAX package's wide policy)."""
    idx = codes.to(torch.int64)
    out = []
    for kind, values, mask, _ in entries:
        if kind == "count":
            upd = mask.to(torch.float64)
        else:
            v = values.to(torch.float64)
            if kind == "f32_sumsq":
                v = v * v
            upd = torch.where(mask, v, torch.zeros((), dtype=torch.float64, device=v.device))
        t = torch.zeros(num_groups, dtype=torch.float64, device=idx.device)
        out.append(t.index_add_(0, idx, upd))
    return out


def fused_group_tables(
    entries, codes, num_groups: int, backend=None, mask_words=None, codes_packed=None
):
    """Many additive group tables in one scan; f64[num_groups] per entry.

    entries: (kind, values, mask, limb_plan) with kind in FUSED_KINDS.
    backend: the plan-time tag, "cuda" or "torch".  "cuda" sends entry sets
    the kernel admits to fused_scan.fused_group_tables (which launches the
    kernel on CUDA tensors); everything else takes the f64 torch path.
    mask_words: optional packed filter bitmap ANDed into every entry mask.
    codes_packed: optional (words, code_bits) packed forward index of the
    key column; the kernel reads the words.  `codes` may be None when
    codes_packed is given: eager torch has no dead-code elimination, so the
    caller does not unpack a key the kernel will not read, and the torch
    path unpacks it here when it needs it."""
    n = int(codes.shape[0]) if codes is not None else int(entries[0][2].shape[0])
    if backend == "cuda" and fused_scan.kernel_supported(entries, num_groups):
        return fused_scan.fused_group_tables(
            entries, codes, num_groups, mask_words=mask_words, codes_packed=codes_packed,
        )
    if codes is None:
        codes = fused_scan.lane_unpack(codes_packed[0], int(codes_packed[1]), n)
    if mask_words is not None:
        row_mask = unpack_bitmap_words(mask_words, n)
        entries = [(k, v, m & row_mask, lp) for k, v, m, lp in entries]
    return _wide_tables(entries, codes, num_groups)


# ---------------------------------------------------------------------------
# Grouped reductions
# ---------------------------------------------------------------------------
def _idx(codes):
    return codes.to(torch.int64)


def group_sum(values, mask, codes, num_groups: int):
    """f64[num_groups] sum of values where mask, by group code."""
    v = torch.where(mask, values.to(torch.float64), torch.zeros((), dtype=torch.float64, device=values.device))
    return torch.zeros(num_groups, dtype=torch.float64, device=v.device).index_add_(0, _idx(codes), v)


def group_sum_sq(values, mask, codes, num_groups: int):
    v = values.to(torch.float64)
    return group_sum(v * v, mask, codes, num_groups)


def group_count(mask, codes, num_groups: int):
    """int64[num_groups] count of mask-true rows by group code."""
    return torch.zeros(num_groups, dtype=torch.int64, device=mask.device).index_add_(
        0, _idx(codes), mask.to(torch.int64)
    )


def _group_extreme(values, mask, codes, num_groups: int, is_min: bool):
    ident = _POS_INF if is_min else _NEG_INF
    v = torch.where(mask, values.to(torch.float64), torch.full((), ident, dtype=torch.float64, device=values.device))
    base = torch.full((num_groups,), ident, dtype=torch.float64, device=v.device)
    return base.scatter_reduce_(0, _idx(codes), v, reduce="amin" if is_min else "amax", include_self=True)


def group_min(values, mask, codes, num_groups: int):
    """f64[num_groups]; +inf where a group matched no rows."""
    return _group_extreme(values, mask, codes, num_groups, True)


def group_max(values, mask, codes, num_groups: int):
    """f64[num_groups]; -inf where a group matched no rows."""
    return _group_extreme(values, mask, codes, num_groups, False)


# ---------------------------------------------------------------------------
# Masked scalar reductions (aggregation without group-by)
# ---------------------------------------------------------------------------
def masked_count(mask):
    """int64 scalar count."""
    return mask.sum(dtype=torch.int64)


def masked_sum(values, mask):
    """f64 scalar masked sum (exact for integer sums below 2^53)."""
    v = values.to(torch.float64)
    return torch.where(mask, v, torch.zeros((), dtype=torch.float64, device=v.device)).sum()


def masked_sum_sq(values, mask):
    v = values.to(torch.float64)
    return masked_sum(v * v, mask)


def masked_min(values, mask):
    """f64 scalar; +inf when nothing matched."""
    v = values.to(torch.float64)
    return torch.where(mask, v, torch.full((), _POS_INF, dtype=torch.float64, device=v.device)).min()


def masked_max(values, mask):
    v = values.to(torch.float64)
    return torch.where(mask, v, torch.full((), _NEG_INF, dtype=torch.float64, device=v.device)).max()
