"""Fused filter -> dense group-by scan: the hand-written CUDA kernel.

Port of ``pinot_tpu/ops/pallas_scan.py`` — the TPU kernel
``fused_group_tables_pallas`` (body ``scan_kernel``, helper
``_lane_unpack``) becomes ``ops/csrc/fused_scan.cu``, built for ``sm_90a``
by ``ops/_build.py`` and called through ctypes.  Same arguments, same
eligibility (``kernel_supported`` = ``pallas_supported``), same errors and
the same ``f64[num_groups]`` table per entry.

What bounds it on an H100: the bytes of key, masks, values and bitmap words,
each read once, against 3.35 TB/s; at small group counts, contention of the
shared-memory atomics on the hot group slots.  What the design does about
it: the TPU's 8-bit limbs, one-hot MXU matmuls and int32 super-tiles are
dropped (they exist because the TPU lacks scatter and 64-bit integer ALUs).
Each thread decodes the key in registers and adds an exact int64 into a
block-private ``[E, G]`` shared-memory table; blocks flush with one atomic
per non-zero slot into a global int64 table, converted to f64 here.  Past
the block's shared memory the rows add straight into the global table.

``fused_group_tables_reference`` is the plain PyTorch version with the same
signature (an int64 ``index_add_`` per entry).  ``fused_group_tables`` takes
it only for tensors on the CPU; on a CUDA tensor it launches the kernel or
raises.  ``LAUNCHES`` counts kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes
from typing import Any, List, Optional, Sequence, Tuple

import torch

KERNEL_KINDS = ("count", "int_sum", "int64_sum")
# the group-table ceiling of the TPU kernel (segmented._MATMUL_MAX_GROUPS)
MAX_GROUPS = 8192
# entries per launch (PINOT_MAX_ENTRIES in csrc/fused_scan.cu); longer entry
# lists launch once per chunk
MAX_ENTRIES = 16

# kernel launches since the last reset (chip_smoke.py reads and resets it)
LAUNCHES = 0

_INT_DTYPES = (torch.uint8, torch.int8, torch.int16, torch.uint16, torch.int32, torch.uint32, torch.int64)
# ElemType codes of csrc/fused_scan.cu
_DTYPE_CODES = {
    torch.uint8: 0, torch.bool: 0, torch.int8: 1, torch.int16: 2, torch.uint16: 3,
    torch.int32: 4, torch.uint32: 5, torch.int64: 6,
}
_KIND_CODES = {"count": 0, "int_sum": 1, "int64_sum": 2}

Entry = Tuple[str, Optional[torch.Tensor], torch.Tensor, Any]


def kernel_supported(entries: Sequence[Entry], num_groups: int) -> bool:
    """Can the fused scan compute these entries exactly?  Integer kinds
    only (floats keep the f64 torch path, as the JAX package keeps them off
    Pallas), 1 <= num_groups <= MAX_GROUPS."""
    if num_groups < 1 or num_groups > MAX_GROUPS:
        return False
    for kind, values, _mask, _lp in entries:
        if kind not in KERNEL_KINDS:
            return False
        if kind == "int_sum" and not (values is not None and values.dtype in _INT_DTYPES
                                      and values.element_size() <= 4):
            return False
        if kind == "int64_sum" and (values is None or values.dtype != torch.int64):
            return False
    return True


def lane_unpack(words: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """[n * bits / 32] uint32 words (held as int32) -> [n] int32 lanes; lane
    l of word i is row i * (32 // bits) + l.  bits=1 unpacks bitmap words,
    bits=4/8/16 packed forward indexes.  Arithmetic shifts on the int32 view
    are masked after each shift (torch has no >> on uint32)."""
    f = 32 // bits
    w = words.view(torch.int32) if words.dtype == torch.uint32 else words.to(torch.int32)
    shifts = torch.arange(f, dtype=torch.int32, device=w.device) * bits
    lanes = (w.unsqueeze(-1) >> shifts) & ((1 << bits) - 1)
    return lanes.reshape(-1)[:n]


def _check_args(entries, codes, num_groups, mask_words, codes_packed) -> int:
    if codes is not None:
        n = int(codes.shape[0])
    elif entries:
        n = int(entries[0][2].shape[0])
    else:
        raise ValueError("fused scan needs codes or at least one entry")
    if mask_words is not None and n % 32:
        raise ValueError("mask_words requires a 32-aligned row count")
    if not kernel_supported(entries, num_groups):
        raise ValueError("entries not eligible for the fused scan kernel")
    if codes_packed is not None:
        kw, bits = codes_packed
        f = 32 // int(bits)
        if n % f or int(kw.shape[0]) != n // f:
            raise ValueError("codes_packed rows must be lane-aligned with codes")
    return n


def _entry_values(kind: str, values: Optional[torch.Tensor], limb_plan) -> Optional[torch.Tensor]:
    """Per-row int64 value an entry adds, read exactly as the Pallas kernel's
    limb plan reads it (see entry_value in csrc/fused_scan.cu)."""
    if kind == "count":
        return None
    if kind == "int_sum":
        n_limbs, signed = limb_plan if limb_plan is not None else (4, True)
        x = values.view(torch.int32) if values.dtype == torch.uint32 else values.to(torch.int32)
        u = x.to(torch.int64) & 0xFFFFFFFF
        if n_limbs < 4:
            u = u & ((1 << (8 * n_limbs)) - 1)
        if signed:
            u = u - ((x < 0).to(torch.int64) << (8 * n_limbs))
        return u
    nl = limb_plan if limb_plan is not None else 8
    if nl >= 8:
        return values
    a = values.abs() & ((1 << (8 * nl)) - 1)  # |INT64_MIN| wraps to itself; its low bits are 0
    return torch.where(values < 0, -a, a)


def fused_group_tables_reference(
    entries: Sequence[Entry],
    codes: Optional[torch.Tensor],
    num_groups: int,
    *,
    mask_words: Optional[torch.Tensor] = None,
    code_pred: Optional[Tuple[torch.Tensor, int, int]] = None,
    codes_packed: Optional[Tuple[torch.Tensor, int]] = None,
) -> List[torch.Tensor]:
    """Plain PyTorch version of the kernel: an int64 index_add_ per entry,
    converted to f64 at the end.  Same signature, checks and tables."""
    n = _check_args(entries, codes, num_groups, mask_words, codes_packed)
    if codes_packed is not None:
        key = lane_unpack(codes_packed[0], int(codes_packed[1]), n).to(torch.int64)
    else:
        key = codes.to(torch.int64)
    base = (key >= 0) & (key < num_groups)  # out-of-table codes drop, as on the TPU
    if mask_words is not None:
        base = base & (lane_unpack(mask_words, 1, n) != 0)
    if code_pred is not None:
        pc, lo, hi = code_pred
        pc = pc.to(torch.int64)
        base = base & (pc >= int(lo)) & (pc < int(hi))
    key = torch.where(base, key, torch.zeros_like(key))
    out = []
    for kind, values, mask, limb_plan in entries:
        m = mask & base
        v = _entry_values(kind, values, limb_plan)
        add = m.to(torch.int64) if v is None else torch.where(m, v, torch.zeros_like(v))
        t = torch.zeros(num_groups, dtype=torch.int64, device=key.device).index_add_(0, key, add)
        out.append(t.to(torch.float64))
    return out


class _ScanEntry(ctypes.Structure):
    _fields_ = [
        ("mask", ctypes.c_void_p),
        ("values", ctypes.c_void_p),
        ("kind", ctypes.c_int32),
        ("vtype", ctypes.c_int32),
        ("n_limbs", ctypes.c_int32),
        ("is_signed", ctypes.c_int32),
    ]


class _ScanParams(ctypes.Structure):
    _fields_ = [
        ("key", ctypes.c_void_p),
        ("mask_words", ctypes.c_void_p),
        ("pred", ctypes.c_void_p),
        ("n", ctypes.c_int64),
        ("key_type", ctypes.c_int32),
        ("key_bits", ctypes.c_int32),
        ("pred_type", ctypes.c_int32),
        ("pred_lo", ctypes.c_int32),
        ("pred_hi", ctypes.c_int32),
        ("num_groups", ctypes.c_int32),
        ("num_entries", ctypes.c_int32),
        ("pad_", ctypes.c_int32),
        ("e", _ScanEntry * MAX_ENTRIES),
    ]


def _operand(t: torch.Tensor, n: int, what: str, device: torch.device) -> int:
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, the key on {device}")
    if t.dim() != 1 or int(t.shape[0]) != n:
        raise ValueError(f"{what} must have shape [{n}], got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if t.dtype not in _DTYPE_CODES:
        raise ValueError(f"{what} has unsupported dtype {t.dtype}")
    return t.data_ptr()


def _launch(entries, key_t, key_bits, n, num_groups, mask_words, code_pred) -> List[torch.Tensor]:
    global LAUNCHES
    from pinot_tpu_torch.ops import _build

    lib = _build.load()
    if lib.pinot_fused_scan_params_size() != ctypes.sizeof(_ScanParams):
        raise RuntimeError("csrc/fused_scan.cu ScanParams layout differs from the ctypes mirror")
    device = key_t.device
    p = _ScanParams()
    p.n = n
    p.num_groups = num_groups
    if key_bits:
        words = key_t.view(torch.int32) if key_t.dtype == torch.uint32 else key_t
        if words.dtype != torch.int32:
            raise ValueError(f"packed key words must be int32/uint32, got {key_t.dtype}")
        p.key = _operand(words, int(words.shape[0]), "codes_packed words", device)
        p.key_bits = int(key_bits)
    else:
        if key_t.dtype == torch.bool:
            raise ValueError("codes must be an integer tensor")
        p.key = _operand(key_t, n, "codes", device)
        p.key_type = _DTYPE_CODES[key_t.dtype]
    if mask_words is not None:
        mw = mask_words.view(torch.int32) if mask_words.dtype == torch.uint32 else mask_words
        if mw.dtype != torch.int32:
            raise ValueError(f"mask_words must be int32/uint32, got {mask_words.dtype}")
        p.mask_words = _operand(mw, n // 32, "mask_words", device)
    if code_pred is not None:
        pc, lo, hi = code_pred
        p.pred = _operand(pc, n, "code_pred codes", device)
        p.pred_type = _DTYPE_CODES[pc.dtype]
        p.pred_lo, p.pred_hi = int(lo), int(hi)
    p.num_entries = len(entries)
    for i, (kind, values, mask, limb_plan) in enumerate(entries):
        if mask.dtype != torch.bool:
            raise ValueError(f"entry {i} mask must be bool, got {mask.dtype}")
        ent = p.e[i]
        ent.mask = _operand(mask, n, f"entry {i} mask", device)
        ent.kind = _KIND_CODES[kind]
        if kind == "int_sum":
            n_limbs, signed = limb_plan if limb_plan is not None else (4, True)
            ent.n_limbs, ent.is_signed = int(n_limbs), int(bool(signed))
        elif kind == "int64_sum":
            ent.n_limbs = int(limb_plan if limb_plan is not None else 8)
        if kind != "count":
            ent.values = _operand(values, n, f"entry {i} values", device)
            ent.vtype = _DTYPE_CODES[values.dtype]
    out = torch.zeros((len(entries), num_groups), dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.pinot_fused_scan(ctypes.byref(p), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fused scan launch failed: {lib.pinot_cuda_error_string(err).decode()}")
    LAUNCHES += 1
    return list(out.to(torch.float64).unbind(0))


def fused_group_tables(
    entries: Sequence[Entry],
    codes: Optional[torch.Tensor],
    num_groups: int,
    *,
    mask_words: Optional[torch.Tensor] = None,
    code_pred: Optional[Tuple[torch.Tensor, int, int]] = None,
    codes_packed: Optional[Tuple[torch.Tensor, int]] = None,
) -> List[torch.Tensor]:
    """Per-entry f64[num_groups] tables, as pallas_scan.fused_group_tables_pallas.

    entries: (kind, values, mask, limb_plan) with kind in KERNEL_KINDS.
    mask_words: optional packed filter bitmap ([n // 32] words, bit r of word
    w is row 32w + r) ANDed into every entry mask.  code_pred: optional
    (codes, lo, hi) dictionary-code range, likewise ANDed.  codes_packed:
    optional (words, code_bits) packed forward index of the key; the kernel
    reads the words and `codes` may then be None.  CPU tensors take the plain
    version; CUDA tensors launch the kernel; anything else raises."""
    n = _check_args(entries, codes, num_groups, mask_words, codes_packed)
    key_t = codes_packed[0] if codes_packed is not None else codes
    if key_t.device.type == "cpu":
        return fused_group_tables_reference(
            entries, codes, num_groups, mask_words=mask_words, code_pred=code_pred,
            codes_packed=codes_packed,
        )
    if key_t.device.type != "cuda":
        raise ValueError(f"fused scan runs on CUDA or CPU tensors, not {key_t.device}")
    key_bits = int(codes_packed[1]) if codes_packed is not None else 0
    tables: List[torch.Tensor] = []
    for i in range(0, len(entries), MAX_ENTRIES):
        tables.extend(_launch(
            list(entries[i:i + MAX_ENTRIES]), key_t, key_bits, n, num_groups, mask_words, code_pred,
        ))
    return tables
