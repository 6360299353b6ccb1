"""Fused filter -> dense group-by scan: the hand-written CUDA kernel.

Port of ``pinot_tpu/ops/pallas_scan.py`` — the TPU kernel
``fused_group_tables_pallas`` (body ``scan_kernel``, helper
``_lane_unpack``) becomes ``ops/csrc/fused_scan.cu``, built for ``sm_90a``
by ``ops/_build.py`` and called through ctypes.  Same arguments, same
eligibility (``kernel_supported`` = ``pallas_supported``), same errors and
the same ``f64[num_groups]`` table per entry.

What bounds it on an H100: the bytes of key, masks, values and bitmap words,
each read once, against 3.35 TB/s; then the shared-memory atomics and the
merge of the block tables.  What the design does about it (the ``.cu``
header has the detail): the TPU's 8-bit limbs, one-hot MXU matmuls and
int32 super-tiles are dropped (they exist because the TPU lacks scatter and
64-bit integer ALUs).  The kernel is a template on the key mode and the
value mode, specialised for the two shapes the SQL path launches and
generic otherwise; each thread takes 16-row tiles, which a warp reads in
coalesced quads of 4 rows; a mask that several entries share is read once;
one persistent block a multiprocessor adds into 32-bit shared-memory words
and flushes with one global atomic per slot.  This module picks the
instantiation (``key_mode``, ``value_mode``, ``table_layout`` against the
card's shared-memory opt-in), deduplicates the masks (``dedup_masks``) and finds
the first row from which every operand is aligned for the vector loads
(``tile_head``), all in ``build_params``; past the opt-in the rows add
straight into the global table.  The int64 tables convert to f64 here.

``fused_group_tables_reference`` is the plain PyTorch version with the same
signature (an int64 ``index_add_`` per entry).  ``fused_group_tables`` takes
it only for tensors on the CPU; on a CUDA tensor it launches the kernel or
raises.  ``LAUNCHES`` counts kernel launches and nothing else;
``VARIANT_LAUNCHES`` splits them by instantiation and
``MASK_WORDS_LAUNCHES`` counts those that read packed filter words.

The member axis.  The JAX package runs W same-shape queries as one
``jax.vmap`` of the planned function, and Pallas' batching rule turns the
scan into ONE ``pallas_call`` whose grid gains a member axis.  Here the
scan is the torch custom op ``pinot_tpu_torch::fused_group_tables`` (the
key, one list of tensors and a spec string of the ints) with a vmap rule, so
``torch.func.vmap`` over a planned closure reaches it with the physical
tensors and their batch dims: on CUDA the rule issues one launch of the
kernel's member-axis form (``pinot_fused_scan_batch``: each member its own
operand pointers, a shared operand the same address in every member, and
``[W, E, G]`` tables); on the CPU it runs the plain version once a member.
``batch_layout`` finds the operands every member shares and the members
``Wg`` one block scans together (with a shared key in a specialised
instantiation, as many as the shared memory holds tables for; else 1), so
the kernel reads each shared stream ``ceil(W / Wg)`` times.  The vmap rule
builds the launch's ``ScanBatch`` with ``vmap_batch``: member 0's
parameters in full, every other member's a copy with each stacked operand's
address moved on by its member stride.
``BATCH_LAUNCHES`` counts member-axis launches by instantiation,
``BATCH_MEMBERS`` the members they carried and ``BATCH_LAYOUTS`` the
launches by ``"W/Wg"``.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

KERNEL_KINDS = ("count", "int_sum", "int64_sum")
# the group-table ceiling of the TPU kernel (segmented._MATMUL_MAX_GROUPS)
MAX_GROUPS = 8192
# entries per launch (PINOT_MAX_ENTRIES in csrc/fused_scan.cu); longer entry
# lists launch once per chunk
MAX_ENTRIES = 16
# rows a thread takes a step (PINOT_TILE in csrc/fused_scan.cu), in quads of
# QUAD_ROWS consecutive rows; a warp's vector tile is WARP_TILE_ROWS rows
TILE_ROWS = 16
QUAD_ROWS = 4
WARP_TILE_ROWS = 32 * TILE_ROWS
# instantiation codes of csrc/fused_scan.cu (KeyMode, ValMode), and the
# instantiations it has: the specialised (key mode, value mode) pairs of the
# SQL path's two fused scans (a packed dictionary key and a computed int32
# key, each with int32 sums), and the generic one that takes any other
# shape; the global-atomic path is generic only
KEY_MODES = ("any", "i32", "p16")
VALUE_MODES = ("any", "i32")
SPECIALISED = (("p16", "i32"), ("i32", "i32"))
INSTANTIATIONS = tuple(f"{k}/{v}/shared" for k, v in SPECIALISED) + ("any/any/shared", "any/any/global")

# kernel launches since the last reset (chip_smoke.py reads and resets it),
# in all, by instantiation ("<key mode>/<value mode>/<shared|global>") and
# those that read the filter as packed bitmap words (mask_words)
LAUNCHES = 0
VARIANT_LAUNCHES: Dict[str, int] = {}
MASK_WORDS_LAUNCHES = 0
BATCH_LAUNCHES: Dict[str, int] = {}
BATCH_MEMBERS = 0
# member-axis launches by "<members>/<members a block scans together>"
BATCH_LAYOUTS: Dict[str, int] = {}
# members one member-axis launch takes (PINOT_MAX_MEMBERS in
# csrc/fused_scan.cu); a wider vmap launches once per chunk of members
MAX_MEMBERS = 8


def reset_counters() -> None:
    """Zero every launch counter of this module."""
    global LAUNCHES, MASK_WORDS_LAUNCHES, BATCH_MEMBERS
    LAUNCHES = MASK_WORDS_LAUNCHES = BATCH_MEMBERS = 0
    VARIANT_LAUNCHES.clear()
    BATCH_LAUNCHES.clear()
    BATCH_LAYOUTS.clear()

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
        ("values", ctypes.c_void_p),
        ("kind", ctypes.c_int32),
        ("vtype", ctypes.c_int32),
        ("n_limbs", ctypes.c_int32),
        ("is_signed", ctypes.c_int32),
        ("mask_idx", ctypes.c_int32),
        ("smem_off", ctypes.c_int32),
    ]


class _ScanParams(ctypes.Structure):
    _fields_ = [
        ("key", ctypes.c_void_p),
        ("mask_words", ctypes.c_void_p),
        ("pred", ctypes.c_void_p),
        ("masks", ctypes.c_void_p * MAX_ENTRIES),
        ("n", ctypes.c_int64),
        ("head", ctypes.c_int64),
        ("tiles", ctypes.c_int64),
        ("key_type", ctypes.c_int32),
        ("key_bits", ctypes.c_int32),
        ("pred_type", ctypes.c_int32),
        ("pred_lo", ctypes.c_int32),
        ("pred_hi", ctypes.c_int32),
        ("num_groups", ctypes.c_int32),
        ("num_entries", ctypes.c_int32),
        ("num_masks", ctypes.c_int32),
        ("key_mode", ctypes.c_int32),
        ("val_mode", ctypes.c_int32),
        ("shared", ctypes.c_int32),
        ("smem_words", ctypes.c_int32),
        ("e", _ScanEntry * MAX_ENTRIES),
    ]


def dedup_masks(masks: Sequence[torch.Tensor]) -> Tuple[List[torch.Tensor], List[int]]:
    """The distinct masks in first-use order, and each entry's index into
    them.  Masks are contiguous bool[n] on one device, so one address is one
    mask: the kernel reads it once a tile for every entry that shares it."""
    distinct: List[torch.Tensor] = []
    where: Dict[int, int] = {}
    idx = []
    for m in masks:
        i = where.setdefault(m.data_ptr(), len(distinct))
        if i == len(distinct):
            distinct.append(m)
        idx.append(i)
    return distinct, idx


def key_mode(key_dtype: torch.dtype, key_bits: int) -> str:
    """The key's specialised mode: 16-bit lanes, raw int32 codes, or "any"
    (every other key type or lane width)."""
    if key_bits:
        return "p16" if int(key_bits) == 16 else "any"
    return "i32" if key_dtype == torch.int32 else "any"


def value_mode(entries: Sequence[Entry]) -> str:
    """"i32" when every sum entry is an int_sum over 4-byte values (or there
    is none), else "any"."""
    sums = [(kind, values.dtype) for kind, values, _m, _lp in entries if kind != "count"]
    if all(k == "int_sum" and dt in (torch.int32, torch.uint32) for k, dt in sums):
        return "i32"
    return "any"


def instantiation(key_dtype: torch.dtype, key_bits: int, entries: Sequence[Entry], shared: bool) -> Tuple[str, str]:
    """The (key mode, value mode) of the kernel that runs: a SPECIALISED
    pair where the shape is one, else the generic ("any", "any")."""
    pair = (key_mode(key_dtype, key_bits), value_mode(entries))
    return pair if shared and pair in SPECIALISED else ("any", "any")


def tile_head(streams: Sequence[Tuple[int, int, bool]]) -> Optional[int]:
    """First row h < TILE_ROWS from which every stream is aligned for the
    kernel's vector loads, or None when no row is (the kernel then reads
    every row with scalar loads).

    streams: (address, bits a row, packed).  The vector loads read quads of
    4 rows (QUAD_ROWS): 4 * bits / 8 bytes, in pieces of up to 16 bytes, so
    a quad must start aligned to min(16, its bytes); a packed quad must also
    start on a word, or on a half word for 4-bit lanes."""
    for h in range(TILE_ROWS):
        ok = True
        for addr, bits, packed in streams:
            if packed and h % min(QUAD_ROWS, 32 // bits):
                ok = False
                break
            if (addr + h * bits // 8) % max(1, min(16, QUAD_ROWS * bits // 8)):
                ok = False
                break
        if ok:
            return h
    return None


def table_layout(entries: Sequence[Entry], num_groups: int) -> Tuple[List[int], int]:
    """Each entry's first 32-bit word in a block's shared tables, and the
    words in all: a count takes num_groups 32-bit counters, a sum a low and
    a high word per group."""
    offs, words = [], 0
    for kind, _v, _m, _lp in entries:
        offs.append(words)
        words += num_groups * (1 if kind == "count" else 2)
    return offs, words


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


def build_params(entries, key_t, key_bits, n, num_groups, mask_words, code_pred, smem_optin: int):
    """The kernel's ScanParams for one launch (at most MAX_ENTRIES entries),
    built and checked without touching the library.  Returns (params,
    order, variant): the kernel's table row j is entries[order[j]] (entries
    sorted stably by their mask's index), and variant names the
    instantiation, "<key mode>/<value mode>/<shared|global>"."""
    p, order, variant, _streams, _mask_idx = _build_params(
        entries, key_t, key_bits, n, num_groups, mask_words, code_pred, smem_optin)
    return p, order, variant


def _key_words(key_t: torch.Tensor) -> torch.Tensor:
    words = key_t.view(torch.int32) if key_t.dtype == torch.uint32 else key_t
    if words.dtype != torch.int32:
        raise ValueError(f"packed key words must be int32/uint32, got {key_t.dtype}")
    return words


def _build_params(entries, key_t, key_bits, n, num_groups, mask_words, code_pred, smem_optin: int):
    """build_params, plus the streams the vector loads read and each
    entry's mask index (what vmap_batch moves the members' copies by)."""
    device = key_t.device
    p = _ScanParams()
    p.n = n
    p.num_groups = num_groups
    streams = []  # what the vector loads read: (address, bits a row, packed)
    if key_bits:
        words = _key_words(key_t)
        p.key = _operand(words, int(words.shape[0]), "codes_packed words", device)
        p.key_bits = int(key_bits)
        streams.append((p.key, int(key_bits), True))
    else:
        if key_t.dtype == torch.bool:
            raise ValueError("codes must be an integer tensor")
        p.key = _operand(key_t, n, "codes", device)
        p.key_type = _DTYPE_CODES[key_t.dtype]
        streams.append((p.key, 8 * key_t.element_size(), False))
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
    for i, (kind, values, mask, _lp) in enumerate(entries):
        if mask.dtype != torch.bool:
            raise ValueError(f"entry {i} mask must be bool, got {mask.dtype}")
        _operand(mask, n, f"entry {i} mask", device)
        if kind != "count":
            _operand(values, n, f"entry {i} values", device)
            streams.append((values.data_ptr(), 8 * values.element_size(), False))
    masks, mask_idx = dedup_masks([mask for _k, _v, mask, _lp in entries])
    for j, m in enumerate(masks):
        p.masks[j] = m.data_ptr()
        streams.append((m.data_ptr(), 8, False))
    order = sorted(range(len(entries)), key=lambda i: mask_idx[i])
    ordered = [entries[i] for i in order]
    offs, words = table_layout(ordered, num_groups)
    shared = 4 * words <= smem_optin
    km, vm = instantiation(key_t.dtype, key_bits, ordered, shared)
    p.num_entries, p.num_masks = len(entries), len(masks)
    p.key_mode, p.val_mode = KEY_MODES.index(km), VALUE_MODES.index(vm)
    p.shared, p.smem_words = int(shared), words if shared else 0
    head = tile_head(streams)
    if head is not None and n > head:
        p.head, p.tiles = head, (n - head) // WARP_TILE_ROWS
    for j, ((kind, values, _mask, limb_plan), i) in enumerate(zip(ordered, order)):
        ent = p.e[j]
        ent.kind = _KIND_CODES[kind]
        ent.mask_idx = mask_idx[i]
        ent.smem_off = offs[j]
        if kind == "int_sum":
            n_limbs, signed = limb_plan if limb_plan is not None else (4, True)
            ent.n_limbs, ent.is_signed = int(n_limbs), int(bool(signed))
        elif kind == "int64_sum":
            ent.n_limbs = int(limb_plan if limb_plan is not None else 8)
        if kind != "count":
            ent.values = values.data_ptr()
            ent.vtype = _DTYPE_CODES[values.dtype]
    return p, order, f"{km}/{vm}/{'shared' if shared else 'global'}", streams, mask_idx


class _BatchHeader(ctypes.Structure):
    _fields_ = [
        ("members", ctypes.c_int32),
        ("group", ctypes.c_int32),
        ("shared", ctypes.c_uint32),
        ("masks_shared", ctypes.c_uint32),
        ("values_shared", ctypes.c_uint32),
        ("unused", ctypes.c_int32),
    ]


class _ScanBatch(ctypes.Structure):
    _fields_ = [("h", _BatchHeader), ("m", _ScanParams * MAX_MEMBERS)]


# BatchHeader.shared bits of csrc/fused_scan.cu (PINOT_SH_*)
_SH_KEY, _SH_WORDS, _SH_PRED = 1, 2, 4


class BatchLayout(NamedTuple):
    """What one member-axis launch shares and how a block takes it: key,
    words, pred: that operand is one address for every member; masks[j]:
    distinct mask j is; values[j]: kernel entry j's values are (False for a
    count); group: the members Wg one block scans together."""
    key: bool
    words: bool
    pred: bool
    masks: Tuple[bool, ...]
    values: Tuple[bool, ...]
    group: int


def batch_layout(params: Sequence[_ScanParams], smem_optin: int) -> BatchLayout:
    """The operands that the members' ScanParams share (one address in
    all), and Wg: where the key is shared and the instantiation specialised
    (the kernel's member path), min(W, smem_optin // one member's table
    bytes), as many members as a block's shared memory holds tables for;
    else 1, one member a grid row."""
    p0 = params[0]

    def same(get) -> bool:
        v = get(p0)
        return v is not None and all(get(p) == v for p in params[1:])

    key = same(lambda p: p.key)
    specialised = (KEY_MODES[p0.key_mode], VALUE_MODES[p0.val_mode]) in SPECIALISED
    group = min(len(params), smem_optin // (4 * p0.smem_words)) if p0.shared and key and specialised else 1
    return BatchLayout(
        key=key,
        words=same(lambda p: p.mask_words),
        pred=same(lambda p: p.pred),
        masks=tuple(same(lambda p, j=j: p.masks[j]) for j in range(p0.num_masks)),
        values=tuple(p0.e[j].kind != _KIND_CODES["count"] and same(lambda p, j=j: p.e[j].values)
                     for j in range(p0.num_entries)),
        group=max(1, group),
    )


# the kernel library once its ScanParams layout was checked, and the
# shared-memory opt-in of each device index
_LIB = None
_SMEM_OPTIN: Dict[int, int] = {}


def _library():
    global _LIB
    if _LIB is None:
        from pinot_tpu_torch.ops import _build

        lib = _build.load()
        if lib.pinot_fused_scan_params_size() != ctypes.sizeof(_ScanParams):
            raise RuntimeError("csrc/fused_scan.cu ScanParams layout differs from the ctypes mirror")
        if lib.pinot_fused_scan_max_members() != MAX_MEMBERS:
            raise RuntimeError("csrc/fused_scan.cu PINOT_MAX_MEMBERS differs from MAX_MEMBERS")
        if lib.pinot_fused_scan_batch_size() != ctypes.sizeof(_ScanBatch):
            raise RuntimeError("csrc/fused_scan.cu ScanBatch layout differs from the ctypes mirror")
        _LIB = lib
    return _LIB


def _smem_optin(lib, index: int) -> int:
    """Bytes of dynamic shared memory a block may opt into on the current
    device (whose index is given)."""
    if index not in _SMEM_OPTIN:
        got = ctypes.c_int(0)
        err = lib.pinot_device_smem_optin(ctypes.byref(got))
        if err != 0:
            raise RuntimeError(f"shared-memory query failed: {lib.pinot_cuda_error_string(err).decode()}")
        _SMEM_OPTIN[index] = got.value
    return _SMEM_OPTIN[index]


def _entry_order(rows: torch.Tensor, order: List[int]) -> List[torch.Tensor]:
    """A launch's f64 [E, G] rows (kernel order) as tables in entry order:
    the kernel's row j is entry order[j]."""
    rows = rows.unbind(0)
    tables: List[Optional[torch.Tensor]] = [None] * len(order)
    for j, i in enumerate(order):
        tables[i] = rows[j]
    return tables


def _launch(entries, key_t, key_bits, n, num_groups, mask_words, code_pred) -> List[torch.Tensor]:
    global LAUNCHES, MASK_WORDS_LAUNCHES
    lib = _library()
    device = key_t.device
    out = torch.zeros((len(entries), num_groups), dtype=torch.int64, device=device)
    with _on_device(device):
        p, order, variant = build_params(
            entries, key_t, key_bits, n, num_groups, mask_words, code_pred,
            _smem_optin(lib, torch.cuda.current_device()),
        )
        err = lib.pinot_fused_scan(ctypes.byref(p), out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused scan launch failed: {lib.pinot_cuda_error_string(err).decode()}")
    LAUNCHES += 1
    VARIANT_LAUNCHES[variant] = VARIANT_LAUNCHES.get(variant, 0) + 1
    MASK_WORDS_LAUNCHES += mask_words is not None
    return _entry_order(out.to(torch.float64), order)


def _set_header(b, W: int, layout: BatchLayout) -> None:
    """A ScanBatch's header: W members in groups of layout.group, and the
    shared-operand bits."""
    b.h.members, b.h.group = W, layout.group
    b.h.shared = _SH_KEY * layout.key | _SH_WORDS * layout.words | _SH_PRED * layout.pred
    b.h.masks_shared = sum(1 << j for j, sh in enumerate(layout.masks) if sh)
    b.h.values_shared = sum(1 << j for j, sh in enumerate(layout.values) if sh)


def _launch_struct(lib, b, order, variant: str, layout: BatchLayout, num_groups: int, device,
                   with_words: bool) -> torch.Tensor:
    """ONE member-axis launch of a built ScanBatch (on the current device,
    the members' own); returns f64 [W, E, G] in entry order."""
    global LAUNCHES, MASK_WORDS_LAUNCHES, BATCH_MEMBERS
    W = b.h.members
    out = torch.zeros((W, len(order), num_groups), dtype=torch.int64, device=device)
    err = lib.pinot_fused_scan_batch(ctypes.byref(b), out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused scan member-axis launch failed: {lib.pinot_cuda_error_string(err).decode()}")
    LAUNCHES += 1
    VARIANT_LAUNCHES[variant] = VARIANT_LAUNCHES.get(variant, 0) + 1
    BATCH_LAUNCHES[variant] = BATCH_LAUNCHES.get(variant, 0) + 1
    layout_key = f"{W}/{layout.group}"
    BATCH_LAYOUTS[layout_key] = BATCH_LAYOUTS.get(layout_key, 0) + 1
    BATCH_MEMBERS += W
    MASK_WORDS_LAUNCHES += with_words
    out = out.to(torch.float64)
    if order == sorted(order):
        return out
    rows = [None] * len(order)
    for j, i in enumerate(order):
        rows[i] = out[:, j]
    return torch.stack(rows, dim=1)


def _on_device(device):
    """The library launches on the current device: make it `device`."""
    current = torch.cuda.current_device()
    return torch.cuda.device(device) if device.index not in (None, current) else contextlib.nullcontext()


# ---------------------------------------------------------------------------
# the custom op: (key, tensors, spec), few arguments because torch's vmap
# adapter for a custom op walks every leaf of them on each call
# ---------------------------------------------------------------------------
_KINDS = {c: k for k, c in _KIND_CODES.items()}


def _op_args(entries, key_bits: int, num_groups: int, mask_words, pred, lo, hi) -> Tuple[List[torch.Tensor], str]:
    """The op's tensors (the sum entries' values, every entry's mask, then
    mask_words and pred, lo, hi where given) and its spec string
    "key_bits,num_groups,has_words,has_pred;kinds;limb counts;signs"
    (limb count -1 for no plan)."""
    kinds, values, masks, limbs, signs = [], [], [], [], []
    for kind, v, m, lp in entries:
        kinds.append(_KIND_CODES[kind])
        masks.append(m)
        if kind != "count":
            values.append(v)
        if lp is None:
            limbs.append(-1)
            signs.append(0)
        elif kind == "int_sum":
            limbs.append(int(lp[0]))
            signs.append(int(bool(lp[1])))
        else:
            limbs.append(int(lp))
            signs.append(0)
    tensors = values + masks + ([mask_words] if mask_words is not None else []) + (
        [pred, lo, hi] if pred is not None else [])
    spec = ";".join(",".join(map(str, x)) for x in (
        (key_bits, num_groups, int(mask_words is not None), int(pred is not None)), kinds, limbs, signs))
    return tensors, spec


@functools.lru_cache(maxsize=4096)
def _parse_spec(spec: str):
    head, kinds, limbs, signs = ([int(x) for x in part.split(",")] for part in spec.split(";"))
    return (*head, kinds, limbs, signs)


class _OpArgs(NamedTuple):
    """The op's arguments taken apart: entries over its tensors (whatever
    their member dims), the filter operands, and lo_at, lo's index in the
    tensor list (hi's is the next: their member dims under vmap)."""
    key_bits: int
    num_groups: int
    entries: List[Entry]
    mask_words: Optional[torch.Tensor]
    pred: Optional[torch.Tensor]
    lo: Optional[torch.Tensor]
    hi: Optional[torch.Tensor]
    lo_at: int


def _op_parts(tensors: Sequence[torch.Tensor], spec: str) -> _OpArgs:
    key_bits, num_groups, has_words, has_pred, kinds, limbs, signs = _parse_spec(spec)
    nv = sum(k != _KIND_CODES["count"] for k in kinds)
    values, masks, rest = tensors[:nv], tensors[nv:nv + len(kinds)], nv + len(kinds)
    entries, vi = [], 0
    for kc, m, nl, sg in zip(kinds, masks, limbs, signs):
        kind = _KINDS[kc]
        v = None
        if kind != "count":
            v = values[vi]
            vi += 1
        lp = None if nl < 0 else ((nl, bool(sg)) if kind == "int_sum" else nl)
        entries.append((kind, v, m, lp))
    mask_words = tensors[rest] if has_words else None
    at = rest + has_words
    pred, lo, hi = tensors[at:at + 3] if has_pred else (None, None, None)
    return _OpArgs(key_bits, num_groups, entries, mask_words, pred, lo, hi, at + 1)


def _scan(entries, key, key_bits, n, num_groups, mask_words, code_pred) -> List[torch.Tensor]:
    """One unbatched call's tables: the plain version on the CPU, on CUDA
    one launch a chunk of MAX_ENTRIES entries."""
    if key.device.type == "cpu":
        codes, packed = (None, (key, key_bits)) if key_bits else (key, None)
        return fused_group_tables_reference(
            entries, codes, num_groups, mask_words=mask_words, code_pred=code_pred, codes_packed=packed)
    return [
        t for i in range(0, len(entries), MAX_ENTRIES)
        for t in _launch(list(entries[i:i + MAX_ENTRIES]), key, key_bits, n, num_groups, mask_words, code_pred)
    ]


def _scan_args(key: torch.Tensor, tensors: Sequence[torch.Tensor], spec: str):
    """(entries, key_bits, rows, num_groups, mask_words, code_pred) of one
    unbatched call, from the op's arguments."""
    a = _op_parts(tensors, spec)
    code_pred = None if a.pred is None else (a.pred, int(a.lo), int(a.hi))
    n = int(a.entries[0][2].shape[0]) if a.key_bits else int(key.shape[0])
    return a.entries, a.key_bits, n, a.num_groups, a.mask_words, code_pred


@torch.library.custom_op("pinot_tpu_torch::fused_group_tables", mutates_args=())
def _fused_op(key: torch.Tensor, tensors: List[torch.Tensor], spec: str) -> torch.Tensor:
    entries, key_bits, n, num_groups, mask_words, code_pred = _scan_args(key, tensors, spec)
    return torch.stack(_scan(entries, key, key_bits, n, num_groups, mask_words, code_pred))


@_fused_op.register_fake
def _(key, tensors, spec):
    _kb, num_groups, _w, _p, kinds, _l, _s = _parse_spec(spec)
    return key.new_empty((len(kinds), num_groups), dtype=torch.float64)


_is_batched = torch._C._functorch.is_batchedtensor


def _stacked(in_dims, key, tensors, spec) -> Dict[int, torch.Tensor]:
    """Each stacked operand of the op under vmap made member-major and dense
    once, by id: member w's slice is its [w] (a shared operand, dim None,
    is not in it)."""
    kd, td, _ = in_dims
    dense = {}
    for t, d in [(key, kd), *zip(tensors, td)]:
        if d is not None and id(t) not in dense:
            dense[id(t)] = t.movedim(d, 0).contiguous()
    return dense


def member_args(W: int, in_dims, key, tensors, spec) -> List[tuple]:
    """The op's arguments for each of W members, from the physical tensors
    and their member dims under vmap.  A shared operand (dim None) is the
    same tensor for every member; a stacked one is made member-major and
    dense once, and member w takes its slice (a dense view)."""
    dense = _stacked(in_dims, key, tensors, spec)

    def mem(t, w):
        return dense[id(t)][w] if id(t) in dense else t

    return [(mem(key, w), [mem(t, w) for t in tensors], spec) for w in range(W)]


def _member_bounds(t: Optional[torch.Tensor], d: Optional[int], W: int) -> List[int]:
    """Each member's code-range bound as an int, read home in one copy (a
    shared bound is one 0-d tensor, a stacked one W values)."""
    if d is None:
        return [t.tolist()] * W
    return t.movedim(d, 0).reshape(W).tolist()


def _cat(parts: List[torch.Tensor], dim: int = 0) -> torch.Tensor:
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


def vmap_batch(dense, entries, key, key_bits, mask_words, pred, ranges, w0: int, W: int, num_groups: int,
               smem_optin: int):
    """The ScanBatch of members [w0, w0 + W) of the op under vmap, without
    making their slices: member w0's parameters in full (_build_params),
    every other member's a copy of them with each stacked operand's address
    moved on by its member stride (a stacked operand is one member-major
    dense tensor, `dense`) and its code range set.  entries: the op's (kind,
    values, mask, limb plan) over the physical tensors; ranges: each
    member's (lo, hi) or None.  Returns (batch, order, variant, layout)."""
    def at(t):
        return dense[id(t)][w0] if t is not None and id(t) in dense else t

    def step(t) -> int:  # bytes from one member's slice to the next; 0 when shared
        d = dense.get(id(t)) if t is not None else None
        return 0 if d is None else d.stride(0) * d.element_size()

    ents = [(k, at(v), at(m), lp) for k, v, m, lp in entries]
    key0 = at(key)
    n = int(ents[0][2].shape[0]) if key_bits else int(key0.shape[0])
    code_pred = None if pred is None else (at(pred), *ranges[w0])
    p0, order, variant, streams, mask_idx = _build_params(
        ents, key0, key_bits, n, num_groups, at(mask_words), code_pred, smem_optin)
    # (set the address, member w0's address, bytes a member, bits a row of a
    # stream the vector loads read, packed) of each stacked operand
    moves = []
    if step(key):
        moves.append((lambda p, a: setattr(p, "key", a), p0.key, step(key),
                      int(key_bits) or 8 * key0.element_size(), bool(key_bits)))
    if step(mask_words):
        moves.append((lambda p, a: setattr(p, "mask_words", a), p0.mask_words, step(mask_words), 0, False))
    if step(pred):
        moves.append((lambda p, a: setattr(p, "pred", a), p0.pred, step(pred), 0, False))
    for j in range(p0.num_masks):
        slot = [entries[i][2] for i in range(len(entries)) if mask_idx[i] == j]
        if step(slot[0]):
            if any(m is not slot[0] for m in slot):
                raise ValueError("a stacked mask shares a slot with another mask at member 0 only")
            moves.append((lambda p, a, j=j: p.masks.__setitem__(j, a), p0.masks[j], step(slot[0]), 8, False))
    for j, i in enumerate(order):
        v = entries[i][1]
        if step(v):
            moves.append((lambda p, a, j=j: setattr(p.e[j], "values", a), p0.e[j].values, step(v),
                          8 * v.element_size(), False))
    b = _ScanBatch()
    b.m[0] = p0
    size = ctypes.sizeof(_ScanParams)
    for w in range(1, W):
        q = b.m[w]
        ctypes.memmove(ctypes.addressof(q), ctypes.addressof(p0), size)
        for set_addr, base, stride, _bits, _packed in moves:
            set_addr(q, base + w * stride)
        if pred is not None:
            q.pred_lo, q.pred_hi = ranges[w0 + w]
    # one row tiling for all: the members' own streams where a member
    # stride moves their alignment
    extra = [(base + w * stride, bits, packed) for _s, base, stride, bits, packed in moves
             if bits and stride % 16 for w in range(1, W)]
    if extra:
        head = tile_head(streams + extra)
        head, tiles = (head, (n - head) // WARP_TILE_ROWS) if head is not None and n > head else (0, 0)
        for w in range(W):
            b.m[w].head, b.m[w].tiles = head, tiles
    layout = batch_layout([b.m[w] for w in range(W)], smem_optin)
    _set_header(b, W, layout)
    return b, order, variant, layout


def _fused_vmap(info, in_dims, key, tensors, spec):
    """The op under torch.func.vmap.  CUDA: one member-axis launch a chunk
    of MAX_MEMBERS members and MAX_ENTRIES entries, its ScanBatch built by
    vmap_batch; CPU: the plain version once a member."""
    W = info.batch_size
    if key.device.type != "cuda":
        return torch.stack([_fused_op(*a) for a in member_args(W, in_dims, key, tensors, spec)]), 0
    a = _op_parts(tensors, spec)
    dense = _stacked(in_dims, key, tensors, spec)
    ranges = None
    if a.pred is not None:
        td = in_dims[1]
        ranges = list(zip(_member_bounds(a.lo, td[a.lo_at], W), _member_bounds(a.hi, td[a.lo_at + 1], W)))
    lib = _library()
    chunks = []
    with _on_device(key.device):
        smem = _smem_optin(lib, torch.cuda.current_device())
        for e0 in range(0, len(a.entries), MAX_ENTRIES):
            rows = []
            for w0 in range(0, W, MAX_MEMBERS):
                b, order, variant, layout = vmap_batch(
                    dense, a.entries[e0:e0 + MAX_ENTRIES], key, a.key_bits, a.mask_words, a.pred, ranges, w0,
                    min(MAX_MEMBERS, W - w0), a.num_groups, smem)
                rows.append(_launch_struct(lib, b, order, variant, layout, a.num_groups, key.device,
                                           a.mask_words is not None))
            chunks.append(_cat(rows))
    return _cat(chunks, dim=1), 0


_fused_op.register_vmap(_fused_vmap)


def fused_group_tables(
    entries: Sequence[Entry],
    codes: Optional[torch.Tensor],
    num_groups: int,
    *,
    mask_words: Optional[torch.Tensor] = None,
    code_pred: Optional[Tuple[Any, Any, Any]] = None,
    codes_packed: Optional[Tuple[torch.Tensor, int]] = None,
) -> List[torch.Tensor]:
    """Per-entry f64[num_groups] tables, as pallas_scan.fused_group_tables_pallas.

    entries: (kind, values, mask, limb_plan) with kind in KERNEL_KINDS.
    mask_words: optional packed filter bitmap ([n // 32] words, bit r of word
    w is row 32w + r) ANDed into every entry mask.  code_pred: optional
    (codes, lo, hi) dictionary-code range, likewise ANDed (lo and hi ints or
    0-d tensors, which may differ by member under vmap).  codes_packed:
    optional (words, code_bits) packed forward index of the key; the kernel
    reads the words and `codes` may then be None.  CPU tensors take the plain
    version; CUDA tensors launch the kernel; anything else raises.  Under
    torch.func.vmap, with any operand batched, the call goes through the
    custom op, whose vmap rule launches the member-axis kernel."""
    n = _check_args(entries, codes, num_groups, mask_words, codes_packed)
    key_bits = int(codes_packed[1]) if codes_packed is not None else 0
    key = codes_packed[0] if codes_packed is not None else codes
    if key.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused scan runs on CUDA or CPU tensors, not {key.device}")
    operands = [key, mask_words, *(code_pred or ())] + [t for e in entries for t in e[1:3]]
    if not any(isinstance(t, torch.Tensor) and _is_batched(t) for t in operands):
        # outside vmap (or with every operand shared): straight to the
        # plain version or the launch, without the op's dispatch (~0.1 ms
        # of host a call on the card)
        return _scan(entries, key, key_bits, n, num_groups, mask_words, code_pred)
    pred = lo = hi = None
    if code_pred is not None:
        pred, lo, hi = code_pred
        lo, hi = (b if isinstance(b, torch.Tensor) else torch.tensor(int(b)) for b in (lo, hi))
    tensors, spec = _op_args(entries, key_bits, num_groups, mask_words, pred, lo, hi)
    return list(_fused_op(key, tensors, spec).unbind(0))
